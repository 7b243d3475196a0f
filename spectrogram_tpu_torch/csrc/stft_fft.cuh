// Device code shared by the STFT kernels: the Hann-pack-pad load, the three
// FFT bodies, the conjugate-symmetric stereo unpack of one window row, and
// the split-real row (one channel as an N/2-point real-FFT pack).
//
// Per row, with N >= W:
//   z[n] = (l[n] + i r[n]) * hann[n]     for n < W, 0 for W <= n < N
//   Z    = DFT_N(z)
//   L[k] = |Z[k] + conj(Z[(N-k) mod N])|, R[k] = |Z[k] - conj(Z[(N-k) mod N])|
// for k = 0 .. B-1 with B = max(N/2, W) output bins (`stft_bins`): N/2 where
// pad_factor >= 2, W (bins 0 .. W-1, Nyquist included for even N) where
// N = W.  DC is included; the k=0 partner is Z[0] itself.  `hann` arrives
// with the reference's 2/W output scale and the unpack's 1/2 folded in, as
// the TPU kernels' `_packed_hann` did.
//
// Three bodies compute DFT_N in place in shared memory:
//   Radix2      N = 2^a: bit-reversed load, log2(N) radix-2 DIT stages run
//               four at a time in registers (a pass over the buffer per
//               four stages), the packed rows' load fused into the first.
//   MixedRadix  N = 2^a 3^b 5^c 7^d: digit-reversed load, radix-4/2/3/5/7
//               DIT stages (4s first, then a 2, then 3s, 5s and 7s), so a
//               5-smooth N keeps the plan it had before radix 7 (N = 4800:
//               4-4-4-3-5-5; N = 4410: 2-3-3-5-7-7), run two at a time in
//               registers where their radices multiply to at most 28 (a
//               pass over the buffer per pair: (4 4)(4 3)(5 5) at N =
//               4800), the packed rows' load fused into the first.
//   Bluestein   N with a prime factor above 7: the chirp-z form of DFT_N as
//               a cyclic convolution of length M >= 2N - 1 (`bluestein_length`),
//               run as a MixedRadix decimation-in-frequency pass (natural
//               order in, digit-reversed out), a product with the filter's
//               transform stored in that digit-reversed order, and the DIT
//               pass (digit-reversed in, natural out), both in the register
//               passes.  The row's load multiplies by the chirp and
//               zero-pads to M (`input`), the DIF pass of stage 0 stores the
//               filter product, and the unpack applies the output chirp
//               where it reads a bin (`result`): no pointwise pass of its
//               own; M complex f32 of shared memory.
// Each reads one host-built table (`fft_table` in ops/cuda/stft_kernel.py),
// computed in float64 and rounded once to f32: the N twiddles exp(-2 pi i t
// / N) of a direct body, or for Bluestein the M twiddles of its inner
// length, the N chirp entries exp(-i pi t^2 / N) (t^2 reduced mod 2N in
// integers first) and the M filter entries.  `with_fft_body` picks the body
// from N on the host.
//
// Every packed kernel runs a row through `stft_packed_row`, every
// split-real kernel (stft_split.cu, push_fused.cu) one channel of a row
// through `stft_real_row`, and all the arithmetic here is written with _rn
// intrinsics, so nvcc contracts nothing differently in one kernel than in
// another: the all-windows kernel and the window-plane kernels give the same
// bits for the same window, and so do the split-real layouts and the fused
// push.  No tensor core is used, so TF32 cannot enter; every stage is true
// f32.
#pragma once

#include <type_traits>

#include "spk_common.cuh"

namespace spk {

constexpr int kStftMaxThreads = 512;
// An N/2 pack of kWideRow entries or more (128 KB) holds most of an SM's
// shared memory, one block per SM: those blocks run kWideThreads threads
// (stft_split.cu), the others at most kStftMaxThreads.
constexpr int kWideRow = 16384;
constexpr int kWideThreads = 1024;
constexpr int kMaxStages = 16;
// the dynamic shared memory a Hopper block may opt into (227 KB)
constexpr int kMaxSmemBytes = 232448;

// Output bins per row: max(N/2, W) (see the top of this file).
__host__ __device__ __forceinline__ int stft_bins(int n, int w) {
  return n / 2 > w ? n / 2 : w;
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(__fmaf_rn(a.x, b.x, -__fmul_rn(a.y, b.y)),
                     __fmaf_rn(a.x, b.y, __fmul_rn(a.y, b.x)));
}

// a - i b and a + i b
__device__ __forceinline__ float2 sub_i(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.y), __fsub_rn(a.y, b.x));
}

__device__ __forceinline__ float2 add_i(float2 a, float2 b) {
  return make_float2(__fsub_rn(a.x, b.y), __fadd_rn(a.y, b.x));
}

// c * a + b for a real c
__device__ __forceinline__ float2 cfma(float c, float2 a, float2 b) {
  return make_float2(__fmaf_rn(c, a.x, b.x), __fmaf_rn(c, a.y, b.y));
}

__device__ __forceinline__ float2 cscale(float c, float2 a) {
  return make_float2(__fmul_rn(c, a.x), __fmul_rn(c, a.y));
}

__device__ __forceinline__ float2 conjugate(float2 a) {
  return make_float2(a.x, -a.y);
}

// In-place forward r-point DFTs of a[0 .. r-1], the butterflies of the
// mixed-radix stages.
__device__ __forceinline__ void dft(float2 (&a)[2]) {
  const float2 a0 = a[0], a1 = a[1];
  a[0] = cadd(a0, a1);
  a[1] = csub(a0, a1);
}

__device__ __forceinline__ void dft(float2 (&a)[4]) {
  const float2 s02 = cadd(a[0], a[2]), d02 = csub(a[0], a[2]);
  const float2 s13 = cadd(a[1], a[3]), d13 = csub(a[1], a[3]);
  a[0] = cadd(s02, s13);
  a[1] = sub_i(d02, d13);
  a[2] = csub(s02, s13);
  a[3] = add_i(d02, d13);
}

__device__ __forceinline__ void dft(float2 (&a)[3]) {
  constexpr float kS = static_cast<float>(0.86602540378443864676);  // sin(2pi/3)
  const float2 a0 = a[0];
  const float2 s12 = cadd(a[1], a[2]);
  const float2 c = cfma(-0.5f, s12, a0);
  const float2 d = cscale(kS, csub(a[1], a[2]));
  a[0] = cadd(a0, s12);
  a[1] = sub_i(c, d);
  a[2] = add_i(c, d);
}

__device__ __forceinline__ void dft(float2 (&a)[5]) {
  constexpr float kC1 = static_cast<float>(0.30901699437494742410);   // cos(2pi/5)
  constexpr float kC2 = static_cast<float>(-0.80901699437494742410);  // cos(4pi/5)
  constexpr float kS1 = static_cast<float>(0.95105651629515357212);   // sin(2pi/5)
  constexpr float kS2 = static_cast<float>(0.58778525229247312917);   // sin(4pi/5)
  const float2 a0 = a[0];
  const float2 b1 = cadd(a[1], a[4]), d1 = csub(a[1], a[4]);
  const float2 b2 = cadd(a[2], a[3]), d2 = csub(a[2], a[3]);
  const float2 c1 = cfma(kC2, b2, cfma(kC1, b1, a0));
  const float2 c2 = cfma(kC1, b2, cfma(kC2, b1, a0));
  const float2 e1 = cfma(kS2, d2, cscale(kS1, d1));
  const float2 e2 = cfma(-kS1, d2, cscale(kS2, d1));
  a[0] = cadd(cadd(a0, b1), b2);
  a[1] = sub_i(c1, e1);
  a[2] = sub_i(c2, e2);
  a[3] = add_i(c2, e2);
  a[4] = add_i(c1, e1);
}

// A[k] = c_k - i e_k and A[7-k] = c_k + i e_k, k = 1 .. 3, with
// c_k = a0 + sum_j cos(2 pi j k / 7) (a_j + a_{7-j}) and
// e_k = sum_j sin(2 pi j k / 7) (a_j - a_{7-j}), j = 1 .. 3.
__device__ __forceinline__ void dft(float2 (&a)[7]) {
  constexpr float kC1 = static_cast<float>(0.62348980185873353053);   // cos(2pi/7)
  constexpr float kC2 = static_cast<float>(-0.22252093395631440429);  // cos(4pi/7)
  constexpr float kC3 = static_cast<float>(-0.90096886790241912624);  // cos(6pi/7)
  constexpr float kS1 = static_cast<float>(0.78183148246802980871);   // sin(2pi/7)
  constexpr float kS2 = static_cast<float>(0.97492791218182360702);   // sin(4pi/7)
  constexpr float kS3 = static_cast<float>(0.43388373911755812048);   // sin(6pi/7)
  const float2 a0 = a[0];
  const float2 b1 = cadd(a[1], a[6]), d1 = csub(a[1], a[6]);
  const float2 b2 = cadd(a[2], a[5]), d2 = csub(a[2], a[5]);
  const float2 b3 = cadd(a[3], a[4]), d3 = csub(a[3], a[4]);
  const float2 c1 = cfma(kC3, b3, cfma(kC2, b2, cfma(kC1, b1, a0)));
  const float2 c2 = cfma(kC1, b3, cfma(kC3, b2, cfma(kC2, b1, a0)));
  const float2 c3 = cfma(kC2, b3, cfma(kC1, b2, cfma(kC3, b1, a0)));
  const float2 e1 = cfma(kS3, d3, cfma(kS2, d2, cscale(kS1, d1)));
  const float2 e2 = cfma(-kS1, d3, cfma(-kS3, d2, cscale(kS2, d1)));
  const float2 e3 = cfma(kS2, d3, cfma(-kS1, d2, cscale(kS3, d1)));
  a[0] = cadd(cadd(cadd(a0, b1), b2), b3);
  a[1] = sub_i(c1, e1);
  a[2] = sub_i(c2, e2);
  a[3] = sub_i(c3, e3);
  a[4] = add_i(c3, e3);
  a[5] = add_i(c2, e2);
  a[6] = add_i(c1, e1);
}

// One radix-R butterfly over x[0], x[l], ..., x[(R-1) l] with twiddles
// tw[q t]: decimation in time multiplies the inputs q >= 1 before the DFT,
// decimation in frequency (the transposed flow graph) the outputs after it.
template <int R, bool kDif>
__device__ __forceinline__ void butterfly(float2* x, int l, int t,
                                          const float2* __restrict__ tw) {
  float2 a[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    a[q] = kDif || q == 0 ? x[q * l] : cmul(x[q * l], tw[q * t]);
  }
  dft(a);
#pragma unroll
  for (int q = 0; q < R; ++q) {
    x[q * l] = !kDif || q == 0 ? a[q] : cmul(a[q], tw[q * t]);
  }
}

// `butterfly` on registers: a[q] <- the same products with tw[q t] before
// (decimation in time) or after (in frequency) the DFT, so a butterfly run
// here gives the bits of one run over shared memory.
template <int R, bool kDif>
__device__ __forceinline__ void twiddled_dft(float2 (&a)[R], const float2* __restrict__ tw,
                                             int t) {
  if constexpr (!kDif) {
#pragma unroll
    for (int q = 1; q < R; ++q) a[q] = cmul(a[q], tw[q * t]);
  }
  dft(a);
  if constexpr (kDif) {
#pragma unroll
    for (int q = 1; q < R; ++q) a[q] = cmul(a[q], tw[q * t]);
  }
}

// Stages per register pass of the radix-2 body (a radix-16 group), and the
// launch bounds of a packed row whose buffer leaves room for kRowBlocks
// blocks per SM: kRowThreads threads, registers for kRowBlocks blocks
// (`with_row_bounds`).
constexpr int kRadix2Pass = 4;
constexpr int kRowThreads = 128;
constexpr int kRowBlocks = 5;

// The b-bit reversal of x < 2^b (0 for b = 0).
__device__ __forceinline__ int reverse_bits(int x, int b) {
  return b == 0 ? 0 : static_cast<int>(__brev(static_cast<unsigned>(x)) >> (32 - b));
}

// N = 2^L: bit-reversed input, L radix-2 DIT stages, natural-order output.
// Stage S merges transforms of size 2^S into 2^(S+1): butterfly (i0, i0 +
// 2^S), i0 with bit S clear, computes t = x[i1] * tw[pos * N / 2^(S+1)],
// pos = i0 mod 2^S, then x[i0] + t and x[i0] - t, each with _rn.
//
// The stages run kRadix2Pass at a time in registers (`pass`): stages s ..
// s+Q-1 close over groups of 2^Q entries, those that share their bits below
// s (lo) and above s+Q-1 (hi), so one thread loads a group from shared
// memory, runs its Q stages and stores it back: ceil(L / 4) round trips
// through shared memory (3 at N = 4096) in place of L, the last pass shorter
// where 4 does not divide L.  Each butterfly is the one above, on the same
// table entry, so the bits are those of one stage per pass.  The packed rows
// fuse their load into the first pass (`load_transform`): a thread reads its
// group's 16 samples straight from the window into registers.
//
// Entry i lives at buf[at(i)]: its low 4 bits XORed with its top 4 (from N =
// 256), so that in every pass, in the first pass's stores and in the
// unpack's reads of X[k] and X[N-k], a half-warp's 16 accesses fall in 16
// banks.  Group u of a pass takes hi = reverse(u mod 2^hb) (hb bits of hi)
// and lo = u >> hb: where hi has 4 bits or more a half-warp shares lo (one
// twiddle address, a broadcast) and spans the top bits (the XOR); where it
// has fewer, lo runs over consecutive values.  In the first pass hi is the
// group and u the first sample it reads, so a warp reads consecutive
// samples.
struct Radix2 {
  int log2n;

  __device__ __forceinline__ int size() const { return 1 << log2n; }
  __host__ __device__ __forceinline__ int buf_size() const { return 1 << log2n; }
  // f32 pairs of the body's table: its N twiddles
  __host__ __device__ __forceinline__ int table_size() const { return 1 << log2n; }

  // where entry i of the transform is kept in `buf`
  __device__ __forceinline__ int at(int i) const {
    return log2n >= 8 ? i ^ ((i >> (log2n - 4)) & 15) : i;
  }

  // bit reversal: where sample i sits before the first DIT stage
  __device__ __forceinline__ int slot(int i) const { return at(reverse_bits(i, log2n)); }

  // The load's value for sample i (z, zero past the window): z itself.
  __device__ __forceinline__ float2 input(int, float2 z) const { return z; }
  // X[k] of the transformed buffer
  __device__ __forceinline__ float2 result(const float2* buf, int k) const {
    return buf[at(k)];
  }
  // After a load into buf[slot(i)]: every stage.  (kCap, the mixed-radix
  // bodies' bound on a pass, leaves the radix-2 passes as they are.)
  template <int kCap>
  __device__ __forceinline__ void transform(float2* buf, const float2* tw) const {
    passes_from(0, buf, tw);
  }

  // The transform of the window z(i), i < w (zero from w to size()), read
  // straight into the first pass's registers.
  template <int kCap, class Z>
  __device__ __forceinline__ void load_transform(float2* buf, const float2* tw,
                                                 int w, const Z& z) const {
    switch (log2n < kRadix2Pass ? log2n : kRadix2Pass) {
      case 1: first_pass<1>(buf, tw, w, z); break;
      case 2: first_pass<2>(buf, tw, w, z); break;
      case 3: first_pass<3>(buf, tw, w, z); break;
      default: first_pass<kRadix2Pass>(buf, tw, w, z); break;
    }
    passes_from(kRadix2Pass, buf, tw);
  }

  // The passes over stages s .. L-1.
  __device__ __forceinline__ void passes_from(int s, float2* buf,
                                              const float2* tw) const {
    for (; s + kRadix2Pass <= log2n; s += kRadix2Pass) pass<kRadix2Pass>(buf, tw, s);
    switch (log2n - s) {
      case 1: pass<1>(buf, tw, s); break;
      case 2: pass<2>(buf, tw, s); break;
      case 3: pass<3>(buf, tw, s); break;
      default: break;
    }
  }

  // Stages s .. s+Q-1 over every group (see above).
  template <int Q>
  __device__ __forceinline__ void pass(float2* buf, const float2* tw, int s) const {
    const int hb = log2n - s - Q;
    for (int u = threadIdx.x; u < (1 << (log2n - Q)); u += blockDim.x) {
      const int lo = u >> hb;
      const int base = (reverse_bits(u & ((1 << hb) - 1), hb) << (s + Q)) | lo;
      float2 x[1 << Q];
#pragma unroll
      for (int d = 0; d < (1 << Q); ++d) x[d] = buf[at(base + (d << s))];
      stages<Q>(x, tw, s, lo);
#pragma unroll
      for (int d = 0; d < (1 << Q); ++d) buf[at(base + (d << s))] = x[d];
    }
    __syncthreads();
  }

  // Stages 0 .. Q-1 with the load: group g = reverse(u) holds slots g 2^Q +
  // d, i.e. samples u + reverse_Q(d) N / 2^Q, those of even d below N/2.
  // Each half's reads issue together (`load_half`); the upper half is read
  // only where the window reaches it (not at W <= N/2).
  template <int Q, class Z>
  __device__ __forceinline__ void first_pass(float2* buf, const float2* tw,
                                             int w, const Z& z) const {
    const int hb = log2n - Q;
    for (int u = threadIdx.x; u < (1 << hb); u += blockDim.x) {
      float2 x[1 << Q];
      load_half<Q>(x, 0, u, hb, w, z);
      if (u + (1 << (log2n - 1)) < w) {
        load_half<Q>(x, 1, u, hb, w, z);
      } else {
#pragma unroll
        for (int d = 1; d < (1 << Q); d += 2) x[d] = make_float2(0.f, 0.f);
      }
      stages<Q>(x, tw, 0, 0);
      const int base = reverse_bits(u, hb) << Q;
#pragma unroll
      for (int d = 0; d < (1 << Q); ++d) buf[at(base + d)] = x[d];
    }
    __syncthreads();
  }

  // x[d] for d = odd, odd + 2, ...: z of its sample, zero past the window.
  // Every slot reads a sample of the window (one past it reads sample w -
  // 1, its value unused), so the reads carry no branch and issue together,
  // and every register index is a constant once the loop is unrolled.
  template <int Q, class Z>
  __device__ __forceinline__ void load_half(float2 (&x)[1 << Q], int odd, int u,
                                            int hb, int w, const Z& z) const {
#pragma unroll
    for (int d = odd; d < (1 << Q); d += 2) {
      const int i = u + (reverse_bits(d, Q) << hb);
      const float2 v = z(i < w ? i : w - 1);
      x[d] = i < w ? v : make_float2(0.f, 0.f);
    }
  }

  // Stages s .. s+Q-1 of the group whose entries d sit at hi + (d << s) +
  // lo: butterfly (b, b + 2^j) of stage s+j has pos = lo + (t << s), t = b
  // mod 2^j, so the stage reads 2^j table entries.
  template <int Q>
  __device__ __forceinline__ void stages(float2 (&x)[1 << Q],
                                         const float2* __restrict__ tw, int s,
                                         int lo) const {
    const int half = 1 << (log2n - 1);
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const int tstep = half >> (s + j);
#pragma unroll
      for (int t = 0; t < (1 << j); ++t) {
        const float2 w = tw[(lo + (t << s)) * tstep];
#pragma unroll
        for (int b = t; b < (1 << Q); b += 2 << j) {
          const float2 p = cmul(x[b + (1 << j)], w);
          const float2 a = x[b];
          x[b] = cadd(a, p);
          x[b + (1 << j)] = csub(a, p);
        }
      }
    }
  }
};

// A radix as a type: `MixedRadixT::with_radices` hands a pass's radices to
// its templates.
template <int R>
struct Radix {
  static constexpr int value = R;
};

// Adjacent mixed-radix stages whose radices multiply to at most kMixedGroup
// run as one register pass, a thread holding the product's entries (N =
// 4800: (4 4)(4 3)(5 5); N = 4410: (2 3)(3 5)(7)(7)); a 7 after a 4, a 5
// or a 7 runs alone (28 entries and more spilled under the 96 registers of
// kRowBlocks blocks per SM).
constexpr int kMixedGroup = 25;
// The same bound on the packed rows' first pass, whose registers also hold
// the samples in flight, and on every pass of a kernel whose launch bounds
// leave 64 registers a thread (`group_cap`: (2 3) the only pair; at 12
// those kernels spilled and ran N = 4801 9% slower, PERF.md §6).
constexpr int kFirstGroup = 16;
constexpr int kNarrowGroup = 7;
static_assert(kMixedGroup < 28, "MixedRadixT::with_radices lists the pairs up to 27 entries");

// v / r for 0 <= v < 2^30 and a radix r of a mixed-radix plan (2, 3, 4, 5,
// 7): the high word of v (floor(2^32 / r) + 1), exact over that range.
__host__ __device__ __forceinline__ int div_radix(int v, int r) {
  const unsigned m = r == 2   ? 2147483649u
                     : r == 3 ? 1431655766u
                     : r == 4 ? 1073741825u
                     : r == 5 ? 858993460u
                              : 613566757u;
#ifdef __CUDA_ARCH__
  return static_cast<int>(__umulhi(static_cast<unsigned>(v), m));
#else
  return static_cast<int>((static_cast<unsigned long long>(v) * m) >> 32);
#endif
}

// kTop, the largest radix of the plan's passes: 7 takes every 7-smooth
// plan, 5 only plans with no 7 (`with_mixed_radix` gives those the 5 body,
// so their kernels keep the code and registers they had before radix 7
// joined the plan).
//
// The DIT stages (`butterfly_at`, the one-stage-per-pass form the large-N
// route runs over device memory) run one or two at a time in registers
// (`pass`): stages s and s+1 with L = L_s close over groups of P = r_s
// r_{s+1} entries b M + p + d L (d < P, M = L P), one per p < L and block
// b, so a thread loads a group, runs both stages and stores it back.  Stage
// s's butterflies are d = q + r_s e (e < r_{s+1}) at twiddle step p (N /
// (L r_s)), stage s+1's d = e + r_s q (e < r_s) at (p + e L) (N / M): the
// table entries and the arithmetic of one pass per stage, so the same bits.
// The packed rows fuse their load into the first pass (`load_transform`):
// the group at slots g P + d holds samples u + e N / P, e the digit
// reversal of d, g that of u, so consecutive threads read consecutive
// samples.  Decimation in frequency (Bluestein's first half) runs the same
// groups from the top stage down, each butterfly's twiddles after its DFT.
// kCap, the most entries a pass holds, follows from the kernel's launch
// bounds (`group_cap`).
//
// Entry i lives at buf[at(i)]: where 16 divides N, its low 4 bits XORed
// with bits 6..9, which spreads the first pass's stores (16 entries a group
// at N = 4800, group starts 960 apart across a warp) over the banks and
// leaves every pass that touches 16 aligned consecutive entries conflict
// free (without it kernel A ran 35% slower at N = 4800, PERF.md §6);
// elsewhere i itself (no stride L_s is then a multiple of 16).
template <int kTop>
struct MixedRadixT {
  int n;
  int stages;
  int radix[kMaxStages];

  __host__ __device__ __forceinline__ bool has_seven() const {
    for (int s = 0; s < stages; ++s) {
      if (radix[s] == 7) return true;
    }
    return false;
  }

  // the same plan with the kOther switch
  template <int kOther>
  __host__ __device__ __forceinline__ MixedRadixT<kOther> as() const {
    MixedRadixT<kOther> other;
    other.n = n;
    other.stages = stages;
    for (int s = 0; s < kMaxStages; ++s) other.radix[s] = radix[s];
    return other;
  }

  __device__ __forceinline__ int size() const { return n; }
  __host__ __device__ __forceinline__ int buf_size() const { return n; }
  __host__ __device__ __forceinline__ int table_size() const { return n; }

  __device__ __forceinline__ float2 input(int, float2 z) const { return z; }
  __device__ __forceinline__ float2 result(const float2* buf, int k) const {
    return buf[at(k)];
  }

  // where entry i of the transform is kept in `buf` (see above)
  __device__ __forceinline__ int at(int i) const {
    return i ^ ((i >> 6) & ((n & 15) == 0 ? 15 : 0));
  }

  // The plan's radices, 3 bits a stage from stage 0 up: read from registers,
  // where radix[s] at a run-time s would copy the plan to the stack.
  __device__ __forceinline__ unsigned long long radix_bits() const {
    unsigned long long bits = 0;
#pragma unroll
    for (int s = 0; s < kMaxStages; ++s) {
      bits |= static_cast<unsigned long long>(radix[s] & 7) << (3 * s);
    }
    return bits;
  }

  // Digit reversal over stages s0 ..: stage s turns r_s sub-transforms of
  // length L_s = r_0 ... r_{s-1}, stored one after another, into one of
  // length L_s r_s; so i goes to sum_s d_s L_s, where d_{m-1}, ..., d_{s0}
  // are the digits of i in radices r_{m-1}, ..., r_{s0}, least significant
  // first.
  __device__ __forceinline__ int reverse(int i, int s0, unsigned long long bits) const {
    int pos = 0;
    int span = n;
    for (int s = stages - 1; s >= s0; --s) {
      const int r = static_cast<int>(bits >> (3 * s)) & 7;
      span = div_radix(span, r);
      const int q = div_radix(i, r);
      pos += (i - q * r) * span;
      i = q;
    }
    return pos;
  }

  // where sample i sits before the first DIT stage
  __device__ __forceinline__ int slot(int i) const { return at(reverse(i, 0, radix_bits())); }

  // The inverse of the digit reversal: the sample whose slot is pos.  pos =
  // sum_s d_s L_s in the stages' radices (r_0 least significant), and the
  // sample's digits are the d_s with r_{m-1} least significant.
  __device__ __forceinline__ int unslot(int pos) const {
    int i = 0;
    for (int s = 0; s < stages; ++s) {
      const int r = radix[s];
      i = i * r + pos % r;
      pos /= r;
    }
    return i;
  }

  // the stages of the DIT pass that starts at stage s: 2 where r_s r_{s+1}
  // <= kCap, else 1
  template <int kCap>
  __host__ __device__ __forceinline__ static int pass_stages(unsigned long long bits, int s,
                                                             int stages) {
    const int r = static_cast<int>(bits >> (3 * s)) & 7;
    return s + 1 < stages && r * (static_cast<int>(bits >> (3 * s + 3)) & 7) <= kCap ? 2 : 1;
  }

  // The most groups a pass of the DIT or the DIF order runs under the pass
  // bound `cap`: the block's threads (`body_threads`).
  __host__ __forceinline__ int max_groups(int cap) const {
    const int fcap = cap < kFirstGroup ? cap : kFirstGroup;
    const int first = stages > 1 && radix[0] * radix[1] <= fcap ? radix[0] * radix[1] : radix[0];
    int most = n / first;
    for (int s = 0; s < stages;) {
      const int pair = s + 1 < stages && radix[s] * radix[s + 1] <= cap;
      const int p = pair ? radix[s] * radix[s + 1] : radix[s];
      most = n / p > most ? n / p : most;
      s += 1 + pair;
    }
    for (int s = stages - 1; s >= 0;) {
      const int pair = s >= 1 && radix[s - 1] * radix[s] <= cap;
      const int p = pair ? radix[s - 1] * radix[s] : radix[s];
      most = n / p > most ? n / p : most;
      s -= 1 + pair;
    }
    return most;
  }

  // fn(Radix<A>, Radix<B>) where (r1, r2) = (A, B) and the pair has at most
  // kCap entries; whether it ran.
  template <int A, int B, int kCap, class Fn>
  __device__ __forceinline__ static bool radix_case(int r1, int r2, Fn& fn) {
    if constexpr (A * B <= kCap && (kTop == 7 || (A != 7 && B != 7))) {
      if (r1 == A && r2 == B) {
        fn(Radix<A>{}, Radix<B>{});
        return true;
      }
    }
    return false;
  }

  // fn(Radix<r1>, Radix<r2>) for a pass's radices (r2 = 1: one stage): the
  // pairs of at most kCap entries that a plan in make_mixed_radix's order
  // (4s, one 2, 3s, 5s, 7s) groups.
  template <int kCap, class Fn>
  __device__ __forceinline__ static void with_radices(int r1, int r2, Fn fn) {
    radix_case<4, 4, kCap>(r1, r2, fn) || radix_case<4, 2, kCap>(r1, r2, fn) ||
        radix_case<4, 3, kCap>(r1, r2, fn) || radix_case<4, 5, kCap>(r1, r2, fn) ||
        radix_case<2, 3, kCap>(r1, r2, fn) || radix_case<2, 5, kCap>(r1, r2, fn) ||
        radix_case<2, 7, kCap>(r1, r2, fn) || radix_case<3, 3, kCap>(r1, r2, fn) ||
        radix_case<3, 5, kCap>(r1, r2, fn) || radix_case<3, 7, kCap>(r1, r2, fn) ||
        radix_case<5, 5, kCap>(r1, r2, fn) || radix_case<4, 1, kCap>(r1, r2, fn) ||
        radix_case<2, 1, kCap>(r1, r2, fn) ||
        radix_case<3, 1, kCap>(r1, r2, fn) || radix_case<5, 1, kCap>(r1, r2, fn) ||
        radix_case<7, 1, kCap>(r1, r2, fn);
  }

  // Decimation in time: digit-reversed input (`slot`), natural-order output;
  // pairs of at most kCap entries.
  template <int kCap>
  __device__ __forceinline__ void transform(float2* buf, const float2* tw) const {
    dit_passes<kCap>(0, 1, radix_bits(), buf, tw);
  }

  // Decimation in frequency, the transposed flow graph of `transform`: the
  // stages from the top down, each an r-point DFT followed by the twiddles,
  // pairs grouped from the top.  Natural-order input; X[k] lands in
  // buf[slot(k)].  With a `filter` (Bluestein's), the pass of stage 0 stores
  // conj(X[k] filter[k]) there instead, k the logical slot.
  template <int kCap>
  __device__ __forceinline__ void transform_dif(float2* buf, const float2* tw,
                                                const float2* filter = nullptr) const {
    const unsigned long long bits = radix_bits();
    int len = n;
    for (int s = stages - 1; s >= 0;) {
      const int r = static_cast<int>(bits >> (3 * s)) & 7;
      const int below = s >= 1 ? static_cast<int>(bits >> (3 * s - 3)) & 7 : 0;
      const int pair = below != 0 && below * r <= kCap;
      len = div_radix(len, r);
      if (pair) len = div_radix(len, below);
      const bool filtered = s == pair && filter != nullptr;
      with_radices<kCap>(pair ? below : r, pair ? r : 1, [&](auto a, auto b) {
        constexpr int A = decltype(a)::value, B = decltype(b)::value;
        if (filtered) {
          this->template pass<A, B, true, true>(buf, tw, len, filter);
        } else {
          this->template pass<A, B, true, false>(buf, tw, len);
        }
      });
      s -= 1 + pair;
    }
  }

  // The transform of the window z(i), i < w (zero from w to n): the first
  // DIT pass reads its samples straight into registers, then the others.
  template <int kCap, class Z>
  __device__ __forceinline__ void load_transform(float2* buf, const float2* tw, int w,
                                                 const Z& z) const {
    constexpr int kFirst = kCap < kFirstGroup ? kCap : kFirstGroup;
    const unsigned long long bits = radix_bits();
    const int q = pass_stages<kFirst>(bits, 0, stages);
    const int r1 = static_cast<int>(bits) & 7;
    const int r2 = q == 2 ? static_cast<int>(bits >> 3) & 7 : 1;
    with_radices<kFirst>(r1, r2, [&](auto a, auto b) {
      this->template first_pass<decltype(a)::value, decltype(b)::value>(buf, tw, w, z, bits);
    });
    dit_passes<kCap>(q, r1 * r2, bits, buf, tw);
  }

  // The DIT passes from stage s, whose sub-transforms have length len.
  template <int kCap>
  __device__ __forceinline__ void dit_passes(int s, int len, unsigned long long bits,
                                             float2* buf, const float2* tw) const {
    while (s < stages) {
      const int q = pass_stages<kCap>(bits, s, stages);
      const int r1 = static_cast<int>(bits >> (3 * s)) & 7;
      const int r2 = q == 2 ? static_cast<int>(bits >> (3 * s + 3)) & 7 : 1;
      with_radices<kCap>(r1, r2, [&](auto a, auto b) {
        this->template pass<decltype(a)::value, decltype(b)::value, false>(buf, tw, len);
      });
      len *= r1 * r2;
      s += q;
    }
  }

  // Stages s (radix R1) and s+1 (R2; none for R2 = 1) over every group,
  // len = L_s (see above); with a `filter`, `transform_dif`'s product.  Each
  // butterfly of the pass's second stage (s+1 in time, s in frequency)
  // stores its entries as it completes, which holds the registers of (5 5)
  // under kRowBlocks' bounds.
  template <int R1, int R2, bool kDif, bool kFilter = false>
  __device__ __forceinline__ void pass(float2* buf, const float2* tw, int len,
                                       const float2* __restrict__ filter = nullptr) const {
    if constexpr (R2 == 1) {
      single_pass<R1, kDif, kFilter>(buf, tw, len, filter);
    } else {
      constexpr int kP = R1 * R2;
      const int m = len * kP;
      const int step2 = n / m;
      for (int u = threadIdx.x; u < n / kP; u += blockDim.x) {
        const int b = u / len;
        const int p = u - b * len;
        const int base = b * m + p;
        float2 x[kP];
#pragma unroll
        for (int d = 0; d < kP; ++d) x[d] = buf[at(base + d * len)];
        if constexpr (kDif) {
          upper_stage<R1, R2, true>(x, tw, p, len, step2);
#pragma unroll
          for (int e = 0; e < R2; ++e) {
            float2 a[R1];
#pragma unroll
            for (int q = 0; q < R1; ++q) a[q] = x[q + R1 * e];
            twiddled_dft<R1, true>(a, tw, p * step2 * R2);
#pragma unroll
            for (int q = 0; q < R1; ++q) {
              const int i = base + (q + R1 * e) * len;
              buf[at(i)] = kFilter ? conjugate(cmul(a[q], filter[i])) : a[q];
            }
          }
        } else {
          lower_stage<R1, R2, false>(x, tw, p * step2 * R2);
#pragma unroll
          for (int e = 0; e < R1; ++e) {
            float2 a[R2];
#pragma unroll
            for (int q = 0; q < R2; ++q) a[q] = x[e + R1 * q];
            twiddled_dft<R2, false>(a, tw, (p + e * len) * step2);
#pragma unroll
            for (int q = 0; q < R2; ++q) buf[at(base + (e + R1 * q) * len)] = a[q];
          }
        }
      }
    }
    __syncthreads();
  }

  // One stage of radix R over every group (the butterflies of
  // `butterfly_at`, with `transform_dif`'s filter product where given).
  template <int R, bool kDif, bool kFilter>
  __device__ __forceinline__ void single_pass(float2* buf, const float2* tw, int len,
                                              const float2* __restrict__ filter) const {
    const int step = n / (len * R);
    for (int u = threadIdx.x; u < n / R; u += blockDim.x) {
      const int b = u / len;
      const int p = u - b * len;
      const int base = b * len * R + p;
      float2 x[R];
#pragma unroll
      for (int q = 0; q < R; ++q) x[q] = buf[at(base + q * len)];
      twiddled_dft<R, kDif>(x, tw, p * step);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int i = base + q * len;
        buf[at(i)] = kFilter ? conjugate(cmul(x[q], filter[i])) : x[q];
      }
    }
  }

  // Stages 0 and 1 with the load: the group of u holds slots reverse(u) + d,
  // samples u + e g (g = n / P groups, e = d's digit reversal: d = d0 + R1
  // d1, e = d0 R2 + d1).  Where R1 is even, the samples of d0 >= R1 / 2 lie
  // at u + n/2 and past, and are read only where the window reaches them.
  template <int R1, int R2, class Z>
  __device__ __forceinline__ void first_pass(float2* buf, const float2* tw, int w,
                                             const Z& z, unsigned long long bits) const {
    constexpr int kP = R1 * R2;
    const int g = n / kP;
    const int s0 = R2 > 1 ? 2 : 1;
    for (int u = threadIdx.x; u < g; u += blockDim.x) {
      float2 x[kP];
      if constexpr (R1 % 2 == 0) {
        load_part<R1, R2, 0, R1 / 2>(x, u, g, w, z);
        if (u + n / 2 < w) {
          load_part<R1, R2, R1 / 2, R1>(x, u, g, w, z);
        } else {
#pragma unroll
          for (int d = 0; d < kP; ++d) {
            if (d % R1 >= R1 / 2) x[d] = make_float2(0.f, 0.f);
          }
        }
      } else {
        load_part<R1, R2, 0, R1>(x, u, g, w, z);
      }
      lower_stage<R1, R2, false>(x, tw, 0);
      if constexpr (R2 > 1) upper_stage<R1, R2, false>(x, tw, 0, 1, g);
      const int base = reverse(u, s0, bits);
#pragma unroll
      for (int d = 0; d < kP; ++d) buf[at(base + d)] = x[d];
    }
    __syncthreads();
  }

  // x[d] for d0 = d mod R1 in [kLo, kHi): z of its sample, zero past the
  // window.  Every slot reads a sample of the window (one past it reads
  // sample w - 1, its value unused), so the reads carry no branch and issue
  // together, and every register index is a constant once unrolled.
  template <int R1, int R2, int kLo, int kHi, class Z>
  __device__ __forceinline__ void load_part(float2 (&x)[R1 * R2], int u, int g, int w,
                                            const Z& z) const {
#pragma unroll
    for (int d = 0; d < R1 * R2; ++d) {
      if (d % R1 < kLo || d % R1 >= kHi) continue;
      const int i = u + ((d % R1) * R2 + d / R1) * g;
      const float2 v = z(i < w ? i : w - 1);
      x[d] = i < w ? v : make_float2(0.f, 0.f);
    }
  }

  // The butterflies of stage s on a group (see above): d = q + R1 e at
  // twiddle step t (p N / (len R1)).
  template <int R1, int R2, bool kDif>
  __device__ __forceinline__ static void lower_stage(float2 (&x)[R1 * R2],
                                                     const float2* __restrict__ tw, int t) {
#pragma unroll
    for (int e = 0; e < R2; ++e) {
      float2 a[R1];
#pragma unroll
      for (int q = 0; q < R1; ++q) a[q] = x[q + R1 * e];
      twiddled_dft<R1, kDif>(a, tw, t);
#pragma unroll
      for (int q = 0; q < R1; ++q) x[q + R1 * e] = a[q];
    }
  }

  // ... and of stage s+1: d = e + R1 q at twiddle step (p + e len) N / M.
  template <int R1, int R2, bool kDif>
  __device__ __forceinline__ static void upper_stage(float2 (&x)[R1 * R2],
                                                     const float2* __restrict__ tw, int p,
                                                     int len, int step2) {
#pragma unroll
    for (int e = 0; e < R1; ++e) {
      float2 a[R2];
#pragma unroll
      for (int q = 0; q < R2; ++q) a[q] = x[e + R1 * q];
      twiddled_dft<R2, kDif>(a, tw, (p + e * len) * step2);
#pragma unroll
      for (int q = 0; q < R2; ++q) x[e + R1 * q] = a[q];
    }
  }

  // Butterfly j (of n / r_s) of stage s over a natural-order `buf` (no
  // `at`), for sub-transforms of length `len`: one stage of one pass, which
  // the large-N route (stft_large.cuh) runs over device memory.
  template <bool kDif>
  __device__ __forceinline__ void butterfly_at(float2* buf, const float2* tw,
                                               int s, int len, int j) const {
    const int r = radix[s];
    const int m = len * r;
    const int p = j % len;
    float2* x = buf + (j / len) * m + p;
    const int t = p * (n / m);
    switch (r) {
      case 4: butterfly<4, kDif>(x, len, t, tw); break;
      case 2: butterfly<2, kDif>(x, len, t, tw); break;
      case 3: butterfly<3, kDif>(x, len, t, tw); break;
      default:
        if constexpr (kTop == 7) {
          if (r == 7) {
            butterfly<7, kDif>(x, len, t, tw);
            break;
          }
        }
        butterfly<5, kDif>(x, len, t, tw);
        break;
    }
  }
};

using MixedRadix = MixedRadixT<7>;

template <class Body>
struct fuses_load : std::false_type {};
template <>
struct fuses_load<Radix2> : std::true_type {};
template <int kTop>
struct fuses_load<MixedRadixT<kTop>> : std::true_type {};

// The row's transform of the window z(i), i < w (zero past it): the radix-2
// and mixed-radix bodies' fused first pass, or for Bluestein a load of
// input(i, z(i)) into buf[slot(i)] over the whole buffer, then `transform`.
template <int kCap, class Body, class Z>
__device__ __forceinline__ void load_transform(const Body& body, float2* buf,
                                               const float2* tw, int w, const Z& z) {
  if constexpr (fuses_load<Body>::value) {
    body.template load_transform<kCap>(buf, tw, w, z);
  } else {
    // coalesced global reads, natural-order shared-memory writes
    for (int i = threadIdx.x; i < body.buf_size(); i += blockDim.x) {
      buf[body.slot(i)] = body.input(i, i < w ? z(i) : make_float2(0.f, 0.f));
    }
    __syncthreads();
    body.template transform<kCap>(buf, tw);
  }
}

// The mixed-radix plan of n on the host; false if n has a prime factor
// above 7 or needs more than kMaxStages stages.  Radix 7 comes last, so a
// 5-smooth n keeps the plan (and the bits) it had before radix 7.
static inline bool make_mixed_radix(int n, MixedRadix* plan) {
  plan->n = n;
  plan->stages = 0;
  int rest = n;
  const int radices[] = {4, 2, 3, 5, 7};  // once the 4s are out, one 2 at most
  for (int r : radices) {
    while (rest % r == 0) {
      if (plan->stages == kMaxStages) return false;
      plan->radix[plan->stages++] = r;
      rest /= r;
    }
  }
  return rest == 1 && n > 1;
}

// Bluestein's convolution length for N: of the 7-smooth M from 2N - 1 up to
// the least 5-smooth one, the M whose plan has the fewest stages, then one
// without a radix 7, then the least (N = 97: 196 = 4 7 7; N = 2204: 4500,
// not 4410, whose six stages include a 2 and two 7s).  A stage is a pass
// over the buffer, and a 7 in the plan costs the kernel registers
// (MixedRadixT<7>).
static inline int bluestein_length(int n) {
  int best = -1, best_key = 0;
  for (int m = 2 * n - 1 > 2 ? 2 * n - 1 : 2;; ++m) {
    MixedRadix plan;
    if (!make_mixed_radix(m, &plan)) continue;
    const int key = 2 * plan.stages + (plan.has_seven() ? 1 : 0);
    if (best < 0 || key < best_key) {
      best = m;
      best_key = key;
    }
    if (!plan.has_seven()) return best;
  }
}

// DFT_N for any N, as a cyclic convolution of length M (`bluestein_length`,
// the MixedRadix body `inner`), with c[t] = exp(-i pi t^2 / N):
//   X[k] = c[k] * sum_t (x[t] c[t]) conj(c[k - t]),  k < N
//   a = x c zero-padded to M;  A = DFT_M(a)           (DIF: A[k] at slot(k))
//   D = conj(A F),  F = DFT_M(b) / M,  b[t] = b[M - t] = conj(c[t]), t < N
//   conv = conj(DFT_M(D))                             (DIT: natural order)
//   X[k] = c[k] conj(DFT_M(D)[k])
// `filter` holds F in the DIF output order (F[k] at slot(k)), so the product
// is pointwise and no pass permutes the buffer.  The row loads x in natural
// order (`slot` is the identity) into buf[0 .. M) through `input`, which
// multiplies by the chirp and zero-pads, the DIF pass's last stage stores
// conj(A F), and the unpack reads X[k] through `result`, which applies the
// output chirp: the three pointwise steps ride the load, a stage and the
// unpack.
template <class Inner>
struct BluesteinT {
  int n;
  Inner inner;           // MixedRadixT of M
  const float2* chirp;   // [N] c
  const float2* filter;  // [M] F, digit-reversed

  __device__ __forceinline__ int size() const { return n; }
  __host__ __device__ __forceinline__ int buf_size() const { return inner.n; }
  // M twiddles, N chirp entries, M filter entries
  __host__ __device__ __forceinline__ int table_size() const {
    return 2 * inner.n + n;
  }
  __device__ __forceinline__ int slot(int i) const { return inner.at(i); }

  // a[i] = z c[i] for i < N, zero from N to M
  __device__ __forceinline__ float2 input(int i, float2 z) const {
    return i < n ? cmul(z, chirp[i]) : make_float2(0.f, 0.f);
  }
  __device__ __forceinline__ float2 result(const float2* buf, int k) const {
    return cmul(chirp[k], conjugate(buf[inner.at(k)]));
  }
  // tw: the M twiddles exp(-2 pi i t / M) of the inner transforms.  The DIF
  // pass of stage 0 (radix r_0 over r_0 adjacent entries, twiddle tw[0])
  // stores conj(A F) directly, so the filter product has no pass of its own.
  template <int kCap>
  __device__ __forceinline__ void transform(float2* buf, const float2* tw) const {
    inner.template transform_dif<kCap>(buf, tw, filter);
    inner.template transform<kCap>(buf, tw);
  }
};

// fn(plan) with the plan's 5 switch where it has no radix 7, else as it is.
template <class Fn>
static inline int with_mixed_radix(const MixedRadix& plan, Fn fn) {
  return plan.has_seven() ? fn(plan) : fn(plan.template as<5>());
}

// fn(body) with the FFT body of size n over its table `consts` (see the top
// of this file): Radix2 for n = 2^a, MixedRadix for other 2^a 3^b 5^c 7^d,
// Bluestein otherwise; fn's result, or cudaErrorInvalidValue where n < 2 or
// the body's buffer exceeds a block's shared memory.
template <class Fn>
static inline int with_fft_body(int n, const void* consts, Fn fn) {
  const auto* table = static_cast<const float2*>(consts);
  if (n < 2) return static_cast<int>(cudaErrorInvalidValue);
  if ((n & (n - 1)) == 0) {
    int log2n = 0;
    while ((1 << log2n) < n) ++log2n;
    if (n * static_cast<int>(sizeof(float2)) > kMaxSmemBytes) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return fn(Radix2{log2n});
  }
  MixedRadix direct;
  if (make_mixed_radix(n, &direct)) {
    if (n * static_cast<int>(sizeof(float2)) > kMaxSmemBytes) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return with_mixed_radix(direct, fn);
  }
  const int m = bluestein_length(n);
  MixedRadix inner;
  if (m * static_cast<int>(sizeof(float2)) > kMaxSmemBytes ||
      !make_mixed_radix(m, &inner)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return with_mixed_radix(inner, [&](auto plan) {
    return fn(BluesteinT<decltype(plan)>{n, plan, table + m, table + m + n});
  });
}

// The conjugate-symmetric stereo unpack of one bin (fft.rs:81-92): zk =
// Z[k] and zm = Z[(N-k) mod N] -> the left and right magnitudes.
__device__ __forceinline__ void unpack_stereo(float2 zk, float2 zm,
                                              float* left, float* right) {
  const float lr = __fadd_rn(zk.x, zm.x), li = __fsub_rn(zk.y, zm.y);
  const float rr = __fsub_rn(zk.x, zm.x), ri = __fadd_rn(zk.y, zm.y);
  *left = sqrtf(__fmaf_rn(lr, lr, __fmul_rn(li, li)));
  *right = sqrtf(__fmaf_rn(rr, rr, __fmul_rn(ri, ri)));
}

// |z|, the split-real rows' magnitude.
__device__ __forceinline__ float magnitude(float2 z) {
  return sqrtf(__fmaf_rn(z.x, z.x, __fmul_rn(z.y, z.y)));
}

// |X[k]|, 0 <= k <= h, of a real row x of N = 2h samples from the h-point
// transform Z of its pack z[t] = x[2t] + i x[2t+1], given zk = Z[k mod h]
// and zm = Z[(h - k) mod h] (`post` holds the h twiddles
// exp(-2 pi i k / N)):
//   X[k] = ((Z[k] + conj Z[h-k]) - i e^{-2 pi i k / N} (Z[k] - conj Z[h-k])) / 2
// with Z[h] = Z[0]; the twiddle of k = h is -1.  The 1/2 is an exact scale
// of the magnitude.
__device__ __forceinline__ float real_pack_bin(float2 zk, float2 zm,
                                               const float2* __restrict__ post,
                                               int h, int k) {
  const float2 e = make_float2(__fadd_rn(zk.x, zm.x), __fsub_rn(zk.y, zm.y));
  const float2 o = make_float2(__fsub_rn(zk.x, zm.x), __fadd_rn(zk.y, zm.y));
  const float2 t = k == h ? make_float2(-o.x, -o.y) : cmul(post[k], o);
  return __fmul_rn(0.5f, magnitude(sub_i(e, t)));
}

// |X[k]|, k < N = 2h, with `z(t)` giving Z[t]: a bin past h is the mirror
// of bin N - k (|X[k]| = |X[N-k]| for real x).
template <class Z>
__device__ __forceinline__ float real_pack_magnitude(const Z& z,
                                                     const float2* __restrict__ post,
                                                     int h, int k) {
  if (k > h) k = 2 * h - k;
  const bool edge = k == 0 || k == h;
  return real_pack_bin(z(edge ? 0 : k), z(edge ? 0 : h - k), post, h, k);
}

// One window row: load l, r through hann into `buf` in the body's input
// order, transform, unpack both channels' magnitudes into ol, orr
// [stft_bins(N, W)].  The caller's block has blockDim.x threads and
// body.buf_size() complex f32 of `buf`.  Every body reads its twiddles from
// the table: staged in shared memory they ran the mixed-radix register
// passes 1.8x slower (fewer blocks per SM), as they did the radix-2 ones
// (PERF.md §6).
//
// Samples are f32, or int16 PCM words (T = short, the i16_planes wire mode:
// half the bytes read).  A word converts to f32 exactly, and its 1/32768
// wire scale arrives folded into `hann` (an exact exponent shift, as the TPU
// kernels did), so the one rounding of x * (hann * 2^-15) gives the bits of
// (x / 32768) * hann: the int16 row equals the f32 row of x / 32768 exactly.
template <int kCap = kMixedGroup, class Body, class T>
__device__ __forceinline__ void stft_packed_row(
    const Body& body, const T* __restrict__ l, const T* __restrict__ r,
    const float* __restrict__ hann, const float2* __restrict__ tw, int w,
    float* __restrict__ ol, float* __restrict__ orr, float2* buf) {
  const int n = body.size();
  load_transform<kCap>(body, buf, tw, w, [&](int i) {
    const float h = hann[i];
    return make_float2(__fmul_rn(static_cast<float>(l[i]), h),
                       __fmul_rn(static_cast<float>(r[i]), h));
  });
  // conjugate-symmetric stereo unpack (fft.rs:81-92), coalesced stores
  const int bins = stft_bins(n, w);
  for (int k = threadIdx.x; k < bins; k += blockDim.x) {
    unpack_stereo(body.result(buf, k), body.result(buf, k == 0 ? 0 : n - k),
                  &ol[k], &orr[k]);
  }
}

// ---- the split-real row -------------------------------------------------
//
// One channel of one window as its own FFT of real input:
//   Z = DFT_N(x * hann) with x zero-padded from W to N,  out[k] = |Z[k]|
// for k = 0 .. stft_bins(N, W)-1, `hann` carrying the reference's 2/W output
// scale (the TPU kernels' `_scaled_hann`).  The window's W samples come from
// a sample source, a functor that returns the sample at window position i
// (`window(i)`):
//   RowSamples         one contiguous window (window planes; the k
//                      hop-shifted windows of a carry+chunk buffer)
//   TransposedSamples  x[j1, t], t < m, is sample t*n1 + j1 (the transposed
//                      carry layout [n1, m] of one channel)
//   SplitSamples       carry [n1, c_cols] then chunk [n1, t_cols]: x[j1, t]
//                      is sample t*n1 + j1, t counted across both
//   PlanarSamples      the planar carry [C] then chunk [k*hop] of one
//                      channel: window sample p is buffer sample start + p,
//                      in the carry below C and in the chunk from there
// The body's first pass reads the samples by window position straight into
// its registers (`load_transform`, as the packed rows do), in every source:
// a warp reads consecutive positions, which the window-ordered sources hold
// at consecutive addresses and the transposed ones m floats apart.  The
// first form read each source in its memory order and stored each sample
// as one f32 lane of its slot, then transformed the buffer; on an H100 80GB
// HBM3 at 700 W the fused load took 0.66x its time on window planes at N =
// 4096, 0.31x at N = 4800, and 0.71x / 0.34x on the transposed operand at
// N = 4096 / 4800, where the strided reads were expected to lose (PERF.md
// §6).  The Bluestein body has no fused pass: its load goes through `slot`
// and `input` over the whole buffer.  Every layout runs the same
// arithmetic on the same values, so all give the same bits for a window.

struct RowSamples {
  const float* x;
  int w;

  __device__ __forceinline__ int size() const { return w; }
  __device__ __forceinline__ float window(int i) const { return x[i]; }
};

struct TransposedSamples {
  const float* x;  // [n1, m]
  int n1, m;

  __device__ __forceinline__ int size() const { return n1 * m; }
  __device__ __forceinline__ float window(int i) const {
    const int t = i / n1;
    return x[(i - t * n1) * m + t];
  }
};

struct SplitSamples {
  const float* carry;  // [n1, c_cols]: window columns 0 .. c_cols-1
  const float* chunk;  // [n1, t_cols]: window columns c_cols .. m-1
  int n1, c_cols, t_cols;

  __device__ __forceinline__ int size() const { return n1 * (c_cols + t_cols); }
  __device__ __forceinline__ float window(int i) const {
    const int t = i / n1;
    const int j1 = i - t * n1;
    return t < c_cols ? carry[j1 * c_cols + t] : chunk[j1 * t_cols + t - c_cols];
  }
};

struct PlanarSamples {
  const float* carry;  // [c_len]: buffer samples 0 .. c_len-1
  const float* chunk;  // buffer samples c_len ..
  int c_len, start, w;

  __device__ __forceinline__ int size() const { return w; }
  __device__ __forceinline__ float window(int i) const {
    const int at = start + i;
    return at < c_len ? carry[at] : chunk[at - c_len];
  }
};

// The split-real row's two forms.  Even N (from 4) runs the N/2-point body
// `half` on the pack z[t] = x[2t] + i x[2t+1] (t < N/2) and unpacks each bin
// with `real_pack_magnitude`: half the buffer and half the stages of an
// N-point transform.  Odd N has no pack and runs the N-point body on
// (x, 0).  `split_fft_table` (ops/cuda/stft_kernel.py) lays out the table:
// even N, N/2's body table followed by the N/2 post-twiddles; odd N, N's.
template <class Body>
struct RealPack {
  Body half;
  const float2* post;  // [N/2] exp(-2 pi i k / N)

  __device__ __forceinline__ int size() const { return 2 * half.size(); }
  __host__ __device__ __forceinline__ int buf_size() const { return half.buf_size(); }
};

template <class Body>
struct RealFull {
  Body body;

  __device__ __forceinline__ int size() const { return body.size(); }
  __host__ __device__ __forceinline__ int buf_size() const { return body.buf_size(); }
};

template <class Row>
struct is_real_pack : std::false_type {};
template <class Body>
struct is_real_pack<RealPack<Body>> : std::true_type {};

// True for a split-real row over the radix-2 body.
template <class Row>
struct is_radix2_row : std::false_type {};
template <>
struct is_radix2_row<RealPack<Radix2>> : std::true_type {};
template <>
struct is_radix2_row<RealFull<Radix2>> : std::true_type {};

// True where the split-real row of N runs as the N/2-point pack.
__host__ __device__ __forceinline__ bool real_packs(int n) {
  return n % 2 == 0 && n >= 4;
}

// fn(row) with the split-real row form of N (RealPack over N/2's body or
// RealFull over N's) on its table `consts`; as `with_fft_body`.
template <class Fn>
static inline int with_real_body(int n, const void* consts, Fn fn) {
  if (!real_packs(n)) {
    return with_fft_body(n, consts, [&](auto body) {
      return fn(RealFull<decltype(body)>{body});
    });
  }
  return with_fft_body(n / 2, consts, [&](auto half) {
    return fn(RealPack<decltype(half)>{
        half, static_cast<const float2*>(consts) + half.table_size()});
  });
}

// x * hann through the pack, transformed, and |X[k]| for k < stft_bins(N,
// W) written to `out`: the first pass reads pack entry t = (x[2t]
// hann[2t], x[2t+1] hann[2t+1]) for t < ceil(W / 2), the odd lane of t =
// (W-1)/2 zero at odd W.
template <int kCap = kMixedGroup, class Body, class Source>
__device__ __forceinline__ void stft_real_row(
    const RealPack<Body>& row, const Source& src, const float* __restrict__ hann,
    const float2* __restrict__ tw, float* __restrict__ out, float2* buf) {
  const int n = row.size();
  const int w = src.size();
  load_transform<kCap>(row.half, buf, tw, (w + 1) / 2, [&](int t) {
    const int i = 2 * t;
    const int j = i + 1 < w ? i + 1 : i;  // read in range; zero past W
    const float a = __fmul_rn(src.window(i), hann[i]);
    const float b = __fmul_rn(src.window(j), hann[j]);
    return make_float2(a, i + 1 < w ? b : 0.f);
  });
  const int bins = stft_bins(n, w);
  const auto z = [&](int t) { return row.half.result(buf, t); };
  for (int k = threadIdx.x; k < bins; k += blockDim.x) {
    out[k] = real_pack_magnitude(z, row.post, n / 2, k);
  }
}

// Odd N: the N-point transform of (x * hann, 0).
template <int kCap = kMixedGroup, class Body, class Source>
__device__ __forceinline__ void stft_real_row(
    const RealFull<Body>& row, const Source& src, const float* __restrict__ hann,
    const float2* __restrict__ tw, float* __restrict__ out, float2* buf) {
  const Body& body = row.body;
  const int n = body.size();
  const int w = src.size();
  if constexpr (fuses_load<Body>::value) {
    load_transform<kCap>(body, buf, tw, w, [&](int i) {
      return make_float2(__fmul_rn(src.window(i), hann[i]), 0.f);
    });
  } else {
    // the window's reads in a loop of their own, then the zero pad
    for (int i = threadIdx.x; i < w; i += blockDim.x) {
      buf[body.slot(i)] = body.input(i, make_float2(__fmul_rn(src.window(i), hann[i]), 0.f));
    }
    for (int i = w + threadIdx.x; i < body.buf_size(); i += blockDim.x) {
      buf[body.slot(i)] = body.input(i, make_float2(0.f, 0.f));
    }
    __syncthreads();
    body.template transform<kCap>(buf, tw);
  }
  const int bins = stft_bins(n, w);
  for (int k = threadIdx.x; k < bins; k += blockDim.x) {
    out[k] = magnitude(body.result(buf, k));
  }
}

// The next carry of the carry+chunk framing, one channel: the window's last
// c_cols columns after a hop of t_cols, [n1, c_cols] in the carry's layout.
// For t_cols < c_cols: carry columns t_cols.. then the chunk; else the
// chunk's last c_cols columns.
__device__ __forceinline__ void split_next_carry(
    const float* __restrict__ carry, const float* __restrict__ chunk,
    float* __restrict__ next, int n1, int c_cols, int t_cols) {
  const int keep = c_cols > t_cols ? c_cols - t_cols : 0;
  for (int f = threadIdx.x; f < n1 * c_cols; f += blockDim.x) {
    const int j1 = f / c_cols;
    const int u = f - j1 * c_cols;
    next[f] = u < keep ? carry[j1 * c_cols + t_cols + u]
                       : chunk[j1 * t_cols + t_cols - c_cols + u];
  }
}

// The planar next carry, one channel: the last c_len samples of carry [c_len]
// + chunk [t_len], i.e. buffer samples t_len .. t_len + c_len - 1.
__device__ __forceinline__ void planar_next_carry(
    const float* __restrict__ carry, const float* __restrict__ chunk,
    float* __restrict__ next, int c_len, int t_len) {
  for (int u = threadIdx.x; u < c_len; u += blockDim.x) {
    const int at = t_len + u;
    next[u] = at < c_len ? carry[at] : chunk[at - c_len];
  }
}

// The last c_len samples of a buffer [ld] into next [c_len] (the all-windows
// kernels' next carry), f32 or int16.
template <class T>
__device__ __forceinline__ void buffer_tail(const T* __restrict__ buf,
                                            T* __restrict__ next, int ld,
                                            int c_len) {
  for (int u = threadIdx.x; u < c_len; u += blockDim.x) {
    next[u] = buf[ld - c_len + u];
  }
}

// `t` threads in whole warps, from 32 to kStftMaxThreads.
static inline int whole_warps(int t) {
  t = (t + 31) / 32 * 32;
  return t < 32 ? 32 : t < kStftMaxThreads ? t : kStftMaxThreads;
}

// Threads per block of the large-N route's local passes: one per butterfly
// of a radix-2 stage over `buf_size` entries, in whole warps, from 32 to 512.
static inline int stft_threads(int buf_size) { return whole_warps(buf_size / 2); }

// Threads per row block of `body`: one per group of its register passes at
// their most under the pass bound `cap` (radix 2: N / 16; mixed radix:
// `max_groups`; Bluestein: its inner body's), in whole warps, from 32 to
// 512; the split-real rows take their N/2 body's.
template <class Body>
static inline int body_threads(const Body& body, int cap = kMixedGroup) {
  if constexpr (std::is_same<Body, Radix2>::value) {
    return whole_warps(body.buf_size() >> kRadix2Pass);
  } else if constexpr (fuses_load<Body>::value) {
    return whole_warps(body.max_groups(cap));
  } else {
    return whole_warps(body.inner.max_groups(cap));
  }
}

template <class Body>
static inline int body_threads(const RealPack<Body>& row, int cap = kMixedGroup) {
  return body_threads(row.half, cap);
}

template <class Body>
static inline int body_threads(const RealFull<Body>& row, int cap = kMixedGroup) {
  return body_threads(row.body, cap);
}

// Launch bounds as a type: at most kThreads threads, kBlocks blocks per SM.
template <int kThreads, int kBlocks>
struct Bounds {
  static constexpr int threads = kThreads, blocks = kBlocks;
};

// The pass bound of the mixed-radix passes in a kernel under launch bounds
// B: kMixedGroup where they leave 96 registers a thread or more, else
// kNarrowGroup (64 registers: 512 threads and two blocks, 1,024 and one).
template <class B>
__host__ __device__ constexpr int group_cap() {
  return 65536 / (B::threads * B::blocks) >= 96 ? kMixedGroup : kNarrowGroup;
}

// A kernel template <class Body, class Bounds> in two launch-bounds forms
// of the same code: `name` under Bounds::threads alone and `name##_blocks`
// under threads and blocks; `name##_for<Body, Bounds>()` is the one that
// the bounds take (only it is instantiated): the threads alone for bounds
// of one block, as a declared minimum of one block moves ptxas's register
// choice at the same cap (the split-real rows' N-point Bluestein row of
// N = 4801: 64 registers in place of 54, 4-5% slower, PERF.md §6).
#define SPK_BOUNDED_KERNEL(name, params, ...)                                  \
  template <class Body, class Bounds>                                         \
  __global__ void __launch_bounds__(Bounds::threads) name params __VA_ARGS__  \
  template <class Body, class Bounds>                                         \
  __global__ void __launch_bounds__(Bounds::threads, Bounds::blocks)          \
      name##_blocks params __VA_ARGS__                                        \
  template <class Body, class Bounds>                                         \
  auto name##_for() {                                                         \
    if constexpr (Bounds::blocks == 1) {                                      \
      return name<Body, Bounds>;                                              \
    } else {                                                                  \
      return name##_blocks<Body, Bounds>;                                     \
    }                                                                         \
  }

// A launch choice, the `launch` argument of the STFT and push entries: 0
// (kLaunchTable) takes the table's rule below; any other value names launch
// bounds that the kernel instantiates for its body, and a value that it
// does not instantiate is refused with cudaErrorInvalidValue.  Every choice
// computes the same bits: the bounds move the threads of a block and the
// registers ptxas leaves them, and with them only the pass bound of the
// mixed-radix passes (`group_cap`), which groups stages, not operations.
// ops/cuda/stft_kernel.py `LAUNCH_BOUNDS` mirrors these values, and
// utils/autotune.py measures them.
constexpr int kLaunchTable = 0;
constexpr int kLaunchRows = 1;    // (kRowThreads, kRowBlocks)
constexpr int kLaunchPair = 2;    // (kStftMaxThreads, 2)
constexpr int kLaunchWide = 3;    // (kStftMaxThreads, 1)
constexpr int kLaunchNarrow = 4;  // (kWideThreads, 1)

// The table's rule for a packed row block over `body` (`with_row_bounds`):
// a row whose buffer fits kRowBlocks times in a block's shared memory
// (radix 2 to N = 4096, mixed radix and Bluestein's M to 5,811) takes
// kRowThreads threads and kRowBlocks blocks, so that ptxas holds its
// registers to that many blocks per SM; a mixed-radix or Bluestein row that
// fits twice takes (512, 2), the narrow passes of 64 registers (N = 4801's
// M = 9604 = 4 7^4, singles only, ran 9% slower at (256, 2) and 35% at
// (512, 1), PERF.md §6); larger rows (fewer blocks per SM: at N = 16,384
// the radix-2 rows ran at half the speed under (128, 5)) take
// kStftMaxThreads threads and one block.
template <class Body>
static inline int row_bounds_rule(const Body& body) {
  const int bytes = body.buf_size() * static_cast<int>(sizeof(float2));
  if (bytes * kRowBlocks <= kMaxSmemBytes) return kLaunchRows;
  if (!std::is_same<Body, Radix2>::value && bytes * 2 <= kMaxSmemBytes) return kLaunchPair;
  return kLaunchWide;
}

// fn(bounds, threads) with the launch bounds of a packed row block over
// `body` that `choice` names (kLaunchTable: `row_bounds_rule`) and its
// threads (`body_threads` under the bounds' `group_cap`, at most
// bounds.threads): kLaunchRows, kLaunchWide, and kLaunchPair except over
// the radix-2 body, which has no (512, 2) form.
template <class Body, class Fn>
static inline int with_row_bounds(const Body& body, Fn fn, int choice = kLaunchTable) {
  const auto launch = [&](auto bounds) {
    using B = decltype(bounds);
    const int threads = body_threads(body, group_cap<B>());
    return fn(bounds, threads < B::threads ? threads : B::threads);
  };
  switch (choice == kLaunchTable ? row_bounds_rule(body) : choice) {
    case kLaunchRows:
      return launch(Bounds<kRowThreads, kRowBlocks>{});
    case kLaunchPair:
      if constexpr (!std::is_same<Body, Radix2>::value) {
        return launch(Bounds<kStftMaxThreads, 2>{});
      }
      break;
    case kLaunchWide:
      return launch(Bounds<kStftMaxThreads, 1>{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The table's rule for a split-real row (`with_split_bounds`).  A row whose
// buffer fits kRowBlocks times in an SM's shared memory (up to 5,811
// entries: N = 4096, 4800, 4410) takes (kRowThreads, kRowBlocks), as kernel
// A's rows do; with the load fused into the first pass that ran every
// layout in 0.87-0.95x the time of (kStftMaxThreads, 1) at N = 4096 and
// 4800 (the lane-loaded rows had run 3-17% slower so, PERF.md §6).  Larger
// rows keep their bounds ((512, 2) ran N = 17,640 within 0.7% of them):
// kLaunchNarrow for N/2 packs of kWideRow entries and more (N = 32,768 and
// 48,000 among the measured sizes), which run one block per SM; else
// kLaunchWide for the radix-2 rows and for the mixed-radix and Bluestein
// rows whose buffer fits four times in an SM's shared memory, and
// kLaunchNarrow for the others.
template <class Row>
static inline int split_bounds_rule(const Row& row) {
  const size_t smem = row.buf_size() * sizeof(float2);
  const size_t limit = kMaxSmemBytes;
  if (is_real_pack<Row>::value && row.buf_size() >= kWideRow) return kLaunchNarrow;
  if (smem * kRowBlocks <= limit) return kLaunchRows;
  if (is_radix2_row<Row>::value || smem * 4 <= limit) return kLaunchWide;
  return kLaunchNarrow;
}

// fn(bounds, threads) with the launch bounds of a split-real row block over
// `row` that `choice` names (kLaunchTable: `split_bounds_rule`) and its
// threads: under kLaunchRows `body_threads` at its `group_cap`, at most
// kRowThreads; under kLaunchWide `body_threads`, at most 128 for the
// mixed-radix and Bluestein rows (passes of up to 25 entries in 128
// registers); under kLaunchNarrow kWideThreads for N/2 packs of kWideRow
// entries and more, else `body_threads` at the narrow passes (64 registers,
// `group_cap`).  Every split-real row instantiates those three; kLaunchPair
// is refused.  Only the pack is compiled at the wide bound for its own
// sake: an odd N's full row of that size (a 7-smooth odd N past 16,384, or
// a Bluestein M past it) is rare and runs the narrow one.  The one-block
// bounds take the kernels' form under the threads alone
// (`SPK_BOUNDED_KERNEL`): a declared minimum of one block gave the N-point
// Bluestein row of N = 4801 64 registers in place of 54 and ran it 4-5%
// slower (PERF.md §6).
template <class Row, class Fn>
static inline int with_split_bounds(const Row& row, Fn fn, int choice = kLaunchTable) {
  using Rows = Bounds<kRowThreads, kRowBlocks>;
  switch (choice == kLaunchTable ? split_bounds_rule(row) : choice) {
    case kLaunchRows: {
      const int threads = body_threads(row, group_cap<Rows>());
      return fn(Rows{}, threads < Rows::threads ? threads : Rows::threads);
    }
    case kLaunchWide: {
      const int threads = body_threads(row);
      const int cap = is_radix2_row<Row>::value ? kStftMaxThreads : 128;
      return fn(Bounds<kStftMaxThreads, 1>{}, threads < cap ? threads : cap);
    }
    case kLaunchNarrow:
      // the full row over the radix-2 body (N = 2) has no narrow form
      if constexpr (is_real_pack<Row>::value || !is_radix2_row<Row>::value) {
        return fn(Bounds<kWideThreads, 1>{},
                  is_real_pack<Row>::value && row.buf_size() >= kWideRow
                      ? kWideThreads
                      : body_threads(row, kNarrowGroup));
      }
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Allow `kernel` `bytes` of dynamic shared memory (above 48 KB only by
// opting in); 0 or the CUDA error.
template <class Kernel>
static inline int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

}  // namespace spk
