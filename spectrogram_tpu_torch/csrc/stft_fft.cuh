// Device code shared by the STFT kernels: the Hann-pack-pad load, the two
// FFT bodies and the conjugate-symmetric stereo unpack of one window row.
//
// Per row, with N >= W:
//   z[n] = (l[n] + i r[n]) * hann[n]     for n < W, 0 for W <= n < N
//   Z    = DFT_N(z)
//   L[k] = |Z[k] + conj(Z[(N-k) mod N])|, R[k] = |Z[k] - conj(Z[(N-k) mod N])|
// for k = 0 .. N/2-1 (DC included; the k=0 partner is Z[0] itself).  `hann`
// arrives with the reference's 2/W output scale and the unpack's 1/2 folded
// in, as the TPU kernels' `_packed_hann` did.
//
// Two bodies compute DFT_N in place in shared memory (N complex f32):
//   Radix2      N = 2^a: bit-reversed load, log2(N) radix-2 DIT stages.
//   MixedRadix  N = 2^a 3^b 5^c: digit-reversed load, radix-4/2/3/5 DIT
//               stages (4s first, then a 2, then 3s, then 5s).
// Both read twiddles from one table of N entries exp(-2 pi i t / N), computed
// in float64 on the host and rounded once.
//
// Every packed kernel runs a row through `stft_packed_row`, every
// split-real kernel (stft_split.cu) one channel of a row through
// `stft_real_row`, and all the arithmetic here is written with _rn
// intrinsics, so nvcc contracts nothing differently in one kernel than in
// another: the all-windows kernel and the window-plane kernels give the same
// bits for the same window, and so do the four split-real layouts.  No
// tensor core is used, so TF32 cannot enter; every stage is true f32.
#pragma once

#include "spk_common.cuh"

namespace spk {

constexpr int kStftMaxThreads = 512;
constexpr int kMaxStages = 16;

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

struct Radix2 {
  int log2n;

  __device__ __forceinline__ int size() const { return 1 << log2n; }

  // bit reversal: where sample i sits before the first DIT stage
  __device__ __forceinline__ int slot(int i) const {
    return static_cast<int>(__brev(static_cast<unsigned>(i)) >> (32 - log2n));
  }

  // Stage s merges transforms of size 2^s into 2^(s+1); the twiddle of
  // butterfly position p is exp(-2 pi i p / 2^(s+1)) = tw[p * N / 2^(s+1)].
  __device__ __forceinline__ void transform(float2* buf, const float2* tw) const {
    const int half = 1 << (log2n - 1);
    for (int s = 0; s < log2n; ++s) {
      const int hs = 1 << s;
      const int tstep = half >> s;
      for (int j = threadIdx.x; j < half; j += blockDim.x) {
        const int pos = j & (hs - 1);
        const int i0 = ((j >> s) << (s + 1)) | pos;
        const int i1 = i0 + hs;
        const float2 t = cmul(buf[i1], tw[pos * tstep]);
        const float2 a = buf[i0];
        buf[i0] = cadd(a, t);
        buf[i1] = csub(a, t);
      }
      __syncthreads();
    }
  }
};

struct MixedRadix {
  int n;
  int stages;
  int radix[kMaxStages];

  __device__ __forceinline__ int size() const { return n; }

  // Digit reversal.  Stage s turns r_s sub-transforms of length
  // L_s = r_0 ... r_{s-1}, stored one after another, into one of length
  // L_s r_s; so sample i goes to sum_s d_s L_s, where d_{m-1}, ..., d_0 are
  // the digits of i in radices r_{m-1}, ..., r_0, least significant first.
  __device__ __forceinline__ int slot(int i) const {
    int pos = 0;
    int span = n;
    for (int s = stages - 1; s >= 0; --s) {
      const int r = radix[s];
      span /= r;
      pos += (i % r) * span;
      i /= r;
    }
    return pos;
  }

  // Decimation in time: butterfly (block b, position p) of stage s takes
  // x_q = buf[b M + p + q L] * exp(-2 pi i p q / M), q < r, with L = L_s and
  // M = L r, and writes the r-point DFT of the x_q back to the same slots.
  __device__ __forceinline__ void transform(float2* buf, const float2* tw) const {
    int len = 1;
    for (int s = 0; s < stages; ++s) {
      const int r = radix[s];
      const int m = len * r;
      const int tstep = n / m;
      const int count = n / r;
      for (int j = threadIdx.x; j < count; j += blockDim.x) {
        const int p = j % len;
        float2* x = buf + (j / len) * m + p;
        const int t = p * tstep;
        switch (r) {
          case 4: radix4(x, len, t, tw); break;
          case 2: radix2(x, len, t, tw); break;
          case 3: radix3(x, len, t, tw); break;
          default: radix5(x, len, t, tw); break;
        }
      }
      __syncthreads();
      len = m;
    }
  }

  static __device__ __forceinline__ void radix2(float2* x, int l, int t,
                                                const float2* tw) {
    const float2 a0 = x[0];
    const float2 a1 = cmul(x[l], tw[t]);
    x[0] = cadd(a0, a1);
    x[l] = csub(a0, a1);
  }

  static __device__ __forceinline__ void radix4(float2* x, int l, int t,
                                                const float2* tw) {
    const float2 a0 = x[0];
    const float2 a1 = cmul(x[l], tw[t]);
    const float2 a2 = cmul(x[2 * l], tw[2 * t]);
    const float2 a3 = cmul(x[3 * l], tw[3 * t]);
    const float2 s02 = cadd(a0, a2), d02 = csub(a0, a2);
    const float2 s13 = cadd(a1, a3), d13 = csub(a1, a3);
    x[0] = cadd(s02, s13);
    x[l] = sub_i(d02, d13);
    x[2 * l] = csub(s02, s13);
    x[3 * l] = add_i(d02, d13);
  }

  static __device__ __forceinline__ void radix3(float2* x, int l, int t,
                                                const float2* tw) {
    constexpr float kS = static_cast<float>(0.86602540378443864676);  // sin(2pi/3)
    const float2 a0 = x[0];
    const float2 a1 = cmul(x[l], tw[t]);
    const float2 a2 = cmul(x[2 * l], tw[2 * t]);
    const float2 s12 = cadd(a1, a2);
    const float2 c = cfma(-0.5f, s12, a0);
    const float2 d = cscale(kS, csub(a1, a2));
    x[0] = cadd(a0, s12);
    x[l] = sub_i(c, d);
    x[2 * l] = add_i(c, d);
  }

  static __device__ __forceinline__ void radix5(float2* x, int l, int t,
                                                const float2* tw) {
    constexpr float kC1 = static_cast<float>(0.30901699437494742410);   // cos(2pi/5)
    constexpr float kC2 = static_cast<float>(-0.80901699437494742410);  // cos(4pi/5)
    constexpr float kS1 = static_cast<float>(0.95105651629515357212);   // sin(2pi/5)
    constexpr float kS2 = static_cast<float>(0.58778525229247312917);   // sin(4pi/5)
    const float2 a0 = x[0];
    const float2 a1 = cmul(x[l], tw[t]);
    const float2 a2 = cmul(x[2 * l], tw[2 * t]);
    const float2 a3 = cmul(x[3 * l], tw[3 * t]);
    const float2 a4 = cmul(x[4 * l], tw[4 * t]);
    const float2 b1 = cadd(a1, a4), d1 = csub(a1, a4);
    const float2 b2 = cadd(a2, a3), d2 = csub(a2, a3);
    const float2 c1 = cfma(kC2, b2, cfma(kC1, b1, a0));
    const float2 c2 = cfma(kC1, b2, cfma(kC2, b1, a0));
    const float2 e1 = cfma(kS2, d2, cscale(kS1, d1));
    const float2 e2 = cfma(-kS1, d2, cscale(kS2, d1));
    x[0] = cadd(cadd(a0, b1), b2);
    x[l] = sub_i(c1, e1);
    x[2 * l] = sub_i(c2, e2);
    x[3 * l] = add_i(c2, e2);
    x[4 * l] = add_i(c1, e1);
  }
};

// The mixed-radix plan of n on the host; false if n has a prime factor
// other than 2, 3 and 5 or needs more than kMaxStages stages.
static inline bool make_mixed_radix(int n, MixedRadix* plan) {
  plan->n = n;
  plan->stages = 0;
  int rest = n;
  const int radices[] = {4, 2, 3, 5};  // once the 4s are out, one 2 at most
  for (int r : radices) {
    while (rest % r == 0) {
      if (plan->stages == kMaxStages) return false;
      plan->radix[plan->stages++] = r;
      rest /= r;
    }
  }
  return rest == 1 && n > 1;
}

// One window row: load l, r through hann into `buf` in the body's input
// order, transform, unpack both channels' magnitudes into ol, orr [N/2].
// The caller's block has blockDim.x threads and N complex f32 of `buf`.
//
// Samples are f32, or int16 PCM words (T = short, the i16_planes wire mode:
// half the bytes read).  A word converts to f32 exactly, and its 1/32768
// wire scale arrives folded into `hann` (an exact exponent shift, as the TPU
// kernels did), so the one rounding of x * (hann * 2^-15) gives the bits of
// (x / 32768) * hann: the int16 row equals the f32 row of x / 32768 exactly.
template <class Body, class T>
__device__ __forceinline__ void stft_packed_row(
    const Body& body, const T* __restrict__ l, const T* __restrict__ r,
    const float* __restrict__ hann, const float2* __restrict__ tw, int w,
    float* __restrict__ ol, float* __restrict__ orr, float2* buf) {
  const int n = body.size();
  // coalesced global reads, scattered shared-memory writes
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float2 z = make_float2(0.f, 0.f);
    if (i < w) {
      const float h = hann[i];
      z = make_float2(__fmul_rn(static_cast<float>(l[i]), h),
                      __fmul_rn(static_cast<float>(r[i]), h));
    }
    buf[body.slot(i)] = z;
  }
  __syncthreads();
  body.transform(buf, tw);
  // conjugate-symmetric stereo unpack (fft.rs:81-92), coalesced stores
  const int half = n >> 1;
  for (int k = threadIdx.x; k < half; k += blockDim.x) {
    const float2 zk = buf[k];
    const float2 zm = buf[k == 0 ? 0 : n - k];
    const float lr = __fadd_rn(zk.x, zm.x), li = __fsub_rn(zk.y, zm.y);
    const float rr = __fsub_rn(zk.x, zm.x), ri = __fadd_rn(zk.y, zm.y);
    ol[k] = sqrtf(__fmaf_rn(lr, lr, __fmul_rn(li, li)));
    orr[k] = sqrtf(__fmaf_rn(rr, rr, __fmul_rn(ri, ri)));
  }
}

// ---- the split-real row -------------------------------------------------
//
// One channel of one window as its own FFT of real input:
//   Z = DFT_N(x * hann) with x zero-padded from W to N,  out[k] = |Z[k]|
// for k = 0 .. N/2-1, `hann` carrying the reference's 2/W output scale (the
// TPU kernels' `_scaled_hann`).  The window's W samples come from a sample
// source, a functor that returns the f-th sample of the window in the
// source's memory order and sets the sample's position i in the window:
//   RowSamples         one contiguous window (window planes; the k
//                      hop-shifted windows of a carry+chunk buffer)
//   TransposedSamples  x[j1, t], t < m, is sample t*n1 + j1 (the transposed
//                      carry layout [n1, m] of one channel)
//   SplitSamples       carry [n1, c_cols] then chunk [n1, t_cols]: x[j1, t]
//                      is sample t*n1 + j1, t counted across both
// Reads follow memory order (coalesced); each sample lands in the body's
// shared-memory slot of its window position.  Every layout runs the same
// arithmetic on the same values, so all give the same bits for a window.

struct RowSamples {
  const float* x;
  int w;

  __device__ __forceinline__ int size() const { return w; }
  __device__ __forceinline__ float sample(int f, int* i) const {
    *i = f;
    return x[f];
  }
};

struct TransposedSamples {
  const float* x;  // [n1, m]
  int n1, m;

  __device__ __forceinline__ int size() const { return n1 * m; }
  __device__ __forceinline__ float sample(int f, int* i) const {
    const int j1 = f / m;
    const int t = f - j1 * m;
    *i = t * n1 + j1;
    return x[f];
  }
};

struct SplitSamples {
  const float* carry;  // [n1, c_cols]: window columns 0 .. c_cols-1
  const float* chunk;  // [n1, t_cols]: window columns c_cols .. m-1
  int n1, c_cols, t_cols;

  __device__ __forceinline__ int size() const { return n1 * (c_cols + t_cols); }
  __device__ __forceinline__ float sample(int f, int* i) const {
    const int in_carry = n1 * c_cols;
    if (f < in_carry) {
      const int j1 = f / c_cols;
      *i = (f - j1 * c_cols) * n1 + j1;
      return carry[f];
    }
    const int g = f - in_carry;
    const int j1 = g / t_cols;
    *i = (c_cols + g - j1 * t_cols) * n1 + j1;
    return chunk[g];
  }
};

template <class Body, class Source>
__device__ __forceinline__ void stft_real_row(
    const Body& body, const Source& src, const float* __restrict__ hann,
    const float2* __restrict__ tw, float* __restrict__ out, float2* buf) {
  const int n = body.size();
  const int w = src.size();
  for (int f = threadIdx.x; f < w; f += blockDim.x) {
    int i;
    const float x = src.sample(f, &i);
    buf[body.slot(i)] = make_float2(__fmul_rn(x, hann[i]), 0.f);
  }
  for (int i = w + threadIdx.x; i < n; i += blockDim.x) {
    buf[body.slot(i)] = make_float2(0.f, 0.f);
  }
  __syncthreads();
  body.transform(buf, tw);
  const int half = n >> 1;
  for (int k = threadIdx.x; k < half; k += blockDim.x) {
    const float2 z = buf[k];
    out[k] = sqrtf(__fmaf_rn(z.x, z.x, __fmul_rn(z.y, z.y)));
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

// Threads per row block: one per butterfly of a radix-2 stage, at most 512.
static inline int stft_threads(int n) {
  return n / 2 < kStftMaxThreads ? n / 2 : kStftMaxThreads;
}

// Allow `kernel` the N complex f32 of dynamic shared memory it needs (above
// 48 KB only by opting in); 0 or the CUDA error.
template <class Kernel>
static inline int allow_smem(Kernel kernel, int n) {
  const int smem = n * static_cast<int>(sizeof(float2));
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

}  // namespace spk
