// The large-N route of the STFT kernels: the index code of stft_large.cu,
// one element or butterfly at a time, so that the kernels and the host test
// (tests/cuda_host_stub/) run the same code.
//
// The other STFT kernels hold a row's FFT buffer in one block's shared
// memory, which caps it at 227 KB (kMaxSmemBytes, 29,056 complex f32): a
// packed row holds N entries (Bluestein: M >= 2N - 1), so N = 2^15 and up,
// 7-smooth N above 29,056 and Bluestein N from about 14,500 do not fit; a
// split-real row holds N/2 (the real-FFT pack), so only even N above 58,112
// (N/2 direct) or whose N/2 takes a Bluestein M past 29,056, and odd N as a
// packed row, do not.  Here the buffer is a row of a [rows, B] complex f32
// scratch in device memory (B = buf_size()), and the MixedRadix stages of
// the transform (direct) or of M (Bluestein) run as passes over every row.
// Stage s combines entries within runs of r_0 ... r_s contiguous entries, so
// the first `local` stages (their span, r_0 ... r_{local-1}, at most a
// block's shared memory) act within each run of `span` entries, and the
// rest (one for every N the kernels take this way) span the row.
//
// A direct N runs in two passes:
//
//   load + local   one block per run c: run c holds the inputs
//                  i = first + G m, m < span (G = n / span runs; first =
//                  unslot(c span), which is c itself where one global stage
//                  is left), in its own plan's digit-reversed order (`runs`:
//                  span entries, stages r_0 .. r_{local-1}).  The block runs
//                  that plan's DIT stages as the shared-memory bodies run
//                  theirs, as register passes (MixedRadixT's `first_pass`
//                  and `pass`: one or two stages a pass, radices picked by
//                  `with_radices`), with the full transform's twiddles
//                  (tw[G t'] for the run's t', read from a copy of every
//                  G-th entry, `run_tw`): the first pass reads its
//                  group's inputs straight from the window planes, G entries
//                  apart, into registers, with the load's arithmetic (the
//                  stereo pack (l + i r) * hann, one real channel's pack
//                  x[2i] h[2i] + i x[2i+1] h[2i+1] (N/2 entries, even N), or
//                  (x * hann, 0) (odd N); nothing read past the window), and
//                  the last writes the run to the row, contiguous
//                  (`large_load_local`); between them the run stays in a
//                  shared-memory tile under the bodies' swizzle (`large_at`)
//   last + unpack  a thread per butterfly pair (j, len - j) of the last DIT
//                  stage (radix R, len = n / R): it reads the 2R entries into
//                  registers, runs both butterflies there, and so holds every
//                  X[k] and X[n - k] for k = +-j mod len, which is what the
//                  stereo unpack and the split-real pack's unpack
//                  (`real_pack_bin`) of those bins need
//                  (`large_last_stage`); each bin is written once
//
// and any global stage between the two (none at the kernels' span) as a
// pass of its own, a thread per butterfly.  Bluestein runs four: the load
// (a thread per entry, in natural order, times the chirp, zero-padded to
// M), its global DIF stages, the local pass (DIF stages, the pointwise
// product with the filter's transform, stored in the DIF output order, DIT
// stages, one `butterfly_at` sweep of the tile a stage), its global DIT
// stages, and the result c[k] conj(row[k]) into the same unpacks
// (`large_unpack`, `large_magnitude`), so packed and split-real rows follow
// one law at every N.
//
// Every butterfly is the shared-memory bodies' own step (`butterfly` and
// `twiddled_dft`, at `butterfly_at`'s places, with the full transform's
// twiddles), and the chirp and filter products are theirs, run in their
// order, so the grouping into passes changes no bit.
//
// Every multiply and add is an _rn intrinsic (stft_fft.cuh), the FFT runs in
// true f32, and the tables are `fft_table`'s and `split_fft_table`'s
// (float64, rounded once).  At an N the shared-memory bodies also take, the
// route gives their bits (the host test checks N = 4800 and 4410, packed
// and split-real); power-of-two N run the MixedRadix stages (radix 4, then
// one 2) here where the shared-memory kernels run Radix2.
#pragma once

#include "stft_fft.cuh"

namespace spk {

struct LargePlan {
  int n;                  // N, the row's FFT length (bins: stft_bins(N, w))
  int size;               // the transform's length: N, or N/2 for the pack
  int w;                  // window samples, w <= N
  bool pack;              // the split-real row as the N/2-point pack
  bool bluestein;
  MixedRadix passes;      // the stages: size's plan (direct) or M's (Bluestein)
  int local;              // stages 0 .. local-1 run in the shared-memory pass
  int span;               // r_0 ... r_{local-1}: the entries of one local run
  MixedRadix runs;        // direct: a run's own plan (n = span, `local` stages)
  int tile_shift;         // direct: the tile's swizzle (`large_at`)
  int tile_mask;
  const float2* tw;       // passes.n twiddles exp(-2 pi i t / passes.n)
  const float2* run_tw;   // direct: every G0-th of them (G0 = n / the kernels' span)
  int run_step;           // the kernels' span / span: tw[G t] = run_tw[run_step t]
  const float2* chirp;    // Bluestein: [size] c[t] = exp(-i pi t^2 / size)
  const float2* filter;   // Bluestein: [M] F in the DIF output order
  const float2* post;     // pack: [N/2] exp(-2 pi i k / N)

  __host__ __device__ __forceinline__ int buf_size() const { return passes.n; }
};

// Dynamic shared memory of a local pass over runs of `span` entries: the
// tile.
__host__ __device__ __forceinline__ size_t large_smem_bytes(int span) {
  return span * sizeof(float2);
}

// The local stages of plan r within `max_span` entries and a block's shared
// memory, leaving at least one global stage: their count, and in *span the
// entries of a run.
static inline int large_local_stages(const MixedRadix& r, int max_span, int* span) {
  int local = 0;
  *span = 1;
  while (local + 1 < r.stages) {
    const int next = *span * r.radix[local];
    if (next > max_span || large_smem_bytes(next) > kMaxSmemBytes) break;
    *span = next;
    ++local;
  }
  return local;
}

// The plan of N over its table `consts` (`fft_table`, or `split_fft_table`
// with `split`: then an even N runs the N/2-point pack; null where only the
// plan's shape is asked for), with as many local stages as fit `max_span`
// entries and a block's shared memory, leaving at least one global stage;
// false where N < 2, w is not in 1 .. N, or no mixed-radix plan of the
// transform or of M exists.
//
// A direct transform's table ends with every G0-th of its twiddles, G0 = n
// over the span of the kernels' runs (`max_span` kMaxSmemBytes / 8): the
// twiddles a run reads, copied, so that a warp's reads of them are
// contiguous where the full table's lie G0 entries apart (a smaller span's
// run reads every run_step-th of them).  A run's tile takes the swizzle of
// the body a span that size would take: a power-of-two span from 256 up
// Radix2's (its low 4 bits XORed with its top 4), any other multiple of 16
// MixedRadixT's (with bits 6..9); so every pass of a 4^7 run, the first's
// stores of 16-entry groups included, touches 16 banks a half-warp, where
// bits 6..9 left those stores conflicting 8 ways.
static inline bool make_large_plan(int n, int w, const void* consts,
                                   LargePlan* plan,
                                   int max_span = kMaxSmemBytes / 8,
                                   bool split = false) {
  if (n < 2 || w < 1 || w > n) return false;
  const auto* table = static_cast<const float2*>(consts);
  const auto entry = [&](int k) { return table == nullptr ? nullptr : table + k; };
  plan->n = n;
  plan->w = w;
  plan->pack = split && real_packs(n);
  plan->size = plan->pack ? n / 2 : n;
  plan->tw = table;
  plan->chirp = plan->filter = plan->post = plan->run_tw = nullptr;
  plan->run_step = 1;
  plan->bluestein = !make_mixed_radix(plan->size, &plan->passes);
  int table_size = plan->size;
  if (plan->bluestein) {
    const int m = bluestein_length(plan->size);
    if (!make_mixed_radix(m, &plan->passes)) return false;
    plan->chirp = entry(m);
    plan->filter = entry(m + plan->size);
    table_size = 2 * m + plan->size;
  }
  if (plan->pack) plan->post = entry(table_size);
  const MixedRadix& r = plan->passes;
  plan->local = large_local_stages(r, max_span, &plan->span);
  if (!plan->bluestein) {
    int kernel_span;
    large_local_stages(r, kMaxSmemBytes / 8, &kernel_span);
    plan->run_tw = entry(table_size + (plan->pack ? plan->size : 0));
    plan->run_step = kernel_span / plan->span;
  }
  plan->runs.n = plan->span;
  plan->runs.stages = plan->local;
  for (int s = 0; s < kMaxStages; ++s) plan->runs.radix[s] = s < plan->local ? r.radix[s] : 0;
  const bool pow2 = (plan->span & (plan->span - 1)) == 0;
  int log2span = 0;
  while ((1 << log2span) < plan->span) ++log2span;
  plan->tile_shift = pow2 && plan->span >= 256 ? log2span - 4 : 6;
  plan->tile_mask = plan->span % 16 == 0 ? 15 : 0;
  return true;
}

// The entry j (< buf_size()) of a row holds transform input large_source(j):
// the digit-reversed input order of the direct DIT stages (the inverse of
// `slot`), or j itself for Bluestein.
__device__ __forceinline__ int large_source(const LargePlan& p, int j) {
  return p.bluestein ? j : p.passes.unslot(j);
}

// The value z of transform input i of a stereo-packed row: (l + i r) * hann,
// zero past the window; f32 or int16 samples (int16: `hann` carries the
// 2^-15 wire scale, as in stft_packed_row).
template <class T>
__device__ __forceinline__ float2 large_packed_value(const LargePlan& p,
                                                     const T* __restrict__ l,
                                                     const T* __restrict__ r,
                                                     const float* __restrict__ hann,
                                                     int i) {
  if (i >= p.w) return make_float2(0.f, 0.f);
  const float h = hann[i];
  return make_float2(__fmul_rn(static_cast<float>(l[i]), h),
                     __fmul_rn(static_cast<float>(r[i]), h));
}

// The value z of transform input i of a split-real row: the pack (x[2i]
// hann[2i], x[2i+1] hann[2i+1]), or (x[i] hann[i], 0) at odd N.
__device__ __forceinline__ float2 large_real_value(const LargePlan& p,
                                                   const float* __restrict__ x,
                                                   const float* __restrict__ hann,
                                                   int i) {
  const auto at = [&](int q) { return q < p.w ? __fmul_rn(x[q], hann[q]) : 0.f; };
  return p.pack ? make_float2(at(2 * i), at(2 * i + 1)) : make_float2(at(i), 0.f);
}

// Entry j of a row from the value z of its input i = large_source(p, j)
// (zero past the samples): z, or for Bluestein z times the chirp (zero past
// the transform's length).
__device__ __forceinline__ void large_put(const LargePlan& p, float2* row,
                                          int j, int i, float2 z) {
  if (!p.bluestein) {
    row[j] = z;
    return;
  }
  row[j] = i < p.size ? cmul(z, p.chirp[i]) : make_float2(0.f, 0.f);
}

// The load of entry j as a pass of its own (Bluestein's): stereo-packed, or
// split-real.
template <class T>
__device__ __forceinline__ void large_load_packed(
    const LargePlan& p, const T* __restrict__ l, const T* __restrict__ r,
    const float* __restrict__ hann, float2* row, int j) {
  const int i = large_source(p, j);
  large_put(p, row, j, i, large_packed_value(p, l, r, hann, i));
}

__device__ __forceinline__ void large_load_real(const LargePlan& p,
                                                const float* __restrict__ x,
                                                const float* __restrict__ hann,
                                                float2* row, int j) {
  const int i = large_source(p, j);
  large_put(p, row, j, i, large_real_value(p, x, hann, i));
}

// The passes in order: fn(kind, stage, len) for each.  A direct N:
// kLargeLoadLocal (the load fused with the local pass, runs 0 .. n / span -
// 1), kLargeDit for each global stage s but the last (sub-transforms of
// length len, butterflies 0 .. n / radix[s] - 1), kLargeLastUnpack (the
// last stage fused with the unpack, pairs 0 .. len / 2).  Bluestein: its
// global kLargeDif stages, kLargeLocal (the shared-memory pass, runs 0 ..
// n / span - 1), its global kLargeDit stages; the load before them and the
// unpack after them are the caller's.  0, or the first nonzero fn returned.
enum LargePass {
  kLargeDit = 0,
  kLargeDif = 1,
  kLargeLocal = 2,
  kLargeLoadLocal = 3,
  kLargeLastUnpack = 4,
};

template <class Fn>
static inline int large_passes(const LargePlan& p, Fn fn) {
  const MixedRadix& r = p.passes;
  if (p.bluestein) {
    int len = r.n;
    for (int s = r.stages - 1; s >= p.local; --s) {
      len /= r.radix[s];
      if (const int e = fn(kLargeDif, s, len)) return e;
    }
  }
  if (const int e = fn(p.bluestein ? kLargeLocal : kLargeLoadLocal, 0, 0)) return e;
  int len = p.span;
  for (int s = p.local; s < r.stages; ++s) {
    const bool last = !p.bluestein && s + 1 == r.stages;
    if (const int e = fn(last ? kLargeLastUnpack : kLargeDit, s, len)) return e;
    len *= r.radix[s];
  }
  return 0;
}

// Butterfly j of global stage s.
__device__ __forceinline__ void large_pass_at(const LargePlan& p, int kind,
                                              int s, int len, float2* row,
                                              int j) {
  if (kind == kLargeDit) {
    p.passes.butterfly_at<false>(row, p.tw, s, len, j);
  } else {
    p.passes.butterfly_at<true>(row, p.tw, s, len, j);
  }
}

// Units of a pass per row: butterflies, local runs, or butterfly pairs of
// the last stage.
__host__ __device__ __forceinline__ int large_pass_count(const LargePlan& p,
                                                         int kind, int s) {
  if (kind == kLargeLocal || kind == kLargeLoadLocal) return p.passes.n / p.span;
  const int butterflies = p.passes.n / p.passes.radix[s];
  return kind == kLargeLastUnpack ? butterflies / 2 + 1 : butterflies;
}

// Stage s of the local pass over the run in `tile`, cooperatively by the
// block (as the shared-memory bodies' `stage`).
template <bool kDif>
__device__ __forceinline__ void large_local_stage(const LargePlan& p,
                                                  float2* tile, int s,
                                                  int len) {
  const int count = p.span / p.passes.radix[s];
  for (int j = threadIdx.x; j < count; j += blockDim.x) {
    p.passes.butterfly_at<kDif>(tile, p.tw, s, len, j);
  }
  __syncthreads();
}

// The local DIT stages 0 .. local-1 over the run in `tile`, then the run
// back to run `run` of the row, contiguous.
__device__ __forceinline__ void large_local_dit(const LargePlan& p, float2* row,
                                                int run, float2* tile) {
  int len = 1;
  for (int s = 0; s < p.local; ++s) {
    large_local_stage<false>(p, tile, s, len);
    len *= p.passes.radix[s];
  }
  float2* at = row + static_cast<size_t>(run) * p.span;
  for (int i = threadIdx.x; i < p.span; i += blockDim.x) at[i] = tile[i];
  __syncthreads();
}

// The local pass over run `run` of a row, through `tile` (span complex f32 of
// shared memory): Bluestein's DIF stages local-1 .. 0 and filter product,
// then the DIT stages 0 .. local-1.  The caller's block runs it together.
__device__ __forceinline__ void large_local(const LargePlan& p, float2* row,
                                            int run, float2* tile) {
  const float2* at = row + static_cast<size_t>(run) * p.span;
  for (int i = threadIdx.x; i < p.span; i += blockDim.x) tile[i] = at[i];
  __syncthreads();
  if (p.bluestein) {
    int len = p.span;
    for (int s = p.local - 1; s >= 0; --s) {
      len /= p.passes.radix[s];
      large_local_stage<true>(p, tile, s, len);
    }
    const float2* filter = p.filter + static_cast<size_t>(run) * p.span;
    for (int i = threadIdx.x; i < p.span; i += blockDim.x) {
      tile[i] = conjugate(cmul(tile[i], filter[i]));
    }
    __syncthreads();
  }
  large_local_dit(p, row, run, tile);
}

// Where entry i of a run is kept in its tile (see `make_large_plan`).
__device__ __forceinline__ int large_at(const LargePlan& p, int i) {
  return i ^ ((i >> p.tile_shift) & p.tile_mask);
}

// The first input of local run `run` of a direct row (the one at its
// place 0): unslot(run * span), run's digits in the global stages' radices
// reversed, < n / span.
__device__ __forceinline__ int large_run_first(const LargePlan& p, int run) {
  const unsigned long long bits = p.passes.radix_bits();
  int first = 0;
  for (int s = p.local; s < p.passes.stages; ++s) {
    const int r = static_cast<int>(bits >> (3 * s)) & 7;
    const int q = div_radix(run, r);
    first = first * r + (run - q * r);
    run = q;
  }
  return first;
}

// Entry i of a run after a register pass: into the tile, or from the last
// pass into the row, unswizzled.
template <bool kLast>
__device__ __forceinline__ void large_run_put(const LargePlan& p, float2* tile,
                                              float2* out, int i, float2 v) {
  if constexpr (kLast) {
    out[i] = v;
  } else {
    tile[large_at(p, i)] = v;
  }
}

// The run's stages 0 (radix R1) and 1 (R2; none for R2 = 1) with the load,
// as MixedRadixT::first_pass runs them: the group of u holds places
// reverse(u) + d, inputs u + e g of the run (g = span / P groups, e = d's
// digit reversal), read through z below `reach` (the run's inputs the
// window reaches; where R1 is even, those of d0 >= R1 / 2 are read only
// where it reaches u + span / 2).  Its twiddles are the run's (`run_tw`).
template <int R1, int R2, bool kLast, class Z>
__device__ __forceinline__ void large_first_pass(const LargePlan& p, float2* tile,
                                                 float2* out, int reach, const Z& z) {
  constexpr int kP = R1 * R2;
  const MixedRadix& runs = p.runs;
  const unsigned long long bits = runs.radix_bits();
  const int g = runs.n / kP;
  const int step = g * p.run_step;
  for (int u = threadIdx.x; u < g; u += blockDim.x) {
    float2 x[kP];
    if constexpr (R1 % 2 == 0) {
      runs.template load_part<R1, R2, 0, R1 / 2>(x, u, g, reach, z);
      if (u + runs.n / 2 < reach) {
        runs.template load_part<R1, R2, R1 / 2, R1>(x, u, g, reach, z);
      } else {
#pragma unroll
        for (int d = 0; d < kP; ++d) {
          if (d % R1 >= R1 / 2) x[d] = make_float2(0.f, 0.f);
        }
      }
    } else {
      runs.template load_part<R1, R2, 0, R1>(x, u, g, reach, z);
    }
    MixedRadix::lower_stage<R1, R2, false>(x, p.run_tw, 0);
    if constexpr (R2 > 1) MixedRadix::upper_stage<R1, R2, false>(x, p.run_tw, 0, 1, step);
    const int base = runs.reverse(u, R2 > 1 ? 2 : 1, bits);
#pragma unroll
    for (int d = 0; d < kP; ++d) large_run_put<kLast>(p, tile, out, base + d, x[d]);
  }
  __syncthreads();
}

// The run's stages s (radix R1) and s+1 (R2; none for R2 = 1) over every
// group, len = L_s, as MixedRadixT::pass runs them (DIT), on the run's
// twiddles (step span / M, M = len P).  Each thread carries its group's
// (b, p) from one group to its next, so no group costs a division.
template <int R1, int R2, bool kLast>
__device__ __forceinline__ void large_run_pass(const LargePlan& p, float2* tile,
                                               float2* out, int len) {
  constexpr int kP = R1 * R2;
  const int m = len * kP;
  const int step2 = p.span / m * p.run_step;
  const int db = blockDim.x / len, dp = blockDim.x - db * len;
  int b = threadIdx.x / len, q = threadIdx.x - b * len;
  for (int u = threadIdx.x; u < p.span / kP; u += blockDim.x) {
    const int base = b * m + q;
    float2 x[kP];
#pragma unroll
    for (int d = 0; d < kP; ++d) x[d] = tile[large_at(p, base + d * len)];
    if constexpr (R2 == 1) {
      twiddled_dft<R1, false>(x, p.run_tw, q * step2);
#pragma unroll
      for (int d = 0; d < kP; ++d) large_run_put<kLast>(p, tile, out, base + d * len, x[d]);
    } else {
      MixedRadix::lower_stage<R1, R2, false>(x, p.run_tw, q * step2 * R2);
#pragma unroll
      for (int e = 0; e < R1; ++e) {
        float2 a[R2];
#pragma unroll
        for (int t = 0; t < R2; ++t) a[t] = x[e + R1 * t];
        twiddled_dft<R2, false>(a, p.run_tw, (q + e * len) * step2);
#pragma unroll
        for (int t = 0; t < R2; ++t) {
          large_run_put<kLast>(p, tile, out, base + (e + R1 * t) * len, a[t]);
        }
      }
    }
    b += db;
    q += dp;
    if (q >= len) {
      q -= len;
      ++b;
    }
  }
  __syncthreads();
}

// Pass 1 of a direct row, run `run` (first input `first`,
// large_run_first): `value(i)` (large_packed_value or large_real_value) of
// inputs first + G m, m < span, through the run's register passes under the
// pass bound kCap (the first within kFirstGroup entries, as the bodies'
// `load_transform`), `tile` (span complex f32 of shared memory) between
// them, the last into run `run` of the row.  The caller's block runs it
// together.
template <int kCap, class Value>
__device__ __forceinline__ void large_load_local(const LargePlan& p, float2* row, int run,
                                                 int first, float2* tile,
                                                 const Value& value) {
  float2* out = row + static_cast<size_t>(run) * p.span;
  const int stages = p.runs.stages;
  const int stride = p.passes.n / p.span;
  if (stages == 0) {
    if (threadIdx.x == 0) out[0] = value(first);
    return;
  }
  // the run's inputs first + stride m that hold samples: m < reach (at
  // least 1, as value() gives zero past the window)
  const int inputs = p.pack ? (p.w + 1) / 2 : p.w;
  int reach = (inputs - first + stride - 1) / stride;
  reach = reach < 1 ? 1 : reach > p.span ? p.span : reach;
  const auto z = [&](int m) { return value(first + stride * m); };
  const unsigned long long bits = p.runs.radix_bits();
  constexpr int kFirst = kCap < kFirstGroup ? kCap : kFirstGroup;
  int s = MixedRadix::pass_stages<kFirst>(bits, 0, stages);
  const int r1 = static_cast<int>(bits) & 7;
  const int r2 = s == 2 ? static_cast<int>(bits >> 3) & 7 : 1;
  MixedRadix::with_radices<kFirst>(r1, r2, [&](auto a, auto b) {
    constexpr int A = decltype(a)::value, B = decltype(b)::value;
    if (s == stages) {
      large_first_pass<A, B, true>(p, tile, out, reach, z);
    } else {
      large_first_pass<A, B, false>(p, tile, out, reach, z);
    }
  });
  int len = r1 * r2;
  while (s < stages) {
    const int q = MixedRadix::pass_stages<kCap>(bits, s, stages);
    const int q1 = static_cast<int>(bits >> (3 * s)) & 7;
    const int q2 = q == 2 ? static_cast<int>(bits >> (3 * s + 3)) & 7 : 1;
    s += q;
    MixedRadix::with_radices<kCap>(q1, q2, [&](auto a, auto b) {
      constexpr int A = decltype(a)::value, B = decltype(b)::value;
      if (s == stages) {
        large_run_pass<A, B, true>(p, tile, out, len);
      } else {
        large_run_pass<A, B, false>(p, tile, out, len);
      }
    });
    len *= q1 * q2;
  }
}

// The register passes `large_load_local` runs over a run under the pass
// bound `cap`, and in *groups the most groups one of them runs.
static inline int large_load_passes(const LargePlan& p, int cap, int* groups) {
  const int* r = p.passes.radix;
  const int first = cap < kFirstGroup ? cap : kFirstGroup;
  int passes = 0, least = p.span;
  for (int s = 0; s < p.local; ++passes) {
    const int pair = s + 1 < p.local && r[s] * r[s + 1] <= (s == 0 ? first : cap);
    const int entries = pair ? r[s] * r[s + 1] : r[s];
    least = entries < least ? entries : least;
    s += 1 + pair;
  }
  *groups = p.span / least;
  return passes;
}

// Pass 1's launch bounds at every span: (kStftMaxThreads, 1), whose 128
// registers hold the (4 4) pairs (`group_cap`).  At N = 65,536 (runs of
// 4^7 entries, one block per SM) pass 1 took 0.66-0.69x the time of
// (kWideThreads, 1), whose 64 registers hold single stages only, seven
// passes over the tile in place of four (PERF.md §6).
using LargeLoadBounds = Bounds<kStftMaxThreads, 1>;

// Pass 1's threads: one per group of its widest pass, in whole warps, at
// most LargeLoadBounds::threads.
static inline int large_load_threads(const LargePlan& p) {
  int groups;
  large_load_passes(p, group_cap<LargeLoadBounds>(), &groups);
  const int threads = (groups + 31) / 32 * 32;
  return threads < 32 ? 32 : threads > LargeLoadBounds::threads ? LargeLoadBounds::threads
                                                                : threads;
}

// Pass 1's form at N and w (the split-real rows with `split`), as the
// kernels launch it: form[0] its register passes over a run, form[1] a
// block's threads; 0 and 0 where N takes Bluestein's passes, which have no
// pass 1.  0, or cudaErrorInvalidValue where the route does not take N and
// w.
static inline int large_pass1_form(int n, int w, bool split, int* form) {
  LargePlan p;
  if (!make_large_plan(n, w, nullptr, &p, kMaxSmemBytes / 8, split)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  form[0] = form[1] = 0;
  if (!p.bluestein) {
    int groups;
    form[0] = large_load_passes(p, group_cap<LargeLoadBounds>(), &groups);
    form[1] = large_load_threads(p);
  }
  return 0;
}

// What pass 2 of a direct row reads of the plan: passed by value, with no
// array indexed at run time, so that a thread keeps it in registers.
struct LargeLast {
  int size;             // the transform's length (passes.n)
  int len;              // size / R: butterflies of the last stage
  int n;                // N
  int bins;             // stft_bins(N, w)
  bool pack;            // split-real: the N/2-point pack's unpack
  const float2* tw;
  const float2* post;
};

static inline LargeLast large_last(const LargePlan& p) {
  const int r = p.passes.radix[p.passes.stages - 1];
  return LargeLast{p.passes.n, p.passes.n / r, p.n, stft_bins(p.n, p.w), p.pack,
                   p.tw, p.post};
}

// fn(std::integral_constant<int, R>) for the last stage's radix R of plan
// p; cudaErrorInvalidValue for a radix the kernels are not built for.
template <class Fn>
static inline int with_last_radix(const LargePlan& p, Fn fn) {
  switch (p.passes.radix[p.passes.stages - 1]) {
    case 2: return fn(std::integral_constant<int, 2>{});
    case 3: return fn(std::integral_constant<int, 3>{});
    case 4: return fn(std::integral_constant<int, 4>{});
    case 5: return fn(std::integral_constant<int, 5>{});
    case 7: return fn(std::integral_constant<int, 7>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Butterflies j and len - j (j <= len / 2) of the last DIT stage, radix R,
// of a row: butterfly j is `butterfly_at`'s of that stage (x = row + j,
// stride len, twiddles tw[q j]), run on a register copy.  It outputs X[j +
// q len], q < R, whose mirror n - k is output R-1-q of butterfly len - j
// (output (R-q) mod R of butterfly 0 for j = 0, which pairs with itself, as
// j = len / 2 does).  fn(k, X[k], X[(n - k) mod n]) for each k of the two.
template <int R, class Fn>
__device__ __forceinline__ void large_last_stage(const LargeLast& p,
                                                 const float2* __restrict__ row,
                                                 int j, const Fn& fn) {
  const int jm = p.len - j;
  const bool pair = j != 0 && jm != j;
  float2 a[R], b[R];
#pragma unroll
  for (int q = 0; q < R; ++q) a[q] = row[j + q * p.len];
  butterfly<R, false>(a, 1, j, p.tw);
  if (pair) {
#pragma unroll
    for (int q = 0; q < R; ++q) b[q] = row[jm + q * p.len];
    butterfly<R, false>(b, 1, jm, p.tw);
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    if (j == 0) {
      fn(q * p.len, a[q], a[(R - q) % R]);
    } else if (!pair) {
      fn(j + q * p.len, a[q], a[R - 1 - q]);
    } else {
      fn(j + q * p.len, a[q], b[R - 1 - q]);
      fn(jm + q * p.len, b[q], a[R - 1 - q]);
    }
  }
}

// Pass 2 of a stereo-packed row: the last stage of pair j, and bins k <
// bins of those outputs into the row's planes out_l, out_r (each bin of a
// row is in exactly one pair).
template <int R, class Out>
__device__ __forceinline__ void large_last_unpack(const LargeLast& p,
                                                  const float2* __restrict__ row,
                                                  int j, Out out_l, Out out_r) {
  large_last_stage<R>(p, row, j, [&](int k, float2 zk, float2 zm) {
    if (k >= p.bins) return;
    float l, r;
    unpack_stereo(zk, zm, &l, &r);
    out_l[k] = l;
    out_r[k] = r;
  });
}

// Pass 2 of a split-real row into its channel's plane `out`: |X[k]| at odd
// N; for the pack, output k < h = size is bin k and its mirror N - k (the
// same |X|, as real_pack_magnitude folds it), and output 0 also gives bin
// h, whose Z[h] is Z[0].
template <int R, class Out>
__device__ __forceinline__ void large_last_magnitude(const LargeLast& p,
                                                     const float2* __restrict__ row,
                                                     int j, Out out) {
  large_last_stage<R>(p, row, j, [&](int k, float2 zk, float2 zm) {
    if (!p.pack) {
      if (k < p.bins) out[k] = magnitude(zk);
      return;
    }
    const float v = real_pack_bin(zk, zm, p.post, p.size, k);
    if (k < p.bins) out[k] = v;
    if (k > 0 && p.n - k < p.bins) out[p.n - k] = v;
    if (k == 0 && p.size < p.bins) out[p.size] = real_pack_bin(zk, zk, p.post, p.size, p.size);
  });
}

// X[k] of a transformed row (the transform's bin k).
__device__ __forceinline__ float2 large_result(const LargePlan& p,
                                               const float2* row, int k) {
  return p.bluestein ? cmul(p.chirp[k], conjugate(row[k])) : row[k];
}

// Bin k (< stft_bins(N, w)) of a packed row into the two planes (the
// unpack as a pass of its own: Bluestein's).
__device__ __forceinline__ void large_unpack(const LargePlan& p,
                                             const float2* row, int k,
                                             float* left, float* right) {
  unpack_stereo(large_result(p, row, k),
                large_result(p, row, k == 0 ? 0 : p.n - k), left, right);
}

// |X[k]| (k < stft_bins(N, w)) of a split-real row.
__device__ __forceinline__ float large_magnitude(const LargePlan& p,
                                                 const float2* row, int k) {
  if (!p.pack) return magnitude(large_result(p, row, k));
  return real_pack_magnitude([&](int t) { return large_result(p, row, t); },
                             p.post, p.size, k);
}

}  // namespace spk
