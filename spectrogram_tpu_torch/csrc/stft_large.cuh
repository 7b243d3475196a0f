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
// the transform (direct) or of M (Bluestein) run as passes over every row:
//
//   load     z into the row in the plan's input order: the stereo pack
//            (l + i r) * hann; one real channel's pack x[2t] h[2t] +
//            i x[2t+1] h[2t+1] (N/2 entries, even N), or (x * hann, 0)
//            (odd N); zero-padded to the transform's length; Bluestein also
//            multiplies by the chirp and zero-pads to M.  Each entry
//            gathers its samples (`unslot`, the inverse digit reversal), so
//            the row's writes stay in order
//   local    stage s combines entries within runs of r_0 ... r_s contiguous
//            entries, so the first `local` stages (their span, r_0 ...
//            r_{local-1}, at most a block's shared memory) act within each
//            run of `span` entries: one pass moves each run into shared
//            memory, runs those stages there (`large_local`) and writes it
//            back; Bluestein runs its DIF stages, the pointwise product
//            with the filter's transform (stored in the DIF output order)
//            and its DIT stages in this one pass
//   global   each remaining stage (one for every N this route takes) as its
//            own pass, each thread one butterfly; Bluestein's DIF ones
//            before the local pass, its DIT ones after
//   result   X[k]: the row's entry k (direct, natural order after DIT), or
//            c[k] conj(row[k]) (Bluestein), into stft_fft.cuh's stereo
//            unpack or split-real unpack (`real_pack_magnitude`, or the
//            magnitude at odd N), so packed and split-real rows follow one
//            law at every N
//
// Every butterfly is the shared-memory bodies' own step (`butterfly_at`,
// with the full transform's twiddles), and the chirp and filter products
// are theirs, run in their order, so the grouping into passes changes no
// bit.
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
  const float2* tw;       // passes.n twiddles exp(-2 pi i t / passes.n)
  const float2* chirp;    // Bluestein: [size] c[t] = exp(-i pi t^2 / size)
  const float2* filter;   // Bluestein: [M] F in the DIF output order
  const float2* post;     // pack: [N/2] exp(-2 pi i k / N)

  __host__ __device__ __forceinline__ int buf_size() const { return passes.n; }
};

// The plan of N over its table `consts` (`fft_table`, or `split_fft_table`
// with `split`: then an even N runs the N/2-point pack), with as many local
// stages as fit `max_span` entries of shared memory, leaving at least one
// global stage; false where N < 2, w is not in 1 .. N, or no mixed-radix
// plan of the transform or of M exists.
static inline bool make_large_plan(int n, int w, const void* consts,
                                   LargePlan* plan,
                                   int max_span = kMaxSmemBytes / 8,
                                   bool split = false) {
  if (n < 2 || w < 1 || w > n) return false;
  const auto* table = static_cast<const float2*>(consts);
  plan->n = n;
  plan->w = w;
  plan->pack = split && real_packs(n);
  plan->size = plan->pack ? n / 2 : n;
  plan->tw = table;
  plan->chirp = plan->filter = plan->post = nullptr;
  plan->bluestein = !make_mixed_radix(plan->size, &plan->passes);
  int table_size = plan->size;
  if (plan->bluestein) {
    const int m = bluestein_length(plan->size);
    if (!make_mixed_radix(m, &plan->passes)) return false;
    plan->chirp = table + m;
    plan->filter = table + m + plan->size;
    table_size = 2 * m + plan->size;
  }
  if (plan->pack) plan->post = table + table_size;
  const MixedRadix& r = plan->passes;
  plan->local = 0;
  plan->span = 1;
  while (plan->local + 1 < r.stages &&
         plan->span * r.radix[plan->local] <= max_span) {
    plan->span *= r.radix[plan->local++];
  }
  return true;
}

// The entry j (< buf_size()) of a row holds transform input large_source(j):
// the digit-reversed input order of the direct DIT stages (the inverse of
// `slot`), or j itself for Bluestein.
__device__ __forceinline__ int large_source(const LargePlan& p, int j) {
  return p.bluestein ? j : p.passes.unslot(j);
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

// The stereo-packed load of entry j: (l + i r) * hann, f32 or int16 samples
// (int16: `hann` carries the 2^-15 wire scale, as in stft_packed_row).
template <class T>
__device__ __forceinline__ void large_load_packed(
    const LargePlan& p, const T* __restrict__ l, const T* __restrict__ r,
    const float* __restrict__ hann, float2* row, int j) {
  const int i = large_source(p, j);
  float2 z = make_float2(0.f, 0.f);
  if (i < p.w) {
    const float h = hann[i];
    z = make_float2(__fmul_rn(static_cast<float>(l[i]), h),
                    __fmul_rn(static_cast<float>(r[i]), h));
  }
  large_put(p, row, j, i, z);
}

// The split-real load of entry j: the pack (x[2i] hann[2i], x[2i+1]
// hann[2i+1]) of input i, or (x[i] hann[i], 0) at odd N.
__device__ __forceinline__ void large_load_real(const LargePlan& p,
                                                const float* __restrict__ x,
                                                const float* __restrict__ hann,
                                                float2* row, int j) {
  const int i = large_source(p, j);
  const auto at = [&](int q) { return q < p.w ? __fmul_rn(x[q], hann[q]) : 0.f; };
  large_put(p, row, j, i,
            p.pack ? make_float2(at(2 * i), at(2 * i + 1)) : make_float2(at(i), 0.f));
}

// The passes between the load and the result, in order: fn(kind, stage,
// len) for each, with kind kLargeDif or kLargeDit (global stage s of
// sub-transforms of length len, butterflies 0 .. passes.n / radix[s] - 1)
// or kLargeLocal (the shared-memory pass, runs 0 .. passes.n / span - 1);
// 0, or the first nonzero fn returned.
enum LargePass { kLargeDit = 0, kLargeDif = 1, kLargeLocal = 2 };

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
  if (const int e = fn(kLargeLocal, 0, 0)) return e;
  int len = p.span;
  for (int s = p.local; s < r.stages; ++s) {
    if (const int e = fn(kLargeDit, s, len)) return e;
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

// Units of a pass per row: butterflies, or local runs.
__host__ __device__ __forceinline__ int large_pass_count(const LargePlan& p,
                                                         int kind, int s) {
  return kind == kLargeLocal ? p.passes.n / p.span
                             : p.passes.n / p.passes.radix[s];
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

// The local pass over run `run` of a row, through `tile` (span complex f32 of
// shared memory): Bluestein's DIF stages local-1 .. 0 and filter product,
// then the DIT stages 0 .. local-1.  The caller's block runs it together.
__device__ __forceinline__ void large_local(const LargePlan& p, float2* row,
                                            int run, float2* tile) {
  float2* at = row + static_cast<size_t>(run) * p.span;
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
  int len = 1;
  for (int s = 0; s < p.local; ++s) {
    large_local_stage<false>(p, tile, s, len);
    len *= p.passes.radix[s];
  }
  for (int i = threadIdx.x; i < p.span; i += blockDim.x) at[i] = tile[i];
  __syncthreads();
}

// X[k] of a transformed row (the transform's bin k).
__device__ __forceinline__ float2 large_result(const LargePlan& p,
                                               const float2* row, int k) {
  return p.bluestein ? cmul(p.chirp[k], conjugate(row[k])) : row[k];
}

// Bin k (< stft_bins(N, w)) of a packed row into the two planes.
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
