// One row of the fused push (push_fused.cu): the split-real STFT of both
// channels into shared memory, then the row's pixels from there.
#pragma once

#include "colormap_common.cuh"
#include "stft_fft.cuh"

namespace spk {

// l, r: the row's [w] samples; tab: its built-in [res*4] table; out: its [h]
// words; mag_l, mag_r: its [stft_bins(N, w)] planes, or null; buf: the
// body's buf_size() complex f32 and planes 2 * stft_bins(N, w) f32, both in
// shared memory; kCap: the kernel's pass bound (`group_cap`).
template <int kCap = kMixedGroup, class Body>
__device__ __forceinline__ void push_fused_row(
    const Body& body, const float* __restrict__ l, const float* __restrict__ r,
    int w, const float* __restrict__ hann, const float2* __restrict__ tw,
    const float* __restrict__ tab, int res, const int* __restrict__ j0,
    const int* __restrict__ j1, const float* __restrict__ w0,
    const float* __restrict__ w1, int h, const ColormapLaws& laws,
    unsigned* __restrict__ out, float* __restrict__ mag_l,
    float* __restrict__ mag_r, float2* buf, float* planes) {
  const int bins = stft_bins(body.size(), w);
  for (int c = 0; c < 2; ++c) {
    stft_real_row<kCap>(body, RowSamples{c ? r : l, w}, hann, tw, planes + c * bins,
                        buf);
    __syncthreads();  // the next load overwrites buf; the pixels read planes
  }
  if (mag_l != nullptr) {
    for (int k = threadIdx.x; k < bins; k += blockDim.x) {
      mag_l[k] = planes[k];
      mag_r[k] = planes[bins + k];
    }
  }
  for (int p = threadIdx.x; p < h; p += blockDim.x) {
    out[p] = colormap_pixel(planes, planes + bins, j0[p], j1[p], w0[p], w1[p],
                            tab, res, laws);
  }
}

// The table's rule for a fused-push block of `smem` bytes (push_fused.cu):
// kLaunchRows where it fits kRowBlocks times in an SM's shared memory, else
// kLaunchWide.
static inline int push_bounds_rule(size_t smem) {
  return smem * kRowBlocks <= static_cast<size_t>(kMaxSmemBytes) ? kLaunchRows
                                                                 : kLaunchWide;
}

// fn(bounds, threads) with the launch bounds of a fused-push block over
// `row` (`smem` bytes: the FFT buffer and both planes) that `choice` names
// (stft_fft.cuh kLaunchTable: `push_bounds_rule`; kLaunchRows or
// kLaunchWide, the two the kernel instantiates) and its threads
// (`body_threads` under the bounds' `group_cap`, at most bounds.threads);
// cudaErrorInvalidValue for any other choice or where the block does not
// fit an SM's shared memory.
template <class Row, class Fn>
static inline int with_push_bounds(const Row& row, size_t smem, Fn fn,
                                   int choice = kLaunchTable) {
  if (smem > static_cast<size_t>(kMaxSmemBytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto launch = [&](auto bounds) {
    using B = decltype(bounds);
    const int threads = body_threads(row, group_cap<B>());
    return fn(bounds, threads < B::threads ? threads : B::threads);
  };
  switch (choice == kLaunchTable ? push_bounds_rule(smem) : choice) {
    case kLaunchRows:
      return launch(Bounds<kRowThreads, kRowBlocks>{});
    case kLaunchWide:
      return launch(Bounds<kStftMaxThreads, 1>{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace spk
