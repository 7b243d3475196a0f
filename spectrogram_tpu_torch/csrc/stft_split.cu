// The split-real STFT kernels: each channel of each window as its own FFT of
// real input, |DFT_N(x * hann)| for bins 0 .. B-1 (B = stft_bins(N, W)), in
// five operand layouts.
//
// Replace spectrogram_tpu/ops/pallas/stft_kernel.py
//   spk_stft_split         `stft_mag_fused2(packed=False)` (bodies
//                          `_kernel2_2d`, `_kernel2`, `_fft_mag_value`):
//                          [rows, W] window planes x2 -> [rows, B] x2
//   spk_stft_split_allk    `stft_mag_fused2_allk(packed=False)` (body
//                          `_allk_kernel`): the k windows buf[s, r*hop :
//                          r*hop + W] of [S, ld] buffers -> row r*S + s
//   spk_stft_split_t       `stft_mag_fused2_t` (body `_kernel2_t`): the
//                          combined transposed operand [rows, 2, n1, m],
//                          x[n, c, j1, t] = sample t*n1 + j1 of channel c
//   spk_stft_split_tsplit  `stft_mag_fused2_tsplit` (body `_tsplit_kernel`):
//                          carry [rows, 2, n1, c_cols] + chunk [rows, 2, n1,
//                          t_cols] -> the magnitudes and the next carry
//   spk_stft_split_carry   `stft_mag_fused2_split` (body `_split_kernel`):
//                          the planar carry [S, 2, C] + chunk [S, 2, k*hop]
//                          -> the k windows' magnitudes, row r*S + s, and the
//                          next carry [S, 2, C], never concatenating them
//   spk_stft_split_allk_carry  `stft_mag_fused2_allk(packed=False,
//                          emit_carry=True)`: spk_stft_split_allk, and the
//                          last C samples of each buffer as [S, 2, C]
// The TPU bodies ran a four-step matrix-unit FFT; here one thread block per
// (window, channel) runs `stft_real_row` (stft_fft.cuh) with the layout's
// sample source.  At even N the row is the N/2-point real-FFT pack: the
// window's samples pair up as x[2t] + i x[2t+1] in an N/2-entry buffer, the
// shared FFT body of N/2 (Radix2, MixedRadix or Bluestein) transforms it,
// and each bin is unpacked with the N/2 post-twiddles exp(-2 pi i k / N);
// odd N runs the N-point body on (x, 0).  The radix-2 and mixed-radix
// bodies read the samples straight from the layout into their first pass.
// The layouts differ only in where a sample is read, so for the same window
// they give the same bits; the kernels with a next carry write it from the
// blocks of window 0, one channel each.  Output rows are stft_bins(N, W)
// wide.
//
// What bounds them on this card: shared-memory traffic of the butterfly
// stages, as the packed kernels: one N/2-point transform per channel, so a
// window's two channels cost what the packed kernels' one N-point transform
// costs, and the row's buffer is N/2 complex f32 (16 KB at N = 4096; 192 KB
// at N = 48,000, which still fits a block: the split-real rows leave the
// large-N route below N/2 = 29,056 for a direct N/2).  Device memory moves 4
// bytes in and 4 out per sample and channel (with a next carry: 4 more per
// carry sample).
#include <type_traits>

#include "stft_fft.cuh"

namespace {

SPK_BOUNDED_KERNEL(stft_split_kernel, (
    Body body, const float* __restrict__ left, const float* __restrict__ right,
    const float* __restrict__ hann, const float2* __restrict__ twiddles,
    float* __restrict__ out_l, float* __restrict__ out_r, int w), {
  extern __shared__ float2 buf[];
  const size_t row = blockIdx.x >> 1;
  const int c = blockIdx.x & 1;
  const spk::RowSamples src{(c ? right : left) + row * w, w};
  spk::stft_real_row<spk::group_cap<Bounds>()>(body, src, hann, twiddles,
                     (c ? out_r : out_l) + row * spk::stft_bins(body.size(), w),
                     buf);
})

SPK_BOUNDED_KERNEL(stft_split_allk_kernel, (
    Body body, const float* __restrict__ buf_l, const float* __restrict__ buf_r,
    const float* __restrict__ hann, const float2* __restrict__ twiddles,
    float* __restrict__ out_l, float* __restrict__ out_r,
    float* __restrict__ next, int streams, int ld, int hop, int w, int c_len), {
  extern __shared__ float2 buf[];
  const int row = blockIdx.x >> 1;
  const int c = blockIdx.x & 1;
  const int s = row % streams;
  const float* b = (c ? buf_r : buf_l) + static_cast<size_t>(s) * ld;
  if (next != nullptr && row < streams) {
    spk::buffer_tail(b, next + (static_cast<size_t>(s) * 2 + c) * c_len, ld,
                     c_len);
  }
  const spk::RowSamples src{b + static_cast<size_t>(row / streams) * hop, w};
  spk::stft_real_row<spk::group_cap<Bounds>()>(body, src, hann, twiddles,
                     (c ? out_r : out_l) + static_cast<size_t>(row) *
                                               spk::stft_bins(body.size(), w),
                     buf);
})

// The k windows of carry [S, 2, c_len] + chunk [S, 2, t_len] (t_len = k*hop),
// one (window, channel) per block, and the next carry from window 0's blocks.
SPK_BOUNDED_KERNEL(stft_split_carry_kernel, (
    Body body, const float* __restrict__ carry, const float* __restrict__ chunk,
    const float* __restrict__ hann, const float2* __restrict__ twiddles,
    float* __restrict__ out_l, float* __restrict__ out_r,
    float* __restrict__ next, int streams, int c_len, int t_len, int hop,
    int w), {
  extern __shared__ float2 buf[];
  const int row = blockIdx.x >> 1;
  const int c = blockIdx.x & 1;
  const size_t sc = static_cast<size_t>(row % streams) * 2 + c;
  const float* ca = carry + sc * c_len;
  const float* ch = chunk + sc * t_len;
  if (row < streams) {
    spk::planar_next_carry(ca, ch, next + sc * c_len, c_len, t_len);
  }
  const spk::PlanarSamples src{ca, ch, c_len, (row / streams) * hop, w};
  spk::stft_real_row<spk::group_cap<Bounds>()>(body, src, hann, twiddles,
                     (c ? out_r : out_l) + static_cast<size_t>(row) *
                                               spk::stft_bins(body.size(), w),
                     buf);
})

SPK_BOUNDED_KERNEL(stft_split_t_kernel, (
    Body body, const float* __restrict__ x, const float* __restrict__ hann,
    const float2* __restrict__ twiddles, float* __restrict__ out_l,
    float* __restrict__ out_r, int n1, int m), {
  extern __shared__ float2 buf[];
  const size_t row = blockIdx.x >> 1;
  const int c = blockIdx.x & 1;
  const spk::TransposedSamples src{x + blockIdx.x * static_cast<size_t>(n1) * m,
                                   n1, m};
  spk::stft_real_row<spk::group_cap<Bounds>()>(body, src, hann, twiddles,
                     (c ? out_r : out_l) + row * spk::stft_bins(body.size(), n1 * m),
                     buf);
})

SPK_BOUNDED_KERNEL(stft_split_tsplit_kernel, (
    Body body, const float* __restrict__ carry, const float* __restrict__ chunk,
    const float* __restrict__ hann, const float2* __restrict__ twiddles,
    float* __restrict__ out_l, float* __restrict__ out_r,
    float* __restrict__ next_carry, int n1, int c_cols, int t_cols), {
  extern __shared__ float2 buf[];
  const size_t row = blockIdx.x >> 1;
  const int c = blockIdx.x & 1;
  const size_t in_carry = blockIdx.x * static_cast<size_t>(n1) * c_cols;
  const size_t in_chunk = blockIdx.x * static_cast<size_t>(n1) * t_cols;
  const spk::SplitSamples src{carry + in_carry, chunk + in_chunk, n1, c_cols,
                              t_cols};
  spk::split_next_carry(carry + in_carry, chunk + in_chunk,
                        next_carry + in_carry, n1, c_cols, t_cols);
  spk::stft_real_row<spk::group_cap<Bounds>()>(body, src, hann, twiddles,
                     (c ? out_r : out_l) +
                         row * spk::stft_bins(body.size(), src.size()),
                     buf);
})

// launch(row, bound, grid, threads, smem, stream) with the split-real row
// form of N (`with_real_body`), 2 * rows blocks, one per (window row,
// channel), and the kernel's launch bounds as a type (`spk::Bounds`, threads
// and blocks per SM) and its threads as `choice` names them
// (stft_fft.cuh `with_split_bounds`: kLaunchTable takes the table's rule,
// `split_bounds_rule`; kLaunchRows, kLaunchWide and kLaunchNarrow the
// bounds they name, every one of which each row form instantiates).
template <class Launch>
int launch_rows(int n, const void* consts, int rows, int choice, void* stream,
                Launch launch) {
  const auto st = static_cast<cudaStream_t>(stream);
  return spk::with_real_body(n, consts, [&](auto body) {
    const size_t smem = body.buf_size() * sizeof(float2);
    return spk::with_split_bounds(body, [&](auto bound, int threads) {
      return launch(body, bound, dim3(2 * rows), threads, smem, st);
    }, choice);
  });
}

}  // namespace

// Each entry: hann [w] f32 (2/W folded in); consts: n's split-real table
// (`split_fft_table`); out_l, out_r: [rows, stft_bins(n, w)] f32.  All
// contiguous.  choice: the launch bounds (`launch_rows`).

// left, right: [rows, w] f32 window planes.
SPK_EXPORT int spk_stft_split(const float* left, const float* right,
                              const float* hann, const void* consts,
                              float* out_l, float* out_r, int rows, int w,
                              int n, int choice, void* stream) {
  const auto* tw = static_cast<const float2*>(consts);
  return launch_rows(n, consts, rows, choice, stream,
                     [&](auto body, auto bound, dim3 grid, int threads,
                         size_t smem, cudaStream_t st) {
    const auto kernel = stft_split_kernel_for<decltype(body), decltype(bound)>();
    const int e = spk::allow_smem(kernel, smem);
    if (e != 0) return e;
    kernel<<<grid, threads, smem, st>>>(
        body, left, right, hann, tw, out_l, out_r, w);
    return static_cast<int>(cudaGetLastError());
  });
}

// buf_l, buf_r: [streams, ld] f32 with ld >= w + (k-1)*hop; rows r*streams
// + s for window r of stream s.
static int split_allk(const float* buf_l, const float* buf_r,
                      const float* hann, const void* consts, float* out_l,
                      float* out_r, float* next, int streams, int ld, int k,
                      int hop, int w, int n, int c_len, int choice,
                      void* stream) {
  const auto* tw = static_cast<const float2*>(consts);
  return launch_rows(n, consts, k * streams, choice, stream,
                     [&](auto body, auto bound, dim3 grid, int threads,
                         size_t smem, cudaStream_t st) {
    const auto kernel = stft_split_allk_kernel_for<decltype(body), decltype(bound)>();
    const int e = spk::allow_smem(kernel, smem);
    if (e != 0) return e;
    kernel<<<grid, threads, smem, st>>>(
        body, buf_l, buf_r, hann, tw, out_l, out_r, next, streams, ld, hop, w,
        c_len);
    return static_cast<int>(cudaGetLastError());
  });
}

SPK_EXPORT int spk_stft_split_allk(const float* buf_l, const float* buf_r,
                                   const float* hann, const void* consts,
                                   float* out_l, float* out_r, int streams,
                                   int ld, int k, int hop, int w, int n,
                                   int choice, void* stream) {
  return split_allk(buf_l, buf_r, hann, consts, out_l, out_r, nullptr,
                    streams, ld, k, hop, w, n, 0, choice, stream);
}

// As spk_stft_split_allk, and next: [streams, 2, c_len] f32, the last c_len
// samples of each buffer, not aliasing the buffers.
SPK_EXPORT int spk_stft_split_allk_carry(const float* buf_l,
                                         const float* buf_r,
                                         const float* hann, const void* consts,
                                         float* out_l, float* out_r,
                                         float* next, int streams, int ld,
                                         int k, int hop, int w, int n,
                                         int c_len, int choice,
                                         void* stream) {
  return split_allk(buf_l, buf_r, hann, consts, out_l, out_r, next, streams,
                    ld, k, hop, w, n, c_len, choice, stream);
}

// carry: [streams, 2, c_len] f32 and chunk: [streams, 2, k*hop] f32, each
// stream's buffer samples 0 .. c_len-1 and c_len .. c_len + k*hop - 1, with
// c_len + hop >= w; rows r*streams + s for window r (buffer samples r*hop ..
// r*hop + w - 1) of stream s; next: [streams, 2, c_len] f32, the last c_len
// samples of carry + chunk, not aliasing the inputs.
SPK_EXPORT int spk_stft_split_carry(const float* carry, const float* chunk,
                                    const float* hann, const void* consts,
                                    float* out_l, float* out_r, float* next,
                                    int streams, int c_len, int k, int hop,
                                    int w, int n, int choice, void* stream) {
  const auto* tw = static_cast<const float2*>(consts);
  return launch_rows(n, consts, k * streams, choice, stream,
                     [&](auto body, auto bound, dim3 grid, int threads,
                         size_t smem, cudaStream_t st) {
    const auto kernel = stft_split_carry_kernel_for<decltype(body), decltype(bound)>();
    const int e = spk::allow_smem(kernel, smem);
    if (e != 0) return e;
    kernel<<<grid, threads, smem, st>>>(
        body, carry, chunk, hann, tw, out_l, out_r, next, streams, c_len,
        k * hop, hop, w);
    return static_cast<int>(cudaGetLastError());
  });
}

// x: [rows, 2, n1, m] f32, x[r, c, j1, t] = window sample t*n1 + j1 of
// channel c (w = n1*m).
SPK_EXPORT int spk_stft_split_t(const float* x, const float* hann,
                                const void* consts, float* out_l,
                                float* out_r, int rows, int n1, int m, int n,
                                int choice, void* stream) {
  const auto* tw = static_cast<const float2*>(consts);
  return launch_rows(n, consts, rows, choice, stream,
                     [&](auto body, auto bound, dim3 grid, int threads,
                         size_t smem, cudaStream_t st) {
    const auto kernel = stft_split_t_kernel_for<decltype(body), decltype(bound)>();
    const int e = spk::allow_smem(kernel, smem);
    if (e != 0) return e;
    kernel<<<grid, threads, smem, st>>>(
        body, x, hann, tw, out_l, out_r, n1, m);
    return static_cast<int>(cudaGetLastError());
  });
}

// carry: [rows, 2, n1, c_cols] f32 and chunk: [rows, 2, n1, t_cols] f32, the
// window's columns 0 .. c_cols-1 and c_cols .. c_cols+t_cols-1 in the
// transposed layout (w = n1*(c_cols+t_cols)); next_carry: [rows, 2, n1,
// c_cols] f32, not aliasing the inputs.
SPK_EXPORT int spk_stft_split_tsplit(const float* carry, const float* chunk,
                                     const float* hann, const void* consts,
                                     float* out_l, float* out_r,
                                     float* next_carry, int rows, int n1,
                                     int c_cols, int t_cols, int n,
                                     int choice, void* stream) {
  const auto* tw = static_cast<const float2*>(consts);
  return launch_rows(n, consts, rows, choice, stream,
                     [&](auto body, auto bound, dim3 grid, int threads,
                         size_t smem, cudaStream_t st) {
    const auto kernel = stft_split_tsplit_kernel_for<decltype(body), decltype(bound)>();
    const int e = spk::allow_smem(kernel, smem);
    if (e != 0) return e;
    kernel<<<grid, threads, smem, st>>>(
        body, carry, chunk, hann, tw, out_l, out_r, next_carry, n1, c_cols,
        t_cols);
    return static_cast<int>(cudaGetLastError());
  });
}
