// The split-real STFT kernels: each channel of each window as its own FFT of
// real input, |DFT_N(x * hann)| for bins 0 .. N/2-1, in four operand layouts.
//
// Replace spectrogram_tpu/ops/pallas/stft_kernel.py
//   spk_stft_split         `stft_mag_fused2(packed=False)` (bodies
//                          `_kernel2_2d`, `_kernel2`, `_fft_mag_value`):
//                          [rows, W] window planes x2 -> [rows, N/2] x2
//   spk_stft_split_allk    `stft_mag_fused2_allk(packed=False)` (body
//                          `_allk_kernel`): the k windows buf[s, r*hop :
//                          r*hop + W] of [S, ld] buffers -> row r*S + s
//   spk_stft_split_t       `stft_mag_fused2_t` (body `_kernel2_t`): the
//                          combined transposed operand [rows, 2, n1, m],
//                          x[n, c, j1, t] = sample t*n1 + j1 of channel c
//   spk_stft_split_tsplit  `stft_mag_fused2_tsplit` (body `_tsplit_kernel`):
//                          carry [rows, 2, n1, c_cols] + chunk [rows, 2, n1,
//                          t_cols] -> the magnitudes and the next carry
// The TPU bodies ran a four-step matrix-unit FFT; here one thread block per
// (window, channel) runs the shared FFT bodies of stft_fft.cuh (Radix2 for
// power-of-two N, MixedRadix for 2^a 3^b 5^c) on the real window, through
// `stft_real_row` with the layout's sample source.  The four layouts differ
// only in where a sample is read, so for the same window they give the same
// bits; the tsplit kernel also writes its channel's next carry.
//
// What bounds them on this card: shared-memory traffic of the butterfly
// stages, as the packed kernels, here twice over: one complex FFT per
// channel where the packed kernels run one for both (the N/2-point real-FFT
// pack would halve it; that is later work).  Device memory moves 4 bytes in
// and 4 out per sample and channel (tsplit: 4 more per carry sample).
#include "stft_fft.cuh"

namespace {

template <class Body>
__global__ void __launch_bounds__(spk::kStftMaxThreads) stft_split_kernel(
    Body body, const float* __restrict__ left, const float* __restrict__ right,
    const float* __restrict__ hann, const float2* __restrict__ twiddles,
    float* __restrict__ out_l, float* __restrict__ out_r, int w) {
  extern __shared__ float2 buf[];
  const size_t row = blockIdx.x >> 1;
  const int c = blockIdx.x & 1;
  const spk::RowSamples src{(c ? right : left) + row * w, w};
  spk::stft_real_row(body, src, hann, twiddles,
                     (c ? out_r : out_l) + row * (body.size() / 2), buf);
}

template <class Body>
__global__ void __launch_bounds__(spk::kStftMaxThreads) stft_split_allk_kernel(
    Body body, const float* __restrict__ buf_l, const float* __restrict__ buf_r,
    const float* __restrict__ hann, const float2* __restrict__ twiddles,
    float* __restrict__ out_l, float* __restrict__ out_r, int streams, int ld,
    int hop, int w) {
  extern __shared__ float2 buf[];
  const int row = blockIdx.x >> 1;
  const int c = blockIdx.x & 1;
  const size_t at = static_cast<size_t>(row % streams) * ld +
                    static_cast<size_t>(row / streams) * hop;
  const spk::RowSamples src{(c ? buf_r : buf_l) + at, w};
  spk::stft_real_row(body, src, hann, twiddles,
                     (c ? out_r : out_l) +
                         static_cast<size_t>(row) * (body.size() / 2),
                     buf);
}

template <class Body>
__global__ void __launch_bounds__(spk::kStftMaxThreads) stft_split_t_kernel(
    Body body, const float* __restrict__ x, const float* __restrict__ hann,
    const float2* __restrict__ twiddles, float* __restrict__ out_l,
    float* __restrict__ out_r, int n1, int m) {
  extern __shared__ float2 buf[];
  const size_t row = blockIdx.x >> 1;
  const int c = blockIdx.x & 1;
  const spk::TransposedSamples src{x + blockIdx.x * static_cast<size_t>(n1) * m,
                                   n1, m};
  spk::stft_real_row(body, src, hann, twiddles,
                     (c ? out_r : out_l) + row * (body.size() / 2), buf);
}

template <class Body>
__global__ void __launch_bounds__(spk::kStftMaxThreads) stft_split_tsplit_kernel(
    Body body, const float* __restrict__ carry, const float* __restrict__ chunk,
    const float* __restrict__ hann, const float2* __restrict__ twiddles,
    float* __restrict__ out_l, float* __restrict__ out_r,
    float* __restrict__ next_carry, int n1, int c_cols, int t_cols) {
  extern __shared__ float2 buf[];
  const size_t row = blockIdx.x >> 1;
  const int c = blockIdx.x & 1;
  const size_t in_carry = blockIdx.x * static_cast<size_t>(n1) * c_cols;
  const size_t in_chunk = blockIdx.x * static_cast<size_t>(n1) * t_cols;
  const spk::SplitSamples src{carry + in_carry, chunk + in_chunk, n1, c_cols,
                              t_cols};
  spk::split_next_carry(carry + in_carry, chunk + in_chunk,
                        next_carry + in_carry, n1, c_cols, t_cols);
  spk::stft_real_row(body, src, hann, twiddles,
                     (c ? out_r : out_l) + row * (body.size() / 2), buf);
}

// launch(body, grid, threads, smem, stream) with the FFT body N selects and
// 2 * rows blocks, one per (window row, channel); 0 or the CUDA error.
template <class Launch>
int launch_rows(int n, int rows, void* stream, Launch launch) {
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(2 * rows);
  const int threads = spk::stft_threads(n);
  const size_t smem = n * sizeof(float2);
  if ((n & (n - 1)) == 0) {
    int log2n = 0;
    while ((1 << log2n) < n) ++log2n;
    return launch(spk::Radix2{log2n}, grid, threads, smem, st);
  }
  spk::MixedRadix body;
  if (!spk::make_mixed_radix(n, &body)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(body, grid, threads, smem, st);
}

}  // namespace

// left, right: [rows, w] f32; hann: [w] f32 (2/W folded in); twiddles: [n]
// complex f32 (exp(-2 pi i t / n)); out_l, out_r: [rows, n/2] f32.  All
// contiguous.
SPK_EXPORT int spk_stft_split(const float* left, const float* right,
                              const float* hann, const void* twiddles,
                              float* out_l, float* out_r, int rows, int w,
                              int n, void* stream) {
  const auto* tw = static_cast<const float2*>(twiddles);
  return launch_rows(n, rows, stream, [&](auto body, dim3 grid, int threads,
                                          size_t smem, cudaStream_t st) {
    const int e = spk::allow_smem(stft_split_kernel<decltype(body)>, n);
    if (e != 0) return e;
    stft_split_kernel<decltype(body)><<<grid, threads, smem, st>>>(
        body, left, right, hann, tw, out_l, out_r, w);
    return static_cast<int>(cudaGetLastError());
  });
}

// buf_l, buf_r: [streams, ld] f32 with ld >= w + (k-1)*hop; out_l, out_r:
// [k*streams, n/2] f32, row r*streams + s for window r of stream s.
SPK_EXPORT int spk_stft_split_allk(const float* buf_l, const float* buf_r,
                                   const float* hann, const void* twiddles,
                                   float* out_l, float* out_r, int streams,
                                   int ld, int k, int hop, int w, int n,
                                   void* stream) {
  const auto* tw = static_cast<const float2*>(twiddles);
  return launch_rows(n, k * streams, stream, [&](auto body, dim3 grid,
                                                 int threads, size_t smem,
                                                 cudaStream_t st) {
    const int e = spk::allow_smem(stft_split_allk_kernel<decltype(body)>, n);
    if (e != 0) return e;
    stft_split_allk_kernel<decltype(body)><<<grid, threads, smem, st>>>(
        body, buf_l, buf_r, hann, tw, out_l, out_r, streams, ld, hop, w);
    return static_cast<int>(cudaGetLastError());
  });
}

// x: [rows, 2, n1, m] f32, x[r, c, j1, t] = window sample t*n1 + j1 of
// channel c; hann: [n1*m] f32; out_l, out_r: [rows, n/2] f32.
SPK_EXPORT int spk_stft_split_t(const float* x, const float* hann,
                                const void* twiddles, float* out_l,
                                float* out_r, int rows, int n1, int m, int n,
                                void* stream) {
  const auto* tw = static_cast<const float2*>(twiddles);
  return launch_rows(n, rows, stream, [&](auto body, dim3 grid, int threads,
                                          size_t smem, cudaStream_t st) {
    const int e = spk::allow_smem(stft_split_t_kernel<decltype(body)>, n);
    if (e != 0) return e;
    stft_split_t_kernel<decltype(body)><<<grid, threads, smem, st>>>(
        body, x, hann, tw, out_l, out_r, n1, m);
    return static_cast<int>(cudaGetLastError());
  });
}

// carry: [rows, 2, n1, c_cols] f32 and chunk: [rows, 2, n1, t_cols] f32, the
// window's columns 0 .. c_cols-1 and c_cols .. c_cols+t_cols-1 in the
// transposed layout; hann: [n1*(c_cols+t_cols)] f32; out_l, out_r: [rows,
// n/2] f32; next_carry: [rows, 2, n1, c_cols] f32, not aliasing the inputs.
SPK_EXPORT int spk_stft_split_tsplit(const float* carry, const float* chunk,
                                     const float* hann, const void* twiddles,
                                     float* out_l, float* out_r,
                                     float* next_carry, int rows, int n1,
                                     int c_cols, int t_cols, int n,
                                     void* stream) {
  const auto* tw = static_cast<const float2*>(twiddles);
  return launch_rows(n, rows, stream, [&](auto body, dim3 grid, int threads,
                                          size_t smem, cudaStream_t st) {
    const int e = spk::allow_smem(stft_split_tsplit_kernel<decltype(body)>, n);
    if (e != 0) return e;
    stft_split_tsplit_kernel<decltype(body)><<<grid, threads, smem, st>>>(
        body, carry, chunk, hann, tw, out_l, out_r, next_carry, n1, c_cols,
        t_cols);
    return static_cast<int>(cudaGetLastError());
  });
}
