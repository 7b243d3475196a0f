// Kernel A: the stereo-packed STFT magnitude kernel, power-of-two N.
//
// Replaces spectrogram_tpu/ops/pallas/stft_kernel.py `stft_mag_fused2`
// (packed=True; bodies `_kernel_packed_2d` and `_packed_mag_rows`), with f32
// window planes and with the int16 planes of the i16_planes wire mode (the
// TPU kernel's int16 operand form, 2^-15 folded into the Hann constant).  The
// TPU kernel wrote the DFT as four-step MXU matmuls; here it is an ordinary
// radix-2 FFT in shared memory (stft_fft.cuh, `Radix2`), one thread block per
// window row of the [rows, W] window planes.  Mixed-radix N is stft_mixed.cu.
//
// What bounds it on this card: shared-memory traffic of the log2(N) butterfly
// stages (N=4096: 12 passes over a 32 KB row), not device memory (8 bytes in,
// 4 with int16 samples, and 8 bytes out per sample).  Speed is later work:
// radix-4 stages, twiddles in shared memory and conflict-free bit reversal
// are the obvious next steps.
#include "stft_fft.cuh"

namespace {

template <class T>
__global__ void __launch_bounds__(spk::kStftMaxThreads) stft_packed_kernel(
    const T* __restrict__ left, const T* __restrict__ right,
    const float* __restrict__ hann, const float2* __restrict__ twiddles,
    float* __restrict__ out_l, float* __restrict__ out_r, int w, int log2n) {
  extern __shared__ float2 buf[];
  const size_t row = blockIdx.x;
  const size_t bins = spk::stft_bins(1 << log2n, w);
  spk::stft_packed_row(spk::Radix2{log2n}, left + row * w, right + row * w,
                       hann, twiddles, w, out_l + row * bins,
                       out_r + row * bins, buf);
}

template <class T>
int launch(const T* left, const T* right, const float* hann,
           const void* twiddles, float* out_l, float* out_r, int rows, int w,
           int log2n, void* stream) {
  const int n = 1 << log2n;
  const int e = spk::allow_smem(stft_packed_kernel<T>, n * sizeof(float2));
  if (e != 0) return e;
  stft_packed_kernel<T><<<rows, spk::stft_threads(n), n * sizeof(float2),
                          static_cast<cudaStream_t>(stream)>>>(
      left, right, hann, static_cast<const float2*>(twiddles), out_l, out_r, w,
      log2n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// left, right: [rows, w] f32; hann: [w] f32; twiddles: [N] complex f32
// (exp(-2 pi i t / N)); out_l, out_r: [rows, stft_bins(N, w)] f32.  All
// contiguous.
SPK_EXPORT int spk_stft_packed(const float* left, const float* right,
                               const float* hann, const void* twiddles,
                               float* out_l, float* out_r, int rows, int w,
                               int log2n, void* stream) {
  return launch(left, right, hann, twiddles, out_l, out_r, rows, w, log2n,
                stream);
}

// As spk_stft_packed with int16 planes; hann carries the 2^-15 wire scale.
SPK_EXPORT int spk_stft_packed_i16(const short* left, const short* right,
                                   const float* hann, const void* twiddles,
                                   float* out_l, float* out_r, int rows, int w,
                                   int log2n, void* stream) {
  return launch(left, right, hann, twiddles, out_l, out_r, rows, w, log2n,
                stream);
}

SPK_EXPORT const char* spk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
