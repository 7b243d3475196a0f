// Kernel A at mixed radix: the stereo-packed STFT magnitudes for
// N = 2^a 3^b 5^c (the reference geometry's N = 4800 = 2^6 3 5^2).
//
// Replaces spectrogram_tpu/ops/pallas/stft_kernel.py `stft_mag_fused2`
// (packed=True) at the sizes the TPU ran through its lane-padded four-step
// plan (`lane_pad`, 48x100 at N=4800).  One thread block per window row of
// the [rows, W] window planes runs the digit-reversed radix-4/2/3/5 DIT of
// stft_fft.cuh (`MixedRadix`) in shared memory: 38.4 KB at N=4800, above
// 48 KB (N > 6144) by the opt-in attribute.  Same load and unpack as the
// power-of-two kernel (stft_packed.cu), which keeps power-of-two N.
//
// What bounds it on this card: shared-memory traffic and the integer index
// arithmetic of its stages (N=4800: six passes, 4-4-4-3-5-5, over a 38.4 KB
// row), not device memory (8 bytes in and 8 out per sample).  Radix-8/16
// stages with register-resident butterflies would cut the passes; that is
// later work.
#include "stft_fft.cuh"

namespace {

__global__ void __launch_bounds__(spk::kStftMaxThreads) stft_mixed_kernel(
    spk::MixedRadix body, const float* __restrict__ left,
    const float* __restrict__ right, const float* __restrict__ hann,
    const float2* __restrict__ twiddles, float* __restrict__ out_l,
    float* __restrict__ out_r, int w) {
  extern __shared__ float2 buf[];
  const size_t row = blockIdx.x;
  const size_t half = body.n / 2;
  spk::stft_packed_row(body, left + row * w, right + row * w, hann, twiddles,
                       w, out_l + row * half, out_r + row * half, buf);
}

}  // namespace

// left, right: [rows, w] f32; hann: [w] f32; twiddles: [n] complex f32
// (exp(-2 pi i t / n)); out_l, out_r: [rows, n/2] f32.  All contiguous.
SPK_EXPORT int spk_stft_mixed(const float* left, const float* right,
                              const float* hann, const void* twiddles,
                              float* out_l, float* out_r, int rows, int w,
                              int n, void* stream) {
  spk::MixedRadix body;
  if (!spk::make_mixed_radix(n, &body)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int e = spk::allow_smem(stft_mixed_kernel, n);
  if (e != 0) return e;
  stft_mixed_kernel<<<rows, spk::stft_threads(n), n * sizeof(float2),
                      static_cast<cudaStream_t>(stream)>>>(
      body, left, right, hann, static_cast<const float2*>(twiddles), out_l,
      out_r, w);
  return static_cast<int>(cudaGetLastError());
}
