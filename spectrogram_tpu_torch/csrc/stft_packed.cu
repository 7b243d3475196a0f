// Kernel A: the stereo-packed STFT magnitude kernel, power-of-two N.
//
// Replaces spectrogram_tpu/ops/pallas/stft_kernel.py `stft_mag_fused2`
// (packed=True; bodies `_kernel_packed_2d` and `_packed_mag_rows`), with f32
// window planes and with the int16 planes of the i16_planes wire mode (the
// TPU kernel's int16 operand form, 2^-15 folded into the Hann constant).  The
// TPU kernel wrote the DFT as four-step MXU matmuls; here it is a radix-2 FFT
// in shared memory (stft_fft.cuh, `Radix2`), one thread block per window row
// of the [rows, W] window planes.  Mixed-radix N is stft_mixed.cu.
//
// What bounds it on this card: the FFT's trips through shared memory, not
// device memory (8 bytes in, 4 with int16 samples, and 8 bytes out per
// sample).  The design cuts those trips: the radix-2 stages run four at a
// time in registers, a thread per 16-entry group, so a row makes
// ceil(log2(N) / 4) passes over its buffer (3 at N = 4096, 32 KB) in place
// of log2(N); the first pass reads its samples straight from the planes,
// so the bit-reversed store of a separate load is gone; an XOR swizzle of
// the buffer spreads every pass's and the unpack's accesses over the banks.
// The block is N/16 threads, up to N = 4096 at most kRadix2Threads with
// launch bounds that hold the registers to kRadix2Blocks blocks per SM
// (`with_row_bounds`; PERF.md §6 has ptxas's count and the card's times).
#include "stft_fft.cuh"

namespace {

template <class T, class Bounds>
__global__ void __launch_bounds__(Bounds::threads, Bounds::blocks)
stft_packed_kernel(
    spk::Radix2 body, const T* __restrict__ left, const T* __restrict__ right,
    const float* __restrict__ hann, const float2* __restrict__ twiddles,
    float* __restrict__ out_l, float* __restrict__ out_r, int w) {
  extern __shared__ float2 buf[];
  const size_t row = blockIdx.x;
  const size_t bins = spk::stft_bins(body.buf_size(), w);
  spk::stft_packed_row(body, left + row * w, right + row * w,
                       hann, twiddles, w, out_l + row * bins,
                       out_r + row * bins, buf);
}

template <class T>
int launch(const T* left, const T* right, const float* hann,
           const void* twiddles, float* out_l, float* out_r, int rows, int w,
           int log2n, int choice, void* stream) {
  const spk::Radix2 body{log2n};
  const size_t smem = body.buf_size() * sizeof(float2);
  return spk::with_row_bounds(body, [&](auto bounds, int threads) {
    using Bounds = decltype(bounds);
    const int e = spk::allow_smem(stft_packed_kernel<T, Bounds>, smem);
    if (e != 0) return e;
    stft_packed_kernel<T, Bounds>
        <<<rows, threads, smem, static_cast<cudaStream_t>(stream)>>>(
            body, left, right, hann, static_cast<const float2*>(twiddles),
            out_l, out_r, w);
    return static_cast<int>(cudaGetLastError());
  }, choice);
}

}  // namespace

// left, right: [rows, w] f32; hann: [w] f32; twiddles: [N] complex f32
// (exp(-2 pi i t / N)); out_l, out_r: [rows, stft_bins(N, w)] f32.  All
// contiguous.  choice: the launch bounds (stft_fft.cuh `kLaunchTable`, the
// table's rule, or kLaunchRows / kLaunchWide; radix 2 has no kLaunchPair).
SPK_EXPORT int spk_stft_packed(const float* left, const float* right,
                               const float* hann, const void* twiddles,
                               float* out_l, float* out_r, int rows, int w,
                               int log2n, int choice, void* stream) {
  return launch(left, right, hann, twiddles, out_l, out_r, rows, w, log2n,
                choice, stream);
}

// As spk_stft_packed with int16 planes; hann carries the 2^-15 wire scale.
SPK_EXPORT int spk_stft_packed_i16(const short* left, const short* right,
                                   const float* hann, const void* twiddles,
                                   float* out_l, float* out_r, int rows, int w,
                                   int log2n, int choice, void* stream) {
  return launch(left, right, hann, twiddles, out_l, out_r, rows, w, log2n,
                choice, stream);
}

SPK_EXPORT const char* spk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
