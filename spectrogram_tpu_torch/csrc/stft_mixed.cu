// Kernel A at every other N: the stereo-packed STFT magnitudes for
// N = 2^a 3^b 5^c 7^d (the reference geometry's N = 4800 = 2^6 3 5^2, and
// 44.1 kHz at the reference's 0.05 s window, N = 4410 = 2 3^2 5 7^2) and, by
// Bluestein's chirp-z convolution, for any N with a prime factor above 7
// (N = 2204 = 2^2 19 29, M = 4500).
//
// Replaces spectrogram_tpu/ops/pallas/stft_kernel.py `stft_mag_fused2`
// (packed=True) at the sizes the TPU ran through its lane-padded four-step
// plan (`lane_pad`, 48x100 at N=4800), and serves the sizes the JAX package
// leaves to XLA's FFT, with f32 or int16 window planes (the i16_planes wire
// mode).  One thread block per window row of the [rows, W] window planes
// runs the body `with_fft_body` picks (stft_fft.cuh): the digit-reversed
// radix-4/2/3/5/7 DIT (`MixedRadix`, 38.4 KB at N=4800, 35.3 KB at N=4410)
// or `Bluestein` (two M-point mixed-radix transforms, the chirp and filter
// products folded into the load, the DIF pass of stage 0 and the unpack),
// above 48 KB by the opt-in attribute.  Same unpack as the power-of-two
// kernel (stft_packed.cu), which keeps power-of-two N.
//
// What bounds it on this card: the FFT's trips through shared memory, not
// device memory (8 bytes in, 4 with int16 samples, and 8 out per sample).
// The design cuts those trips: adjacent radix stages run in pairs in
// registers, a thread per group of up to 28 entries (N=4800: three passes
// over the 38.4 KB row, (4 4)(4 3)(5 5), in place of six; N=4410: four,
// (2 3)(3 5)(7)(7); Bluestein's M-point DIF and DIT likewise); the first
// pass reads its samples straight from the planes, so the digit-reversed
// store of a separate load is gone; where 16 divides N, an XOR swizzle of
// the buffer spreads that pass's stores over the banks.  The twiddles stay
// in the device table (staged in shared memory they cost blocks per SM).
// A row whose buffer fits five times in an SM's shared memory (N up to
// 5,811) runs kRowThreads threads with launch bounds for kRowBlocks blocks
// per SM (`with_row_bounds`; PERF.md §6 has ptxas's count and the card's
// times).
#include "stft_fft.cuh"

namespace {

template <class Body, class T, class Bounds>
__global__ void __launch_bounds__(Bounds::threads, Bounds::blocks) stft_mixed_kernel(
    Body body, const T* __restrict__ left, const T* __restrict__ right,
    const float* __restrict__ hann, const float2* __restrict__ twiddles,
    float* __restrict__ out_l, float* __restrict__ out_r, int w) {
  extern __shared__ float2 buf[];
  const size_t row = blockIdx.x;
  const size_t bins = spk::stft_bins(body.size(), w);
  spk::stft_packed_row<spk::group_cap<Bounds>()>(body, left + row * w, right + row * w, hann,
                                                 twiddles, w, out_l + row * bins,
                                                 out_r + row * bins, buf);
}

template <class T>
int launch(const T* left, const T* right, const float* hann,
           const void* consts, float* out_l, float* out_r, int rows, int w,
           int n, int choice, void* stream) {
  const auto* tw = static_cast<const float2*>(consts);
  return spk::with_fft_body(n, consts, [&](auto body) {
    // power-of-two N runs stft_packed.cu
    if constexpr (std::is_same<decltype(body), spk::Radix2>::value) {
      return static_cast<int>(cudaErrorInvalidValue);
    } else {
      const size_t smem = body.buf_size() * sizeof(float2);
      return spk::with_row_bounds(body, [&](auto bounds, int threads) {
        const auto kernel = stft_mixed_kernel<decltype(body), T, decltype(bounds)>;
        const int e = spk::allow_smem(kernel, smem);
        if (e != 0) return e;
        kernel<<<rows, threads, smem, static_cast<cudaStream_t>(stream)>>>(
            body, left, right, hann, tw, out_l, out_r, w);
        return static_cast<int>(cudaGetLastError());
      }, choice);
    }
  });
}

}  // namespace

// left, right: [rows, w] f32; hann: [w] f32; consts: N's FFT table
// (`fft_table`); out_l, out_r: [rows, stft_bins(n, w)] f32.  All contiguous.
// choice: the launch bounds (stft_fft.cuh `kLaunchTable`, the table's rule,
// or kLaunchRows / kLaunchPair / kLaunchWide).
SPK_EXPORT int spk_stft_mixed(const float* left, const float* right,
                              const float* hann, const void* consts,
                              float* out_l, float* out_r, int rows, int w,
                              int n, int choice, void* stream) {
  return launch(left, right, hann, consts, out_l, out_r, rows, w, n, choice,
                stream);
}

// As spk_stft_mixed with int16 planes; hann carries the 2^-15 wire scale.
SPK_EXPORT int spk_stft_mixed_i16(const short* left, const short* right,
                                  const float* hann, const void* consts,
                                  float* out_l, float* out_r, int rows, int w,
                                  int n, int choice, void* stream) {
  return launch(left, right, hann, consts, out_l, out_r, rows, w, n, choice,
                stream);
}
