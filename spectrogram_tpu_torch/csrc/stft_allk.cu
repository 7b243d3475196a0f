// The all-windows STFT kernel: k hop-shifted windows per stream, read
// straight out of the carry+chunk sample planes.
//
// Replaces spectrogram_tpu/ops/pallas/stft_kernel.py `stft_mag_fused2_allk`
// (packed=True; body `_allk_kernel_packed`), with f32 buffers and with the
// int16 buffers of the i16_planes wire mode (2^-15 folded into the Hann
// constant), and computes what `stft_mag_fused2_buf` computes: for buffers
// buf_l, buf_r [S, ld], output row r*S + s (window-major, [k*S, N/2], DC
// included) holds the packed STFT magnitudes of window r of stream s,
// buf[s, r*hop : r*hop + W].  The TPU kernels sliced the windows out of VMEM
// blocks (allk) or DMA'd them by element offset (buf); here one thread block
// per output row reads its window from device memory at its offset, so the k
// window planes are never materialized.  Each row runs the body of the
// window-plane kernels (stft_fft.cuh): Radix2 for power-of-two N, MixedRadix
// otherwise, so a window gives the same bits here as through stft_packed.cu /
// stft_mixed.cu.
//
// What bounds it on this card: as those kernels, shared-memory traffic of
// the FFT stages, not device memory.  A buffer sample is read by about W/hop
// windows (2.6 at BENCH_CONFIG), which is still less traffic than writing
// the [k*S, W] window planes and reading them back, as the window-plane
// path would.
#include "stft_fft.cuh"

namespace {

template <class Body, class T>
__global__ void __launch_bounds__(spk::kStftMaxThreads) stft_allk_kernel(
    Body body, const T* __restrict__ buf_l, const T* __restrict__ buf_r,
    const float* __restrict__ hann, const float2* __restrict__ twiddles,
    float* __restrict__ out_l, float* __restrict__ out_r, int streams, int ld,
    int hop, int w) {
  extern __shared__ float2 buf[];
  const int row = blockIdx.x;
  const size_t at = static_cast<size_t>(row % streams) * ld +
                    static_cast<size_t>(row / streams) * hop;
  const size_t out = static_cast<size_t>(row) * (body.size() / 2);
  spk::stft_packed_row(body, buf_l + at, buf_r + at, hann, twiddles, w,
                       out_l + out, out_r + out, buf);
}

template <class Body, class T>
int launch_body(Body body, const T* buf_l, const T* buf_r, const float* hann,
                const float2* twiddles, float* out_l, float* out_r,
                int streams, int ld, int k, int hop, int w, int n,
                cudaStream_t stream) {
  const int e = spk::allow_smem(stft_allk_kernel<Body, T>, n);
  if (e != 0) return e;
  stft_allk_kernel<Body, T><<<k * streams, spk::stft_threads(n),
                              n * sizeof(float2), stream>>>(
      body, buf_l, buf_r, hann, twiddles, out_l, out_r, streams, ld, hop, w);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch(const T* buf_l, const T* buf_r, const float* hann,
           const void* twiddles, float* out_l, float* out_r, int streams,
           int ld, int k, int hop, int w, int n, void* stream) {
  const auto* tw = static_cast<const float2*>(twiddles);
  const auto st = static_cast<cudaStream_t>(stream);
  if ((n & (n - 1)) == 0) {
    int log2n = 0;
    while ((1 << log2n) < n) ++log2n;
    return launch_body(spk::Radix2{log2n}, buf_l, buf_r, hann, tw, out_l,
                       out_r, streams, ld, k, hop, w, n, st);
  }
  spk::MixedRadix body;
  if (!spk::make_mixed_radix(n, &body)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_body(body, buf_l, buf_r, hann, tw, out_l, out_r, streams, ld,
                     k, hop, w, n, st);
}

}  // namespace

// buf_l, buf_r: [streams, ld] f32 with ld >= w + (k-1)*hop; hann: [w] f32;
// twiddles: [n] complex f32 (exp(-2 pi i t / n)); out_l, out_r:
// [k*streams, n/2] f32.  All contiguous.
SPK_EXPORT int spk_stft_allk(const float* buf_l, const float* buf_r,
                             const float* hann, const void* twiddles,
                             float* out_l, float* out_r, int streams, int ld,
                             int k, int hop, int w, int n, void* stream) {
  return launch(buf_l, buf_r, hann, twiddles, out_l, out_r, streams, ld, k,
                hop, w, n, stream);
}

// As spk_stft_allk with int16 buffers; hann carries the 2^-15 wire scale.
SPK_EXPORT int spk_stft_allk_i16(const short* buf_l, const short* buf_r,
                                 const float* hann, const void* twiddles,
                                 float* out_l, float* out_r, int streams,
                                 int ld, int k, int hop, int w, int n,
                                 void* stream) {
  return launch(buf_l, buf_r, hann, twiddles, out_l, out_r, streams, ld, k,
                hop, w, n, stream);
}
