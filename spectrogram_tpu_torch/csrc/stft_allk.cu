// The all-windows STFT kernel: k hop-shifted windows per stream, read
// straight out of the carry+chunk sample planes, and on request the next
// push's carry.
//
// Replaces spectrogram_tpu/ops/pallas/stft_kernel.py `stft_mag_fused2_allk`
// (packed=True; body `_allk_kernel_packed`, with `emit_carry` its carry
// output, :993-1001 and :1033-1037), with f32 buffers and with the int16
// buffers of the i16_planes wire mode (2^-15 folded into the Hann constant),
// and computes what `stft_mag_fused2_buf` computes: for buffers buf_l, buf_r
// [S, ld], output row r*S + s (window-major, [k*S, B], B = stft_bins(N, W),
// DC included) holds the packed STFT magnitudes of window r of stream s,
// buf[s, r*hop : r*hop + W].  The TPU kernels sliced the windows out of VMEM
// blocks (allk) or DMA'd them by element offset (buf); here one thread block
// per output row reads its window from device memory at its offset, so the k
// window planes are never materialized.  Each row runs the body of the
// window-plane kernels (stft_fft.cuh `with_fft_body`: Radix2, MixedRadix or
// Bluestein), so a window gives the same bits here as through
// stft_packed.cu / stft_mixed.cu.  `spk_stft_allk_carry` (and its int16 form) also writes
// next [S, 2, c_len], the last c_len = W - hop samples of each buffer in the
// buffers' dtype: the blocks of window 0 copy their stream's two tails.
//
// What bounds it on this card: as those kernels, the FFT's trips through
// shared memory, not device memory; it runs kernel A's register passes
// (radix 2, stft_packed.cu; mixed radix and Bluestein, stft_mixed.cu), the
// first pass reading the window straight from the buffers, with kernel A's
// block size and launch bounds (`with_row_bounds`).  A buffer sample is read by about W/hop windows (2.6
// at BENCH_CONFIG), which is still less traffic than writing the [k*S, W]
// window planes and reading them back, as the window-plane path would.  The
// next carry adds c_len samples written per stream and channel, and spares
// the framing its separate copy.
#include "stft_fft.cuh"

namespace {

template <class Body, class T, class Bounds>
__global__ void __launch_bounds__(Bounds::threads, Bounds::blocks)
stft_allk_kernel(
    Body body, const T* __restrict__ buf_l, const T* __restrict__ buf_r,
    const float* __restrict__ hann, const float2* __restrict__ twiddles,
    float* __restrict__ out_l, float* __restrict__ out_r,
    T* __restrict__ next, int streams, int ld, int hop, int w, int c_len) {
  extern __shared__ float2 buf[];
  const int row = blockIdx.x;
  const int s = row % streams;
  const size_t at = static_cast<size_t>(s) * ld +
                    static_cast<size_t>(row / streams) * hop;
  if (next != nullptr && row < streams) {
    T* dst = next + static_cast<size_t>(s) * 2 * c_len;
    spk::buffer_tail(buf_l + static_cast<size_t>(s) * ld, dst, ld, c_len);
    spk::buffer_tail(buf_r + static_cast<size_t>(s) * ld, dst + c_len, ld,
                     c_len);
  }
  const size_t out = static_cast<size_t>(row) * spk::stft_bins(body.size(), w);
  spk::stft_packed_row<spk::group_cap<Bounds>()>(body, buf_l + at, buf_r + at, hann,
                                                 twiddles, w, out_l + out, out_r + out, buf);
}

template <class T>
int launch(const T* buf_l, const T* buf_r, const float* hann,
           const void* consts, float* out_l, float* out_r, T* next,
           int streams, int ld, int k, int hop, int w, int n, int c_len,
           int choice, void* stream) {
  const auto* tw = static_cast<const float2*>(consts);
  return spk::with_fft_body(n, consts, [&](auto body) {
    const size_t smem = body.buf_size() * sizeof(float2);
    return spk::with_row_bounds(body, [&](auto bounds, int threads) {
      const auto kernel = stft_allk_kernel<decltype(body), T, decltype(bounds)>;
      const int e = spk::allow_smem(kernel, smem);
      if (e != 0) return e;
      kernel<<<k * streams, threads, smem, static_cast<cudaStream_t>(stream)>>>(
          body, buf_l, buf_r, hann, tw, out_l, out_r, next, streams, ld, hop,
          w, c_len);
      return static_cast<int>(cudaGetLastError());
    }, choice);
  });
}

}  // namespace

// buf_l, buf_r: [streams, ld] f32 with ld >= w + (k-1)*hop; hann: [w] f32;
// consts: n's FFT table (`fft_table`); out_l, out_r: [k*streams,
// stft_bins(n, w)] f32.  All contiguous.  choice: the launch bounds, as
// spk_stft_packed's (radix 2) or spk_stft_mixed's (every other n).
SPK_EXPORT int spk_stft_allk(const float* buf_l, const float* buf_r,
                             const float* hann, const void* consts,
                             float* out_l, float* out_r, int streams, int ld,
                             int k, int hop, int w, int n, int choice,
                             void* stream) {
  return launch<float>(buf_l, buf_r, hann, consts, out_l, out_r, nullptr,
                       streams, ld, k, hop, w, n, 0, choice, stream);
}

// As spk_stft_allk with int16 buffers; hann carries the 2^-15 wire scale.
SPK_EXPORT int spk_stft_allk_i16(const short* buf_l, const short* buf_r,
                                 const float* hann, const void* consts,
                                 float* out_l, float* out_r, int streams,
                                 int ld, int k, int hop, int w, int n,
                                 int choice, void* stream) {
  return launch<short>(buf_l, buf_r, hann, consts, out_l, out_r, nullptr,
                       streams, ld, k, hop, w, n, 0, choice, stream);
}

// As spk_stft_allk, and next: [streams, 2, c_len] f32, the last c_len
// samples of each buffer (c_len <= ld), not aliasing the buffers.
SPK_EXPORT int spk_stft_allk_carry(const float* buf_l, const float* buf_r,
                                   const float* hann, const void* consts,
                                   float* out_l, float* out_r, float* next,
                                   int streams, int ld, int k, int hop, int w,
                                   int n, int c_len, int choice,
                                   void* stream) {
  return launch<float>(buf_l, buf_r, hann, consts, out_l, out_r, next,
                       streams, ld, k, hop, w, n, c_len, choice, stream);
}

// As spk_stft_allk_carry with int16 buffers and an int16 next carry.
SPK_EXPORT int spk_stft_allk_carry_i16(const short* buf_l, const short* buf_r,
                                       const float* hann, const void* consts,
                                       float* out_l, float* out_r,
                                       short* next, int streams, int ld,
                                       int k, int hop, int w, int n,
                                       int c_len, int choice, void* stream) {
  return launch<short>(buf_l, buf_r, hann, consts, out_l, out_r, next,
                       streams, ld, k, hop, w, n, c_len, choice, stream);
}
