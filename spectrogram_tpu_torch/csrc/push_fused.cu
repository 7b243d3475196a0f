// The fused push: the split-real STFT of a window row and its built-in
// colormap in one kernel.
//
// Replaces spectrogram_tpu/ops/pallas/push_kernel.py `push_fused_single`
// (body `_push_kernel`): [rows, W] window planes x2 -> [rows, H] int32
// RGBA8888, and with mags the two [rows, B] magnitude planes as well (B =
// stft_bins(N, W), N/2 at pad_factor >= 2).  One thread block per row runs
// `stft_real_row` (stft_fft.cuh, the body of the split-real kernels, any N;
// the N/2-point real-FFT pack at even N) for each channel into shared
// memory, then writes every pixel of the row with `colormap_pixel`
// (colormap_common.cuh, the body of kernel B) from those shared planes,
// reading row n's table tables[n % n_tables].  Both bodies are the
// two-kernel chain's, on the same values, so the rows equal spk_stft_split
// followed by spk_colormap_builtin bit for bit.
//
// What bounds it on this card: the STFT's shared-memory passes, as
// spk_stft_split (two N/2-point transforms per row at even N), each
// channel's samples read straight into the first pass (`stft_real_row`).
// The fusion saves the chain's device memory round trip of the planes (8 B
// written and 8 B read per bin and row, minus what the pixels' taps touch)
// and one launch; it holds the FFT buffer and both planes per block (32 KB
// at N = 4096), which bounds occupancy as the FFT buffer alone did.  Where
// the two do not fit a block together (`push_fused_fits` in
// ops/cuda/push_kernel.py), the wrapper runs the chain instead.
//
// The launch: a block whose buffer and planes fit kRowBlocks times in an
// SM's shared memory runs kRowThreads threads under the launch bounds
// (kRowThreads, kRowBlocks), as kernel A's rows do, larger ones
// kStftMaxThreads threads under the threads alone (`SPK_BOUNDED_KERNEL`,
// as the split-real rows of one block).  On an H100 80GB HBM3 at 700 W
// the row bounds ran the push at N = 4800 in 0.49x the time of (512, 1)
// (whose 416 threads idle through most passes), tied at N = 4096, and lost
// 32% at N = 17,640, whose 141 KB rows run one block per SM.  Both
// channels' transforms at once (two rows of 128 threads on two buffers, 48
// KB) ran 1.09x / 1.06x the time at N = 4096 / 17,640, and four pixels a
// thread with their taps in registers (the row tile's grouping) 0.99-1.01x:
// the channels run one after the other and the pixels one a thread
// (PERF.md §6).
#include "push_fused.cuh"

namespace {

SPK_BOUNDED_KERNEL(push_fused_kernel, (
    Body body, const float* __restrict__ left, const float* __restrict__ right,
    const float* __restrict__ hann, const float2* __restrict__ twiddles,
    const float* __restrict__ tables, int n_tables, int res,
    const int* __restrict__ j0, const int* __restrict__ j1,
    const float* __restrict__ w0, const float* __restrict__ w1, int h,
    spk::ColormapLaws laws, unsigned* __restrict__ out,
    float* __restrict__ mag_l, float* __restrict__ mag_r, int w), {
  extern __shared__ float2 buf[];
  const int row = blockIdx.x;
  const size_t at = static_cast<size_t>(row) * spk::stft_bins(body.size(), w);
  spk::push_fused_row<spk::group_cap<Bounds>()>(
      body, left + static_cast<size_t>(row) * w,
      right + static_cast<size_t>(row) * w, w, hann, twiddles,
      spk::row_table(tables, row, 1, n_tables, res), res, j0, j1, w0, w1, h,
      laws, out + static_cast<size_t>(row) * h,
      mag_l == nullptr ? nullptr : mag_l + at,
      mag_r == nullptr ? nullptr : mag_r + at, buf,
      reinterpret_cast<float*>(buf + body.buf_size()));
})

}  // namespace

// left, right: [rows, w] f32 window planes; hann: [w] f32 (2/W folded in);
// consts: n's split-real table (`split_fft_table`); tables: [n_tables, res*4] f32
// built-in tables; j0, j1: [h] i32 and w0, w1: [h] f32 taps below
// stft_bins(n, w); out: [rows, h] i32; mag_l, mag_r: [rows, stft_bins(n, w)]
// f32, or both null.  All contiguous.  choice: the launch bounds
// (push_fused.cuh `with_push_bounds`: stft_fft.cuh kLaunchTable, the table's
// rule, or kLaunchRows / kLaunchWide).
SPK_EXPORT int spk_push_fused(const float* left, const float* right,
                              const float* hann, const void* consts,
                              const float* tables, int n_tables, int res,
                              const int* j0, const int* j1, const float* w0,
                              const float* w1, int h, float min_db,
                              float db_range, float db_eps, float inv_res1,
                              int* out, float* mag_l, float* mag_r, int rows,
                              int w, int n, int choice, void* stream) {
  const auto* tw = static_cast<const float2*>(consts);
  const spk::ColormapLaws laws{static_cast<float>(res), min_db, db_range,
                               db_eps, inv_res1};
  return spk::with_real_body(n, consts, [&](auto body) {
    const size_t smem = body.buf_size() * sizeof(float2) +
                        2 * spk::stft_bins(n, w) * sizeof(float);
    return spk::with_push_bounds(body, smem, [&](auto bounds, int threads) {
      const auto kernel = push_fused_kernel_for<decltype(body), decltype(bounds)>();
      const int e = spk::allow_smem(kernel, smem);
      if (e != 0) return e;
      kernel<<<rows, threads, smem, static_cast<cudaStream_t>(stream)>>>(
          body, left, right, hann, tw, tables, n_tables, res, j0, j1, w0, w1,
          h, laws, reinterpret_cast<unsigned*>(out), mag_l, mag_r, w);
      return static_cast<int>(cudaGetLastError());
    }, choice);
  });
}
