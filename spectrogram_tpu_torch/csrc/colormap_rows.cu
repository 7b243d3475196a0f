// The fused generic colormap of planar rows: [N, 2, B] magnitude rows ->
// RGBA8888 through per-row rank-1 factored palettes and any resample matrix.
//
// Replaces spectrogram_tpu/ops/pallas/colormap_kernel.py
// `colormap_rows_fused` (body `_kernel`, via `_resample_and_laws` and
// `_tent_lut_channels`): the JAX package's public fused colormap, which
// takes the planar rows its STFT emits, one u/v factor pair per row and the
// dense transposed resample matrix [B, H].  The TPU kernel multiplied each
// channel plane by the dense matrix on the matrix unit and evaluated the
// factors as tent-basis sums, all to avoid gathers.  Here the matrix arrives
// as K taps per pixel (`resample_taps_k`: an ELL form, [H, K] bins and
// weights, K = the most nonzeros of any pixel column, padding taps of weight
// 0), and each thread reads its pixel's taps from row n's left plane at
// rows + n*2B and right plane at + B (no copy of the planes), sums them in
// ascending bin order (`tap_sum`), applies the laws (`texels_of`) and reads
// U at xu and V at xv from row n's tables at n*R*4 (`generic_word`).  Every
// matrix the package builds has K = 2, where the sum is `pixel_texels`'
// two-tap expression, so the words equal `colormap_generic`'s
// (colormap_generic.cu) on the same planes, tables and matrix bit for bit;
// a denser matrix still computes, in K multiply-adds per plane and pixel.
//
// The output is the packed word [N, H] (byte 0 = R); the u8 form [N, H, 4]
// is the same buffer viewed as bytes, which is the JAX kernel's channel
// planes moved to the last axis.
//
// What bounds it on this card: device memory, as the generic kernel: 4
// bytes out per pixel, the tap reads (L1/L2 hits: two planes of B floats per
// row), and a row's two tables (1 KB against 4 KB of output at H = 1024).
// The arithmetic is ~70 flops and one log10f per pixel at K = 2.
#include "colormap_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads) colormap_rows_kernel(
    const float* __restrict__ rows, int n_rows, int bins,
    const int* __restrict__ tap_j, const float* __restrict__ tap_w, int h,
    int taps, const float* __restrict__ u_tables,
    const float* __restrict__ v_tables, int res, spk::ColormapLaws laws,
    unsigned* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= h) return;
  const int* j = tap_j + static_cast<size_t>(p) * taps;
  const float* w = tap_w + static_cast<size_t>(p) * taps;
  for (int n = blockIdx.y; n < n_rows; n += gridDim.y) {
    const size_t table = static_cast<size_t>(n) * res * 4;
    out[static_cast<size_t>(n) * h + p] = spk::planar_row_pixel(
        rows + static_cast<size_t>(n) * 2 * bins, bins, j, w, taps,
        u_tables + table, v_tables + table, res, laws);
  }
}

}  // namespace

// rows: [n_rows, 2, bins] f32; tap_j: [h, taps] i32 and tap_w: [h, taps] f32,
// every tap below bins; u_tables, v_tables: [n_rows, res, 4] f32; out:
// [n_rows, h] i32.  All contiguous.
SPK_EXPORT int spk_colormap_rows(const float* rows, int n_rows, int bins,
                                 const int* tap_j, const float* tap_w, int h,
                                 int taps, const float* u_tables,
                                 const float* v_tables, int res, float min_db,
                                 float db_range, float db_eps, float inv_res1,
                                 int* out, void* stream) {
  const dim3 grid((h + kThreads - 1) / kThreads,
                  n_rows < kMaxGridY ? n_rows : kMaxGridY);
  colormap_rows_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      rows, n_rows, bins, tap_j, tap_w, h, taps, u_tables, v_tables, res,
      spk::ColormapLaws{static_cast<float>(res), min_db, db_range, db_eps,
                        inv_res1},
      reinterpret_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}
