// Kernel B: the per-row built-in colormap, magnitude planes -> RGBA8888.
//
// Replaces spectrogram_tpu/ops/pallas/colormap_kernel.py
// `colormap_planes_banded` with the per-row body `_builtin_kernel` (via
// `_builtin_word_tile`, `_resample_and_laws` and `_tent_lut_channels`).  The
// TPU kernel wrote the two-tap resample as a banded matmul and the LUT read
// as a tent-basis sum, both to avoid gathers; here each thread reads its two
// taps and its two LUT entries directly.
//
// The per-pixel laws are in colormap_common.cuh, shared with the blockwise
// kernel (colormap_blockwise.cu).  Row n takes the table
// tables[(n / rows_per_table) % n_tables]:
// rows_per_table = 1 and n_tables = S for per-stream tables over the push's
// window-major rows, rows_per_table = R' for the viewport's stream-major
// rows (R' rows per stream), n_tables = 1 for one palette for all rows.
//
// What bounds it on this card: device memory.  It writes 4 bytes per pixel
// and reads two f32 taps per channel per pixel (mostly L1/L2 hits, since
// neighbouring pixels share bins); the arithmetic is ~40 flops and one log10f.
#include "colormap_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads) colormap_builtin_kernel(
    const float* __restrict__ mag_l, const float* __restrict__ mag_r,
    int rows, int bins, const int* __restrict__ j0,
    const int* __restrict__ j1, const float* __restrict__ w0,
    const float* __restrict__ w1, int h, const float* __restrict__ tables,
    int n_tables, int rows_per_table, int res, spk::ColormapLaws laws,
    unsigned* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= h) return;
  const int a = j0[p], b = j1[p];
  const float wa = w0[p], wb = w1[p];
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const size_t at = static_cast<size_t>(row) * bins;
    const float* tab = spk::row_table(tables, row, rows_per_table, n_tables, res);
    out[static_cast<size_t>(row) * h + p] = spk::colormap_pixel(
        mag_l + at, mag_r + at, a, b, wa, wb, tab, res, laws);
  }
}

}  // namespace

// mag_l, mag_r: [rows, bins] f32; j0, j1: [h] i32 and w0, w1: [h] f32 taps;
// tables: [n_tables, res*4] f32; out: [rows, h] i32.  All contiguous.
SPK_EXPORT int spk_colormap_builtin(const float* mag_l, const float* mag_r,
                                    int rows, int bins, const int* j0,
                                    const int* j1, const float* w0,
                                    const float* w1, int h,
                                    const float* tables, int n_tables,
                                    int rows_per_table, int res,
                                    float min_db, float db_range, float db_eps,
                                    float inv_res1, int* out, void* stream) {
  const dim3 grid((h + kThreads - 1) / kThreads,
                  rows < kMaxGridY ? rows : kMaxGridY);
  colormap_builtin_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      mag_l, mag_r, rows, bins, j0, j1, w0, w1, h, tables, n_tables,
      rows_per_table, res,
      spk::ColormapLaws{static_cast<float>(res), min_db, db_range, db_eps,
                        inv_res1},
      reinterpret_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}
