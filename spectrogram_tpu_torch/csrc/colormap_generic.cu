// The generic two-table colormap: magnitude planes -> RGBA8888 through any
// rank-1 factored palette, LUT[i, j, c] = U[i, c] * V[j, c].
//
// Replaces spectrogram_tpu/ops/pallas/colormap_kernel.py
// `colormap_planes_banded` with the per-row body `_generic_kernel` (via
// `_generic_word_tile`) and, with one table for all rows, the body
// `_uniform_generic_kernel`: the device path for user-defined
// `FactoredScheme`s outside the built-in mono/stereo structure.  The TPU
// kernels evaluated both factors as tent-basis sums and read a uniform table
// as SMEM scalars, all to avoid gathers; here each thread reads its two
// plane taps, then two entries of U at xu and two of V at xv, 4 channels
// each, directly.
//
// The per-pixel laws are colormap_common.cuh's `pixel_texels` and
// `generic_word`, which colormap_static.cu runs too.  Row n takes the tables
// u[(n / rows_per_table) % n_tables] and v[...] (as kernel B does): per-row
// tables over the push's window-major rows, rows_per_table = R' for a
// viewport's stream-major rows, n_tables = 1 for one palette for all rows.
//
// What bounds it on this card: device memory, as kernel B: 4 bytes out per
// pixel, the tap reads (mostly L1/L2 hits), and two tables per row where
// kernel B reads one (1 KB against the row's 4 KB of output at H=1024, also
// mostly cache hits).  The arithmetic is ~60 flops and one log10f per pixel.
#include "colormap_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads) colormap_generic_kernel(
    const float* __restrict__ mag_l, const float* __restrict__ mag_r,
    int rows, int bins, const int* __restrict__ j0,
    const int* __restrict__ j1, const float* __restrict__ w0,
    const float* __restrict__ w1, int h, const float* __restrict__ u_tables,
    const float* __restrict__ v_tables, int n_tables, int rows_per_table,
    int res, spk::ColormapLaws laws, unsigned* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= h) return;
  const int a = j0[p], b = j1[p];
  const float wa = w0[p], wb = w1[p];
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const size_t at = static_cast<size_t>(row) * bins;
    const spk::Texels x =
        spk::pixel_texels(mag_l + at, mag_r + at, a, b, wa, wb, laws);
    out[static_cast<size_t>(row) * h + p] = spk::generic_word(
        x, spk::row_table(u_tables, row, rows_per_table, n_tables, res),
        spk::row_table(v_tables, row, rows_per_table, n_tables, res), res);
  }
}

}  // namespace

// mag_l, mag_r: [rows, bins] f32; j0, j1: [h] i32 and w0, w1: [h] f32 taps;
// u_tables, v_tables: [n_tables, res*4] f32 each; out: [rows, h] i32.  All
// contiguous.
SPK_EXPORT int spk_colormap_generic(const float* mag_l, const float* mag_r,
                                    int rows, int bins, const int* j0,
                                    const int* j1, const float* w0,
                                    const float* w1, int h,
                                    const float* u_tables,
                                    const float* v_tables, int n_tables,
                                    int rows_per_table, int res, float min_db,
                                    float db_range, float db_eps,
                                    float inv_res1, int* out, void* stream) {
  const dim3 grid((h + kThreads - 1) / kThreads,
                  rows < kMaxGridY ? rows : kMaxGridY);
  colormap_generic_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      mag_l, mag_r, rows, bins, j0, j1, w0, w1, h, u_tables, v_tables,
      n_tables, rows_per_table, res,
      spk::ColormapLaws{static_cast<float>(res), min_db, db_range, db_eps,
                        inv_res1},
      reinterpret_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}
