// The generic two-table colormap: magnitude planes -> RGBA8888 through any
// rank-1 factored palette, LUT[i, j, c] = U[i, c] * V[j, c].
//
// Replaces spectrogram_tpu/ops/pallas/colormap_kernel.py
// `colormap_planes_banded` with the per-row body `_generic_kernel` (via
// `_generic_word_tile`) and, with one table for all rows, the body
// `_uniform_generic_kernel`: the device path for user-defined
// `FactoredScheme`s outside the built-in mono/stereo structure.  The TPU
// kernels evaluated both factors as tent-basis sums and read a uniform table
// as SMEM scalars, all to avoid gathers; here each pixel reads its two plane
// taps, then two entries of U at xu and two of V at xv, 4 channels each,
// directly.
//
// Row n takes the tables u[(n / rows_per_table) % n_tables] and v[...] (as
// kernel B does): per-row tables over the push's window-major rows,
// rows_per_table = R' for a viewport's stream-major rows, n_tables = 1 for
// one palette for all rows.
//
// What bounds it on this card: device memory and instruction issue, as
// kernel B: 4 bytes out per pixel and the row's planes over the bins its
// taps reach; two tables per row where kernel B reads one (1 KB against the
// row's 4 KB of output at H=1024).  The arithmetic is ~70 flops, two IEEE divisions and a log10f
// per pixel.  It is kernel B's tile (colormap_tile.cuh) with
// `generic_word`: whole rows per CTA, the taps in registers, each row's
// planes and U and V copied into shared memory with TMA a row ahead of use
// (planes too wide to stage take the first form's structure).  The
// per-pixel laws are colormap_common.cuh's `pixel_texels` and
// `generic_word`, which colormap_static.cu and colormap_rows.cu run too.
#include "colormap_tile.cuh"

// mag_l, mag_r: [rows, bins] f32; span: the taps' highest bin + 1; j0, j1:
// [h] i32 and w0, w1: [h] f32 taps; u_tables, v_tables: [n_tables, res*4]
// f32 each, 16-byte aligned; out: [rows, h] i32.  All contiguous.  form: the
// tile's form, as spk_colormap_builtin's.
SPK_EXPORT int spk_colormap_generic(const float* mag_l, const float* mag_r,
                                    int rows, int bins, int span,
                                    const int* j0, const int* j1,
                                    const float* w0, const float* w1, int h,
                                    const float* u_tables,
                                    const float* v_tables, int n_tables,
                                    int rows_per_table, int res, float min_db,
                                    float db_range, float db_eps,
                                    float inv_res1, int* out, int form,
                                    void* stream) {
  const spk::TileArgs a{
      mag_l, mag_r, rows, bins, bins, span, j0, j1, w0, w1, h, u_tables, v_tables,
      n_tables, rows_per_table, res,
      spk::ColormapLaws{static_cast<float>(res), min_db, db_range, db_eps,
                        inv_res1}};
  return spk::launch_tile<true>(a, reinterpret_cast<unsigned*>(out),
                                static_cast<cudaStream_t>(stream), form);
}
