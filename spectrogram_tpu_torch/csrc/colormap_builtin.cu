// Kernel B: the per-row built-in colormap, magnitude planes -> RGBA8888.
//
// Replaces spectrogram_tpu/ops/pallas/colormap_kernel.py
// `colormap_planes_banded` with the per-row body `_builtin_kernel` (via
// `_builtin_word_tile`, `_resample_and_laws` and `_tent_lut_channels`) and,
// with one table for all rows, `_uniform_builtin_kernel`.  The TPU kernel
// wrote the two-tap resample as a banded matmul and the LUT read as a
// tent-basis sum, both to avoid gathers; here each pixel reads its two taps
// and its two LUT entries directly.
//
// Row n takes the table tables[(n / rows_per_table) % n_tables]:
// rows_per_table = 1 and n_tables = S for per-stream tables over the push's
// window-major rows, rows_per_table = R' for the viewport's stream-major
// rows (R' rows per stream), n_tables = 1 for one palette for all rows.
//
// What bounds it on this card: device memory and instruction issue about
// equally.  It writes 4 bytes per pixel and reads each row's planes over the
// bins its taps reach (near the top of the spectrum the taps are ~14 bins
// apart, so whole 32-byte sectors of nearly every bin); each pixel runs ~50
// flops, two IEEE divisions and a log10f.  A first
// form (one pixel per thread, 128 threads, one row per CTA) waited on a
// chain of dependent reads per pixel (taps, planes, table flag, table):
// bound by latency.  The tile (colormap_tile.cuh) takes whole rows per CTA,
// the taps in registers, and copies each row's planes and table into shared
// memory with TMA a row ahead of use, so the gathers hit shared memory and
// the copies overlap the arithmetic; planes too wide to stage take the
// first form's structure.  The per-pixel laws are colormap_common.cuh's,
// shared with the blockwise kernel (colormap_blockwise.cu), so both give
// the same bits.
#include "colormap_tile.cuh"

// mag_l, mag_r: [rows, bins] f32; span: the taps' highest bin + 1; j0, j1:
// [h] i32 and w0, w1: [h] f32 taps; tables: [n_tables, res*4] f32, 16-byte
// aligned; out: [rows, h] i32.  All contiguous.  form: the tile's form
// (colormap_tile.cuh kTileFormRule, the rule `spk_colormap_form` reports,
// kTileFormStaged or kTileFormDirect).
SPK_EXPORT int spk_colormap_builtin(const float* mag_l, const float* mag_r,
                                    int rows, int bins, int span,
                                    const int* j0, const int* j1,
                                    const float* w0, const float* w1, int h,
                                    const float* tables, int n_tables,
                                    int rows_per_table, int res, float min_db,
                                    float db_range, float db_eps,
                                    float inv_res1, int* out, int form,
                                    void* stream) {
  const spk::TileArgs a{
      mag_l, mag_r, rows, bins, bins, span, j0, j1, w0, w1, h, tables, nullptr,
      n_tables, rows_per_table, res,
      spk::ColormapLaws{static_cast<float>(res), min_db, db_range, db_eps,
                        inv_res1}};
  return spk::launch_tile<false>(a, reinterpret_cast<unsigned*>(out),
                                 static_cast<cudaStream_t>(stream), form);
}

// The form kernel B (generic = 0) or the generic kernel (generic = 1) takes
// at `span`, width `h` and `res`-entry tables: 1 staged, 0 direct
// (colormap_tile.cuh `tile_staged`).
SPK_EXPORT int spk_colormap_form(int span, int h, int res, int generic) {
  return spk::tile_staged(span, h, generic != 0, res) ? 1 : 0;
}
