// The blockwise built-in colormap: kernel B's function over rows taken in
// blocks, launched as kernel B.
//
// Replaces spectrogram_tpu/ops/pallas/colormap_kernel.py
// `colormap_planes_banded` with the body `_blockwise_builtin_kernel` and its
// operands `_blockwise_operands`: per block of `block_rows` window-major rows,
// one flag says whether every row of the block reads the same table; such a
// block reads that one table, a mixed block reads per-row tables.  The TPU
// computed the flags and the block tables in a pass before the kernel and
// prefetched them into SMEM as scalars, so that a uniform block's LUT reads
// were scalars.
//
// On this card the flag cannot pay.  Proving a block uniform, byte for byte
// as `_blockwise_operands` compares, reads every row's table: the same 512
// bytes a row (R=32) that staging the row's own table moves, about 3% of a
// row's ~19 KB of planes and output at BENCH_CONFIG.  So the blockwise
// colormap launches kernel B (colormap_tile.cuh `launch_tile`) on the same
// per-row tables, in the form the span allows: the row tile (whole rows per
// CTA, four pixels per thread, the taps in registers, each row's planes over
// [0, span) and its table copied into shared memory with TMA a row ahead of
// use, a table skipped where the stage already holds it), or the direct form
// where the span is wide beside the row's pixels.  `block_rows` changes
// nothing.  The export stays its own, so that its launches count apart from
// kernel B's.
//
// A first form took one CTA per block of rows and 128 pixel columns, each
// CTA deciding its block's flag from every row's table and staging a
// uniform block's table once, every other read from device memory.  On an
// H100 80GB HBM3 at 700 W it colored 10,240 serving rows in 0.1357 ms on
// sorted tables (uniform blocks) and 0.1530 on scattered ones, where kernel
// B's tile takes 0.0799 and 0.0806; at the spans kernel B takes its direct
// form (H=512 at BENCH_CONFIG, N = 6,400 to 48,000) it ran 1.11-2.47x that
// form's time (PERF.md §6).
#include "colormap_tile.cuh"

// As spk_colormap_builtin, with block_rows, the rows of the JAX kernel's
// blocks (at least 1), accepted and unused.  mag_l, mag_r: [rows, bins] f32;
// span: the taps' highest bin + 1; j0, j1: [h] i32 and w0, w1: [h] f32 taps;
// tables: [n_tables, res*4] f32, 16-byte aligned; out: [rows, h] i32.  All
// contiguous.  form: the tile's form, as spk_colormap_builtin's.  block_rows
// < 1, a span outside [1, bins] or a form refused is refused with
// cudaErrorInvalidValue.
SPK_EXPORT int spk_colormap_blockwise(const float* mag_l, const float* mag_r,
                                      int rows, int bins, int span,
                                      const int* j0, const int* j1,
                                      const float* w0, const float* w1, int h,
                                      const float* tables, int n_tables,
                                      int rows_per_table, int res,
                                      int block_rows, float min_db,
                                      float db_range, float db_eps,
                                      float inv_res1, int* out, int form,
                                      void* stream) {
  if (block_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const spk::TileArgs a{
      mag_l, mag_r, rows, bins, bins, span, j0, j1, w0, w1, h, tables, nullptr,
      n_tables, rows_per_table, res,
      spk::ColormapLaws{static_cast<float>(res), min_db, db_range, db_eps,
                        inv_res1}};
  return spk::launch_tile<false>(a, reinterpret_cast<unsigned*>(out),
                                 static_cast<cudaStream_t>(stream), form);
}
