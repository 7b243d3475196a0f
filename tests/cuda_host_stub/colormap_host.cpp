// The colormap kernels' per-pixel code (colormap_common.cuh) as a host
// library: one call colors `rows` rows of magnitude planes, every pixel as
// one thread of the kernels would, with the built-in body (v = null) or the
// generic body, row n reading the tables at (n / rows_per_table) % n_tables;
// and the tile (colormap_tile.cuh) with each CTA's loop run in turn, as
// kernel B, the blockwise colormap and the generic kernel launch it.
#include <cstddef>
#include <cmath>
#include <cstring>
#include <vector>

#include "colormap_common.cuh"
#include "colormap_tile.cuh"

extern "C" int colormap_host_rows(const float* mag_l, const float* mag_r,
                                  int rows, int bins, const int* j0,
                                  const int* j1, const float* w0,
                                  const float* w1, int h, const float* u,
                                  const float* v, int n_tables,
                                  int rows_per_table, int res, float min_db,
                                  float db_range, float db_eps,
                                  float inv_res1, unsigned* out) {
  const spk::ColormapLaws laws{static_cast<float>(res), min_db, db_range,
                               db_eps, inv_res1};
  for (int row = 0; row < rows; ++row) {
    const size_t at = static_cast<size_t>(row) * bins;
    const float* tu = spk::row_table(u, row, rows_per_table, n_tables, res);
    for (int p = 0; p < h; ++p) {
      const spk::Texels x = spk::pixel_texels(mag_l + at, mag_r + at, j0[p],
                                              j1[p], w0[p], w1[p], laws);
      out[static_cast<size_t>(row) * h + p] =
          v == nullptr
              ? spk::builtin_word(x, tu, res, laws)
              : spk::generic_word(
                    x, tu, spk::row_table(v, row, rows_per_table, n_tables, res),
                    res);
    }
  }
  return 0;
}

// colormap_rows.cu: planar rows [n_rows, 2, bins], K taps per pixel ([h,
// taps] bins and weights), row n's factors at u, v + n * res * 4.
extern "C" int colormap_host_planar_rows(const float* rows, int n_rows,
                                         int bins, const int* tap_j,
                                         const float* tap_w, int h, int taps,
                                         const float* u, const float* v,
                                         int res, float min_db, float db_range,
                                         float db_eps, float inv_res1,
                                         unsigned* out) {
  const spk::ColormapLaws laws{static_cast<float>(res), min_db, db_range,
                               db_eps, inv_res1};
  for (int n = 0; n < n_rows; ++n) {
    const size_t table = static_cast<size_t>(n) * res * 4;
    for (int p = 0; p < h; ++p) {
      out[static_cast<size_t>(n) * h + p] = spk::planar_row_pixel(
          rows + static_cast<size_t>(n) * 2 * bins, bins,
          tap_j + static_cast<size_t>(p) * taps,
          tap_w + static_cast<size_t>(p) * taps, taps, u + table, v + table,
          res, laws);
    }
  }
  return 0;
}

// The tile's output on the host: each word stored, and each store counted.
struct CountedOut {
  unsigned* words;
  int* count;  // [rows, h]: stores of each word
  void store(size_t at, unsigned w) const {
    words[at] = w;
    ++count[at];
  }
};

template <bool kGeneric>
int host_tile(const spk::TileArgs& a, const CountedOut& out) {
  const spk::TileLayout lay =
      spk::tile_layout(a.span, spk::tile_table_floats(kGeneric, a.res));
  const int grid = spk::tile_grid(a.rows), threads = spk::tile_threads(a.h);
  for (int cta = 0; cta < grid; ++cta) {
    // the CTA's stages, NaN until a copy lands: a row whose table copy was
    // skipped reads the table its stage's previous row left
    std::vector<float> stages(static_cast<size_t>(spk::kTileStages) * lay.floats,
                              std::nanf(""));
    for (int i = 0; i < spk::tile_row_count(cta, grid, a.rows); ++i) {
      const int row = spk::tile_row(cta, grid, i);
      float* stage = stages.data() + static_cast<size_t>(i % spk::kTileStages) * lay.floats;
      const spk::RowCopies c = spk::row_copies(
          a, lay, row, spk::stage_prev_row(cta, grid, i), kGeneric);
      for (int k = 0; k < c.n; ++k) {
        const spk::CopySeg& seg = c.seg[k];
        if (seg.dst % 4 || seg.floats % 4 || seg.dst + seg.floats > lay.floats ||
            reinterpret_cast<uintptr_t>(seg.src) % 16) {
          return 2;  // a copy TMA would refuse, or one past its stage
        }
        std::memcpy(stage + seg.dst, seg.src, seg.floats * sizeof(float));
      }
      const spk::RowOperands op = spk::row_operands(a, lay, stage, row);
      for (int tid = 0; tid < threads; ++tid) {
        spk::color_row<kGeneric>(a, op, spk::group_taps(a, 0, tid, threads), tid,
                                 threads, out, row);
      }
    }
  }
  return 0;
}

// spk_colormap_builtin (v = null) or spk_colormap_generic as the tile runs
// it, whichever form the launch would take at this span and width: out
// [rows, h] words, count [rows, h] ints (added to).  Returns 1 where the
// launch refuses the span, 2 for a copy out of line.
extern "C" int colormap_host_tile(const float* mag_l, const float* mag_r,
                                  int rows, int bins, int span, const int* j0,
                                  const int* j1, const float* w0,
                                  const float* w1, int h, const float* u,
                                  const float* v, int n_tables,
                                  int rows_per_table, int res, float min_db,
                                  float db_range, float db_eps, float inv_res1,
                                  unsigned* out, int* count) {
  const spk::TileArgs a{mag_l, mag_r, rows, bins, bins, span, j0, j1, w0, w1, h, u, v,
                        n_tables, rows_per_table, res,
                        spk::ColormapLaws{static_cast<float>(res), min_db,
                                          db_range, db_eps, inv_res1}};
  if (span < 1 || span > bins) return 1;
  const CountedOut o{out, count};
  return v == nullptr ? host_tile<false>(a, o) : host_tile<true>(a, o);
}

// spk_colormap_blockwise's arguments as it hands them to kernel B's launch,
// the tile run as colormap_host_tile runs it (the row blocks change
// nothing): out and count as there.  Returns 3 where the entry refuses
// block_rows, else colormap_host_tile's code.
extern "C" int colormap_host_blockwise(
    const float* mag_l, const float* mag_r, int rows, int bins, int span,
    const int* j0, const int* j1, const float* w0, const float* w1, int h,
    const float* tables, int n_tables, int rows_per_table, int res,
    int block_rows, float min_db, float db_range, float db_eps,
    float inv_res1, unsigned* out, int* count) {
  if (block_rows < 1) return 3;
  return colormap_host_tile(mag_l, mag_r, rows, bins, span, j0, j1, w0, w1, h,
                            tables, nullptr, n_tables, rows_per_table, res,
                            min_db, db_range, db_eps, inv_res1, out, count);
}

// spk_colormap_rows at two taps as it hands the planar rows [n_rows, 2,
// bins] to the generic kernel's launch (`planar_tile_args`: tap-major taps
// [2, h], row n's factors at u, v + n * res * 4), the tile run as
// colormap_host_tile runs it: out and count as there.
extern "C" int colormap_host_planar_tile(
    const float* rows, int n_rows, int bins, int span, const int* tap_j,
    const float* tap_w, int h, const float* u, const float* v, int res,
    float min_db, float db_range, float db_eps, float inv_res1, unsigned* out,
    int* count) {
  if (span < 1 || span > bins) return 1;
  return host_tile<true>(
      spk::planar_tile_args(rows, n_rows, bins, span, tap_j, tap_w, h, u, v, res,
                            spk::ColormapLaws{static_cast<float>(res), min_db,
                                              db_range, db_eps, inv_res1}),
      CountedOut{out, count});
}

// colormap_tile.cuh `tile_staged`, as spk_colormap_form answers it: 1 where
// the launch takes the tile, 0 where it takes the direct form.
extern "C" int colormap_host_form(int span, int h, int res, int generic) {
  return spk::tile_staged(span, h, generic != 0, res) ? 1 : 0;
}

// colormap_tile.cuh `tile_launch_form`: the form a launch with `form`
// (kTileFormRule, kTileFormStaged, kTileFormDirect) takes, or -1 where the
// launch refuses it.
extern "C" int colormap_host_launch_form(int span, int h, int res, int generic,
                                         int form) {
  return spk::tile_launch_form(span, h, generic != 0, res, form);
}
