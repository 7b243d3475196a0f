// The colormap kernels' per-pixel code (colormap_common.cuh) as a host
// library: one call colors `rows` rows of magnitude planes, every pixel as
// one thread of the kernels would, with the built-in body (v = null) or the
// generic body, row n reading the tables at (n / rows_per_table) % n_tables.
#include <cstddef>

#include "colormap_common.cuh"

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
