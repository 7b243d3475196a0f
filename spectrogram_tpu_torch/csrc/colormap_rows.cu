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
// as K taps per pixel (`resample_taps_k`: an ELL form, K = the most nonzeros
// of any pixel column, padding taps of weight 0).
//
// Every matrix the package builds has K = 2, and then the function is the
// generic kernel's (colormap_generic.cu) on row n's left plane at rows +
// n*2B and right plane at + B: the launch is the generic kernel's row tile
// (colormap_tile.cuh `launch_tile<true>`, in the form `tile_staged` names)
// with a plane row stride of 2B, row n's tables as table n, and the two
// taps tap-major ([2, H]: the j0, w0 of every pixel, then j1, w1), so the
// words equal `colormap_generic`'s on copies of the planes bit for bit.  A
// denser matrix (K > 2) takes `colormap_rows_kernel`: one pixel per thread,
// its K taps summed in ascending bin order (`tap_sum`), rows walked by
// blockIdx.y, every read from device memory (`planar_row_pixel`).
//
// The output is the packed word [N, H] (byte 0 = R); the u8 form [N, H, 4]
// is the same buffer viewed as bytes, which is the JAX kernel's channel
// planes moved to the last axis.
//
// What bounds it on this card: as the generic kernel, its copies of each
// row's planes over [0, span) and its two tables (1 KB against 4 KB of
// output at H = 1024) and its per-pixel arithmetic (~70 flops, two IEEE
// divisions and a log10f), about equally.  Its first form, one pixel per
// thread at K = 2, took 0.0506 ms at 4,096 rows of [2, 2047], H = 1024,
// against the tile's 0.042 on the generic kernel's planes (PERF.md §6).
#include "colormap_tile.cuh"

namespace {

constexpr int kThreads = 128;

// The kernel the last spk_colormap_rows call launched (-1 before any): 0
// colormap_rows_kernel, 1 the row tile staged, 2 the row tile direct.
int g_route = -1;

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

// rows: [n_rows, 2, bins] f32; span: the taps' highest bin + 1; tap_j,
// tap_w: at taps == 2 tap-major [2, h] (i32, f32), else pixel-major [h,
// taps], every tap below bins; u_tables, v_tables: [n_rows, res, 4] f32,
// 16-byte aligned at taps == 2; out: [n_rows, h] i32.  All contiguous.
// form: at taps == 2 the row tile's form (colormap_tile.cuh kTileFormRule,
// kTileFormStaged or kTileFormDirect); at other taps it must be
// kTileFormRule.
SPK_EXPORT int spk_colormap_rows(const float* rows, int n_rows, int bins,
                                 int span, const int* tap_j,
                                 const float* tap_w, int h, int taps,
                                 const float* u_tables,
                                 const float* v_tables, int res, float min_db,
                                 float db_range, float db_eps, float inv_res1,
                                 int* out, int form, void* stream) {
  const spk::ColormapLaws laws{static_cast<float>(res), min_db, db_range,
                               db_eps, inv_res1};
  const auto st = static_cast<cudaStream_t>(stream);
  if (taps == 2) {
    const spk::TileArgs a = spk::planar_tile_args(
        rows, n_rows, bins, span, tap_j, tap_w, h, u_tables, v_tables, res, laws);
    const int f = spk::tile_launch_form(a.span, a.h, true, a.res, form);
    if (f < 0) return static_cast<int>(cudaErrorInvalidValue);
    g_route = f == spk::kTileFormStaged ? 1 : 2;
    return spk::launch_tile<true>(a, reinterpret_cast<unsigned*>(out), st, form);
  }
  if (form != spk::kTileFormRule) return static_cast<int>(cudaErrorInvalidValue);
  g_route = 0;
  const dim3 grid((h + kThreads - 1) / kThreads,
                  n_rows < spk::kMaxGridY ? n_rows : spk::kMaxGridY);
  colormap_rows_kernel<<<grid, kThreads, 0, st>>>(
      rows, n_rows, bins, tap_j, tap_w, h, taps, u_tables, v_tables, res,
      laws, reinterpret_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Which kernel spk_colormap_rows launched last, as g_route above.
SPK_EXPORT int spk_colormap_rows_route() { return g_route; }
