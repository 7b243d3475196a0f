// The tile of kernel B (colormap_builtin.cu), the blockwise colormap
// (colormap_blockwise.cu: kernel B's function and launch under its own
// export), the generic kernel (colormap_generic.cu) and the two-tap
// planar rows (colormap_rows.cu: the generic kernel's launch on [rows, 2,
// B] rows): one design, templated on the word.
//
// A CTA colors whole rows.  Its threads take kTilePixels = 4 pixels each
// (256 threads cover H = 1024 in one sweep; a narrower H takes fewer warps,
// a wider one more sweeps), and hold the taps of their first sweep in
// registers for every row the CTA takes.  CTA c of a grid of G takes rows
// c, c + G, c + 2G, ... (`tile_grid`: about kTileRowsPerCta rows each), so
// no row count meets a grid limit.
//
// A row's operands go to shared memory ahead of use, kTileStages rows deep,
// each in a TMA bulk copy: its left and right planes over bins [0, span),
// span = the taps' highest bin + 1, and its table (R*4 floats built-in, U
// and V generic) unless the stage already holds it.  A plane's rows lie `ld`
// floats apart: the plane width, or twice it for planar rows [rows, 2, B]
// whose right plane starts B floats into the row (colormap_rows.cu).  A
// plane row is 16-byte aligned only where 4 divides its offset (not at B =
// 2205, the ring's W - 1, or planar rows of B = 2047, whose right planes
// start 8,188 bytes in), so the copy starts at the row's address rounded
// down to 16 bytes and its length is rounded up; the row's bin 0 lies
// `shift` floats into the staged copy.  Every pixel runs through colormap_common.cuh's
// `pixel_texels` and `builtin_word` / `generic_word`, so the bits are the
// per-pixel code's whatever the tile.
//
// The staged form copies every bin below the span for each row, where the
// direct form, `colormap_direct_kernel` (the first kernels' structure and
// code: one pixel per thread, every read from device memory), reads only
// the sectors its pixels' taps touch.  So the tile pays only where the span
// is small beside the row's pixels: `tile_staged` takes it where span <=
// 2.25h (built-in) or 3h (generic, whose sixteen table reads a pixel leave
// more time to cover the copies) and two stages fit the default 48 KB of
// dynamic shared memory, else the direct form.  On an H100 80GB HBM3 at
// 700 W and H = 1024, the tile took 0.86-0.89x the direct form's time at
// spans of 1,875-2,205 bins, 1.02x (built-in) / 0.84x (generic) at 2,929,
// 1.18x / 0.95x at 3,749 and 1.30-1.47x / 1.08-1.28x at 5,491-7,029; at
// H = 512, 0.95x / 0.87x at 1,096 and 1.25x / 1.10x at 1,869 (PERF.md
// §6).  So at H = 1024 the main paths (spans 1,875-2,205) take the
// tile, and windows from N = 6,400 (built-in) or 8,192 (generic) up the
// direct form.
//
// On that card the tile is bound by the per-pixel arithmetic as much as by
// its copies: without its plane copies it takes 86% of its time, without
// its arithmetic 90% (PERF.md §6).  TMA's bulk copies beat 16-byte
// cp.async by 1.5x, four rows per CTA beat 8, 16 and 32, a third stage
// helped only past 8,192 rows, and a 16-byte store of a thread's four
// words measured neutral, so each word goes out on its own.
//
// Everything above the `__CUDACC__` section compiles for the host against
// tests/cuda_host_stub/cuda_runtime.h: colormap_host.cpp there runs a CTA's
// loop on the CPU with these functions, the copies as memcpy into an array.
// The sizing functions are __host__ __device__ for the launch.
#pragma once

#include <cstddef>
#include <cstdint>

#include "colormap_common.cuh"

namespace spk {

constexpr int kTileThreads = 256;        // a CTA's threads at H >= 1024
constexpr int kTilePixels = 4;           // consecutive pixels per thread
constexpr int kTileRowsPerCta = 4;       // rows per CTA (the grid's size)
constexpr int kTileStages = 2;           // rows in flight per CTA
// the staged form's shared memory at most: the default limit of dynamic
// shared memory, so the launch needs no opt-in
constexpr int kTileMaxStagedBytes = 48 * 1024;

// The kernels' operands.
struct TileArgs {
  const float* mag_l;  // row n's bins at mag_l + n * ld
  const float* mag_r;
  int rows, bins;
  int ld;              // floats from a plane's row to the next: bins for
                       // [rows, bins] planes, 2 * bins for planar rows
                       // [rows, 2, bins] (colormap_rows.cu)
  int span;            // the taps' highest bin + 1, at most bins
  const int* j0;       // [h] taps
  const int* j1;
  const float* w0;
  const float* w1;
  int h;
  const float* u_tables;  // [n_tables, res*4]: built-in tables, or U
  const float* v_tables;  // [n_tables, res*4]: V, or null (built-in)
  int n_tables, rows_per_table, res;
  ColormapLaws laws;
};

// The operands of the two-tap planar rows [rows, 2, bins] (colormap_rows.cu):
// each row's right plane `bins` floats after its left, rows 2 * bins
// apart; the taps tap-major [2, h] (tap_j: every j0, then every j1; tap_w
// likewise); row n's factors the n-th of [rows, res * 4] U and V.
__host__ __device__ __forceinline__ TileArgs planar_tile_args(
    const float* rows, int n_rows, int bins, int span, const int* tap_j,
    const float* tap_w, int h, const float* u, const float* v, int res,
    const ColormapLaws& laws) {
  return TileArgs{rows, rows + bins, n_rows, bins, 2 * bins, span,
                  tap_j, tap_j + h, tap_w, tap_w + h, h, u, v, n_rows, 1, res,
                  laws};
}

// Threads of a CTA at width h: warps enough for its pixel groups, at most
// kTileThreads.
__host__ __device__ __forceinline__ int tile_threads(int h) {
  const int groups = (h + kTilePixels - 1) / kTilePixels;
  const int threads = (groups + 31) / 32 * 32;
  return threads < kTileThreads ? threads : kTileThreads;
}

__host__ __device__ __forceinline__ int tile_grid(int rows) {
  return (rows + kTileRowsPerCta - 1) / kTileRowsPerCta;
}

// How many rows CTA `cta` of `grid` takes: rows cta + i * grid, i below it.
__device__ __forceinline__ int tile_row_count(int cta, int grid, int rows) {
  return cta < rows ? (rows - 1 - cta) / grid + 1 : 0;
}

// The i-th row of CTA `cta`, and the row its stage i % kTileStages held
// before it (-1 for none).
__device__ __forceinline__ int tile_row(int cta, int grid, int i) {
  return cta + i * grid;
}

__device__ __forceinline__ int stage_prev_row(int cta, int grid, int i) {
  return i < kTileStages ? -1 : tile_row(cta, grid, i - kTileStages);
}

// Floats of one staged plane row in shared memory: span plus the largest
// shift, in whole 16-byte chunks.
__host__ __device__ __forceinline__ int staged_plane_floats(int span) {
  return (span + 3 + 3) / 4 * 4;
}

// Where a stage keeps a row's operands, in floats from the stage's start;
// every offset a multiple of 4 (16 bytes).
struct TileLayout {
  int l, r, tab;  // left plane, right plane, tables (U, then V)
  int floats;     // the stage
};

__host__ __device__ __forceinline__ int tile_table_floats(bool generic,
                                                          int res) {
  return (generic ? 2 : 1) * res * 4;
}

__host__ __device__ __forceinline__ TileLayout tile_layout(int span,
                                                           int table_floats) {
  const int plane = staged_plane_floats(span);
  return TileLayout{0, plane, 2 * plane, 2 * plane + table_floats};
}

__host__ __device__ __forceinline__ size_t tile_smem_bytes(int span,
                                                           int table_floats) {
  return static_cast<size_t>(kTileStages) *
         tile_layout(span, table_floats).floats * sizeof(float);
}

// The form a launch takes: the tile where span <= 2.25h (built-in) or 3h
// (generic) and its stages fit kTileMaxStagedBytes, else the direct form.
__host__ __device__ __forceinline__ bool tile_staged(int span, int h,
                                                     bool generic, int res) {
  return 4 * span <= (generic ? 12 : 9) * h &&
         tile_smem_bytes(span, tile_table_floats(generic, res)) <=
             kTileMaxStagedBytes;
}

// A tile launch's form, the `form` argument of kernel B, the blockwise
// colormap, the generic kernel and the two-tap planar rows: kTileFormRule
// takes `tile_staged`'s rule; kTileFormStaged the staged tile wherever its
// stages fit kTileMaxStagedBytes, at any span (the tile's code holds at
// every span up to the planes' bins: the span ratio of the rule is a speed
// rule); kTileFormDirect the direct form, at any span.  Both forms give the
// same bits (every pixel runs `pixel_texels` and the same word).
// ops/cuda/colormap_kernel.py `TILE_FORMS` mirrors these values, and
// utils/autotune.py measures them.
constexpr int kTileFormRule = 0;
constexpr int kTileFormStaged = 1;
constexpr int kTileFormDirect = 2;

// The form a launch with `form` takes (kTileFormStaged or kTileFormDirect),
// or -1 where it is refused: a staged form whose stages do not fit, or a
// value outside the three.
__host__ __device__ __forceinline__ int tile_launch_form(int span, int h, bool generic,
                                                         int res, int form) {
  switch (form) {
    case kTileFormRule:
      return tile_staged(span, h, generic, res) ? kTileFormStaged : kTileFormDirect;
    case kTileFormStaged:
      return tile_smem_bytes(span, tile_table_floats(generic, res)) <= kTileMaxStagedBytes
                 ? kTileFormStaged
                 : -1;
    case kTileFormDirect:
      return kTileFormDirect;
  }
  return -1;
}

// A plane row's staged copy: the source rounded down to 16 bytes is
// `shift` floats before the row, and `floats` (a multiple of 4) cover
// bins [0, span).
struct StagedRow {
  int shift, floats;
};

__device__ __forceinline__ StagedRow staged_row(const float* row, int span) {
  const int shift = static_cast<int>((reinterpret_cast<uintptr_t>(row) & 15u) >> 2);
  return StagedRow{shift, (shift + span + 3) / 4 * 4};
}

// One copy into a stage: `floats` floats from `src` to stage + dst.
struct CopySeg {
  int dst;
  const float* src;
  int floats;
};

struct RowCopies {
  CopySeg seg[4];
  int n;
};

__device__ __forceinline__ const float* plane_row(const float* plane, int row,
                                                  int ld) {
  return plane + static_cast<size_t>(row) * ld;
}

// What a stage receives for `row`: its planes' staged copies and its
// table, or U and V (generic), unless `prev`, the row the stage held before
// (-1 for none), left the same table(s) there.  A table that every CTA
// copied for every row would have all SMs read the same few L2 lines at
// once (one table for all rows).
__device__ __forceinline__ RowCopies row_copies(const TileArgs& a,
                                                const TileLayout& lay, int row,
                                                int prev, bool generic) {
  RowCopies c{};
  const float* l = plane_row(a.mag_l, row, a.ld);
  const float* r = plane_row(a.mag_r, row, a.ld);
  const StagedRow sl = staged_row(l, a.span), sr = staged_row(r, a.span);
  c.seg[c.n++] = CopySeg{lay.l, l - sl.shift, sl.floats};
  c.seg[c.n++] = CopySeg{lay.r, r - sr.shift, sr.floats};
  const float* u =
      row_table(a.u_tables, row, a.rows_per_table, a.n_tables, a.res);
  if (prev >= 0 &&
      row_table(a.u_tables, prev, a.rows_per_table, a.n_tables, a.res) == u) {
    return c;
  }
  const int table = a.res * 4;
  c.seg[c.n++] = CopySeg{lay.tab, u, table};
  if (generic) {
    c.seg[c.n++] = CopySeg{
        lay.tab + table,
        row_table(a.v_tables, row, a.rows_per_table, a.n_tables, a.res), table};
  }
  return c;
}

// Where `row`'s operands are once `stage` holds its copies: the planes'
// bin 0 and the tables.
struct RowOperands {
  const float* l;
  const float* r;
  const float* u;
  const float* v;
};

__device__ __forceinline__ RowOperands row_operands(const TileArgs& a,
                                                    const TileLayout& lay,
                                                    const float* stage,
                                                    int row) {
  const int sl = staged_row(plane_row(a.mag_l, row, a.ld), a.span).shift;
  const int sr = staged_row(plane_row(a.mag_r, row, a.ld), a.span).shift;
  return RowOperands{stage + lay.l + sl, stage + lay.r + sr, stage + lay.tab,
                     stage + lay.tab + a.res * 4};
}

// Pixel q of the group thread `tid` of `threads` colors in sweep s: four
// consecutive pixels per thread.
__device__ __forceinline__ int group_pixel(int s, int tid, int threads, int q) {
  return (s * threads + tid) * kTilePixels + q;
}

// The taps of thread tid's group in sweep s; a pixel at or past h reads bin
// 0 with weight 0 and is never stored.
struct GroupTaps {
  int a[kTilePixels], b[kTilePixels];
  float wa[kTilePixels], wb[kTilePixels];
};

__device__ __forceinline__ GroupTaps group_taps(const TileArgs& a, int s,
                                                int tid, int threads) {
  GroupTaps t;
  for (int q = 0; q < kTilePixels; ++q) {
    const int p = group_pixel(s, tid, threads, q);
    const bool in = p < a.h;
    t.a[q] = in ? a.j0[p] : 0;
    t.b[q] = in ? a.j1[p] : 0;
    t.wa[q] = in ? a.w0[p] : 0.f;
    t.wb[q] = in ? a.w1[p] : 0.f;
  }
  return t;
}

// Thread tid's group of sweep s of a row whose operands are `op`, into
// out.store at row_at + pixel, the pixels at or past h left out.
template <bool kGeneric, class Out>
__device__ __forceinline__ void color_group(const TileArgs& a,
                                            const RowOperands& op,
                                            const GroupTaps& t, int s, int tid,
                                            int threads, const Out& out,
                                            size_t row_at) {
  unsigned w[kTilePixels];
  for (int q = 0; q < kTilePixels; ++q) {
    const Texels x =
        pixel_texels(op.l, op.r, t.a[q], t.b[q], t.wa[q], t.wb[q], a.laws);
    if constexpr (kGeneric) {
      w[q] = generic_word(x, op.u, op.v, a.res);
    } else {
      w[q] = builtin_word(x, op.u, a.res, a.laws);
    }
  }
  const int p0 = group_pixel(s, tid, threads, 0);
  for (int q = 0; q < kTilePixels; ++q) {
    if (p0 + q < a.h) out.store(row_at + p0 + q, w[q]);
  }
}

// Thread `tid` of `threads` colors its groups of `row`, sweep by sweep;
// `first` holds its taps of sweep 0.
template <bool kGeneric, class Out>
__device__ __forceinline__ void color_row(const TileArgs& a,
                                          const RowOperands& op,
                                          const GroupTaps& first, int tid,
                                          int threads, const Out& out,
                                          int row) {
  const size_t row_at = static_cast<size_t>(row) * a.h;
  if (group_pixel(0, tid, threads, 0) < a.h) {
    color_group<kGeneric>(a, op, first, 0, tid, threads, out, row_at);
  }
  for (int s = 1; group_pixel(s, tid, threads, 0) < a.h; ++s) {
    color_group<kGeneric>(a, op, group_taps(a, s, tid, threads), s, tid,
                          threads, out, row_at);
  }
}

#ifdef __CUDACC__

// The kernels' output: [rows, h] RGBA8888 words.
struct TileOut {
  unsigned* words;
  __device__ __forceinline__ void store(size_t at, unsigned w) const {
    words[at] = w;
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

// One arrival that announces `bytes` of copies to come.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// TMA's 1-D bulk copy, completing on `bar`: both addresses 16-byte
// aligned, `bytes` a multiple of 16.
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The tile kernel: CTA blockIdx.x of gridDim.x colors its rows, thread 0
// keeping kTileStages - 1 rows' copies in flight ahead of the row the CTA
// colors.  Stage s holds rows i with i % kTileStages == s; the barrier of
// stage s completes once per row it receives, so row i waits on parity
// (i / kTileStages) & 1.  The __syncthreads() after a row frees its stage
// for the copy issued at the top of the next iteration.
template <bool kGeneric>
__global__ void __launch_bounds__(kTileThreads)
    colormap_tile_kernel(const TileArgs a, unsigned* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t full[kTileStages];
  const int tid = threadIdx.x;
  const TileLayout lay = tile_layout(a.span, tile_table_floats(kGeneric, a.res));
  const int n = tile_row_count(blockIdx.x, gridDim.x, a.rows);
  const auto issue = [&](int i) {
    const int s = i % kTileStages;
    const RowCopies c =
        row_copies(a, lay, tile_row(blockIdx.x, gridDim.x, i),
                   stage_prev_row(blockIdx.x, gridDim.x, i), kGeneric);
    unsigned bytes = 0;
    for (int k = 0; k < c.n; ++k) bytes += c.seg[k].floats * sizeof(float);
    mbar_expect(&full[s], bytes);
    for (int k = 0; k < c.n; ++k) {
      bulk_load(smem + s * lay.floats + c.seg[k].dst, c.seg[k].src,
                c.seg[k].floats * sizeof(float), &full[s]);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < kTileStages; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < kTileStages - 1 && i < n; ++i) issue(i);
  }
  __syncthreads();
  const GroupTaps first = group_taps(a, 0, tid, blockDim.x);
  const TileOut o{out};
  for (int i = 0; i < n; ++i) {
    if (tid == 0 && i + kTileStages - 1 < n) issue(i + kTileStages - 1);
    const int s = i % kTileStages;
    mbar_wait(&full[s], (i / kTileStages) & 1);
    const int row = tile_row(blockIdx.x, gridDim.x, i);
    const RowOperands op = row_operands(a, lay, smem + s * lay.floats, row);
    color_row<kGeneric>(a, op, first, tid, blockDim.x, o, row);
    __syncthreads();
  }
}

// The direct form, for spans too wide to stage: the first kernels, one
// pixel per thread of kDirectThreads, its taps in registers, rows walked by
// blockIdx.y, every read straight from device memory, each word computed
// in their order (the built-in word's table picked before its planes are
// read: computed after them it ran 3-7% slower).  A tile that read the
// planes in place and staged only the tables ran 1.18-1.32x slower at N =
// 16,384 and 48,000.
constexpr int kDirectThreads = 128;
constexpr int kMaxGridY = 65535;

template <bool kGeneric>
__global__ void __launch_bounds__(kDirectThreads) colormap_direct_kernel(
    const float* __restrict__ mag_l, const float* __restrict__ mag_r,
    int rows, int ld, const int* __restrict__ j0,
    const int* __restrict__ j1, const float* __restrict__ w0,
    const float* __restrict__ w1, int h, const float* __restrict__ u_tables,
    const float* __restrict__ v_tables, int n_tables, int rows_per_table,
    int res, ColormapLaws laws, unsigned* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= h) return;
  const int a = j0[p], b = j1[p];
  const float wa = w0[p], wb = w1[p];
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const size_t at = static_cast<size_t>(row) * ld;
    if constexpr (kGeneric) {
      const Texels x = pixel_texels(mag_l + at, mag_r + at, a, b, wa, wb, laws);
      out[static_cast<size_t>(row) * h + p] = generic_word(
          x, row_table(u_tables, row, rows_per_table, n_tables, res),
          row_table(v_tables, row, rows_per_table, n_tables, res), res);
    } else {
      const float* tab = row_table(u_tables, row, rows_per_table, n_tables, res);
      out[static_cast<size_t>(row) * h + p] =
          colormap_pixel(mag_l + at, mag_r + at, a, b, wa, wb, tab, res, laws);
    }
  }
}

// Launch kernel B or the blockwise colormap (kGeneric false), or the
// generic kernel, in the form `form` names (`tile_launch_form`); returns the
// launch's error (cudaErrorInvalidValue for a span outside [1, bins] or a
// form refused).
template <bool kGeneric>
int launch_tile(const TileArgs& a, unsigned* out, cudaStream_t stream,
                int form = kTileFormRule) {
  const int f = tile_launch_form(a.span, a.h, kGeneric, a.res, form);
  if (a.span < 1 || a.span > a.bins || f < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (f == kTileFormDirect) {
    const dim3 grid((a.h + kDirectThreads - 1) / kDirectThreads,
                    a.rows < kMaxGridY ? a.rows : kMaxGridY);
    colormap_direct_kernel<kGeneric><<<grid, kDirectThreads, 0, stream>>>(
        a.mag_l, a.mag_r, a.rows, a.ld, a.j0, a.j1, a.w0, a.w1, a.h,
        a.u_tables, a.v_tables, a.n_tables, a.rows_per_table, a.res, a.laws,
        out);
    return static_cast<int>(cudaGetLastError());
  }
  colormap_tile_kernel<kGeneric><<<
      tile_grid(a.rows), tile_threads(a.h),
      tile_smem_bytes(a.span, tile_table_floats(kGeneric, a.res)), stream>>>(
      a, out);
  return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__

}  // namespace spk
