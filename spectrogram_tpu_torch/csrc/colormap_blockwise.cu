// The blockwise built-in colormap: kernel B's function, with one palette
// table staged per block of rows where the block allows it.
//
// Replaces spectrogram_tpu/ops/pallas/colormap_kernel.py
// `colormap_planes_banded` with the body `_blockwise_builtin_kernel` and its
// operands `_blockwise_operands`: per block of `block_rows` window-major rows,
// one flag says whether every row of the block reads the same table; such a
// block reads that one table, a mixed block reads per-row tables.  The TPU
// computed the flags and the block tables in a pass before the kernel and
// prefetched them into SMEM as scalars; here each CTA decides its own block's
// flag when it starts: every row it covers must read a table equal, byte for
// byte, to its first row's (as `_blockwise_operands` compares).  That holds
// for any rows % block_rows, with no extra launch and no flag array.  A
// uniform block stages its table (res*4 floats, 512 bytes at R=32) in shared
// memory once; a mixed block reads the per-row tables as kernel B does.
//
// Every pixel goes through colormap_common.cuh's `colormap_pixel`, the body
// of kernel B (colormap_builtin.cu), so both arms give kernel B's bits.
//
// One CTA covers one block of rows and 128 pixel columns: threadIdx.x is the
// pixel, threadIdx.y one of kRowGroups interleaved row groups of the block.
//
// What bounds it on this card: as kernel B, device memory (4 bytes out per
// pixel) and the gathers of the taps.  A per-row table is 512 bytes against
// the row's 4 KB of output, mostly L2 hits, so a staged table is expected to
// save little here; the flag costs one coalesced read of each row's table.
#include "colormap_common.cuh"

namespace {

constexpr int kPixels = 128;
constexpr int kRowGroups = 4;
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kPixels * kRowGroups)
    colormap_blockwise_kernel(
        const float* __restrict__ mag_l, const float* __restrict__ mag_r,
        int rows, int bins, const int* __restrict__ j0,
        const int* __restrict__ j1, const float* __restrict__ w0,
        const float* __restrict__ w1, int h, const float* __restrict__ tables,
        int n_tables, int rows_per_table, int res, int block_rows,
        spk::ColormapLaws laws, unsigned* __restrict__ out) {
  extern __shared__ float staged[];  // res*4 floats: a uniform block's table
  const int res4 = res * 4;
  const int p = blockIdx.x * kPixels + threadIdx.x;
  const bool active = p < h;
  int a = 0, b = 0;
  float wa = 0.f, wb = 0.f;
  if (active) {
    a = j0[p];
    b = j1[p];
    wa = w0[p];
    wb = w1[p];
  }
  const int tid = threadIdx.y * kPixels + threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kWarps = kPixels * kRowGroups / 32;
  const int n_blocks = (rows + block_rows - 1) / block_rows;
  for (int blk = blockIdx.y; blk < n_blocks; blk += gridDim.y) {
    const int r0 = blk * block_rows;
    const int r1 = min(r0 + block_rows, rows);
    const float* first = spk::row_table(tables, r0, rows_per_table, n_tables, res);
    // the flag: one warp per row compares the row's table with the first
    // row's, as bits (so -0 and +0 differ: "byte for byte")
    const auto* want = reinterpret_cast<const unsigned*>(first);
    int differs = 0;
    for (int r = r0 + 1 + warp; r < r1 && !differs; r += kWarps) {
      const auto* got = reinterpret_cast<const unsigned*>(
          spk::row_table(tables, r, rows_per_table, n_tables, res));
      if (got == want) continue;
      for (int i = lane; i < res4; i += 32) differs |= got[i] != want[i];
    }
    const bool uniform = !__syncthreads_or(differs);
    if (uniform) {
      for (int i = tid; i < res4; i += kPixels * kRowGroups) staged[i] = first[i];
    }
    __syncthreads();
    if (active) {
      for (int row = r0 + threadIdx.y; row < r1; row += kRowGroups) {
        const size_t at = static_cast<size_t>(row) * bins;
        const float* tab =
            uniform ? staged
                    : spk::row_table(tables, row, rows_per_table, n_tables, res);
        out[static_cast<size_t>(row) * h + p] = spk::colormap_pixel(
            mag_l + at, mag_r + at, a, b, wa, wb, tab, res, laws);
      }
    }
    __syncthreads();  // the next block restages `staged`
  }
}

}  // namespace

// As spk_colormap_builtin, with rows grouped into blocks of block_rows for
// the per-block table test.  mag_l, mag_r: [rows, bins] f32; j0, j1: [h] i32
// and w0, w1: [h] f32 taps; tables: [n_tables, res*4] f32; out: [rows, h]
// i32.  All contiguous.
SPK_EXPORT int spk_colormap_blockwise(const float* mag_l, const float* mag_r,
                                      int rows, int bins, const int* j0,
                                      const int* j1, const float* w0,
                                      const float* w1, int h,
                                      const float* tables, int n_tables,
                                      int rows_per_table, int res,
                                      int block_rows, float min_db,
                                      float db_range, float db_eps,
                                      float inv_res1, int* out, void* stream) {
  const int n_blocks = (rows + block_rows - 1) / block_rows;
  const dim3 grid((h + kPixels - 1) / kPixels,
                  n_blocks < kMaxGridY ? n_blocks : kMaxGridY);
  const dim3 block(kPixels, kRowGroups);
  colormap_blockwise_kernel<<<grid, block, res * 4 * sizeof(float),
                              static_cast<cudaStream_t>(stream)>>>(
      mag_l, mag_r, rows, bins, j0, j1, w0, w1, h, tables, n_tables,
      rows_per_table, res, block_rows,
      spk::ColormapLaws{static_cast<float>(res), min_db, db_range, db_eps,
                        inv_res1},
      reinterpret_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}
