// Kernel B: the per-row built-in colormap, magnitude planes -> RGBA8888.
//
// Replaces spectrogram_tpu/ops/pallas/colormap_kernel.py
// `colormap_planes_banded` with the per-row body `_builtin_kernel` (via
// `_builtin_word_tile`, `_resample_and_laws` and `_tent_lut_channels`).  The
// TPU kernel wrote the two-tap resample as a banded matmul and the LUT read
// as a tent-basis sum, both to avoid gathers; here each thread reads its two
// taps and its two LUT entries directly.
//
// Per pixel p of row n (the reference's fragment shader,
// gpu_spectrogram.rs:158-190):
//   pl = w0[p]*L[n, j0[p]] + w1[p]*L[n, j1[p]], pr the same on R
//   mag = (10*log10(pl^2 + pr^2 + eps) - min_db) / (max_db - min_db)
//   pan = pr / (pl + pr), or 0.5 where pl + pr == 0
//   xu, xv = clamp(clamp(mag|pan, 0, 1)*R - 0.5, 0, R-1)
//   stereo = tab[3]; x = stereo ? xv : xu
//   rgb = two-tap linear read of tab[t*4 + c]; alpha = stereo ? xu/(R-1) : 1
//   word = q(r) | q(g) << 8 | q(b) << 16 | q(a) << 24, q(v) = clamp(rint(255v))
// with the row's table tab = tables[(n / rows_per_table) % n_tables]:
// rows_per_table = 1 and n_tables = S for per-stream tables over the push's
// window-major rows, rows_per_table = R' for the viewport's stream-major
// rows (R' rows per stream), n_tables = 1 for one palette for all rows.
//
// Every multiply and add is written with the _rn intrinsics so that nvcc does
// not contract them into FMAs: the plain PyTorch version rounds each one, and
// so did the JAX kernel.  rintf rounds half to even, as jnp.round does.
//
// What bounds it on this card: device memory.  It writes 4 bytes per pixel
// and reads two f32 taps per channel per pixel (mostly L1/L2 hits, since
// neighbouring pixels share bins); the arithmetic is ~40 flops and one log10f.
#include "spk_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float clamp01(float v, float hi) {
  return fminf(fmaxf(v, 0.f), hi);
}

// GL clamped-linear texel position: clamp(clamp(c,0,1)*R - 0.5, 0, R-1).
__device__ __forceinline__ float texel(float c, float res) {
  return clamp01(__fsub_rn(__fmul_rn(clamp01(c, 1.f), res), 0.5f), res - 1.f);
}

__device__ __forceinline__ unsigned quantize(float v) {
  return static_cast<unsigned>(clamp01(rintf(__fmul_rn(v, 255.f)), 255.f));
}

__global__ void __launch_bounds__(kThreads) colormap_builtin_kernel(
    const float* __restrict__ mag_l, const float* __restrict__ mag_r,
    int rows, int bins, const int* __restrict__ j0,
    const int* __restrict__ j1, const float* __restrict__ w0,
    const float* __restrict__ w1, int h, const float* __restrict__ tables,
    int n_tables, int rows_per_table, int res, float min_db, float db_range,
    float db_eps, float inv_res1, unsigned* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= h) return;
  const int a = j0[p], b = j1[p];
  const float wa = w0[p], wb = w1[p];
  const float fres = static_cast<float>(res);
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const float* L = mag_l + static_cast<size_t>(row) * bins;
    const float* R = mag_r + static_cast<size_t>(row) * bins;
    const float pl = __fadd_rn(__fmul_rn(wa, L[a]), __fmul_rn(wb, L[b]));
    const float pr = __fadd_rn(__fmul_rn(wa, R[a]), __fmul_rn(wb, R[b]));
    const float power = __fadd_rn(__fmul_rn(pl, pl), __fmul_rn(pr, pr));
    const float db = __fmul_rn(10.f, log10f(__fadd_rn(power, db_eps)));
    const float mag = __fdiv_rn(__fsub_rn(db, min_db), db_range);
    const float denom = __fadd_rn(pl, pr);
    const float pan = denom != 0.f ? __fdiv_rn(pr, denom) : 0.5f;
    const float xu = texel(mag, fres);
    const float xv = texel(pan, fres);

    const int table = (row / rows_per_table) % n_tables;
    const float* tab = tables + static_cast<size_t>(table) * (res * 4);
    const bool stereo = tab[3] != 0.f;
    const float x = stereo ? xv : xu;
    const float f0 = floorf(x);
    const int t0 = static_cast<int>(f0);
    const int t1 = min(t0 + 1, res - 1);
    const float wlo = clamp01(__fsub_rn(1.f, fabsf(__fsub_rn(x, f0))), 1.f);
    const float whi =
        clamp01(__fsub_rn(1.f, fabsf(__fsub_rn(x, __fadd_rn(f0, 1.f)))), 1.f);
    unsigned word = 0;
    for (int c = 0; c < 3; ++c) {
      const float v = __fadd_rn(__fmul_rn(wlo, tab[t0 * 4 + c]),
                                __fmul_rn(whi, tab[t1 * 4 + c]));
      word |= quantize(v) << (8 * c);
    }
    const float alpha = stereo ? __fmul_rn(xu, inv_res1) : 1.f;
    word |= quantize(alpha) << 24;
    out[static_cast<size_t>(row) * h + p] = word;
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
      rows_per_table, res, min_db, db_range, db_eps, inv_res1,
      reinterpret_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}
