// Device code shared by the colormap kernels: one pixel of one row, from the
// two magnitude planes to its RGBA8888 word.
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
//
// Every multiply and add is written with the _rn intrinsics so that nvcc does
// not contract them into FMAs: the plain PyTorch version rounds each one, and
// so did the JAX kernel.  rintf rounds half to even, as jnp.round does.  Both
// kernels (colormap_builtin.cu, colormap_blockwise.cu) run every pixel through
// `colormap_pixel`, so for the same table they give the same bits.
#pragma once

#include "spk_common.cuh"

namespace spk {

struct ColormapLaws {
  float res;       // LUT entries R, as a float
  float min_db;
  float db_range;  // max_db - min_db
  float db_eps;
  float inv_res1;  // 1 / (R - 1)
};

__device__ __forceinline__ float clamp_to(float v, float hi) {
  return fminf(fmaxf(v, 0.f), hi);
}

// GL clamped-linear texel position: clamp(clamp(c,0,1)*R - 0.5, 0, R-1).
__device__ __forceinline__ float texel(float c, float res) {
  return clamp_to(__fsub_rn(__fmul_rn(clamp_to(c, 1.f), res), 0.5f), res - 1.f);
}

__device__ __forceinline__ unsigned quantize(float v) {
  return static_cast<unsigned>(clamp_to(rintf(__fmul_rn(v, 255.f)), 255.f));
}

// The word of the pixel whose taps (a, b, wa, wb) read the row's planes L, R,
// colored with the [R*4] table `tab` (rgb entries t*4+c, stereo flag tab[3]).
__device__ __forceinline__ unsigned colormap_pixel(
    const float* __restrict__ L, const float* __restrict__ R, int a, int b,
    float wa, float wb, const float* __restrict__ tab, int res,
    const ColormapLaws& laws) {
  const float pl = __fadd_rn(__fmul_rn(wa, L[a]), __fmul_rn(wb, L[b]));
  const float pr = __fadd_rn(__fmul_rn(wa, R[a]), __fmul_rn(wb, R[b]));
  const float power = __fadd_rn(__fmul_rn(pl, pl), __fmul_rn(pr, pr));
  const float db = __fmul_rn(10.f, log10f(__fadd_rn(power, laws.db_eps)));
  const float mag = __fdiv_rn(__fsub_rn(db, laws.min_db), laws.db_range);
  const float denom = __fadd_rn(pl, pr);
  const float pan = denom != 0.f ? __fdiv_rn(pr, denom) : 0.5f;
  const float xu = texel(mag, laws.res);
  const float xv = texel(pan, laws.res);

  const bool stereo = tab[3] != 0.f;
  const float x = stereo ? xv : xu;
  const float f0 = floorf(x);
  const int t0 = static_cast<int>(f0);
  const int t1 = min(t0 + 1, res - 1);
  const float wlo = clamp_to(__fsub_rn(1.f, fabsf(__fsub_rn(x, f0))), 1.f);
  const float whi =
      clamp_to(__fsub_rn(1.f, fabsf(__fsub_rn(x, __fadd_rn(f0, 1.f)))), 1.f);
  unsigned word = 0;
  for (int c = 0; c < 3; ++c) {
    const float v = __fadd_rn(__fmul_rn(wlo, tab[t0 * 4 + c]),
                              __fmul_rn(whi, tab[t1 * 4 + c]));
    word |= quantize(v) << (8 * c);
  }
  const float alpha = stereo ? __fmul_rn(xu, laws.inv_res1) : 1.f;
  return word | quantize(alpha) << 24;
}

// Row n's table: tables[(n / rows_per_table) % n_tables], each res*4 floats.
__device__ __forceinline__ const float* row_table(const float* tables, int row,
                                                  int rows_per_table,
                                                  int n_tables, int res) {
  const int table = (row / rows_per_table) % n_tables;
  return tables + static_cast<size_t>(table) * (res * 4);
}

}  // namespace spk
