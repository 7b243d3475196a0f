// Device code shared by the colormap kernels: one pixel of one row, from the
// two magnitude planes to its RGBA8888 word.
//
// Per pixel p of row n (the reference's fragment shader,
// gpu_spectrogram.rs:158-190), in `pixel_texels` (two taps) or `tap_sum`
// (K taps) and `texels_of`:
//   pl = w0[p]*L[n, j0[p]] + w1[p]*L[n, j1[p]], pr the same on R
//   mag = (10*log10(pl^2 + pr^2 + eps) - min_db) / (max_db - min_db)
//   pan = pr / (pl + pr), or 0.5 where pl + pr == 0
//   xu, xv = clamp(clamp(mag|pan, 0, 1)*R - 0.5, 0, R-1)
// then the word, from a built-in table (`builtin_word`):
//   stereo = tab[3]; x = stereo ? xv : xu
//   rgb = two-tap linear read of tab[t*4 + c]; alpha = stereo ? xu/(R-1) : 1
//   word = q(r) | q(g) << 8 | q(b) << 16 | q(a) << 24, q(v) = clamp(rint(255v))
// or from the two factors of a generic table, LUT[i, j, c] = U[i, c]*V[j, c]
// (`generic_word`):
//   cu[c] = two-tap read of U[t*4 + c] at xu, cv[c] of V[t*4 + c] at xv
//   word = q(cu[0]*cv[0]) | ... | q(cu[3]*cv[3]) << 24
// with the product rounded before the scale by 255, as the JAX kernel's
// round(cu*cv*255) associates.
//
// Every multiply and add is written with the _rn intrinsics so that nvcc does
// not contract them into FMAs: the plain PyTorch version rounds each one, and
// so did the JAX kernel.  rintf rounds half to even, as jnp.round does.  Every
// colormap kernel (colormap_builtin.cu, colormap_blockwise.cu,
// colormap_generic.cu, colormap_static.cu, colormap_rows.cu) runs its pixels
// through these functions, so for the same tables they give the same bits.
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

// A pixel's coordinates on the LUT's two axes, in texels.
struct Texels {
  float xu;  // magnitude axis
  float xv;  // pan axis
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

// The K-tap resample of one plane at a pixel: acc = w[0] x[j[0]], then acc
// += w[t] x[j[t]] in tap order (ascending bins).  At K = 2 it is
// `pixel_texels`' two-tap sum, bit for bit.
__device__ __forceinline__ float tap_sum(const float* __restrict__ x,
                                         const int* __restrict__ j,
                                         const float* __restrict__ w,
                                         int taps) {
  float acc = __fmul_rn(w[0], x[j[0]]);
  for (int t = 1; t < taps; ++t) acc = __fadd_rn(acc, __fmul_rn(w[t], x[j[t]]));
  return acc;
}

// The laws of a pixel whose resampled magnitudes are pl, pr: its texel
// coordinates.
__device__ __forceinline__ Texels texels_of(float pl, float pr,
                                            const ColormapLaws& laws) {
  const float power = __fadd_rn(__fmul_rn(pl, pl), __fmul_rn(pr, pr));
  const float db = __fmul_rn(10.f, log10f(__fadd_rn(power, laws.db_eps)));
  const float mag = __fdiv_rn(__fsub_rn(db, laws.min_db), laws.db_range);
  const float denom = __fadd_rn(pl, pr);
  const float pan = denom != 0.f ? __fdiv_rn(pr, denom) : 0.5f;
  return Texels{texel(mag, laws.res), texel(pan, laws.res)};
}

// The texel coordinates of the pixel whose taps (a, b, wa, wb) read the row's
// planes L, R.
__device__ __forceinline__ Texels pixel_texels(
    const float* __restrict__ L, const float* __restrict__ R, int a, int b,
    float wa, float wb, const ColormapLaws& laws) {
  const float pl = __fadd_rn(__fmul_rn(wa, L[a]), __fmul_rn(wb, L[b]));
  const float pr = __fadd_rn(__fmul_rn(wa, R[a]), __fmul_rn(wb, R[b]));
  return texels_of(pl, pr, laws);
}

// The two taps of a clamped-linear read at texel x: entries t0 and t1 with
// weights wlo and whi (whi = 0 where t1 is clamped onto t0).
struct LutTaps {
  int t0, t1;
  float wlo, whi;
};

__device__ __forceinline__ LutTaps lut_taps(float x, int res) {
  const float f0 = floorf(x);
  const int t0 = static_cast<int>(f0);
  return LutTaps{
      t0, min(t0 + 1, res - 1),
      clamp_to(__fsub_rn(1.f, fabsf(__fsub_rn(x, f0))), 1.f),
      clamp_to(__fsub_rn(1.f, fabsf(__fsub_rn(x, __fadd_rn(f0, 1.f)))), 1.f)};
}

// Channel c of the [R*4] table `tab` read at `k`.
__device__ __forceinline__ float lut_read(const float* __restrict__ tab,
                                          const LutTaps& k, int c) {
  return __fadd_rn(__fmul_rn(k.wlo, tab[k.t0 * 4 + c]),
                   __fmul_rn(k.whi, tab[k.t1 * 4 + c]));
}

// The word of a pixel at `x`, colored with the built-in [R*4] table `tab`
// (rgb entries t*4+c, stereo flag tab[3]).
__device__ __forceinline__ unsigned builtin_word(
    Texels x, const float* __restrict__ tab, int res, const ColormapLaws& laws) {
  const bool stereo = tab[3] != 0.f;
  const LutTaps k = lut_taps(stereo ? x.xv : x.xu, res);
  unsigned word = 0;
  for (int c = 0; c < 3; ++c) word |= quantize(lut_read(tab, k, c)) << (8 * c);
  const float alpha = stereo ? __fmul_rn(x.xu, laws.inv_res1) : 1.f;
  return word | quantize(alpha) << 24;
}

// The word of a pixel at `x`, colored with the generic factors `u` (read at
// xu) and `v` (read at xv), each [R*4] with entries t*4+c.
__device__ __forceinline__ unsigned generic_word(
    Texels x, const float* __restrict__ u, const float* __restrict__ v,
    int res) {
  const LutTaps ku = lut_taps(x.xu, res);
  const LutTaps kv = lut_taps(x.xv, res);
  unsigned word = 0;
  for (int c = 0; c < 4; ++c) {
    word |= quantize(__fmul_rn(lut_read(u, ku, c), lut_read(v, kv, c)))
            << (8 * c);
  }
  return word;
}

// The generic word of the pixel whose K taps (bins j, weights w) read one
// planar row [2, bins] (left plane, then right), colored with the row's
// factors u and v: colormap_rows.cu's body.
__device__ __forceinline__ unsigned planar_row_pixel(
    const float* __restrict__ row, int bins, const int* __restrict__ j,
    const float* __restrict__ w, int taps, const float* __restrict__ u,
    const float* __restrict__ v, int res, const ColormapLaws& laws) {
  return generic_word(texels_of(tap_sum(row, j, w, taps),
                                tap_sum(row + bins, j, w, taps), laws),
                      u, v, res);
}

// The built-in word of the pixel whose taps (a, b, wa, wb) read the row's
// planes L, R: kernel B's and the blockwise kernel's body.
__device__ __forceinline__ unsigned colormap_pixel(
    const float* __restrict__ L, const float* __restrict__ R, int a, int b,
    float wa, float wb, const float* __restrict__ tab, int res,
    const ColormapLaws& laws) {
  return builtin_word(pixel_texels(L, R, a, b, wa, wb, laws), tab, res, laws);
}

// Row n's table: tables[(n / rows_per_table) % n_tables], each res*4 floats.
__device__ __forceinline__ const float* row_table(const float* tables, int row,
                                                  int rows_per_table,
                                                  int n_tables, int res) {
  const int table = (row / rows_per_table) % n_tables;
  return tables + static_cast<size_t>(table) * (res * 4);
}

}  // namespace spk
