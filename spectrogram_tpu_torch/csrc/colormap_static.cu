// The static colormap: one palette for every row, passed to the kernel by
// value, with no table operand in device memory.
//
// Replaces spectrogram_tpu/ops/pallas/colormap_kernel.py
// `colormap_planes_banded` with the bodies `_static_builtin_kernel` (one
// built-in table) and `_static_generic_kernel` (the two factors U and V of a
// generic palette), which the JAX pipeline takes for `static_palette=`.  The
// TPU kernels baked the table into the kernel as compile-time scalars, so
// that a palette switch meant a recompile.  Here the entry point copies the
// host's table into a struct of R*4 floats (U then V for the generic form)
// that is a kernel parameter: it lands in the parameter (constant) bank, so
// there is no table pointer and no per-row table index, and one build serves
// every palette.  R is at most kMaxRes = 64: a 1 KB struct for the built-in
// form and 2 KB for the generic one, inside the 4 KB kernel-parameter limit.
//
// The constant cache serves a warp at one address per cycle, and
// neighbouring pixels read different entries, so each CTA first copies the
// table into shared memory (512 bytes at R=32, 1 KB generic, in an array
// sized for R=64) and reads its taps from there.  A CTA covers 128 pixels of
// kRowsPerCta rows (more only past 65,535 x kRowsPerCta rows), so the copy
// is paid once per 1,024 pixels.
//
// The pixels run through colormap_common.cuh's `builtin_word` and
// `generic_word`, so the output is kernel B's with one table (built-in form)
// and the generic kernel's with one table (generic form), bit for bit.
//
// What bounds it on this card: device memory, as kernel B: 4 bytes out per
// pixel and the tap reads of the planes; no table bytes.
#include <cstring>

#include "colormap_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRowsPerCta = 8;
constexpr int kMaxGridY = 65535;
constexpr int kMaxRes = 64;

// kTables tables of res*4 floats, one after the other.
template <int kTables>
struct StaticTables {
  float t[kTables * kMaxRes * 4];
};

template <bool kGeneric>
__global__ void __launch_bounds__(kThreads) colormap_static_kernel(
    const float* __restrict__ mag_l, const float* __restrict__ mag_r,
    int rows, int bins, const int* __restrict__ j0,
    const int* __restrict__ j1, const float* __restrict__ w0,
    const float* __restrict__ w1, int h, int res,
    const StaticTables<kGeneric ? 2 : 1> tables, spk::ColormapLaws laws,
    unsigned* __restrict__ out) {
  constexpr int kTables = kGeneric ? 2 : 1;
  __shared__ float staged[kTables * kMaxRes * 4];
  for (int i = threadIdx.x; i < kTables * res * 4; i += kThreads) {
    staged[i] = tables.t[i];
  }
  __syncthreads();
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= h) return;
  const int a = j0[p], b = j1[p];
  const float wa = w0[p], wb = w1[p];
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const size_t at = static_cast<size_t>(row) * bins;
    const spk::Texels x =
        spk::pixel_texels(mag_l + at, mag_r + at, a, b, wa, wb, laws);
    if constexpr (kGeneric) {
      out[static_cast<size_t>(row) * h + p] =
          spk::generic_word(x, staged, staged + res * 4, res);
    } else {
      out[static_cast<size_t>(row) * h + p] =
          spk::builtin_word(x, staged, res, laws);
    }
  }
}

template <bool kGeneric>
int launch(const float* mag_l, const float* mag_r, int rows, int bins,
           const int* j0, const int* j1, const float* w0, const float* w1,
           int h, const float* u_host, const float* v_host, int res,
           const spk::ColormapLaws& laws, int* out, cudaStream_t stream) {
  StaticTables<kGeneric ? 2 : 1> tables{};
  const size_t bytes = static_cast<size_t>(res) * 4 * sizeof(float);
  std::memcpy(tables.t, u_host, bytes);
  if constexpr (kGeneric) std::memcpy(tables.t + res * 4, v_host, bytes);
  const int row_blocks = (rows + kRowsPerCta - 1) / kRowsPerCta;
  const dim3 grid((h + kThreads - 1) / kThreads,
                  row_blocks < kMaxGridY ? row_blocks : kMaxGridY);
  colormap_static_kernel<kGeneric><<<grid, kThreads, 0, stream>>>(
      mag_l, mag_r, rows, bins, j0, j1, w0, w1, h, res, tables, laws,
      reinterpret_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mag_l, mag_r: [rows, bins] f32; j0, j1: [h] i32 and w0, w1: [h] f32 taps
// (device); u_host: the built-in table, or U of a generic palette, and
// v_host: V, or null for the built-in form, each res*4 f32 in host memory,
// copied before the launch; out: [rows, h] i32 (device).  All contiguous.
// res above 64 is refused with cudaErrorInvalidValue.
SPK_EXPORT int spk_colormap_static(const float* mag_l, const float* mag_r,
                                   int rows, int bins, const int* j0,
                                   const int* j1, const float* w0,
                                   const float* w1, int h,
                                   const float* u_host, const float* v_host,
                                   int res, float min_db, float db_range,
                                   float db_eps, float inv_res1, int* out,
                                   void* stream) {
  if (res < 2 || res > kMaxRes) return static_cast<int>(cudaErrorInvalidValue);
  const spk::ColormapLaws laws{static_cast<float>(res), min_db, db_range,
                               db_eps, inv_res1};
  const auto s = static_cast<cudaStream_t>(stream);
  if (v_host == nullptr) {
    return launch<false>(mag_l, mag_r, rows, bins, j0, j1, w0, w1, h, u_host,
                         nullptr, res, laws, out, s);
  }
  return launch<true>(mag_l, mag_r, rows, bins, j0, j1, w0, w1, h, u_host,
                      v_host, res, laws, out, s);
}
