// Host stand-in for the CUDA runtime: just enough for the STFT device code
// (spectrogram_tpu_torch/csrc/stft_fft.cuh) to compile with a C++ compiler
// and run on the CPU as one thread per block (threadIdx.x = 0,
// blockDim.x = 1).  The _rn intrinsics round as the card does when the host
// compiler contracts nothing (-ffp-contract=off).
#pragma once

#include <cmath>
#include <cstddef>

#define __device__
#define __global__
#define __forceinline__ inline

struct float2 {
  float x, y;
};

inline float2 make_float2(float x, float y) { return float2{x, y}; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }

inline unsigned __brev(unsigned v) {
  unsigned r = 0;
  for (int i = 0; i < 32; ++i, v >>= 1) r = (r << 1) | (v & 1u);
  return r;
}

struct HostDim3 {
  unsigned x;
};
static const HostDim3 threadIdx{0}, blockDim{1};
inline void __syncthreads() {}

typedef int cudaError_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class T>
inline cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int) {
  return 0;
}
