// The radix-2 body as one shared-memory pass per stage, in natural layout:
// the sequence of butterflies the STFT kernels ran before their grouped
// register passes (spectrogram_tpu_torch/csrc/stft_fft.cuh `Radix2`), kept
// for the tests as the bits the grouped passes must give.
#pragma once

#include "stft_fft.cuh"

struct Radix2Stages {
  int log2n;

  int size() const { return 1 << log2n; }
  int buf_size() const { return 1 << log2n; }
  int table_size() const { return 1 << log2n; }
  int slot(int i) const {
    return static_cast<int>(__brev(static_cast<unsigned>(i)) >> (32 - log2n));
  }
  float2 input(int, float2 z) const { return z; }
  float2 result(const float2* buf, int k) const { return buf[k]; }

  // Stage s merges transforms of size 2^s into 2^(s+1); the twiddle of
  // butterfly position p is exp(-2 pi i p / 2^(s+1)) = tw[p * N / 2^(s+1)].
  template <int kCap>
  void transform(float2* buf, const float2* tw) const {
    const int half = 1 << (log2n - 1);
    for (int s = 0; s < log2n; ++s) {
      const int hs = 1 << s;
      const int tstep = half >> s;
      for (int j = threadIdx.x; j < half; j += blockDim.x) {
        const int pos = j & (hs - 1);
        const int i0 = ((j >> s) << (s + 1)) | pos;
        const int i1 = i0 + hs;
        const float2 t = spk::cmul(buf[i1], tw[pos * tstep]);
        const float2 a = buf[i0];
        buf[i0] = spk::cadd(a, t);
        buf[i1] = spk::csub(a, t);
      }
      __syncthreads();
    }
  }
};
