// The mixed-radix body as one shared-memory pass per stage, in natural
// layout: the sequence of butterflies the STFT kernels ran before their
// grouped register passes (spectrogram_tpu_torch/csrc/stft_fft.cuh
// `MixedRadixT`: `slot`, `transform`, `transform_dif`, `stage`,
// `butterfly_at`, and Bluestein's filtered stage 0), kept for the tests as
// the bits the grouped passes must give.
#pragma once

#include "stft_fft.cuh"

struct MixedStages {
  int n;
  int stages;
  int radix[spk::kMaxStages];

  int size() const { return n; }
  int buf_size() const { return n; }
  int table_size() const { return n; }
  float2 input(int, float2 z) const { return z; }
  float2 result(const float2* buf, int k) const { return buf[k]; }
  int at(int i) const { return i; }

  // Digit reversal.  Stage s turns r_s sub-transforms of length
  // L_s = r_0 ... r_{s-1}, stored one after another, into one of length
  // L_s r_s; so sample i goes to sum_s d_s L_s, where d_{m-1}, ..., d_0 are
  // the digits of i in radices r_{m-1}, ..., r_0, least significant first.
  int slot(int i) const {
    int pos = 0;
    int span = n;
    for (int s = stages - 1; s >= 0; --s) {
      const int r = radix[s];
      span /= r;
      pos += (i % r) * span;
      i /= r;
    }
    return pos;
  }

  // Decimation in time: butterfly (block b, position p) of stage s takes
  // x_q = buf[b M + p + q L] * exp(-2 pi i p q / M), q < r, with L = L_s and
  // M = L r, and writes the r-point DFT of the x_q back to the same slots.
  // Digit-reversed input (`slot`), natural-order output.
  template <int kCap>
  void transform(float2* buf, const float2* tw) const {
    int len = 1;
    for (int s = 0; s < stages; ++s) {
      stage<false>(buf, tw, s, len);
      len *= radix[s];
    }
  }

  // Decimation in frequency, the transposed flow graph of `transform`: the
  // stages in reverse order, each an r-point DFT followed by the twiddles.
  // Natural-order input; X[k] lands in buf[slot(k)].  With a `filter`
  // (Bluestein's), stages stages-1 .. 1 run so, then stage 0 with the
  // filter product (Bluestein's `filtered_dft`).
  template <int kCap>
  void transform_dif(float2* buf, const float2* tw, const float2* filter = nullptr) const {
    const int last = filter == nullptr ? 0 : 1;
    int len = n;
    for (int s = stages - 1; s >= last; --s) {
      len /= radix[s];
      stage<true>(buf, tw, s, len);
    }
    if (filter == nullptr) return;
    const int r = radix[0];
    for (int j = threadIdx.x; j < n / r; j += blockDim.x) {
      switch (r) {
        case 4: filtered_dft<4>(buf, j * 4, tw, filter); break;
        case 2: filtered_dft<2>(buf, j * 2, tw, filter); break;
        case 3: filtered_dft<3>(buf, j * 3, tw, filter); break;
        case 7: filtered_dft<7>(buf, j * 7, tw, filter); break;
        default: filtered_dft<5>(buf, j * 5, tw, filter); break;
      }
    }
    __syncthreads();
  }

  // Butterfly j of the DIF pass's stage 0 (`butterfly<R, true>` with
  // twiddle tw[0]) over buf[at .. at + R), then the filter product.
  template <int R>
  static void filtered_dft(float2* buf, int at, const float2* tw, const float2* filter) {
    float2 a[R];
    for (int q = 0; q < R; ++q) a[q] = buf[at + q];
    spk::dft(a);
    for (int q = 0; q < R; ++q) {
      const float2 x = q == 0 ? a[q] : spk::cmul(a[q], tw[0]);
      buf[at + q] = spk::conjugate(spk::cmul(x, filter[at + q]));
    }
  }

  template <bool kDif>
  void stage(float2* buf, const float2* tw, int s, int len) const {
    const int count = n / radix[s];
    for (int j = threadIdx.x; j < count; j += blockDim.x) {
      butterfly_at<kDif>(buf, tw, s, len, j);
    }
    __syncthreads();
  }

  template <bool kDif>
  void butterfly_at(float2* buf, const float2* tw, int s, int len, int j) const {
    const int r = radix[s];
    const int m = len * r;
    const int p = j % len;
    float2* x = buf + (j / len) * m + p;
    const int t = p * (n / m);
    switch (r) {
      case 4: spk::butterfly<4, kDif>(x, len, t, tw); break;
      case 2: spk::butterfly<2, kDif>(x, len, t, tw); break;
      case 3: spk::butterfly<3, kDif>(x, len, t, tw); break;
      case 7: spk::butterfly<7, kDif>(x, len, t, tw); break;
      default: spk::butterfly<5, kDif>(x, len, t, tw); break;
    }
  }
};
