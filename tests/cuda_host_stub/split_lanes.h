// The split-real row with the load it had before its samples went straight
// into the body's first pass (spectrogram_tpu_torch/csrc/stft_fft.cuh
// `stft_real_row`): each sample read in the source's memory order
// (`memory_sample`, the sources' mapping from a memory offset to a window
// position before they read by window position) and stored x * hann as one
// f32 lane of its shared-memory slot (lane i & 1 of pack entry i >> 1 at
// even N, the real part of entry i at odd N), the lanes past the window
// zeroed, the body's `input` applied over its buffer (Bluestein's chirp and
// zero pad), then the whole transform and the same unpack.  Kept for the
// tests as the bits the fused load must give, its index arithmetic
// included.
#pragma once

#include "stft_fft.cuh"

// Sample f of the source in memory order, and its window position *i.
inline float memory_sample(const spk::RowSamples& s, int f, int* i) {
  *i = f;
  return s.x[f];
}

// x[j1, t] of [n1, m] is window sample t * n1 + j1.
inline float memory_sample(const spk::TransposedSamples& s, int f, int* i) {
  const int j1 = f / s.m;
  const int t = f - j1 * s.m;
  *i = t * s.n1 + j1;
  return s.x[f];
}

// The carry [n1, c_cols], then the chunk [n1, t_cols]: columns counted
// across both.
inline float memory_sample(const spk::SplitSamples& s, int f, int* i) {
  const int in_carry = s.n1 * s.c_cols;
  if (f < in_carry) {
    const int j1 = f / s.c_cols;
    *i = (f - j1 * s.c_cols) * s.n1 + j1;
    return s.carry[f];
  }
  const int g = f - in_carry;
  const int j1 = g / s.t_cols;
  *i = (s.c_cols + g - j1 * s.t_cols) * s.n1 + j1;
  return s.chunk[g];
}

inline float memory_sample(const spk::PlanarSamples& s, int f, int* i) {
  *i = f;
  const int at = s.start + f;
  return at < s.c_len ? s.carry[at] : s.chunk[at - s.c_len];
}

// buf[slot(i)] = input(i, buf[slot(i)]) below size(), input(i, 0) past it.
template <class Body>
void lanes_input(const Body& body, float2* buf) {
  for (int i = threadIdx.x; i < body.buf_size(); i += blockDim.x) {
    const float2 z = i < body.size() ? buf[body.slot(i)] : make_float2(0.f, 0.f);
    buf[body.slot(i)] = body.input(i, z);
  }
  __syncthreads();
}

template <int kCap, class Body, class Source>
void real_row_lanes(const spk::RealPack<Body>& row, const Source& src,
                    const float* hann, const float2* tw, float* out, float2* buf) {
  const int n = row.size();
  const int w = src.size();
  float* lanes = reinterpret_cast<float*>(buf);
  for (int f = threadIdx.x; f < w; f += blockDim.x) {
    int i;
    const float x = memory_sample(src, f, &i);
    lanes[2 * row.half.slot(i >> 1) + (i & 1)] = __fmul_rn(x, hann[i]);
  }
  for (int i = w + threadIdx.x; i < n; i += blockDim.x) {
    lanes[2 * row.half.slot(i >> 1) + (i & 1)] = 0.f;
  }
  __syncthreads();
  lanes_input(row.half, buf);
  row.half.template transform<kCap>(buf, tw);
  const int bins = spk::stft_bins(n, w);
  const auto z = [&](int t) { return row.half.result(buf, t); };
  for (int k = threadIdx.x; k < bins; k += blockDim.x) {
    out[k] = spk::real_pack_magnitude(z, row.post, n / 2, k);
  }
}

template <int kCap, class Body, class Source>
void real_row_lanes(const spk::RealFull<Body>& row, const Source& src,
                    const float* hann, const float2* tw, float* out, float2* buf) {
  const Body& body = row.body;
  const int n = body.size();
  const int w = src.size();
  for (int f = threadIdx.x; f < w; f += blockDim.x) {
    int i;
    const float x = memory_sample(src, f, &i);
    buf[body.slot(i)] = make_float2(__fmul_rn(x, hann[i]), 0.f);
  }
  for (int i = w + threadIdx.x; i < n; i += blockDim.x) {
    buf[body.slot(i)] = make_float2(0.f, 0.f);
  }
  __syncthreads();
  lanes_input(body, buf);
  body.template transform<kCap>(buf, tw);
  const int bins = spk::stft_bins(n, w);
  for (int k = threadIdx.x; k < bins; k += blockDim.x) {
    out[k] = spk::magnitude(body.result(buf, k));
  }
}
