// The STFT kernels' row code (stft_fft.cuh) as a host library: each call
// runs its rows through the Radix2 (mixed = 0) or MixedRadix (mixed = 1)
// body, one thread block after another as the kernels' grids would, with
// the operand offsets of the kernels in csrc/.
#include <vector>

#include "stft_fft.cuh"

// fn(body) with the body N selects; 1 where the body does not take N.
template <class Fn>
static int with_body(int mixed, int n, Fn fn) {
  if (mixed) {
    spk::MixedRadix plan;
    if (!spk::make_mixed_radix(n, &plan)) return 1;
    fn(plan);
    return 0;
  }
  spk::Radix2 pow2{0};
  while ((1 << pow2.log2n) < n) ++pow2.log2n;
  if ((1 << pow2.log2n) != n) return 1;
  fn(pow2);
  return 0;
}

template <class T>
static int host_rows(int mixed, int n, int rows, int w, const T* l,
                     const T* r, const float* hann, const float* twiddles,
                     float* out_l, float* out_r) {
  std::vector<float2> buf(n);
  const auto* tw = reinterpret_cast<const float2*>(twiddles);
  return with_body(mixed, n, [&](const auto& body) {
    for (int row = 0; row < rows; ++row) {
      const size_t in = static_cast<size_t>(row) * w;
      const size_t out = static_cast<size_t>(row) * (n / 2);
      spk::stft_packed_row(body, l + in, r + in, hann, tw, w, out_l + out,
                           out_r + out, buf.data());
    }
  });
}

extern "C" int stft_host_rows(int mixed, int n, int rows, int w,
                              const float* l, const float* r,
                              const float* hann, const float* twiddles,
                              float* out_l, float* out_r) {
  return host_rows(mixed, n, rows, w, l, r, hann, twiddles, out_l, out_r);
}

// The same with int16 sample planes (hann carrying the 2^-15 wire scale).
extern "C" int stft_host_rows_i16(int mixed, int n, int rows, int w,
                                  const short* l, const short* r,
                                  const float* hann, const float* twiddles,
                                  float* out_l, float* out_r) {
  return host_rows(mixed, n, rows, w, l, r, hann, twiddles, out_l, out_r);
}

// The radices of n's mixed-radix plan into `radix`; their count, or -1.
extern "C" int stft_host_plan(int n, int* radix) {
  spk::MixedRadix plan;
  if (!spk::make_mixed_radix(n, &plan)) return -1;
  for (int s = 0; s < plan.stages; ++s) radix[s] = plan.radix[s];
  return plan.stages;
}

// ---- the split-real kernels (stft_split.cu): block b is window b / 2,
// channel b % 2, and writes out_l or out_r [rows, n/2].

// spk_stft_split: [rows, w] planes l, r.
extern "C" int stft_host_split(int mixed, int n, int rows, int w,
                               const float* l, const float* r,
                               const float* hann, const float* twiddles,
                               float* out_l, float* out_r) {
  std::vector<float2> buf(n);
  const auto* tw = reinterpret_cast<const float2*>(twiddles);
  return with_body(mixed, n, [&](const auto& body) {
    for (int b = 0; b < 2 * rows; ++b) {
      const size_t row = b >> 1;
      const int c = b & 1;
      const spk::RowSamples src{(c ? r : l) + row * w, w};
      spk::stft_real_row(body, src, hann, tw,
                         (c ? out_r : out_l) + row * (n / 2), buf.data());
    }
  });
}

// spk_stft_split_allk: [streams, ld] buffers; row r*streams + s is window
// buf[s, r*hop : r*hop + w].
extern "C" int stft_host_split_allk(int mixed, int n, int streams, int ld,
                                    int k, int hop, int w, const float* l,
                                    const float* r, const float* hann,
                                    const float* twiddles, float* out_l,
                                    float* out_r) {
  std::vector<float2> buf(n);
  const auto* tw = reinterpret_cast<const float2*>(twiddles);
  return with_body(mixed, n, [&](const auto& body) {
    for (int b = 0; b < 2 * k * streams; ++b) {
      const int row = b >> 1;
      const int c = b & 1;
      const size_t at = static_cast<size_t>(row % streams) * ld +
                        static_cast<size_t>(row / streams) * hop;
      const spk::RowSamples src{(c ? r : l) + at, w};
      spk::stft_real_row(body, src, hann, tw,
                         (c ? out_r : out_l) + static_cast<size_t>(row) * (n / 2),
                         buf.data());
    }
  });
}

// spk_stft_split_t: the [rows, 2, n1, m] transposed operand x.
extern "C" int stft_host_split_t(int mixed, int n, int rows, int n1, int m,
                                 const float* x, const float* hann,
                                 const float* twiddles, float* out_l,
                                 float* out_r) {
  std::vector<float2> buf(n);
  const auto* tw = reinterpret_cast<const float2*>(twiddles);
  return with_body(mixed, n, [&](const auto& body) {
    for (int b = 0; b < 2 * rows; ++b) {
      const size_t row = b >> 1;
      const int c = b & 1;
      const spk::TransposedSamples src{x + b * static_cast<size_t>(n1) * m, n1,
                                       m};
      spk::stft_real_row(body, src, hann, tw,
                         (c ? out_r : out_l) + row * (n / 2), buf.data());
    }
  });
}

// spk_stft_split_tsplit: carry [rows, 2, n1, c_cols] and chunk [rows, 2, n1,
// t_cols]; also writes next [rows, 2, n1, c_cols].
extern "C" int stft_host_split_tsplit(int mixed, int n, int rows, int n1,
                                      int c_cols, int t_cols,
                                      const float* carry, const float* chunk,
                                      const float* hann, const float* twiddles,
                                      float* out_l, float* out_r,
                                      float* next) {
  std::vector<float2> buf(n);
  const auto* tw = reinterpret_cast<const float2*>(twiddles);
  return with_body(mixed, n, [&](const auto& body) {
    for (int b = 0; b < 2 * rows; ++b) {
      const size_t row = b >> 1;
      const int c = b & 1;
      const size_t in_carry = b * static_cast<size_t>(n1) * c_cols;
      const size_t in_chunk = b * static_cast<size_t>(n1) * t_cols;
      const spk::SplitSamples src{carry + in_carry, chunk + in_chunk, n1,
                                  c_cols, t_cols};
      spk::split_next_carry(carry + in_carry, chunk + in_chunk,
                            next + in_carry, n1, c_cols, t_cols);
      spk::stft_real_row(body, src, hann, tw,
                         (c ? out_r : out_l) + row * (n / 2), buf.data());
    }
  });
}
