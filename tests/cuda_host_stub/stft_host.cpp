// The STFT kernels' row code (stft_fft.cuh, push_fused.cuh) as a host
// library: each call runs its rows through the Radix2 (body = 0), MixedRadix
// (body = 1) or the body `with_fft_body` picks (body = 2, Bluestein where
// the size has a prime factor above 7), the radix-2 stages one pass each
// (body = 3, radix2_stages.h), or the mixed-radix stages one pass each
// (body = 4, mixed_stages.h: at a 7-smooth n the direct body, else
// Bluestein over that inner body), or the picked body with its passes at
// the narrow bound of 64-register kernels (body = 5, kNarrowGroup), one
// thread block after another as the
// kernels' grids would, with the operand offsets of the kernels in csrc/.
// The packed rows take that body of n and n's FFT table (`fft_table`); the
// split-real rows take it of n/2 (the real-FFT pack, even n from 4) or of n
// (odd n), and n's split-real table (`split_fft_table`), with the kernels'
// load or the lane load of split_lanes.h (`stft_host_set_load`).  Output
// rows are stft_bins(n, w) wide.
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <type_traits>
#include <vector>

#include "mixed_stages.h"
#include "push_fused.cuh"
#include "radix2_stages.h"
#include "split_lanes.h"
#include "stft_large.cuh"

// fn(body, buf) with the body chosen as above and a buffer of its size; 1
// where the body does not take n.
template <class Fn>
static int with_body(int body, int n, const float* consts, Fn fn) {
  auto run = [&](const auto& b) {
    std::vector<float2> buf(b.buf_size());
    fn(b, buf.data());
    return 0;
  };
  if (body == 1) {
    spk::MixedRadix plan;
    return spk::make_mixed_radix(n, &plan) ? run(plan) : 1;
  }
  if (body == 2 || body == 5) return spk::with_fft_body(n, consts, run);
  if (body == 4) {
    spk::MixedRadix plan;
    const auto stages = [](const spk::MixedRadix& p) {
      MixedStages copy{p.n, p.stages, {}};
      std::copy(p.radix, p.radix + spk::kMaxStages, copy.radix);
      return copy;
    };
    if ((n & (n - 1)) == 0) return 1;
    if (spk::make_mixed_radix(n, &plan)) return run(stages(plan));
    const int m = spk::bluestein_length(n);
    if (!spk::make_mixed_radix(m, &plan)) return 1;
    const auto* table = reinterpret_cast<const float2*>(consts);
    return run(spk::BluesteinT<MixedStages>{n, stages(plan), table + m, table + m + n});
  }
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;
  if ((1 << log2n) != n) return 1;
  return body == 3 ? run(Radix2Stages{log2n}) : run(spk::Radix2{log2n});
}

// stft_packed_row and stft_real_row at the pass bound of `body` (5: the
// narrow one).
template <class... A>
static void packed_row(int body, const A&... args) {
  if (body == 5) {
    spk::stft_packed_row<spk::kNarrowGroup>(args...);
  } else {
    spk::stft_packed_row(args...);
  }
}

// The split-real rows' load (`stft_host_set_load`): 0 the kernels' (fused
// into the first pass), 1 the lane load of split_lanes.h.
static int g_load = 0;

extern "C" void stft_host_set_load(int load) { g_load = load; }

template <int kCap, class... A>
static void real_row_at(const A&... args) {
  if (g_load == 1) {
    real_row_lanes<kCap>(args...);
  } else {
    spk::stft_real_row<kCap>(args...);
  }
}

template <class... A>
static void real_row(int body, const A&... args) {
  if (body == 5) {
    real_row_at<spk::kNarrowGroup>(args...);
  } else {
    real_row_at<spk::kMixedGroup>(args...);
  }
}

static const float2* tw_of(const float* consts) {
  return reinterpret_cast<const float2*>(consts);
}

// fn(row, buf) with the split-real row form of n (`with_real_body`) over the
// body chosen as above; 1 where the body does not take the transform.
template <class Fn>
static int with_real(int body, int n, const float* consts, Fn fn) {
  if (!spk::real_packs(n)) {
    return with_body(body, n, consts, [&](const auto& b, float2* buf) {
      fn(spk::RealFull<std::decay_t<decltype(b)>>{b}, buf);
    });
  }
  return with_body(body, n / 2, consts, [&](const auto& b, float2* buf) {
    fn(spk::RealPack<std::decay_t<decltype(b)>>{b, tw_of(consts) + b.table_size()},
       buf);
  });
}

template <class T>
static int host_rows(int body, int n, int rows, int w, const T* l,
                     const T* r, const float* hann, const float* consts,
                     float* out_l, float* out_r) {
  const size_t bins = spk::stft_bins(n, w);
  return with_body(body, n, consts, [&](const auto& b, float2* buf) {
    for (int row = 0; row < rows; ++row) {
      const size_t in = static_cast<size_t>(row) * w;
      packed_row(body, b, l + in, r + in, hann, tw_of(consts), w,
                           out_l + row * bins, out_r + row * bins, buf);
    }
  });
}

extern "C" int stft_host_rows(int body, int n, int rows, int w,
                              const float* l, const float* r,
                              const float* hann, const float* consts,
                              float* out_l, float* out_r) {
  return host_rows(body, n, rows, w, l, r, hann, consts, out_l, out_r);
}

// The same with int16 sample planes (hann carrying the 2^-15 wire scale).
extern "C" int stft_host_rows_i16(int body, int n, int rows, int w,
                                  const short* l, const short* r,
                                  const float* hann, const float* consts,
                                  float* out_l, float* out_r) {
  return host_rows(body, n, rows, w, l, r, hann, consts, out_l, out_r);
}

// spk_stft_allk(_carry) and its int16 forms: [streams, ld] buffers; row
// r*streams + s is window buf[s, r*hop : r*hop + w]; with next (else null),
// the last c_len samples of each buffer as [streams, 2, c_len].
template <class T>
static int host_allk(int body, int n, int streams, int ld, int k, int hop,
                     int w, const T* l, const T* r, const float* hann,
                     const float* consts, float* out_l, float* out_r, T* next,
                     int c_len) {
  const size_t bins = spk::stft_bins(n, w);
  return with_body(body, n, consts, [&](const auto& b, float2* buf) {
    for (int row = 0; row < k * streams; ++row) {
      const int s = row % streams;
      const size_t at = static_cast<size_t>(s) * ld +
                        static_cast<size_t>(row / streams) * hop;
      if (next != nullptr && row < streams) {
        T* dst = next + static_cast<size_t>(s) * 2 * c_len;
        spk::buffer_tail(l + static_cast<size_t>(s) * ld, dst, ld, c_len);
        spk::buffer_tail(r + static_cast<size_t>(s) * ld, dst + c_len, ld, c_len);
      }
      packed_row(body, b, l + at, r + at, hann, tw_of(consts), w,
                           out_l + row * bins, out_r + row * bins, buf);
    }
  });
}

extern "C" int stft_host_allk(int body, int n, int streams, int ld, int k,
                              int hop, int w, const float* l, const float* r,
                              const float* hann, const float* consts,
                              float* out_l, float* out_r, float* next,
                              int c_len) {
  return host_allk(body, n, streams, ld, k, hop, w, l, r, hann, consts, out_l,
                   out_r, next, c_len);
}

extern "C" int stft_host_allk_i16(int body, int n, int streams, int ld, int k,
                                  int hop, int w, const short* l,
                                  const short* r, const float* hann,
                                  const float* consts, float* out_l,
                                  float* out_r, short* next, int c_len) {
  return host_allk(body, n, streams, ld, k, hop, w, l, r, hann, consts, out_l,
                   out_r, next, c_len);
}

// The radices of n's mixed-radix plan into `radix`; their count, or -1.
extern "C" int stft_host_plan(int n, int* radix) {
  spk::MixedRadix plan;
  if (!spk::make_mixed_radix(n, &plan)) return -1;
  for (int s = 0; s < plan.stages; ++s) radix[s] = plan.radix[s];
  return plan.stages;
}

// The buffer length of the body with_fft_body picks for n (n, or Bluestein's
// M), or -1 where none does.
extern "C" int stft_host_buf_size(int n) {
  int size = -1;
  const std::vector<float> table(1);
  spk::with_fft_body(n, table.data(), [&](const auto& b) {
    size = b.buf_size();
    return 0;
  });
  return size;
}

// The same for the split-real row of n (`with_real_body`: n/2's body at
// even n from 4).
extern "C" int stft_host_split_buf_size(int n) {
  int size = -1;
  const std::vector<float> table(1);
  spk::with_real_body(n, table.data(), [&](const auto& b) {
    size = b.buf_size();
    return 0;
  });
  return size;
}

// ---- the split-real kernels (stft_split.cu): block b is window b / 2,
// channel b % 2, and writes out_l or out_r [rows, bins].

// spk_stft_split: [rows, w] planes l, r.
extern "C" int stft_host_split(int body, int n, int rows, int w,
                               const float* l, const float* r,
                               const float* hann, const float* consts,
                               float* out_l, float* out_r) {
  const size_t bins = spk::stft_bins(n, w);
  return with_real(body, n, consts, [&](const auto& b, float2* buf) {
    for (int blk = 0; blk < 2 * rows; ++blk) {
      const size_t row = blk >> 1;
      const int c = blk & 1;
      const spk::RowSamples src{(c ? r : l) + row * w, w};
      real_row(body, b, src, hann, tw_of(consts),
                         (c ? out_r : out_l) + row * bins, buf);
    }
  });
}

// spk_stft_split_allk(_carry): [streams, ld] buffers; row r*streams + s is
// window buf[s, r*hop : r*hop + w]; with next (else null), the last c_len
// samples of each buffer as [streams, 2, c_len].
extern "C" int stft_host_split_allk(int body, int n, int streams, int ld,
                                    int k, int hop, int w, const float* l,
                                    const float* r, const float* hann,
                                    const float* consts, float* out_l,
                                    float* out_r, float* next, int c_len) {
  const size_t bins = spk::stft_bins(n, w);
  return with_real(body, n, consts, [&](const auto& b, float2* buf) {
    for (int blk = 0; blk < 2 * k * streams; ++blk) {
      const int row = blk >> 1;
      const int c = blk & 1;
      const int s = row % streams;
      const float* x = (c ? r : l) + static_cast<size_t>(s) * ld;
      if (next != nullptr && row < streams) {
        spk::buffer_tail(x, next + (static_cast<size_t>(s) * 2 + c) * c_len,
                         ld, c_len);
      }
      const spk::RowSamples src{x + static_cast<size_t>(row / streams) * hop,
                                w};
      real_row(body, b, src, hann, tw_of(consts),
                         (c ? out_r : out_l) + row * bins, buf);
    }
  });
}

// spk_stft_split_carry: carry [streams, 2, c_len] + chunk [streams, 2,
// k*hop]; next [streams, 2, c_len].
extern "C" int stft_host_split_carry(int body, int n, int streams, int c_len,
                                     int k, int hop, int w,
                                     const float* carry, const float* chunk,
                                     const float* hann, const float* consts,
                                     float* out_l, float* out_r,
                                     float* next) {
  const size_t bins = spk::stft_bins(n, w);
  const int t_len = k * hop;
  return with_real(body, n, consts, [&](const auto& b, float2* buf) {
    for (int blk = 0; blk < 2 * k * streams; ++blk) {
      const int row = blk >> 1;
      const int c = blk & 1;
      const size_t sc = static_cast<size_t>(row % streams) * 2 + c;
      const float* ca = carry + sc * c_len;
      const float* ch = chunk + sc * t_len;
      if (row < streams) {
        spk::planar_next_carry(ca, ch, next + sc * c_len, c_len, t_len);
      }
      const spk::PlanarSamples src{ca, ch, c_len, (row / streams) * hop, w};
      real_row(body, b, src, hann, tw_of(consts),
                         (c ? out_r : out_l) + row * bins, buf);
    }
  });
}

// spk_stft_split_t: the [rows, 2, n1, m] transposed operand x.
extern "C" int stft_host_split_t(int body, int n, int rows, int n1, int m,
                                 const float* x, const float* hann,
                                 const float* consts, float* out_l,
                                 float* out_r) {
  const size_t bins = spk::stft_bins(n, n1 * m);
  return with_real(body, n, consts, [&](const auto& b, float2* buf) {
    for (int blk = 0; blk < 2 * rows; ++blk) {
      const size_t row = blk >> 1;
      const int c = blk & 1;
      const spk::TransposedSamples src{
          x + blk * static_cast<size_t>(n1) * m, n1, m};
      real_row(body, b, src, hann, tw_of(consts),
                         (c ? out_r : out_l) + row * bins, buf);
    }
  });
}

// spk_stft_split_tsplit: carry [rows, 2, n1, c_cols] and chunk [rows, 2, n1,
// t_cols]; also writes next [rows, 2, n1, c_cols].
extern "C" int stft_host_split_tsplit(int body, int n, int rows, int n1,
                                      int c_cols, int t_cols,
                                      const float* carry, const float* chunk,
                                      const float* hann, const float* consts,
                                      float* out_l, float* out_r,
                                      float* next) {
  const size_t bins = spk::stft_bins(n, n1 * (c_cols + t_cols));
  return with_real(body, n, consts, [&](const auto& b, float2* buf) {
    for (int blk = 0; blk < 2 * rows; ++blk) {
      const size_t row = blk >> 1;
      const int c = blk & 1;
      const size_t in_carry = blk * static_cast<size_t>(n1) * c_cols;
      const size_t in_chunk = blk * static_cast<size_t>(n1) * t_cols;
      const spk::SplitSamples src{carry + in_carry, chunk + in_chunk, n1,
                                  c_cols, t_cols};
      spk::split_next_carry(carry + in_carry, chunk + in_chunk,
                            next + in_carry, n1, c_cols, t_cols);
      real_row(body, b, src, hann, tw_of(consts),
                         (c ? out_r : out_l) + row * bins, buf);
    }
  });
}

// ---- the large-N route (stft_large.cu): each pass over every scratch row
// before the next, as the route's launches run them.  The planes l, r are
// [rows, w]; split = 0 takes n's `fft_table` (spk_stft_large_packed), split
// = 1 n's `split_fft_table` (spk_stft_large_split); local runs hold at most
// max_span entries (the kernels': kMaxSmemBytes / 8).  Each returns 1 where
// the route does not take n.

// An output plane that counts the writes of each bin in place of the value.
struct CountedPlane {
  int* count;
  struct Bin {
    int* count;
    Bin& operator=(float) {
      ++*count;
      return *this;
    }
  };
  Bin operator[](size_t k) const { return Bin{count + k}; }
  CountedPlane operator+(size_t k) const { return CountedPlane{count + k}; }
};

// The rows' window-plane samples into the kernels' operands.
struct LargeRows {
  int split, rows, w;
  const float *l, *r, *hann;

  int scratch_rows() const { return split ? 2 * rows : rows; }
  // scratch row q's planes: packed, row q of l and r; split-real, channel
  // q & 1 of row q >> 1
  const float* left(int q) const { return l + static_cast<size_t>(q) * w; }
  const float* right(int q) const { return r + static_cast<size_t>(q) * w; }
  const float* channel(int q) const {
    return ((q & 1) ? r : l) + static_cast<size_t>(q >> 1) * w;
  }
};

// The passes as the route ran them before its load and last stage were
// fused (and as it runs Bluestein): the load, kLargeLocal, every global
// stage, the unpack, for every n.
template <class Out>
static void host_large_unfused(const spk::LargePlan& p, const LargeRows& in,
                               std::vector<float2>& scratch, Out out_l, Out out_r) {
  const size_t m = p.buf_size();
  const int q_rows = in.scratch_rows();
  for (int q = 0; q < q_rows; ++q) {
    for (int j = 0; j < static_cast<int>(m); ++j) {
      if (in.split) {
        spk::large_load_real(p, in.channel(q), in.hann, scratch.data() + q * m, j);
      } else {
        spk::large_load_packed(p, in.left(q), in.right(q), in.hann,
                               scratch.data() + q * m, j);
      }
    }
  }
  std::vector<float2> tile(p.span);
  const auto pass = [&](int kind, int s, int len) {
    for (int q = 0; q < q_rows; ++q) {
      for (int j = 0; j < spk::large_pass_count(p, kind, s); ++j) {
        if (kind == spk::kLargeLocal) {
          spk::large_local(p, scratch.data() + q * m, j, tile.data());
        } else {
          spk::large_pass_at(p, kind, s, len, scratch.data() + q * m, j);
        }
      }
    }
    return 0;
  };
  if (p.bluestein) {
    spk::large_passes(p, pass);
  } else {
    pass(spk::kLargeLocal, 0, 0);
    int len = p.span;
    for (int s = p.local; s < p.passes.stages; ++s) {
      pass(spk::kLargeDit, s, len);
      len *= p.passes.radix[s];
    }
  }
  const size_t bins = spk::stft_bins(p.n, p.w);
  for (int q = 0; q < q_rows; ++q) {
    const float2* row = scratch.data() + q * m;
    for (int k = 0; k < static_cast<int>(bins); ++k) {
      if (in.split) {
        ((q & 1) ? out_r : out_l)[(q >> 1) * bins + k] = spk::large_magnitude(p, row, k);
      } else {
        float a, b;
        spk::large_unpack(p, row, k, &a, &b);
        out_l[q * bins + k] = a;
        out_r[q * bins + k] = b;
      }
    }
  }
}

// The route as its kernels run it: a direct n in the fused order (pass 1 per
// run, any middle global stage, pass 2 per butterfly pair), Bluestein as
// above.
template <class Out>
static int host_large(const LargeRows& in, int n, const float* consts, Out out_l,
                      Out out_r, int max_span, bool fused) {
  spk::LargePlan p;
  if (!spk::make_large_plan(n, in.w, consts, &p, max_span, in.split != 0)) {
    return 1;
  }
  const size_t m = p.buf_size();
  const int q_rows = in.scratch_rows();
  std::vector<float2> scratch(q_rows * m);
  if (!fused || p.bluestein) {
    host_large_unfused(p, in, scratch, out_l, out_r);
    return 0;
  }
  std::vector<float2> tile(p.span);
  const size_t bins = spk::stft_bins(n, in.w);
  const spk::LargeLast last = spk::large_last(p);
  return spk::large_passes(p, [&](int kind, int s, int len) {
    const int count = spk::large_pass_count(p, kind, s);
    for (int q = 0; q < q_rows; ++q) {
      float2* row = scratch.data() + q * m;
      for (int j = 0; j < count; ++j) {
        if (kind == spk::kLargeLoadLocal) {
          // the pass bound of the kernel's launch bounds
          constexpr int kCap = spk::group_cap<spk::LargeLoadBounds>();
          const int first = spk::large_run_first(p, j);
          if (in.split) {
            const float* x = in.channel(q);
            spk::large_load_local<kCap>(p, row, j, first, tile.data(), [&](int i) {
              return spk::large_real_value(p, x, in.hann, i);
            });
          } else {
            const float *l = in.left(q), *r = in.right(q);
            spk::large_load_local<kCap>(p, row, j, first, tile.data(), [&](int i) {
              return spk::large_packed_value(p, l, r, in.hann, i);
            });
          }
        } else if (kind == spk::kLargeDit) {
          spk::large_pass_at(p, kind, s, len, row, j);
        } else {
          spk::with_last_radix(p, [&](auto radix) {
            constexpr int R = decltype(radix)::value;
            if (in.split) {
              spk::large_last_magnitude<R>(last, row, j,
                                           ((q & 1) ? out_r : out_l) + (q >> 1) * bins);
            } else {
              spk::large_last_unpack<R>(last, row, j, out_l + q * bins, out_r + q * bins);
            }
            return 0;
          });
        }
      }
    }
    return 0;
  });
}

// The route's kernels' order into out_l, out_r [rows, stft_bins(n, w)],
// which it fills with NaN first (a bin no pass writes stays NaN).
extern "C" int stft_host_large(int split, int n, int rows, int w,
                               const float* l, const float* r,
                               const float* hann, const float* consts,
                               float* out_l, float* out_r, int max_span) {
  const size_t size = static_cast<size_t>(rows) * spk::stft_bins(n, w);
  std::fill(out_l, out_l + size, std::nanf(""));
  std::fill(out_r, out_r + size, std::nanf(""));
  return host_large(LargeRows{split, rows, w, l, r, hann}, n, consts, out_l, out_r,
                    max_span, true);
}

// The unfused passes (load, local, each global stage, unpack) at every n.
extern "C" int stft_host_large_unfused(int split, int n, int rows, int w,
                                       const float* l, const float* r,
                                       const float* hann, const float* consts,
                                       float* out_l, float* out_r, int max_span) {
  return host_large(LargeRows{split, rows, w, l, r, hann}, n, consts, out_l, out_r,
                    max_span, false);
}

// The kernels' order with each output plane counting its writes per bin:
// count_l, count_r [rows, stft_bins(n, w)] ints, added to.
extern "C" int stft_host_large_writes(int split, int n, int rows, int w,
                                      const float* l, const float* r,
                                      const float* hann, const float* consts,
                                      int* count_l, int* count_r, int max_span) {
  return host_large(LargeRows{split, rows, w, l, r, hann}, n, consts,
                    CountedPlane{count_l}, CountedPlane{count_r}, max_span, true);
}

// spk_stft_large_pass1: pass 1's register passes and threads at n, w.
extern "C" int stft_host_large_pass1(int n, int w, int split, int* form) {
  return spk::large_pass1_form(n, w, split != 0, form);
}

// spk_push_fused: [rows, w] planes l, r -> out [rows, h] words, row n
// colored with tables[n % n_tables]; with mag_l (else null) the planes too.
extern "C" int stft_host_push(int body, int n, int rows, int w,
                              const float* l, const float* r,
                              const float* hann, const float* consts,
                              const float* tables, int n_tables, int res,
                              const int* j0, const int* j1, const float* w0,
                              const float* w1, int h, float min_db,
                              float db_range, float db_eps, float inv_res1,
                              unsigned* out, float* mag_l, float* mag_r) {
  const spk::ColormapLaws laws{static_cast<float>(res), min_db, db_range,
                               db_eps, inv_res1};
  const size_t bins = spk::stft_bins(n, w);
  std::vector<float> planes(2 * bins);
  return with_real(body, n, consts, [&](const auto& b, float2* buf) {
    for (int row = 0; row < rows; ++row) {
      spk::push_fused_row(
          b, l + static_cast<size_t>(row) * w, r + static_cast<size_t>(row) * w,
          w, hann, tw_of(consts), spk::row_table(tables, row, 1, n_tables, res),
          res, j0, j1, w0, w1, h, laws, out + static_cast<size_t>(row) * h,
          mag_l == nullptr ? nullptr : mag_l + row * bins,
          mag_r == nullptr ? nullptr : mag_r + row * bins, buf, planes.data());
    }
  });
}

// Kernel B's per-pixel body (`colormap_pixel`) over planes [rows, bins]:
// out [rows, h] words, row n colored with tables[n % n_tables] (the second
// kernel of the chain the fused push stands for).
extern "C" int stft_host_builtin(const float* mag_l, const float* mag_r,
                                 int rows, int bins, const float* tables,
                                 int n_tables, int res, const int* j0,
                                 const int* j1, const float* w0,
                                 const float* w1, int h, float min_db,
                                 float db_range, float db_eps, float inv_res1,
                                 unsigned* out) {
  const spk::ColormapLaws laws{static_cast<float>(res), min_db, db_range,
                               db_eps, inv_res1};
  for (int row = 0; row < rows; ++row) {
    const size_t at = static_cast<size_t>(row) * bins;
    const float* tab = spk::row_table(tables, row, 1, n_tables, res);
    for (int p = 0; p < h; ++p) {
      out[static_cast<size_t>(row) * h + p] = spk::colormap_pixel(
          mag_l + at, mag_r + at, j0[p], j1[p], w0[p], w1[p], tab, res, laws);
    }
  }
  return 0;
}

// The launch a choice takes (stft_fft.cuh kLaunchTable .. kLaunchNarrow) at
// n: family 0 the packed rows (`with_row_bounds` over `with_fft_body`, as
// kernel A and the all-windows kernels launch), 1 the split-real rows
// (`with_split_bounds` over `with_real_body`), 2 the fused push
// (push_fused.cuh `with_push_bounds`, its block the row's buffer and two
// planes of stft_bins(n, w)); consts: the table the family reads (n's
// `fft_table`, or `split_fft_table`).  out: the bounds' threads and blocks
// per SM, the threads launched and the pass bound (`group_cap`).  Returns
// 0, or the C tables' error where they refuse the choice.
extern "C" int stft_host_launch(int family, int n, int w, int choice,
                                const float* consts, int* out) {
  const auto record = [&](auto bounds, int threads) {
    using B = decltype(bounds);
    out[0] = B::threads;
    out[1] = B::blocks;
    out[2] = threads;
    out[3] = spk::group_cap<B>();
    return 0;
  };
  if (family == 0) {
    return spk::with_fft_body(n, consts, [&](auto body) {
      return spk::with_row_bounds(body, record, choice);
    });
  }
  return spk::with_real_body(n, consts, [&](auto row) {
    if (family == 1) return spk::with_split_bounds(row, record, choice);
    const size_t smem = row.buf_size() * sizeof(float2) +
                        2 * spk::stft_bins(n, w) * sizeof(float);
    return spk::with_push_bounds(row, smem, record, choice);
  });
}
