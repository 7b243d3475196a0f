// Host-side lock-free SPSC ring buffers for PCM ingest.
//
// TPU-native replacement for the reference's sample transport layer: the
// `ringbuf` HeapRb SPSC queue created at
// reference src/devices/audio_input_list_model.rs:30 and consumed at
// src/fourier/audio_transform.rs:38-39.  Differences by design:
//
//  * a RingBank packs S rings of uniform capacity contiguously so one C call
//    can fill a whole [S, n, 2] device-feed batch (at 10k streams, per-ring
//    Python calls per hop tick would dominate; SURVEY.md §6 "Host->device
//    feed at 10k streams");
//  * overrun is COUNTED, not silent: the reference's push_iter drops samples
//    wordlessly on a full ring (SURVEY.md §5 "Metrics"); here every dropped
//    frame increments a per-ring counter readable from Python;
//  * peek/skip mirror the reference's non-destructive window peek + hop skip
//    (audio_transform.rs:34-42) for the single-ring API.
//
// Memory model: single producer, single consumer per ring.  head (write
// cursor) is only advanced by the producer, tail only by the consumer; both
// are monotonically increasing uint64 frame counters, masked by capacity
// (power of two) on access.
//
// Build: make -C spectrogram_tpu/native  (g++ -O3 -shared -fPIC)

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <new>
#include <thread>
#include <vector>

namespace {

// alignas(64): rings sit contiguously in banks; without padding, adjacent
// rings' head/tail atomics share cache lines and false-share across the
// producer threads and the 4-16 pop workers on the hot hop-tick path.
struct alignas(64) Ring {
  float *data = nullptr;  // capacity * 2 floats (stereo frames)
  uint64_t capacity = 0;  // frames, power of two
  uint64_t mask = 0;
  std::atomic<uint64_t> head{0};     // next frame index to write
  std::atomic<uint64_t> tail{0};     // next frame index to read
  std::atomic<uint64_t> dropped{0};  // frames dropped on overrun
};

uint64_t round_pow2(uint64_t v) {
  uint64_t p = 1;
  while (p < v) p <<= 1;
  return p;
}

void ring_init(Ring *r, uint64_t capacity, float *storage) {
  r->capacity = capacity;
  r->mask = capacity - 1;
  r->data = storage;
  r->head.store(0, std::memory_order_relaxed);
  r->tail.store(0, std::memory_order_relaxed);
  r->dropped.store(0, std::memory_order_relaxed);
}

// Copy n frames from the ring starting at absolute frame index `from`.
void copy_out(const Ring *r, uint64_t from, float *out, uint64_t n) {
  uint64_t start = from & r->mask;
  uint64_t first = n < (r->capacity - start) ? n : (r->capacity - start);
  std::memcpy(out, r->data + 2 * start, first * 2 * sizeof(float));
  if (n > first) {
    std::memcpy(out + 2 * first, r->data, (n - first) * 2 * sizeof(float));
  }
}

uint64_t push_impl(Ring *r, const float *frames, uint64_t n) {
  const uint64_t head = r->head.load(std::memory_order_relaxed);
  const uint64_t tail = r->tail.load(std::memory_order_acquire);
  const uint64_t free_frames = r->capacity - (head - tail);
  uint64_t accepted = n < free_frames ? n : free_frames;
  if (accepted < n) {
    r->dropped.fetch_add(n - accepted, std::memory_order_relaxed);
  }
  uint64_t start = head & r->mask;
  uint64_t first =
      accepted < (r->capacity - start) ? accepted : (r->capacity - start);
  std::memcpy(r->data + 2 * start, frames, first * 2 * sizeof(float));
  if (accepted > first) {
    std::memcpy(r->data, frames + 2 * first,
                (accepted - first) * 2 * sizeof(float));
  }
  r->head.store(head + accepted, std::memory_order_release);
  return accepted;
}

uint64_t pop_impl(Ring *r, float *out, uint64_t n) {
  const uint64_t tail = r->tail.load(std::memory_order_relaxed);
  const uint64_t head = r->head.load(std::memory_order_acquire);
  const uint64_t avail = head - tail;
  uint64_t taken = n < avail ? n : avail;
  if (out) copy_out(r, tail, out, taken);
  r->tail.store(tail + taken, std::memory_order_release);
  return taken;
}

}  // namespace

extern "C" {

// ------------------------------- single ring -------------------------------

Ring *ring_create(uint64_t capacity) {
  capacity = round_pow2(capacity < 2 ? 2 : capacity);
  Ring *r = new (std::nothrow) Ring();
  if (!r) return nullptr;
  float *storage =
      static_cast<float *>(std::malloc(capacity * 2 * sizeof(float)));
  if (!storage) {
    delete r;
    return nullptr;
  }
  ring_init(r, capacity, storage);
  return r;
}

void ring_destroy(Ring *r) {
  if (!r) return;
  std::free(r->data);
  delete r;
}

uint64_t ring_capacity(const Ring *r) { return r->capacity; }

uint64_t ring_size(const Ring *r) {
  // Load tail FIRST: with head loaded first, a concurrent pop can make
  // tail > loaded-head and the unsigned difference wraps to ~2^64.
  const uint64_t tail = r->tail.load(std::memory_order_acquire);
  const uint64_t head = r->head.load(std::memory_order_acquire);
  return head >= tail ? head - tail : 0;
}

uint64_t ring_dropped(const Ring *r) {
  return r->dropped.load(std::memory_order_relaxed);
}

// Producer side: interleaved stereo frames; drops (and counts) overflow.
uint64_t ring_push(Ring *r, const float *frames, uint64_t n) {
  return push_impl(r, frames, n);
}

// Consumer side.
uint64_t ring_pop(Ring *r, float *out, uint64_t n) {
  return pop_impl(r, out, n);
}

// Non-destructive read of up to n frames (the reference's window peek).
uint64_t ring_peek(const Ring *r, float *out, uint64_t n) {
  const uint64_t tail = r->tail.load(std::memory_order_relaxed);
  const uint64_t head = r->head.load(std::memory_order_acquire);
  const uint64_t avail = head - tail;
  uint64_t taken = n < avail ? n : avail;
  copy_out(r, tail, out, taken);
  return taken;
}

// Advance the read cursor by up to n frames (the reference's hop skip).
uint64_t ring_skip(Ring *r, uint64_t n) { return pop_impl(r, nullptr, n); }

// -------------------------------- ring bank --------------------------------

struct RingBank {
  Ring *rings = nullptr;
  float *storage = nullptr;
  uint64_t n_streams = 0;
  uint64_t capacity = 0;
};

RingBank *bank_create(uint64_t n_streams, uint64_t capacity) {
  capacity = round_pow2(capacity < 2 ? 2 : capacity);
  RingBank *b = new (std::nothrow) RingBank();
  if (!b) return nullptr;
  b->n_streams = n_streams;
  b->capacity = capacity;
  b->rings = new (std::nothrow) Ring[n_streams]();
  b->storage = static_cast<float *>(
      std::malloc(n_streams * capacity * 2 * sizeof(float)));
  if (!b->rings || !b->storage) {
    delete[] b->rings;
    std::free(b->storage);
    delete b;
    return nullptr;
  }
  for (uint64_t s = 0; s < n_streams; ++s) {
    ring_init(&b->rings[s], capacity, b->storage + s * capacity * 2);
  }
  return b;
}

void bank_destroy(RingBank *b) {
  if (!b) return;
  delete[] b->rings;
  std::free(b->storage);
  delete b;
}

uint64_t bank_capacity(const RingBank *b) { return b->capacity; }

uint64_t bank_push(RingBank *b, uint64_t stream, const float *frames,
                   uint64_t n) {
  if (stream >= b->n_streams) return 0;
  return push_impl(&b->rings[stream], frames, n);
}

}  // extern "C" (pause: templates cannot have C linkage)

namespace {

// Split [0, n_streams) across worker threads.  Rings are independent
// (per-ring SPSC), so stream-range parallelism is race-free as long as each
// stream keeps one producer and one consumer.  At 10k streams x 48 kHz the
// single-threaded copy loop alone exceeds the 16.7 ms hop budget (measured
// 29 ms); 4-8 workers bring it well under.  Templated so every bank variant
// shares ONE fan-out implementation (keeping three hand-copies in sync was
// its own bug class).
template <typename BankT, typename RangeFn, typename BufT>
void parallel_streams(BankT *b, uint64_t n_threads, RangeFn fn, BufT *buf,
                      uint64_t n, uint64_t *counts) {
  const uint64_t n_streams = b->n_streams;
  if (n_threads <= 1 || n_streams < 2 * n_threads) {
    fn(b, 0, n_streams, buf, n, counts);
    return;
  }
  std::vector<std::thread> workers;
  uint64_t per = (n_streams + n_threads - 1) / n_threads;
  for (uint64_t t = 0; t < n_threads; ++t) {
    uint64_t lo = t * per;
    uint64_t hi = lo + per < n_streams ? lo + per : n_streams;
    if (lo >= hi) break;
    workers.emplace_back(fn, b, lo, hi, buf, n, counts);
  }
  for (auto &w : workers) w.join();
}

void push_range(RingBank *b, uint64_t lo, uint64_t hi, float *frames,
                uint64_t n, uint64_t *) {
  for (uint64_t s = lo; s < hi; ++s) {
    push_impl(&b->rings[s], frames + s * n * 2, n);
  }
}

// dest (nullable): destination-row permutation — stream s's frames land in
// output row dest[s] instead of row s.  The host-sorted drain for palette-
// sorted pipelines (`SpectrogramPipeline.input_dest`): the bank already
// scatters per stream, so permuting the target row is free and deletes the
// device-side chunk gather.  Race-free iff dest is a permutation (each
// output row written by exactly one stream).  counts stay indexed by the
// SOURCE stream (drop accounting is per external stream).
void pop_range_d(RingBank *b, uint64_t lo, uint64_t hi, float *out, uint64_t n,
                 uint64_t *counts, const uint64_t *dest) {
  for (uint64_t s = lo; s < hi; ++s) {
    const uint64_t d = dest ? dest[s] : s;
    uint64_t got = pop_impl(&b->rings[s], out + d * n * 2, n);
    if (got < n) {
      std::memset(out + (d * n + got) * 2, 0, (n - got) * 2 * sizeof(float));
    }
    if (counts) counts[s] = got;
  }
}

void pop_range(RingBank *b, uint64_t lo, uint64_t hi, float *out, uint64_t n,
               uint64_t *counts) {
  pop_range_d(b, lo, hi, out, n, counts, nullptr);
}

// Planar variant: out[S, 2, n] with the channels deinterleaved during the
// copy — free on the host, and saves the device a [S, n, 2] -> [S, 2, n]
// transpose pass before every push (the TPU pipeline is channels-planar).
void pop_range_planar_d(RingBank *b, uint64_t lo, uint64_t hi, float *out,
                        uint64_t n, uint64_t *counts, const uint64_t *dest) {
  for (uint64_t s = lo; s < hi; ++s) {
    Ring *r = &b->rings[s];
    float *left = out + (dest ? dest[s] : s) * 2 * n;
    float *right = left + n;
    const uint64_t tail = r->tail.load(std::memory_order_relaxed);
    const uint64_t head = r->head.load(std::memory_order_acquire);
    const uint64_t avail = head - tail;
    uint64_t taken = n < avail ? n : avail;
    for (uint64_t i = 0; i < taken; ++i) {
      uint64_t idx = (tail + i) & r->mask;
      left[i] = r->data[2 * idx];
      right[i] = r->data[2 * idx + 1];
    }
    if (taken < n) {
      std::memset(left + taken, 0, (n - taken) * sizeof(float));
      std::memset(right + taken, 0, (n - taken) * sizeof(float));
    }
    r->tail.store(tail + taken, std::memory_order_release);
    if (counts) counts[s] = taken;
  }
}

void pop_range_planar(RingBank *b, uint64_t lo, uint64_t hi, float *out,
                      uint64_t n, uint64_t *counts) {
  pop_range_planar_d(b, lo, hi, out, n, counts, nullptr);
}

}  // namespace

extern "C" {

// Push the same count of frames to every stream from one [S, n, 2] block.
void bank_push_matrix(RingBank *b, const float *frames, uint64_t n) {
  push_range(b, 0, b->n_streams, const_cast<float *>(frames), n, nullptr);
}

void bank_push_matrix_mt(RingBank *b, const float *frames, uint64_t n,
                         uint64_t n_threads) {
  parallel_streams(b, n_threads, push_range, const_cast<float *>(frames), n,
                   nullptr);
}

// Fill out[S, n, 2] with n frames per stream.  Streams with fewer than n
// buffered frames contribute what they have, zero-padded; the per-stream
// count actually popped is written to counts[S].  One call per device feed.
void bank_pop_matrix(RingBank *b, float *out, uint64_t n, uint64_t *counts) {
  pop_range(b, 0, b->n_streams, out, n, counts);
}

void bank_pop_matrix_mt(RingBank *b, float *out, uint64_t n, uint64_t *counts,
                        uint64_t n_threads) {
  parallel_streams(b, n_threads, pop_range, out, n, counts);
}

// Planar [S, 2, n] drain (channels deinterleaved host-side; see
// pop_range_planar).
void bank_pop_matrix_planar_mt(RingBank *b, float *out, uint64_t n,
                               uint64_t *counts, uint64_t n_threads) {
  parallel_streams(b, n_threads, pop_range_planar, out, n, counts);
}

// Destination-permuted drains (host-sorted chunk order; see pop_range_d).
void bank_pop_matrix_mt_perm(RingBank *b, float *out, uint64_t n,
                             uint64_t *counts, uint64_t n_threads,
                             const uint64_t *dest) {
  auto fn = [dest](RingBank *bb, uint64_t lo, uint64_t hi, float *o,
                   uint64_t nn, uint64_t *c) {
    pop_range_d(bb, lo, hi, o, nn, c, dest);
  };
  parallel_streams(b, n_threads, fn, out, n, counts);
}

void bank_pop_matrix_planar_mt_perm(RingBank *b, float *out, uint64_t n,
                                    uint64_t *counts, uint64_t n_threads,
                                    const uint64_t *dest) {
  auto fn = [dest](RingBank *bb, uint64_t lo, uint64_t hi, float *o,
                   uint64_t nn, uint64_t *c) {
    pop_range_planar_d(bb, lo, hi, o, nn, c, dest);
  };
  parallel_streams(b, n_threads, fn, out, n, counts);
}

// Smallest buffered frame count across all streams (lockstep readiness).
uint64_t bank_min_size(const RingBank *b) {
  uint64_t m = UINT64_MAX;
  for (uint64_t s = 0; s < b->n_streams; ++s) {
    uint64_t sz = ring_size(&b->rings[s]);
    if (sz < m) m = sz;
  }
  return b->n_streams ? m : 0;
}

uint64_t bank_size(const RingBank *b, uint64_t stream) {
  return stream < b->n_streams ? ring_size(&b->rings[stream]) : 0;
}

uint64_t bank_dropped_total(const RingBank *b) {
  uint64_t total = 0;
  for (uint64_t s = 0; s < b->n_streams; ++s) {
    total += b->rings[s].dropped.load(std::memory_order_relaxed);
  }
  return total;
}

uint64_t bank_dropped(const RingBank *b, uint64_t stream) {
  return stream < b->n_streams ? ring_dropped(&b->rings[stream]) : 0;
}

// --------------------------- int16 ring bank --------------------------------
//
// PCM arrives from capture/network as int16; storing it that way halves ring
// memory and the hop-tick read traffic (the host memory bus is the 10k-stream
// bottleneck — see io/ring.py).  The i16 -> f32 conversion (x / 32768) fuses
// into the single pop pass.

struct alignas(64) Ring16 {
  int16_t *data = nullptr;  // capacity * 2 samples
  uint64_t capacity = 0;
  uint64_t mask = 0;
  std::atomic<uint64_t> head{0};
  std::atomic<uint64_t> tail{0};
  std::atomic<uint64_t> dropped{0};
};

struct RingBank16 {
  Ring16 *rings = nullptr;
  int16_t *storage = nullptr;
  uint64_t n_streams = 0;
  uint64_t capacity = 0;
};

namespace {

uint64_t push16_impl(Ring16 *r, const int16_t *frames, uint64_t n) {
  const uint64_t head = r->head.load(std::memory_order_relaxed);
  const uint64_t tail = r->tail.load(std::memory_order_acquire);
  const uint64_t free_frames = r->capacity - (head - tail);
  uint64_t accepted = n < free_frames ? n : free_frames;
  if (accepted < n) r->dropped.fetch_add(n - accepted, std::memory_order_relaxed);
  uint64_t start = head & r->mask;
  uint64_t first =
      accepted < (r->capacity - start) ? accepted : (r->capacity - start);
  std::memcpy(r->data + 2 * start, frames, first * 2 * sizeof(int16_t));
  if (accepted > first) {
    std::memcpy(r->data, frames + 2 * first,
                (accepted - first) * 2 * sizeof(int16_t));
  }
  r->head.store(head + accepted, std::memory_order_release);
  return accepted;
}

void pop16_to_f32(Ring16 *r, float *out, uint64_t n, uint64_t *count) {
  const uint64_t tail = r->tail.load(std::memory_order_relaxed);
  const uint64_t head = r->head.load(std::memory_order_acquire);
  const uint64_t avail = head - tail;
  uint64_t taken = n < avail ? n : avail;
  constexpr float kScale = 1.0f / 32768.0f;
  for (uint64_t i = 0; i < taken; ++i) {
    uint64_t idx = (tail + i) & r->mask;
    out[2 * i] = r->data[2 * idx] * kScale;
    out[2 * i + 1] = r->data[2 * idx + 1] * kScale;
  }
  if (taken < n) {
    std::memset(out + taken * 2, 0, (n - taken) * 2 * sizeof(float));
  }
  r->tail.store(tail + taken, std::memory_order_release);
  if (count) *count = taken;
}

// Producer-side batched int16 ingest: without it, 10k-stream producers are
// forced into per-stream ctypes calls (~5 us each — the exact cost
// bank_push_matrix_mt exists to amortize on the f32 bank).
void push16_range(RingBank16 *b, uint64_t lo, uint64_t hi,
                  const int16_t *frames, uint64_t n, uint64_t *counts) {
  for (uint64_t s = lo; s < hi; ++s) {
    uint64_t accepted = push16_impl(&b->rings[s], frames + s * n * 2, n);
    if (counts) counts[s] = accepted;
  }
}

// Planar producer variant: frames arrive [S, 2, n] (separate channel runs,
// e.g. from a decoder that emits planar PCM); interleave during the copy.
uint64_t push16_planar_impl(Ring16 *r, const int16_t *left,
                            const int16_t *right, uint64_t n) {
  const uint64_t head = r->head.load(std::memory_order_relaxed);
  const uint64_t tail = r->tail.load(std::memory_order_acquire);
  const uint64_t free_frames = r->capacity - (head - tail);
  uint64_t accepted = n < free_frames ? n : free_frames;
  if (accepted < n) {
    r->dropped.fetch_add(n - accepted, std::memory_order_relaxed);
  }
  for (uint64_t i = 0; i < accepted; ++i) {
    uint64_t idx = (head + i) & r->mask;
    r->data[2 * idx] = left[i];
    r->data[2 * idx + 1] = right[i];
  }
  r->head.store(head + accepted, std::memory_order_release);
  return accepted;
}

void push16_range_planar(RingBank16 *b, uint64_t lo, uint64_t hi,
                         const int16_t *frames, uint64_t n, uint64_t *counts) {
  for (uint64_t s = lo; s < hi; ++s) {
    const int16_t *left = frames + s * 2 * n;
    uint64_t accepted = push16_planar_impl(&b->rings[s], left, left + n, n);
    if (counts) counts[s] = accepted;
  }
}

// dest semantics as pop_range_d: stream s -> output row dest[s] (nullable).
void pop16_range_d(RingBank16 *b, uint64_t lo, uint64_t hi, float *out,
                   uint64_t n, uint64_t *counts, const uint64_t *dest) {
  for (uint64_t s = lo; s < hi; ++s) {
    pop16_to_f32(&b->rings[s], out + (dest ? dest[s] : s) * n * 2, n,
                 counts ? counts + s : nullptr);
  }
}

void pop16_range(RingBank16 *b, uint64_t lo, uint64_t hi, float *out,
                 uint64_t n, uint64_t *counts) {
  pop16_range_d(b, lo, hi, out, n, counts, nullptr);
}

// Raw int16 planar drain: no f32 conversion — the wire-dtype path where
// the i16 -> f32 scale runs ON DEVICE inside the jitted push (halves the
// host->device transfer bytes; the framing pass absorbs the multiply).
void pop16_range_planar_i16_d(RingBank16 *b, uint64_t lo, uint64_t hi,
                              int16_t *out, uint64_t n, uint64_t *counts,
                              const uint64_t *dest) {
  for (uint64_t s = lo; s < hi; ++s) {
    Ring16 *r = &b->rings[s];
    int16_t *left = out + (dest ? dest[s] : s) * 2 * n;
    int16_t *right = left + n;
    const uint64_t tail = r->tail.load(std::memory_order_relaxed);
    const uint64_t head = r->head.load(std::memory_order_acquire);
    const uint64_t avail = head - tail;
    uint64_t taken = n < avail ? n : avail;
    for (uint64_t i = 0; i < taken; ++i) {
      uint64_t idx = (tail + i) & r->mask;
      left[i] = r->data[2 * idx];
      right[i] = r->data[2 * idx + 1];
    }
    if (taken < n) {
      std::memset(left + taken, 0, (n - taken) * sizeof(int16_t));
      std::memset(right + taken, 0, (n - taken) * sizeof(int16_t));
    }
    r->tail.store(tail + taken, std::memory_order_release);
    if (counts) counts[s] = taken;
  }
}

void pop16_range_planar_i16(RingBank16 *b, uint64_t lo, uint64_t hi,
                            int16_t *out, uint64_t n, uint64_t *counts) {
  pop16_range_planar_i16_d(b, lo, hi, out, n, counts, nullptr);
}

void pop16_range_planar_d(RingBank16 *b, uint64_t lo, uint64_t hi, float *out,
                          uint64_t n, uint64_t *counts, const uint64_t *dest) {
  constexpr float kScale = 1.0f / 32768.0f;
  for (uint64_t s = lo; s < hi; ++s) {
    Ring16 *r = &b->rings[s];
    float *left = out + (dest ? dest[s] : s) * 2 * n;
    float *right = left + n;
    const uint64_t tail = r->tail.load(std::memory_order_relaxed);
    const uint64_t head = r->head.load(std::memory_order_acquire);
    const uint64_t avail = head - tail;
    uint64_t taken = n < avail ? n : avail;
    for (uint64_t i = 0; i < taken; ++i) {
      uint64_t idx = (tail + i) & r->mask;
      left[i] = r->data[2 * idx] * kScale;
      right[i] = r->data[2 * idx + 1] * kScale;
    }
    if (taken < n) {
      std::memset(left + taken, 0, (n - taken) * sizeof(float));
      std::memset(right + taken, 0, (n - taken) * sizeof(float));
    }
    r->tail.store(tail + taken, std::memory_order_release);
    if (counts) counts[s] = taken;
  }
}

void pop16_range_planar(RingBank16 *b, uint64_t lo, uint64_t hi, float *out,
                        uint64_t n, uint64_t *counts) {
  pop16_range_planar_d(b, lo, hi, out, n, counts, nullptr);
}

}  // namespace

RingBank16 *bank16_create(uint64_t n_streams, uint64_t capacity) {
  capacity = round_pow2(capacity < 2 ? 2 : capacity);
  RingBank16 *b = new (std::nothrow) RingBank16();
  if (!b) return nullptr;
  b->n_streams = n_streams;
  b->capacity = capacity;
  b->rings = new (std::nothrow) Ring16[n_streams]();
  b->storage = static_cast<int16_t *>(
      std::malloc(n_streams * capacity * 2 * sizeof(int16_t)));
  if (!b->rings || !b->storage) {
    delete[] b->rings;
    std::free(b->storage);
    delete b;
    return nullptr;
  }
  for (uint64_t s = 0; s < n_streams; ++s) {
    Ring16 *r = &b->rings[s];
    r->capacity = capacity;
    r->mask = capacity - 1;
    r->data = b->storage + s * capacity * 2;
  }
  return b;
}

void bank16_destroy(RingBank16 *b) {
  if (!b) return;
  delete[] b->rings;
  std::free(b->storage);
  delete b;
}

uint64_t bank16_capacity(const RingBank16 *b) { return b->capacity; }

uint64_t bank16_push(RingBank16 *b, uint64_t stream, const int16_t *frames,
                     uint64_t n) {
  if (stream >= b->n_streams) return 0;
  return push16_impl(&b->rings[stream], frames, n);
}

// Push one [S, n, 2] interleaved int16 block to every stream; per-stream
// accepted counts (for overflow accounting) go to counts[S] when non-null.
void bank16_push_matrix_mt(RingBank16 *b, const int16_t *frames, uint64_t n,
                           uint64_t *counts, uint64_t n_threads) {
  parallel_streams(b, n_threads, push16_range, frames, n, counts);
}

// Planar producer: frames [S, 2, n] int16, interleaved into the rings.
void bank16_push_matrix_planar_mt(RingBank16 *b, const int16_t *frames,
                                  uint64_t n, uint64_t *counts,
                                  uint64_t n_threads) {
  parallel_streams(b, n_threads, push16_range_planar, frames, n, counts);
}

// Sub-range batched push for sharded producers: frames [hi-lo, n, 2] lands
// on streams [lo, hi).  Single-threaded inside the call — the producer
// thread IS the parallelism, and each ring keeps exactly one producer
// (the SPSC contract).
void bank16_push_matrix_range(RingBank16 *b, uint64_t lo, uint64_t hi,
                              const int16_t *frames, uint64_t n,
                              uint64_t *counts) {
  if (hi > b->n_streams) hi = b->n_streams;
  for (uint64_t s = lo; s < hi; ++s) {
    uint64_t accepted =
        push16_impl(&b->rings[s], frames + (s - lo) * n * 2, n);
    if (counts) counts[s - lo] = accepted;
  }
}

void bank16_pop_matrix_f32(RingBank16 *b, float *out, uint64_t n,
                           uint64_t *counts, uint64_t n_threads) {
  parallel_streams(b, n_threads, pop16_range, out, n, counts);
}

void bank16_pop_matrix_f32_planar(RingBank16 *b, float *out, uint64_t n,
                                  uint64_t *counts, uint64_t n_threads) {
  parallel_streams(b, n_threads, pop16_range_planar, out, n, counts);
}

void bank16_pop_matrix_i16_planar(RingBank16 *b, int16_t *out, uint64_t n,
                                  uint64_t *counts, uint64_t n_threads) {
  parallel_streams(b, n_threads, pop16_range_planar_i16, out, n, counts);
}

// Destination-permuted drains (host-sorted chunk order; see pop_range_d).
void bank16_pop_matrix_f32_perm(RingBank16 *b, float *out, uint64_t n,
                                uint64_t *counts, uint64_t n_threads,
                                const uint64_t *dest) {
  auto fn = [dest](RingBank16 *bb, uint64_t lo, uint64_t hi, float *o,
                   uint64_t nn, uint64_t *c) {
    pop16_range_d(bb, lo, hi, o, nn, c, dest);
  };
  parallel_streams(b, n_threads, fn, out, n, counts);
}

void bank16_pop_matrix_f32_planar_perm(RingBank16 *b, float *out, uint64_t n,
                                       uint64_t *counts, uint64_t n_threads,
                                       const uint64_t *dest) {
  auto fn = [dest](RingBank16 *bb, uint64_t lo, uint64_t hi, float *o,
                   uint64_t nn, uint64_t *c) {
    pop16_range_planar_d(bb, lo, hi, o, nn, c, dest);
  };
  parallel_streams(b, n_threads, fn, out, n, counts);
}

void bank16_pop_matrix_i16_planar_perm(RingBank16 *b, int16_t *out,
                                       uint64_t n, uint64_t *counts,
                                       uint64_t n_threads,
                                       const uint64_t *dest) {
  auto fn = [dest](RingBank16 *bb, uint64_t lo, uint64_t hi, int16_t *o,
                   uint64_t nn, uint64_t *c) {
    pop16_range_planar_i16_d(bb, lo, hi, o, nn, c, dest);
  };
  parallel_streams(b, n_threads, fn, out, n, counts);
}

// Consumer-side discard of everything buffered for one stream (slot reuse:
// a new tenant must not consume the previous tenant's backlog).  The drop
// counter is left untouched — discarded-on-detach is not an overrun.
void bank16_reset(RingBank16 *b, uint64_t stream) {
  if (stream >= b->n_streams) return;
  Ring16 *r = &b->rings[stream];
  const uint64_t head = r->head.load(std::memory_order_acquire);
  r->tail.store(head, std::memory_order_release);
}

uint64_t bank16_size(const RingBank16 *b, uint64_t stream) {
  if (stream >= b->n_streams) return 0;
  const uint64_t tail = b->rings[stream].tail.load(std::memory_order_acquire);
  const uint64_t head = b->rings[stream].head.load(std::memory_order_acquire);
  return head >= tail ? head - tail : 0;
}

uint64_t bank16_min_size(const RingBank16 *b) {
  uint64_t m = UINT64_MAX;
  for (uint64_t s = 0; s < b->n_streams; ++s) {
    const uint64_t tail = b->rings[s].tail.load(std::memory_order_acquire);
    const uint64_t head = b->rings[s].head.load(std::memory_order_acquire);
    uint64_t sz = head >= tail ? head - tail : 0;
    if (sz < m) m = sz;
  }
  return b->n_streams ? m : 0;
}

uint64_t bank16_dropped_total(const RingBank16 *b) {
  uint64_t total = 0;
  for (uint64_t s = 0; s < b->n_streams; ++s) {
    total += b->rings[s].dropped.load(std::memory_order_relaxed);
  }
  return total;
}

}  // extern "C"
