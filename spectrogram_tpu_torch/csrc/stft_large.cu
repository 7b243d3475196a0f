// The large-N STFT route: the STFT kernels' function at any N, with each
// row's FFT buffer in device memory where it passes a block's 227 KB of
// shared memory.  Packed rows hold N entries (Bluestein: M): N = 2^15 and
// up, 7-smooth N above 29,056, Bluestein N from about 14,500 (48 kHz with
// a 0.5 s window, N=48,000; a 16,384-sample window at pad 2; the prime
// 16,411, M = 33,614).  Split-real rows hold the N/2-point pack, so only
// even N above 58,112 (N = 65,536 at a 32,768-sample window), even N whose
// N/2 needs a Bluestein M past 29,056, and odd N from about 14,500 take it.
//
// Replaces spectrogram_tpu/ops/pallas/stft_kernel.py `stft_mag_fused2`
// (packed and split-real) at those N, where the JAX package's fused chain
// has no plan and its pipeline runs XLA's FFT; every STFT entry of
// ops/cuda/stft_kernel.py (window planes, all-windows, carry+chunk,
// transposed, tsplit) and the fused push take it there, with their operands
// framed into [rows, W] window planes first.
//
//   spk_stft_large_packed(_i16)  [rows, w] f32 (int16) window planes l, r ->
//                                the stereo-packed magnitudes, [rows, B] x2
//   spk_stft_large_split         [rows, w] f32 window planes -> each
//                                channel's split-real magnitudes, [rows, B] x2
//
// with B = stft_bins(N, w).  Each entry runs the passes of stft_large.cuh
// over a caller-allocated scratch of [rows, buf_size] complex f32 ([2 rows,
// buf_size] split-real, buf_size N/2 at even N), each walking rows along the
// grid's y axis.  A direct N takes two kernels: `large_load_local_kernel`
// (one block per (run, row), blockIdx.x the run, so that a row's G runs,
// which read the same 32-byte sectors of its window planes G entries apart,
// are neighbours in the launch order and L2 serves them; at most 512
// threads, `LargeLoadBounds`, a run of 128 KB holding an SM alone) and
// `large_last_unpack_kernel` / `large_last_magnitude_kernel` (a thread per
// butterfly pair of the last stage, templated on its radix), with a
// `large_pass_kernel` launch for each global stage between them (none at
// the kernels' span).  Bluestein takes the load (a thread per entry), its
// DIF stage, the local pass, its DIT stage and the unpack (a thread per
// bin).  It is one launch of the route, counted once by its wrapper.
//
// What bounds it on this card (H100).  A direct N reads its samples once,
// writes and reads the scratch once each (pass 1, pass 2) and writes its
// planes: at N=65,536 and 4,096 int16 rows 0.54 GB of samples, 2.15 GB
// written, 2.15 GB read, 1.07 GB of planes, 5.9 GB or 1.77 ms at 3.35 TB/s.
// Pass 2 runs near that rate (1.19 ms for its 3.2 GB).  Pass 1 (0.80 ms of
// bytes) took 3.95 ms: a run's four register passes, one block of 16 warps
// a SM (the 128 KB tile), a barrier between passes, so no other block
// hides a pass's latency (the first's reads of the window planes, the
// others' reads of the run's twiddles from L2).  It was 7.93 ms as one
// `butterfly_at` sweep of the tile a stage (seven, each through run-time
// radices and divisions) after a load through two slot tables; the register
// passes took it to 4.82 ms, reading the run's twiddles contiguous (every
// G-th entry of the table, copied) to 3.95, and the tile's swizzle took
// 0.88x the time of bits 6..9 (PERF.md §6).  Its samples are read G (2 to
// 7) entries apart, so each warp's load touches G times the sectors it
// uses; the row's other runs read the rest from L2.  Bluestein's passes
// each read and write the scratch once.
#include "stft_large.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;
// blocks per element-wise launch: four waves of 8 blocks on each of the
// H100's 132 SMs.  Each thread walks rows blockIdx.y, + gridDim.y, ..., so
// the plan it copies to its stack frame (ptxas: 128 bytes, `radix[]` is
// indexed at run time) is paid once for many elements, not once for each.
constexpr int kBlocksPerLaunch = 4 * 8 * 132;

dim3 grid_of(int count, int rows) {
  const int x = (count + kThreads - 1) / kThreads;
  const int y = kBlocksPerLaunch / x;
  return dim3(x, y < 1 ? 1 : y < rows ? y : rows);
}

// Bluestein's load, a thread per entry: stereo-packed ...
template <class T>
__global__ void __launch_bounds__(kThreads) large_load_packed_kernel(
    spk::LargePlan p, const T* __restrict__ l, const T* __restrict__ r,
    const float* __restrict__ hann, float2* __restrict__ scratch, int rows) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.buf_size()) return;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const size_t in = static_cast<size_t>(row) * p.w;
    spk::large_load_packed(p, l + in, r + in, hann,
                           scratch + static_cast<size_t>(row) * p.buf_size(), i);
  }
}

// ... or split-real: scratch row q = 2 * row + c holds channel c of window
// row `row`
__global__ void __launch_bounds__(kThreads) large_load_real_kernel(
    spk::LargePlan p, const float* __restrict__ l, const float* __restrict__ r,
    const float* __restrict__ hann, float2* __restrict__ scratch, int rows) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.buf_size()) return;
  for (int q = blockIdx.y; q < 2 * rows; q += gridDim.y) {
    const float* x = ((q & 1) ? r : l) + static_cast<size_t>(q >> 1) * p.w;
    spk::large_load_real(p, x, hann,
                         scratch + static_cast<size_t>(q) * p.buf_size(), i);
  }
}

// Bluestein's local pass: one block per (run, row), through shared memory
__global__ void __launch_bounds__(spk::kStftMaxThreads) large_local_kernel(
    spk::LargePlan p, float2* __restrict__ scratch, int rows) {
  extern __shared__ float2 tile[];
  for (int q = blockIdx.y; q < rows; q += gridDim.y) {
    spk::large_local(p, scratch + static_cast<size_t>(q) * p.buf_size(),
                     blockIdx.x, tile);
  }
}

// Pass 1 of a direct N: one block per (run, row), the run's inputs straight
// from the window planes (f32 or int16 stereo-packed; kSplit: f32 split-real,
// scratch row q = 2 * row + c) into the first register pass, the run's
// other passes through shared memory, the last into the scratch.
template <class T, bool kSplit>
__global__ void __launch_bounds__(spk::LargeLoadBounds::threads) large_load_local_kernel(
    spk::LargePlan p, const T* __restrict__ l, const T* __restrict__ r,
    const float* __restrict__ hann, float2* __restrict__ scratch, int rows) {
  constexpr int kCap = spk::group_cap<spk::LargeLoadBounds>();
  extern __shared__ float2 tile[];
  const int run = blockIdx.x;
  const int first = spk::large_run_first(p, run);
  const int q_rows = kSplit ? 2 * rows : rows;
  for (int q = blockIdx.y; q < q_rows; q += gridDim.y) {
    float2* row = scratch + static_cast<size_t>(q) * p.buf_size();
    if constexpr (kSplit) {
      const float* x = ((q & 1) ? r : l) + static_cast<size_t>(q >> 1) * p.w;
      spk::large_load_local<kCap>(p, row, run, first, tile, [&](int i) {
        return spk::large_real_value(p, x, hann, i);
      });
    } else {
      const size_t in = static_cast<size_t>(q) * p.w;
      spk::large_load_local<kCap>(p, row, run, first, tile, [&](int i) {
        return spk::large_packed_value(p, l + in, r + in, hann, i);
      });
    }
  }
}

// One block per (run, scratch row), rows walked along y.
dim3 runs_grid(const spk::LargePlan& p, int scratch_rows) {
  return dim3(p.passes.n / p.span, scratch_rows < kMaxGridY ? scratch_rows : kMaxGridY);
}

// Pass 1's launch; 0 or the CUDA error.
template <class T, bool kSplit>
int launch_load_local(const spk::LargePlan& p, const T* left, const T* right,
                      const float* hann, float2* scratch, int rows, cudaStream_t st) {
  const size_t smem = spk::large_smem_bytes(p.span);
  const auto kernel = large_load_local_kernel<T, kSplit>;
  const int e = spk::allow_smem(kernel, smem);
  if (e != 0) return e;
  kernel<<<runs_grid(p, kSplit ? 2 * rows : rows), spk::large_load_threads(p), smem, st>>>(
      p, left, right, hann, scratch, rows);
  return static_cast<int>(cudaGetLastError());
}

// A global stage of its own, a thread per butterfly
__global__ void __launch_bounds__(kThreads) large_pass_kernel(
    spk::LargePlan p, int kind, int s, int len, float2* __restrict__ scratch,
    int rows) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= spk::large_pass_count(p, kind, s)) return;
  for (int q = blockIdx.y; q < rows; q += gridDim.y) {
    spk::large_pass_at(p, kind, s, len,
                       scratch + static_cast<size_t>(q) * p.buf_size(), j);
  }
}

// Pass 2 of a direct N, a thread per butterfly pair of the last stage:
// stereo-packed ...
template <int R>
__global__ void __launch_bounds__(kThreads) large_last_unpack_kernel(
    spk::LargeLast p, const float2* __restrict__ scratch,
    float* __restrict__ out_l, float* __restrict__ out_r, int rows) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j > p.len / 2) return;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const size_t at = static_cast<size_t>(row) * p.bins;
    spk::large_last_unpack<R>(p, scratch + static_cast<size_t>(row) * p.size, j,
                              out_l + at, out_r + at);
  }
}

// ... or split-real (scratch row q: channel q & 1 of row q >> 1)
template <int R>
__global__ void __launch_bounds__(kThreads) large_last_magnitude_kernel(
    spk::LargeLast p, const float2* __restrict__ scratch,
    float* __restrict__ out_l, float* __restrict__ out_r, int rows) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j > p.len / 2) return;
  for (int q = blockIdx.y; q < 2 * rows; q += gridDim.y) {
    float* out = ((q & 1) ? out_r : out_l) + static_cast<size_t>(q >> 1) * p.bins;
    spk::large_last_magnitude<R>(p, scratch + static_cast<size_t>(q) * p.size, j, out);
  }
}

// Bluestein's unpack, a thread per bin: stereo-packed ...
__global__ void __launch_bounds__(kThreads) large_unpack_kernel(
    spk::LargePlan p, const float2* __restrict__ scratch,
    float* __restrict__ out_l, float* __restrict__ out_r, int rows) {
  const int bins = spk::stft_bins(p.n, p.w);
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= bins) return;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const size_t at = static_cast<size_t>(row) * bins + k;
    spk::large_unpack(p, scratch + static_cast<size_t>(row) * p.buf_size(), k,
                      out_l + at, out_r + at);
  }
}

// ... or split-real
__global__ void __launch_bounds__(kThreads) large_magnitude_kernel(
    spk::LargePlan p, const float2* __restrict__ scratch,
    float* __restrict__ out_l, float* __restrict__ out_r, int rows) {
  const int bins = spk::stft_bins(p.n, p.w);
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= bins) return;
  for (int q = blockIdx.y; q < 2 * rows; q += gridDim.y) {
    const float2* row = scratch + static_cast<size_t>(q) * p.buf_size();
    ((q & 1) ? out_r : out_l)[static_cast<size_t>(q >> 1) * bins + k] =
        spk::large_magnitude(p, row, k);
  }
}

// The route over `rows` window rows (scratch_rows = rows, or 2 rows
// split-real); 0 or the CUDA error.  T, kSplit: the sample type and form.
template <class T, bool kSplit>
int run_route(const spk::LargePlan& p, const T* left, const T* right,
              const float* hann, float2* scratch, float* out_l, float* out_r,
              int rows, cudaStream_t st) {
  const int scratch_rows = kSplit ? 2 * rows : rows;
  if (p.bluestein) {
    if constexpr (kSplit) {
      large_load_real_kernel<<<grid_of(p.buf_size(), scratch_rows), kThreads, 0, st>>>(
          p, left, right, hann, scratch, rows);
    } else {
      large_load_packed_kernel<T><<<grid_of(p.buf_size(), rows), kThreads, 0, st>>>(
          p, left, right, hann, scratch, rows);
    }
  }
  const size_t smem = spk::large_smem_bytes(p.span);
  int e = static_cast<int>(cudaGetLastError());
  if (e == 0 && p.bluestein) e = spk::allow_smem(large_local_kernel, smem);
  if (e == 0) {
    e = spk::large_passes(p, [&](int kind, int s, int len) {
      const int count = spk::large_pass_count(p, kind, s);
      if (kind == spk::kLargeLoadLocal) {
        return launch_load_local<T, kSplit>(p, left, right, hann, scratch, rows, st);
      }
      if (kind == spk::kLargeLocal) {
        large_local_kernel<<<runs_grid(p, scratch_rows), spk::stft_threads(p.span), smem,
                             st>>>(p, scratch, scratch_rows);
      } else if (kind == spk::kLargeLastUnpack) {
        const spk::LargeLast last = spk::large_last(p);
        return spk::with_last_radix(p, [&](auto radix) {
          constexpr int R = decltype(radix)::value;
          const dim3 grid = grid_of(count, scratch_rows);
          if constexpr (kSplit) {
            large_last_magnitude_kernel<R><<<grid, kThreads, 0, st>>>(last, scratch, out_l,
                                                                      out_r, rows);
          } else {
            large_last_unpack_kernel<R><<<grid, kThreads, 0, st>>>(last, scratch, out_l,
                                                                   out_r, rows);
          }
          return static_cast<int>(cudaGetLastError());
        });
      } else {
        large_pass_kernel<<<grid_of(count, scratch_rows), kThreads, 0, st>>>(
            p, kind, s, len, scratch, scratch_rows);
      }
      return static_cast<int>(cudaGetLastError());
    });
  }
  if (e != 0 || !p.bluestein) return e;
  const dim3 grid = grid_of(spk::stft_bins(p.n, p.w), scratch_rows);
  if constexpr (kSplit) {
    large_magnitude_kernel<<<grid, kThreads, 0, st>>>(p, scratch, out_l, out_r, rows);
  } else {
    large_unpack_kernel<<<grid, kThreads, 0, st>>>(p, scratch, out_l, out_r, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int large_packed(const T* left, const T* right, const float* hann,
                 const void* consts, float* scratch, float* out_l,
                 float* out_r, int rows, int w, int n, void* stream) {
  spk::LargePlan p;
  if (!spk::make_large_plan(n, w, consts, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return run_route<T, false>(p, left, right, hann, reinterpret_cast<float2*>(scratch),
                             out_l, out_r, rows, static_cast<cudaStream_t>(stream));
}

}  // namespace

// left, right: [rows, w] f32 window planes; hann: [w] (packed_hann);
// consts: n's FFT table (`fft_table`); scratch: [rows, buf_size] complex f32
// (buf_size = n, or Bluestein's M), overwritten; out_l, out_r: [rows,
// stft_bins(n, w)] f32.  All contiguous, in device memory.
SPK_EXPORT int spk_stft_large_packed(const float* left, const float* right,
                                     const float* hann, const void* consts,
                                     float* scratch, float* out_l,
                                     float* out_r, int rows, int w, int n,
                                     void* stream) {
  return large_packed(left, right, hann, consts, scratch, out_l, out_r, rows,
                      w, n, stream);
}

// As spk_stft_large_packed with int16 planes; hann carries the 2^-15 wire
// scale (packed_hann_i16).
SPK_EXPORT int spk_stft_large_packed_i16(const short* left, const short* right,
                                         const float* hann, const void* consts,
                                         float* scratch, float* out_l,
                                         float* out_r, int rows, int w, int n,
                                         void* stream) {
  return large_packed(left, right, hann, consts, scratch, out_l, out_r, rows,
                      w, n, stream);
}

// As spk_stft_large_packed with the split-real rows: hann is split_hann,
// consts n's split-real table (`split_fft_table`), and scratch [2 rows,
// buf_size] complex f32 (buf_size of N/2 at even N, else of N).
SPK_EXPORT int spk_stft_large_split(const float* left, const float* right,
                                    const float* hann, const void* consts,
                                    float* scratch, float* out_l, float* out_r,
                                    int rows, int w, int n, void* stream) {
  spk::LargePlan p;
  if (!spk::make_large_plan(n, w, consts, &p, spk::kMaxSmemBytes / 8, true)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return run_route<float, true>(p, left, right, hann, reinterpret_cast<float2*>(scratch),
                                out_l, out_r, rows, static_cast<cudaStream_t>(stream));
}

// Pass 1's form at N and w, packed or split-real (`large_pass1_form`):
// form[0] its register passes over a run, form[1] a block's threads.
SPK_EXPORT int spk_stft_large_pass1(int n, int w, int split, int* form) {
  return spk::large_pass1_form(n, w, split != 0, form);
}
