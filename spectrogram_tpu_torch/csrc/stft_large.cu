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
// buf_size] split-real, buf_size N/2 at even N): the load (a thread per
// entry, gathering its samples), the local pass (one block per run of
// `span` entries, through shared memory), one launch per global stage (a
// thread per butterfly; Bluestein's DIF stage before the local pass) and the
// unpack (a thread per bin), each thread walking rows along the grid's y
// axis.  It is one launch of the route, counted once by its wrapper.
//
// What bounds it on this card: device memory.  Each pass reads and writes
// the scratch once, 16 bytes per entry and row: four passes for a direct
// N, five for Bluestein, where the bytes the function must move (samples
// in, planes out) are one pass's worth; a direct N's load also gathers its
// samples from digit-reversed positions, 4 bytes scattered over the row.
// The split-real pack halves the entries of a row, and so the bytes of
// every pass.  A radix-N/span global stage fused with the unpack, and the
// load fused with the local pass, would cut two passes; that is later work.
#include "stft_large.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;
// blocks per element-wise launch: four waves of 8 blocks on each of the
// H100's 132 SMs.  Each thread walks rows blockIdx.y, + gridDim.y, ..., so
// the plan it copies to its stack frame (ptxas: 112 bytes, `radix[]` is
// indexed at run time) is paid once for many elements, not once for each.
constexpr int kBlocksPerLaunch = 4 * 8 * 132;

dim3 grid_of(int count, int rows) {
  const int x = (count + kThreads - 1) / kThreads;
  const int y = kBlocksPerLaunch / x;
  return dim3(x, y < 1 ? 1 : y < rows ? y : rows);
}

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

// scratch row q = 2 * row + c holds channel c of window row `row`
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

// one block per (run, row): the local stages through shared memory
__global__ void __launch_bounds__(spk::kStftMaxThreads) large_local_kernel(
    spk::LargePlan p, float2* __restrict__ scratch, int rows) {
  extern __shared__ float2 tile[];
  for (int q = blockIdx.y; q < rows; q += gridDim.y) {
    spk::large_local(p, scratch + static_cast<size_t>(q) * p.buf_size(),
                     blockIdx.x, tile);
  }
}

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

// The passes of the plan over `scratch_rows` rows; 0 or the CUDA error.
int run_passes(const spk::LargePlan& p, float2* scratch, int scratch_rows,
               cudaStream_t st) {
  const size_t smem = p.span * sizeof(float2);
  const int e = spk::allow_smem(large_local_kernel, smem);
  if (e != 0) return e;
  return spk::large_passes(p, [&](int kind, int s, int len) {
    const int count = spk::large_pass_count(p, kind, s);
    if (kind == spk::kLargeLocal) {
      large_local_kernel<<<dim3(count, scratch_rows < kMaxGridY ? scratch_rows
                                                                : kMaxGridY),
                           spk::stft_threads(p.span), smem, st>>>(
          p, scratch, scratch_rows);
    } else {
      large_pass_kernel<<<grid_of(count, scratch_rows), kThreads, 0, st>>>(
          p, kind, s, len, scratch, scratch_rows);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

template <class T>
int large_packed(const T* left, const T* right, const float* hann,
                 const void* consts, float* scratch, float* out_l,
                 float* out_r, int rows, int w, int n, void* stream) {
  spk::LargePlan p;
  if (!spk::make_large_plan(n, w, consts, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  auto* buf = reinterpret_cast<float2*>(scratch);
  large_load_packed_kernel<T><<<grid_of(p.buf_size(), rows), kThreads, 0, st>>>(
      p, left, right, hann, buf, rows);
  int e = static_cast<int>(cudaGetLastError());
  if (e == 0) e = run_passes(p, buf, rows, st);
  if (e != 0) return e;
  large_unpack_kernel<<<grid_of(spk::stft_bins(n, w), rows), kThreads, 0, st>>>(
      p, buf, out_l, out_r, rows);
  return static_cast<int>(cudaGetLastError());
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
  const auto st = static_cast<cudaStream_t>(stream);
  auto* buf = reinterpret_cast<float2*>(scratch);
  large_load_real_kernel<<<grid_of(p.buf_size(), 2 * rows), kThreads, 0, st>>>(
      p, left, right, hann, buf, rows);
  int e = static_cast<int>(cudaGetLastError());
  if (e == 0) e = run_passes(p, buf, 2 * rows, st);
  if (e != 0) return e;
  large_magnitude_kernel<<<grid_of(spk::stft_bins(n, w), 2 * rows), kThreads, 0,
                           st>>>(p, buf, out_l, out_r, rows);
  return static_cast<int>(cudaGetLastError());
}
