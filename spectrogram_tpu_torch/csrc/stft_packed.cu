// Kernel A: the stereo-packed STFT magnitude kernel.
//
// Replaces spectrogram_tpu/ops/pallas/stft_kernel.py `stft_mag_fused2`
// (packed=True; bodies `_kernel_packed_2d` and `_packed_mag_rows`).  The TPU
// kernel wrote the DFT as four-step MXU matmuls; here it is an ordinary
// radix-2 FFT in shared memory, one thread block per window row.
//
// Per row, with N = 2^log2n >= W:
//   z[n] = (l[n] + i r[n]) * hann[n]     for n < W, 0 for W <= n < N
//   Z    = DFT_N(z)
//   L[k] = |Z[k] + conj(Z[(N-k) mod N])|, R[k] = |Z[k] - conj(Z[(N-k) mod N])|
// for k = 0 .. N/2-1 (DC included; the k=0 partner is Z[0] itself).  `hann`
// arrives with the reference's 2/W output scale and the unpack's 1/2 folded
// in, as the TPU kernel's `_packed_hann` did.
//
// What bounds it on this card: shared-memory traffic of the log2(N) butterfly
// stages (N=4096: 12 passes over a 32 KB row), not device memory (8 bytes in
// and 8 bytes out per sample).  Every stage runs in true f32 with twiddles
// from a table the host computed in float64; nothing touches tensor cores,
// so TF32 cannot apply.  Speed is later work: radix-4 stages, twiddles in
// shared memory and conflict-free bit reversal are the obvious next steps.
#include "spk_common.cuh"

namespace {

constexpr int kMaxThreads = 512;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__global__ void __launch_bounds__(kMaxThreads) stft_packed_kernel(
    const float* __restrict__ left, const float* __restrict__ right,
    const float* __restrict__ hann, const float2* __restrict__ twiddles,
    float* __restrict__ out_l, float* __restrict__ out_r, int w, int log2n) {
  extern __shared__ float2 buf[];
  const int n = 1 << log2n;
  const int half = n >> 1;
  const size_t row = blockIdx.x;
  const float* l = left + row * w;
  const float* r = right + row * w;

  // Hann, pack and zero-pad, stored in bit-reversed order for the
  // decimation-in-time stages (coalesced global reads).
  const int shift = 32 - log2n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float2 z = make_float2(0.f, 0.f);
    if (i < w) {
      const float h = hann[i];
      z = make_float2(l[i] * h, r[i] * h);
    }
    buf[__brev(static_cast<unsigned>(i)) >> shift] = z;
  }
  __syncthreads();

  // Stage s merges transforms of size 2^s into 2^(s+1); the twiddle of
  // butterfly position p is exp(-2 pi i p / 2^(s+1)) = twiddles[p * N / 2^(s+1)].
  for (int s = 0; s < log2n; ++s) {
    const int hs = 1 << s;
    const int tstep = half >> s;
    for (int j = threadIdx.x; j < half; j += blockDim.x) {
      const int pos = j & (hs - 1);
      const int i0 = ((j >> s) << (s + 1)) | pos;
      const int i1 = i0 + hs;
      const float2 t = cmul(buf[i1], twiddles[pos * tstep]);
      const float2 a = buf[i0];
      buf[i0] = make_float2(a.x + t.x, a.y + t.y);
      buf[i1] = make_float2(a.x - t.x, a.y - t.y);
    }
    __syncthreads();
  }

  // Conjugate-symmetric stereo unpack (fft.rs:81-92), coalesced stores.
  float* ol = out_l + row * half;
  float* orr = out_r + row * half;
  for (int k = threadIdx.x; k < half; k += blockDim.x) {
    const float2 zk = buf[k];
    const float2 zm = buf[(n - k) & (n - 1)];
    const float lr = zk.x + zm.x, li = zk.y - zm.y;
    const float rr = zk.x - zm.x, ri = zk.y + zm.y;
    ol[k] = sqrtf(lr * lr + li * li);
    orr[k] = sqrtf(rr * rr + ri * ri);
  }
}

}  // namespace

// left, right: [rows, w] f32; hann: [w] f32; twiddles: [N/2] complex f32
// (exp(-2 pi i k / N)); out_l, out_r: [rows, N/2] f32.  All contiguous.
SPK_EXPORT int spk_stft_packed(const float* left, const float* right,
                               const float* hann, const void* twiddles,
                               float* out_l, float* out_r, int rows, int w,
                               int log2n, void* stream) {
  const int n = 1 << log2n;
  const int smem = n * static_cast<int>(sizeof(float2));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stft_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int threads = n / 2 < kMaxThreads ? n / 2 : kMaxThreads;
  stft_packed_kernel<<<rows, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      left, right, hann, static_cast<const float2*>(twiddles), out_l, out_r, w,
      log2n);
  return static_cast<int>(cudaGetLastError());
}

SPK_EXPORT const char* spk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
