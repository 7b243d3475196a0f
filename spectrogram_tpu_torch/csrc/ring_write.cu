// The display ring write: window-major f32 magnitude planes -> ring rows
// cursor .. cursor+k-1 of every stream, in the ring's dtype, in place.
//
// Replaces no Pallas kernel.  The JAX pipeline writes its ring with
// `jax.lax.dynamic_update_slice(state.ring, rows.astype(ring_dtype), ...)`
// (spectrogram_tpu/models/spectrogram.py), which XLA fuses into one pass on
// the TPU; this kernel does that fusion by hand.  Its plain version
// (`ring_kernel.ring_write_plain`) is the three ATen passes it replaces: a
// stack of bins 1..W-1 of both channels, the cast, and an index_copy_ into
// the ring's rows.
//
// For stream s and hop row r it writes ring[s, cursor + r, ch, j] =
// round(mag_ch[r*S + s, 1 + j]) for j < B = W-1, rounding to nearest even
// with the intrinsics PyTorch's own cast uses (`__float2bfloat16_rn`,
// `__float2half_rn`), so its bits are `.to(ring_dtype)`'s, NaN included.
// The cursor is read from device memory, so the host never waits for it.
// The pipeline keeps the cursor on the k-row grid of a ring whose length
// is a multiple of k, so the rows never wrap; a row past the ring's end is
// taken modulo its length, so no cursor writes outside the ring.
//
// What bounds it on this card: device memory, and nothing else; it is a
// pure copy with a rounding.  At the display geometry (2,048 streams x 8
// rows x 2 channels x 2,399 bins) it reads 314.4 MB of f32 and writes
// 157.2 MB of bf16: 471.6 MB a push, 0.141 ms at 3.35 TB/s.  The ATen
// passes moved about 1.41 GB for it (the stack and the cast each wrote an
// intermediate, and index_copy_ gathered through a transposed view).
//
// What the design does about it: each byte crosses device memory once.  A
// block writes one (stream, row) span of 2B ring elements, which the
// ring's last two dims make contiguous; 2,048 x 8 = 16,384 blocks at
// display, so every SM stays full.  Neighbouring threads store neighbouring
// 16-byte words (8 bf16), after a scalar head up to the span's first word
// boundary and before a scalar tail.  An element's source (channel, plane
// row, bin) follows from its place in the span, so a warp's loads walk
// along the plane rows; bin 1 lies off every vector boundary, so the loads
// are scalar `__ldg`s.  kUnroll words a thread have their loads issued
// before any store, to keep enough bytes in flight.  Nothing is transposed
// within a span, so nothing is staged in shared memory.  Measured at the
// display shape by chip_smoke.py phase 30 (H100 80GB HBM3 at 700 W, CUDA
// events, mean of 20): 0.1638 ms into the 2,048-row ring, against the
// 0.1408 ms bound and 0.1593 ms for an ATen cast of the same planes to
// bf16 (the same bytes, with no ring to address).  In one probe of the
// variants, where this form read 0.166 ms, 4-byte pair stores read 0.175
// and the reads as aligned float4s shifted in registers 0.168.
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <cstdint>

#include "spk_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRowsInGrid = 65535;   // k rides on gridDim.y

// The ring's element types: the bits a store writes and the rounding.
struct Bf16 {
  using bits = unsigned short;
  static __device__ __forceinline__ bits round(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};
struct F16 {
  using bits = unsigned short;
  static __device__ __forceinline__ bits round(float x) {
    return __half_as_ushort(__float2half_rn(x));
  }
};
struct F32 {
  using bits = float;
  static __device__ __forceinline__ bits round(float x) { return x; }
};
struct F64 {
  using bits = double;
  static __device__ __forceinline__ bits round(float x) {
    return static_cast<double>(x);
  }
};

// A store of kBytes as one machine word.
template <int kBytes> struct Word;
template <> struct Word<4> { using type = unsigned; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<16> { using type = uint4; };

template <class Ring, int kVec>
union Pack {
  typename Word<kVec * sizeof(typename Ring::bits)>::type word;
  typename Ring::bits v[kVec];
};

template <class Ring, int kVec, int kUnroll>
__global__ void __launch_bounds__(kThreads) ring_write_kernel(
    const float* __restrict__ mag_l, const float* __restrict__ mag_r,
    long long plane_stride, int streams, int bins,
    typename Ring::bits* __restrict__ ring, long long stream_stride,
    long long row_stride, int ring_rows, const int* __restrict__ cursor) {
  using Bits = typename Ring::bits;
  using P = Pack<Ring, kVec>;
  const int s = blockIdx.x;
  const int r = blockIdx.y;
  const unsigned row =
      (static_cast<unsigned>(__ldg(cursor)) + r) % static_cast<unsigned>(ring_rows);
  const long long plane_row = static_cast<long long>(r) * streams + s;
  const float* left = mag_l + plane_row * plane_stride + 1;
  const float* right = mag_r + plane_row * plane_stride + 1;
  Bits* dst = ring + s * stream_stride + row * row_stride;
  const auto source = [&](int e) {
    return __ldg(e < bins ? left + e : right + (e - bins));
  };

  const int span = 2 * bins;
  const int misaligned = static_cast<int>(
      reinterpret_cast<uintptr_t>(dst) % sizeof(P) / sizeof(Bits));
  const int head = min(span, misaligned ? kVec - misaligned : 0);
  const int words = (span - head) / kVec;
  const int tail = head + words * kVec;
  for (int e = threadIdx.x; e < head; e += kThreads) dst[e] = Ring::round(source(e));
  for (int e = tail + threadIdx.x; e < span; e += kThreads) {
    dst[e] = Ring::round(source(e));
  }

  P* body = reinterpret_cast<P*>(dst + head);
  for (int w0 = threadIdx.x; w0 < words; w0 += kThreads * kUnroll) {
    float x[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int w = w0 + u * kThreads;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        x[u][i] = w < words ? source(head + w * kVec + i) : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int w = w0 + u * kThreads;
      if (w < words) {
        P out;
#pragma unroll
        for (int i = 0; i < kVec; ++i) out.v[i] = Ring::round(x[u][i]);
        body[w] = out;
      }
    }
  }
}

// A 16-byte word a store: 8 bf16 or f16, 4 f32, 2 f64 ring elements.
template <class Ring>
int launch(const float* mag_l, const float* mag_r, long long plane_stride,
           int streams, int k, int bins, void* ring, long long stream_stride,
           long long row_stride, int ring_rows, const int* cursor,
           cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(typename Ring::bits);
  const dim3 grid(streams, k);
  ring_write_kernel<Ring, kVec, 4><<<grid, kThreads, 0, stream>>>(
      mag_l, mag_r, plane_stride, streams, bins,
      static_cast<typename Ring::bits*>(ring), stream_stride, row_stride,
      ring_rows, cursor);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mag_l, mag_r: [k*streams, >= bins+1] f32 planes, row r*streams + s at
// r*streams + s times plane_stride floats, bins contiguous; ring:
// [streams, ring_rows, 2, bins] of the element type `dtype` names (0
// bfloat16, 1 float16, 2 float32, 3 float64), its last two dims contiguous,
// streams and rows stream_stride and row_stride elements apart; cursor: one
// int32 on the device, the first ring row written.  Writes rows cursor ..
// cursor+k-1 (mod ring_rows) of every stream.  An unknown dtype, or k past
// the grid's 65,535 rows, is refused with cudaErrorInvalidValue.
SPK_EXPORT int spk_ring_write(const float* mag_l, const float* mag_r,
                              long long plane_stride, int streams, int k,
                              int bins, void* ring, int dtype,
                              long long stream_stride, long long row_stride,
                              int ring_rows, const int* cursor, void* stream) {
  if (k < 1 || k > kMaxRowsInGrid || streams < 1 || bins < 1 || ring_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto tag) {
    return launch<decltype(tag)>(mag_l, mag_r, plane_stride, streams, k, bins,
                                 ring, stream_stride, row_stride, ring_rows,
                                 cursor, s);
  };
  switch (dtype) {
    case 0: return go(Bf16{});
    case 1: return go(F16{});
    case 2: return go(F32{});
    case 3: return go(F64{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
