// The STFT kernels' row code (stft_fft.cuh) as a host library: one call
// runs `rows` window rows through the Radix2 (mixed = 0) or MixedRadix
// (mixed = 1) body, as one thread block per row would.
#include <vector>

#include "stft_fft.cuh"

extern "C" int stft_host_rows(int mixed, int n, int rows, int w,
                              const float* l, const float* r,
                              const float* hann, const float* twiddles,
                              float* out_l, float* out_r) {
  std::vector<float2> buf(n);
  const auto* tw = reinterpret_cast<const float2*>(twiddles);
  spk::MixedRadix plan;
  spk::Radix2 pow2{0};
  if (mixed) {
    if (!spk::make_mixed_radix(n, &plan)) return 1;
  } else {
    while ((1 << pow2.log2n) < n) ++pow2.log2n;
    if ((1 << pow2.log2n) != n) return 1;
  }
  for (int row = 0; row < rows; ++row) {
    const size_t in = static_cast<size_t>(row) * w;
    const size_t out = static_cast<size_t>(row) * (n / 2);
    if (mixed) {
      spk::stft_packed_row(plan, l + in, r + in, hann, tw, w, out_l + out,
                           out_r + out, buf.data());
    } else {
      spk::stft_packed_row(pow2, l + in, r + in, hann, tw, w, out_l + out,
                           out_r + out, buf.data());
    }
  }
  return 0;
}

// The radices of n's mixed-radix plan into `radix`; their count, or -1.
extern "C" int stft_host_plan(int n, int* radix) {
  spk::MixedRadix plan;
  if (!spk::make_mixed_radix(n, &plan)) return -1;
  for (int s = 0; s < plan.stages; ++s) radix[s] = plan.radix[s];
  return plan.stages;
}
