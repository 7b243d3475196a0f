"""Device ms per push of the large-N STFT route's last stage and unpack
(csrc/stft_large.cu): a direct N's last radix stage fused into the
stereo unpack or the split-real magnitude, and Bluestein's unpack passes,
read by kernel name from the traced stretch.  Nothing to read where the
stretch ran none of them."""

from portbench.metrics.large_load_ms import kernels_ms

KERNELS = ("large_last_unpack_kernel", "large_unpack_kernel", "large_last_magnitude_kernel",
           "large_magnitude_kernel")


def read(rec):
    return kernels_ms(rec, KERNELS)
