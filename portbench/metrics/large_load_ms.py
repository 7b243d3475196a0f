"""Device ms per push of the large-N STFT route's passes before its last
stage (csrc/stft_large.cu): the fused load and shared-memory stages of a
direct N (`large_load_local_kernel`), and Bluestein's load, local and
global passes, read by kernel name from the traced stretch.  Nothing to
read where the stretch ran none of them."""

KERNELS = ("large_load_local_kernel", "large_local_kernel", "large_load_packed_kernel",
           "large_load_real_kernel", "large_pass_kernel")


def kernels_ms(rec, kernels) -> float | None:
    """Device ms per unit of the named kernels in the traced stretch, None
    where it ran none of them."""
    if rec.trace is None or not rec.trace.units:
        return None
    seconds = [rec.trace.op_s[k] for k in kernels if k in rec.trace.op_s]
    return sum(seconds) * 1e3 / rec.trace.units if seconds else None


def read(rec):
    return kernels_ms(rec, KERNELS)
