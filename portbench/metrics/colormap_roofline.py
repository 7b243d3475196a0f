"""The colormap layer's share of its roofline: the least time its work could
take on the card (work/colormap.py: bytes over the peak bandwidth or f32
operations over the peak rate, whichever is longer) over its device time
per unit in the traced stretch, in %."""

from portbench.harness import least_seconds


def read(rec):
    if rec.trace is None:
        return None
    ms = rec.trace.per_unit_ms("colormap")
    if not ms:
        return None
    least, _ = least_seconds(*rec.work("colormap"))
    return 100.0 * least / (ms * 1e-3)
