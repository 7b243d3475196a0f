"""95th percentile over every push of the window of the time from its
hand-over to its completion on the card (host clock and CUDA events)."""

from portbench.harness import tail


def read(rec):
    if rec.latency_of != "push" or not rec.latency_ms.size:
        return None
    return tail(rec.latency_ms)
