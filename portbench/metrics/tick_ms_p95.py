"""95th percentile over every tick of the window of the time from its
hand-over to the feeder to the moment its rows are a host array."""

from portbench.harness import tail


def read(rec):
    if rec.latency_of != "tick" or not rec.latency_ms.size:
        return None
    return tail(rec.latency_ms)
