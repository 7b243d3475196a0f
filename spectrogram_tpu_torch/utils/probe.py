"""Throughput probe: counters for the ingest -> device -> output path.

The analog of the reference's PlaceholderVisualizer (src/widgets/
placeholder.rs:21-25), which displayed samples-per-frame as a debug widget —
generalized into real counters: samples in, rows out, drops, wall time, and
derived rates.  Used by bench/demos and exposed for services.

A copy of `spectrogram_tpu/utils/probe.py` (standard library only; the
JAX package's module cannot be imported without JAX).
`tests/test_torch_io.py` pins it against the original.
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class ThroughputProbe:
    samples_in: int = 0
    rows_out: int = 0
    pushes: int = 0
    dropped: int = 0
    started_at: float = dataclasses.field(default_factory=time.perf_counter)

    def record_push(self, n_streams: int, chunk_samples: int, rows: int) -> None:
        self.samples_in += n_streams * chunk_samples
        self.rows_out += n_streams * rows
        self.pushes += 1

    def record_drops(self, dropped_total: int) -> None:
        self.dropped = dropped_total

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.started_at

    def summary(self) -> dict:
        dt = max(self.elapsed, 1e-9)
        return {
            "elapsed_s": round(dt, 3),
            "pushes": self.pushes,
            "samples_in": self.samples_in,
            "rows_out": self.rows_out,
            "rows_per_sec": round(self.rows_out / dt, 1),
            "samples_per_sec": round(self.samples_in / dt, 1),
            "dropped_frames": self.dropped,
        }
