"""Profiling and latency instrumentation.

The port's counterpart of `spectrogram_tpu/utils/profiling.py`: wall timers
that force completion, latency percentile trackers for the push loop
(`LatencyTracker`, a copy of the JAX package's), and a `torch.profiler`
trace context for kernel-level inspection.

`force_completion` synchronizes every CUDA card that holds a tensor of the
tree (a push's outputs, a state); CPU tensors are complete when returned.
"""

from __future__ import annotations

import contextlib
import pathlib
import statistics
import time
from typing import Optional

import numpy as np
import torch

# Chrome traces of `device_trace` go here unless the caller names a
# directory: beside the package, in a directory git ignores.
DEFAULT_TRACE_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "trace"


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):     # NamedTuple states included
        for v in tree:
            yield from _tensors(v)


def force_completion(tree) -> None:
    """Wait for every CUDA card that holds a tensor of `tree` (tensors,
    nested in tuples, lists, dicts or NamedTuples) to finish its queued
    work.  A no-op for CPU tensors."""
    cards = {t.device for t in _tensors(tree) if t.is_cuda}
    for dev in cards:
        torch.cuda.synchronize(dev)


class LatencyTracker:
    """Rolling latency stats for the push loop (p50 target < 16 ms)."""

    def __init__(self, window: int = 512):
        self.window = window
        self.samples: list[float] = []

    @contextlib.contextmanager
    def measure(self, result_tree=None):
        t0 = time.perf_counter()
        yield
        if result_tree is not None:
            force_completion(result_tree)
        self.samples.append(time.perf_counter() - t0)
        if len(self.samples) > self.window:
            del self.samples[: -self.window]

    def record(self, seconds: float) -> None:
        self.samples.append(seconds)
        if len(self.samples) > self.window:
            del self.samples[: -self.window]

    def percentile(self, q: float) -> Optional[float]:
        if not self.samples:
            return None
        return float(np.percentile(self.samples, q))

    @property
    def p50_ms(self) -> Optional[float]:
        p = self.percentile(50)
        return None if p is None else p * 1e3

    @property
    def p99_ms(self) -> Optional[float]:
        p = self.percentile(99)
        return None if p is None else p * 1e3

    def summary(self) -> dict:
        if not self.samples:
            return {"count": 0}
        return {
            "count": len(self.samples),
            "p50_ms": round(self.p50_ms, 3),
            "p99_ms": round(self.p99_ms, 3),
            "mean_ms": round(statistics.mean(self.samples) * 1e3, 3),
        }


@contextlib.contextmanager
def device_trace(log_dir=None):
    """`torch.profiler` over the block, CPU and (where a card is present)
    CUDA activities; on exit the Chrome trace is written to
    `log_dir/trace.json` (default `DEFAULT_TRACE_DIR`; open it in Perfetto
    or chrome://tracing).  Yields the profiler, whose `key_averages()` is
    readable after the block."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = pathlib.Path(log_dir or DEFAULT_TRACE_DIR)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()      # the block's device work, traced whole
    prof.export_chrome_trace(str(log_dir / "trace.json"))
