"""Device time of the push and of render_viewport, by kernel, on one card.

    python -m spectrogram_tpu_torch.profile_push [--pushes 50] [--renders 5]

Profiles, each with torch.profiler over a steady window after a warm-up:

  1. the k=8 push at BENCH_CONFIG, 4096 streams, no ring (the JAX bench's
     BENCH_CHUNK_HOPS=8 mode);
  2. the display push (k=8, ring R=2048, 256 streams, palettes
     arange(S) % 19) at BENCH_CONFIG and at DEFAULT_CONFIG;
  3. render_viewport of that display state.

For each it prints the host wall time per call over the window (ended by a
synchronize), the device busy time per call (the sum of its kernels), the
idle share 1 - busy/wall, and the kernels by device time.  It needs a CUDA
card and fails without one, or when the profiler records no device time.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch

from spectrogram_tpu_torch import testing
from spectrogram_tpu_torch.config import BENCH_CONFIG, DEFAULT_CONFIG
from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline


def _short(name: str) -> str:
    """A kernel's name without its return type, namespaces and template
    arguments."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("<")[0].split("(")[0].split("::")[-1][:60]


def profile(label: str, fn, calls: int) -> None:
    """Print wall, busy and idle per call of fn, and its kernels."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    kernels = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total:
            key = _short(ev.key)
            ms, n = kernels.get(key, (0.0, 0))
            kernels[key] = (ms + ev.self_device_time_total / 1e3 / calls, n + ev.count)
    busy = sum(ms for ms, _ in kernels.values())
    if busy <= 0:
        raise SystemExit(f"FAIL: the profiler recorded no device time for {label}")
    print(f"== {label}: wall {wall:.4f} ms/call, device busy {busy:.4f} ms/call, "
          f"idle share {1 - busy / wall:.3f} ({calls} calls)")
    for key, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0]):
        print(f"   {ms:9.4f} ms/call {ms / busy:6.1%}  x{n / calls:g}/call  {key}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pushes", type=int, default=50)
    ap.add_argument("--renders", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: no CUDA card; this script measures the card")
    smi = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
           "--format=csv,noheader"]
    print("card:", subprocess.run(smi, capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda", 0)

    p = SpectrogramPipeline(BENCH_CONFIG, chunk_hops=8, store_ring=False, device=dev)
    state = [p.set_palette(p.init_state(4096), np.arange(4096) % 19)]
    chunk = torch.from_numpy(testing.chirp_tone(4096, p.chunk_size, 48000.0, seed=4)).to(dev)

    def push():
        state[0], _ = p.push(state[0], chunk)

    profile("k=8 push, BENCH_CONFIG, 4096 streams, no ring", push, args.pushes)
    del state, chunk

    for name, cfg in (("BENCH_CONFIG", BENCH_CONFIG), ("DEFAULT_CONFIG", DEFAULT_CONFIG)):
        p = SpectrogramPipeline(cfg, chunk_hops=8, device=dev)
        state = [p.set_palette(p.init_state(256), np.arange(256) % 19)]
        chunk = torch.from_numpy(
            testing.chirp_tone(256, p.chunk_size, cfg.sample_rate, seed=5)).to(dev)
        profile(f"display push, {name}, 256 streams, ring {p.viewport_rows}", push,
                args.pushes)
        profile(f"render_viewport, {name}, 256 streams",
                lambda: p.render_viewport(state[0]), args.renders)
        del state, chunk
    print("card:", subprocess.run(smi, capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
