"""Run one cell of the benchmark once and print its result:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `spectrogram_tpu_torch`.  With
`--trace 0` the result carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, from a profiled stretch of the window.
Lines before the last say what makes the numbers readable (the card, its
power limit, the launches of each kernel and FFT body in the window, the
samples behind each tail, the peak memory, what each layer took, by
kernel and launching op, and the kernels no layer claims); the
last lines on standard error give each number the check compares beside
its limit.  Without a CUDA card, or with fewer cards than the cell asks
for, it exits with code 3 and prints no result; if JAX or the JAX package
is loaded once the window has closed, with code 4.
"""

from __future__ import annotations

import os
import time

_T_START = time.perf_counter()


def _process_age() -> float:
    """Seconds since this process started (Linux), 0.0 where unknown."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


T_PROCESS = _T_START - _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

_ROOT = pathlib.Path(__file__).resolve().parents[1]
# every kernel cache of the run inside the checkout, at fixed paths
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = str(_ROOT / "build" / "portbench-cache" / _sub)
os.environ["USE_FLAX"] = "0"

import torch  # noqa: E402

_T_TORCH = time.perf_counter()

from portbench import harness  # noqa: E402


_PLURAL = {"push": "pushes", "tick": "ticks"}


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = "nvidia-smi unavailable"
    return out.splitlines()[0] if out else "nvidia-smi gave nothing"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.cell(args.workload)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA card: this benchmark measures the card", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"FAIL: the cell asks for {cell.chips} cards, {torch.cuda.device_count()} "
              "are visible", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.set_num_threads(2)
    run = harness.Run(cell, args.seed, device, t_process=T_PROCESS)
    run.marks.append(("interpreter and torch import", _T_TORCH))
    run.setup()
    run.loop.window(run, args.seconds, bool(args.trace))
    info = run.close()
    checks = run.judge()
    line = harness.result(run, bool(args.trace), info, checks)
    barred = harness.barred_modules()
    if barred:
        print(f"FAIL: the process loaded {', '.join(barred)}", file=sys.stderr)
        return 4
    print(f"card: {_card_line()}; cards used 1 of {torch.cuda.device_count()}")
    print(f"launches in the window: {json.dumps(info.get('launches', {}))}")
    print(f"FFT bodies in the window: {json.dumps(info.get('body_launches', {}))}")
    lat = run.latency_ms
    if lat.size:
        print(f"{run.latency_of} latency: {lat.size} samples, p50 {harness.tail(lat, 50)} ms, "
              f"p95 {harness.tail(lat, 95)} ms, {int((lat > harness.tail(lat, 95)).sum())} "
              "beyond p95")
    if hasattr(run, "clock_ppm"):
        print(f"card clock against the host's over the window: {run.clock_ppm} ppm")
    print(f"window: {run.units} {_PLURAL[run.latency_of]} of {run.streams * run.k} stream-rows "
          f"in {run.window_s} s; setup {harness.setup_seconds(run)} s")
    print("set-up stages (s): " + json.dumps(harness.setup_stages(run)))
    print(f"peak device memory: {info.get('memory_peak_bytes', 0)} bytes; check: "
          f"{len(run.held)} held {_PLURAL[run.latency_of]}, {run.pixels_checked} pixels")
    if run.trace is not None:
        print(f"traced stretch: {run.trace.units} units, window {run.trace.window_s} s, "
              f"busy {run.trace.busy_s} s, profiler stalls left out "
              f"{run.trace.profiler_stall_s} s; device ms per unit by layer: "
              + json.dumps({b: s * 1e3 / run.trace.units
                            for b, s in sorted(run.trace.bucket_s.items())}))
        for bucket, ops in sorted(run.trace.bucket_ops.items()):
            print(f"layer {bucket}, device ms per unit by kernel @ launching op: "
                  + json.dumps({k: s * 1e3 / run.trace.units
                                for k, s in sorted(ops.items(), key=lambda kv: -kv[1])}))
        for key, (n, s) in sorted(run.trace.unattributed.items(), key=lambda kv: -kv[1][1]):
            print(f"unattributed device operation: {key}: {n} ops, {s} s")
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
