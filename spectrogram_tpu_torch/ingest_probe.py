"""The serving loop's host half on a schedule: how late the producers land
each hop in a `RingBank16`, with its rings made resident at construction and
as malloc left them.

    python -m spectrogram_tpu_torch.ingest_probe [--streams 10240]
        [--capacity 8192] [--hops 24] [--reps 2] [--fragment-gb 20]
        [--device cuda]

`chip_smoke.py` phase 26's paced loop without the pipeline: producer threads
push 256-stream blocks of seeded int16 PCM into the bank at the hop rate of
BENCH_CONFIG (800 frames at 48 kHz); the consumer drains each hop with
`pop_matrix_i16_planar(dest=...)` into pinned buffers and copies it to the
device. Each round is run with the bank as the constructor leaves it
("resident") and with `_make_resident` skipped ("as malloc left them"), in
turns, first in a fresh process and then after `--fragment-gb` of host
arrays were made and half of them freed, as a long run's earlier phases
leave the heap. One JSON line a round: the producers' worst lateness per hop
(ms after its schedule that the last of them had the hop in the bank), when
the first hop was drained, the slowest first push, drops, drain ms p50 and
the bank's construction ms. `--device cpu` skips the copy.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from unittest import mock

import numpy as np
import torch

from spectrogram_tpu_torch.io import ring

HOP_FRAMES, RATE, BLOCK = 800, 48000.0, 256


def paced_round(hops: np.ndarray, dest: np.ndarray, pool: list, capacity: int,
                resident: bool, dev: torch.device) -> dict:
    """One paced loop over `hops` ([T, S, n, 2] int16) into a new bank."""
    t_hops, s = hops.shape[0], hops.shape[1]
    hop_s = HOP_FRAMES / RATE
    t0 = time.perf_counter()
    if resident:
        bank = ring.RingBank16(s, capacity=capacity)
    else:
        with mock.patch.object(ring, "_make_resident", lambda *a: None):
            bank = ring.RingBank16(s, capacity=capacity)
    create_ms = (time.perf_counter() - t0) * 1e3
    blocks = range(0, s, BLOCK)
    late = np.full((len(blocks), t_hops), np.nan)
    push_ms = np.full((len(blocks), t_hops), np.nan)
    go, start, errors = threading.Event(), 0.0, []

    def producer(i: int, lo: int) -> None:
        go.wait()
        try:
            for t in range(t_hops):
                wait = start + t * hop_s - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                a = time.perf_counter()
                bank.push_matrix_range(lo, hops[t, lo:lo + BLOCK])
                b = time.perf_counter()
                push_ms[i, t] = (b - a) * 1e3
                late[i, t] = (b - start - t * hop_s) * 1e3
        except Exception as exc:                     # reported below
            errors.append(exc)

    threads = [threading.Thread(target=producer, args=(i, lo), daemon=True)
               for i, lo in enumerate(blocks)]
    for th in threads:
        th.start()
    start = time.perf_counter() + 0.01
    go.set()
    drains, first_pop, stalled = [], None, None
    for t in range(t_hops):
        give_up = time.perf_counter() + 3.0
        while bank.min_size() < HOP_FRAMES and stalled is None:
            if errors or time.perf_counter() > give_up:
                stalled = t + 1
            time.sleep(0.0002)
        if stalled is not None:
            break
        a = time.perf_counter()
        if first_pop is None:
            first_pop = (a - start) * 1e3
        buf = pool[t % len(pool)]
        bank.pop_matrix_i16_planar(HOP_FRAMES, buf, dest=dest)
        drains.append((time.perf_counter() - a) * 1e3)
        if dev.type == "cuda":
            torch.from_numpy(buf).to(dev, non_blocking=True)
            torch.cuda.synchronize()
    for th in threads:
        th.join(timeout=10)
    worst = np.nanmax(np.where(np.isnan(late), -np.inf, late), axis=0)
    return {
        "rings": "resident" if resident else "as malloc left them",
        "create_ms": round(create_ms, 2),
        "first_drain_ms": None if first_pop is None else round(first_pop, 1),
        "worst_lateness_per_hop_ms": [round(float(v), 1) for v in worst],
        "slowest_first_push_ms": round(float(np.nanmax(push_ms[:, 0])), 1),
        "drain_p50_ms": round(float(np.median(drains)), 2) if drains else None,
        "dropped": bank.dropped_total, "stalled_at_tick": stalled,
        "errors": [repr(e) for e in errors],
    }


def fragment(gb: float, seed: int) -> list:
    """Host arrays of 1-600 MB, written, half of them freed: the kept half."""
    rng = np.random.default_rng(seed)
    keep, total, i = [], 0, 0
    while total < gb * 1e9:
        a = np.ones(int(rng.integers(1 << 20, 600 << 20)) // 4, np.float32)
        total += a.nbytes
        if i % 2:
            keep.append(a)
        i += 1
    return keep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=10240)
    ap.add_argument("--capacity", type=int, default=8192)
    ap.add_argument("--hops", type=int, default=24)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--fragment-gb", type=float, default=20.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.ones(1, device=dev)
    rng = np.random.default_rng(args.seed)
    s = args.streams
    hops = rng.integers(-20000, 20000, (args.hops, s, HOP_FRAMES, 2), dtype=np.int16)
    dest = rng.permutation(s).astype(np.uint64)
    pin = dev.type == "cuda"
    pool = [(torch.empty((s, 2, HOP_FRAMES), dtype=torch.int16).pin_memory() if pin
             else torch.empty((s, 2, HOP_FRAMES), dtype=torch.int16)).numpy()
            for _ in range(3)]
    heap, kept = "fresh process", []
    for stage in range(2):
        for _ in range(args.reps):
            for resident in (False, True):
                row = paced_round(hops, dest, pool, args.capacity, resident, dev)
                print(json.dumps({"heap": heap, "streams": s, **row}), flush=True)
        if stage == 0 and args.fragment_gb > 0:
            t0 = time.perf_counter()
            kept = fragment(args.fragment_gb, args.seed)
            heap = (f"after {args.fragment_gb:g} GB made and half freed "
                    f"({time.perf_counter() - t0:.1f} s)")
        else:
            break
    del kept
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
