"""The served path: the port's `DeviceFeeder` fed from pinned host slots,
every tick's rows read back to a host array.

The pool's hops are written into `pool_pushes` page-locked slots of a
`ChunkPool` at set-up and cycled without host copies
(`copy_chunks=False`; the pool holds more than depth + 1 slots, its
contract).  Each tick hands one slot to `DeviceFeeder.push`, which copies
it to the card on a side stream, pushes, and returns a completed older
tick's rows as a host array (readback "full").  A tick's latency runs from
its hand-over to the moment its rows are a host array; the window's rows
are every stream-row of every tick handed over before the deadline, all
in host memory before the window's clock stops.

Traffic keys: depth, pool_pushes, warmup_pushes, held_units, trace_at,
trace_units.
"""

from __future__ import annotations

import collections
import contextlib
import time

import numpy as np
import torch

from portbench.trace import HOST_LABEL, events, profiler, reduce, warm_profiler


def setup(run) -> None:
    from spectrogram_tpu_torch.io.feeder import ChunkPool, DeviceFeeder

    tr = run.cell.traffic
    planar = run.wire["layout"] == "planar"
    run.feeder = DeviceFeeder(run.pipe, run.state, depth=int(tr["depth"]), planar=planar,
                              readback="full", copy_chunks=False)
    src = run.pool_prog
    run.slots = ChunkPool(src.shape[0], tuple(src.shape[1:]),
                          dtype=torch.empty(0, dtype=src.dtype).numpy().dtype,
                          pin_memory=run.on_card)
    for j in range(src.shape[0]):
        run.slots.next()[...] = src[j].cpu().numpy()
    run.warm = int(tr["warmup_pushes"])
    for _ in range(run.warm):
        run.feeder.push(run.slots.next())
    run.feeder.flush()
    if run.on_card:
        torch.cuda.synchronize()
        run.build.library().reset_launches()


def window(run, seconds: float, trace: bool) -> None:
    tr = run.cell.traffic
    feeder, slots = run.feeder, run.slots
    u = run.warm
    if trace:
        def once():
            nonlocal u
            feeder.push(slots.next())
            feeder.flush()
            u += 1
        warm_profiler(run, once)
    inflight = collections.deque()
    hand, arrive = {}, {}
    prof, first_traced, stretch = None, None, None
    t0 = time.perf_counter()
    run.t_first = t0
    deadline = t0 + seconds
    trace_from = t0 + seconds * float(tr["trace_at"])
    n = 0
    while True:
        now = time.perf_counter()
        if now >= deadline:
            break
        if trace and prof is None and now >= trace_from:
            prof, first_traced = profiler(run.on_card), n
            run.untraced = (n, now - t0)     # the units and seconds before the stretch
            prof.start()
        tracing = prof is not None and first_traced is not None
        with torch.profiler.record_function(HOST_LABEL) if tracing else contextlib.nullcontext():
            hand[u] = time.perf_counter()
            inflight.append(u)
            rows = feeder.push(slots.next())
            t = time.perf_counter()
        if rows is not None:
            v = inflight.popleft()
            arrive[v] = t
            run.hold(v, rows)
        u += 1
        n += 1
        if tracing and n - first_traced == int(tr["trace_units"]):
            if run.on_card:
                torch.cuda.synchronize()
            prof.stop()
            stretch = (prof, n - first_traced)
            first_traced = None
    for rows in feeder.flush():
        v = inflight.popleft()
        arrive[v] = time.perf_counter()
        run.hold(v, rows, last=not inflight)
    t1 = time.perf_counter()
    run.units = n
    run.next_unit = u
    run.window_s = t1 - t0
    run.missing = len([v for v in hand if v not in arrive])
    run.latency_ms = np.asarray([(arrive[v] - hand[v]) * 1e3 for v in sorted(arrive)])
    run.state = feeder.state
    run.latency_of = "tick"
    if trace:
        if stretch is None:
            raise RuntimeError("the window ended before its traced stretch did: "
                               "lengthen --seconds or shorten trace_units")
        if run.on_card:          # a run on the CPU has no device to read
            run.trace = reduce(events(stretch[0]), stretch[1])


def teardown(run) -> None:
    run.feeder = None
    run.slots = None
    run.pool_prog = None
