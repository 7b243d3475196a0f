"""Closed loop on the card: `SpectrogramPipeline.push` (or `push_planar`)
fed from a pool of chunks already on the device, `depth` pushes in flight.

Push i is handed over once push i - depth has completed on the card.  Its
latency runs from the host clock just before `push` to its completion on
the card, read from a CUDA event recorded after it and placed on the
host's timeline through two reference events recorded at synchronised
instants, one before the window and one after it, so that the card's
clock is scaled to the host's over the window (the two drift apart by a
few parts per million: hundreds of microseconds over a 51 s window): no
push waits for its own completion.  The window's rows are
every stream-row of every push handed over before the deadline, all
completed before the window's clock stops.

Traffic keys: depth, pool_pushes, warmup_pushes, held_units, ring_streams,
trace_at (the share of the window before the traced stretch), trace_units.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from portbench.trace import HOST_LABEL, events, profiler, reduce, warm_profiler


def setup(run) -> None:
    """Warm up every shape of the cell's pushes (the library is built and
    loaded by the first), then zero the launch counts."""
    tr = run.cell.traffic
    run.warm = int(tr["warmup_pushes"])
    pool = run.pool_prog
    for u in range(run.warm):
        run.state, _ = run.push(pool[u % pool.shape[0]])
    if run.on_card:
        torch.cuda.synchronize()
        run.build.library().reset_launches()


def window(run, seconds: float, trace: bool) -> None:
    tr = run.cell.traffic
    depth, pool = int(tr["depth"]), run.pool_prog
    p = pool.shape[0]
    u = run.warm
    if trace:
        def once():
            nonlocal u
            run.state, _ = run.push(pool[u % p])
            u += 1
        warm_profiler(run, once)
    card = run.on_card
    if card:
        torch.cuda.synchronize()
        ref = torch.cuda.Event(enable_timing=True)
        t_ref = time.perf_counter()
        ref.record()
        torch.cuda.synchronize()
    hand, done, enq, traced = [], [], [], []
    prof, first_traced, stretch = None, None, None
    t0 = time.perf_counter()
    run.t_first = t0
    deadline = t0 + seconds
    trace_from = t0 + seconds * float(tr["trace_at"])
    n = 0
    rows = None
    while True:
        if n >= depth and card:
            done[n - depth].synchronize()
        now = time.perf_counter()
        if now >= deadline:
            break
        if trace and prof is None and now >= trace_from:
            prof, first_traced = profiler(card), n
            run.untraced = (n, now - t0)     # the units and seconds before the stretch
            prof.start()
        tracing = prof is not None and first_traced is not None
        with torch.profiler.record_function(HOST_LABEL) if tracing else contextlib.nullcontext():
            h = time.perf_counter()
            run.state, rows = run.push(pool[u % p])
            if card:
                e = torch.cuda.Event(enable_timing=True)
                e.record()
            t = time.perf_counter()
        hand.append(h)
        done.append(e if card else t)
        enq.append(t - h)
        traced.append(tracing)
        run.hold(u, rows)
        u += 1
        n += 1
        if tracing and n - first_traced == int(tr["trace_units"]):
            if card:
                e.synchronize()
            prof.stop()
            stretch = (prof, n - first_traced)
            first_traced = None
    if card:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    if n and (u - 1) not in run.held:
        run.hold(u - 1, rows, last=True)
    run.units = n
    run.next_unit = u
    run.window_s = t1 - t0
    hand = np.asarray(hand)
    if card:
        end = torch.cuda.Event(enable_timing=True)
        t_end = time.perf_counter()
        end.record()
        torch.cuda.synchronize()
        scale = (t_end - t_ref) / (ref.elapsed_time(end) * 1e-3)
        run.clock_ppm = (scale - 1.0) * 1e6
        finish = t_ref + np.asarray([ref.elapsed_time(e) for e in done]) * 1e-3 * scale
    else:
        finish = np.asarray(done)
    run.latency_ms = (finish - hand) * 1e3
    run.latency_of = "push"
    keep = ~np.asarray(traced, bool)
    run.enqueue_ms = np.asarray(enq)[keep] * 1e3
    if trace:
        if stretch is None:
            raise RuntimeError("the window ended before its traced stretch did: "
                               "lengthen --seconds or shorten trace_units")
        if run.on_card:          # a run on the CPU has no device to read
            run.trace = reduce(events(stretch[0]), stretch[1])


def teardown(run) -> None:
    run.pool_prog = None
