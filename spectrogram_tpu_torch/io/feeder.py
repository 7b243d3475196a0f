"""Async device feeder: host ring -> pipelined pushes with bounded depth.

The port's counterpart of `spectrogram_tpu/io/feeder.py`, with the same
surface.  The reference achieves <= 1 display frame of latency by doing
exactly one texture upload + draw per vsync (README.md:10-11;
gpu_spectrogram.rs's tick callback).  On the card the analog is CUDA's
asynchronous queue: a push is enqueued while the previous one still runs,
and the host->device copy of chunk N+1 overlaps the kernels of chunk N
(SURVEY.md §7, "hop-tick dispatch cadence with async dispatch depth 2").

How a host chunk reaches the card: `push` copies it with
`non_blocking=True` on a side copy stream, the compute stream waits on that
copy's event, and the device tensor is marked as used by the compute stream
(`record_stream`) so that the caching allocator does not hand its memory out
again before the push has read it.  The copy overlaps anything only from
pinned memory, which is what `ChunkPool.for_feeder` allocates for a CUDA
pipeline; from pageable memory the driver stages it synchronously.  A chunk
already on the pipeline's device passes straight through.  On a CPU
pipeline the transfer is a host copy (the next carry may be a view of the
chunk), so a pool slot is free again as soon as `push` returns.

`DeviceFeeder` bounds the number of in-flight pushes (depth): unbounded
enqueueing would hide a falling-behind pipeline until the card's memory runs
out; depth 1 serializes and wastes the transfer/compute overlap.  Depth 2 is
the reference-equivalent setting.  Results are yielded in order once
forced.
"""

from __future__ import annotations

import collections
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline, StreamState
from spectrogram_tpu_torch.utils.probe import ThroughputProbe
from spectrogram_tpu_torch.utils.profiling import LatencyTracker


def _host_copy(rows: torch.Tensor) -> np.ndarray:
    """A C-contiguous host copy of `rows` as numpy, which the caller owns.
    From a card it goes through page-locked memory from PyTorch's caching
    host allocator (reused once the array is dropped): a copy into fresh
    pageable memory faults in every page and runs many times slower for the
    42 MB of a 10,240-stream tick (PERF.md section 6, PR 15)."""
    if not rows.is_cuda:
        return rows.contiguous().numpy()
    staged = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
    staged.copy_(rows)
    return staged.numpy()


class ChunkPool:
    """Rotating pool of preallocated host chunk buffers.

    The copy-free drain pattern at scale (a 10,240-stream planar chunk is
    ~65 MB in f32, ~33 MB in int16; a defensive copy per push would burn
    much of the hop budget on the host):

        pool = ChunkPool.for_feeder(feeder, bank.n_streams)
        buf = pool.next()
        bank.pop_matrix_f32_planar(n, out=buf)   # drain INTO the pool slot
        feeder.push(buf)                          # zero further host copies

    With `pin_memory` (what `for_feeder` picks for a CUDA pipeline) the
    buffers are page-locked host tensors and `next` hands out their numpy
    views, so the ring's drain writes straight into memory the card can copy
    from asynchronously.

    Safety contract: with `n_buffers >= depth + 1`, by the time a slot is
    handed out again the push that used it has been drained (the feeder
    drains push i while admitting push i+depth-1), and draining push i waits
    for the end of its host->device copy, whichever stream ran it — so the
    card can no longer be reading the buffer when the bank overwrites it.
    One extra slot beyond the proof's minimum (depth) guards the
    fill-while-enqueued window.
    """

    def __init__(self, n_buffers: int, shape: tuple, dtype=np.float32,
                 pin_memory: bool = False):
        if n_buffers < 2:
            raise ValueError("a rotation pool needs >= 2 buffers")
        dtype = np.dtype(dtype)
        self.pinned = bool(pin_memory)
        if self.pinned:
            tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
            self._tensors = [torch.zeros(shape, dtype=tdtype, pin_memory=True)
                             for _ in range(n_buffers)]
            self._bufs = [t.numpy() for t in self._tensors]
        else:
            self._bufs = [np.zeros(shape, dtype) for _ in range(n_buffers)]
        self._i = 0

    @classmethod
    def for_feeder(
        cls, feeder: "DeviceFeeder", n_streams: int, dtype=np.float32
    ) -> "ChunkPool":
        """Pool sized depth+1 with the feeder's chunk geometry ([S, 2, n]
        planar or [S, n, 2] interleaved), pinned when the feeder's pipeline
        is on a CUDA card.

        dtype=np.int16 is the HALF-BANDWIDTH wire path: drain raw PCM words
        with `RingBank16.pop_matrix_i16_planar(n, out=buf)` and push the
        int16 block as-is — the pipeline scales by 1/32768 on the device,
        bit-identical to the f32 drain's host-side conversion (or keeps the
        words, with `i16_planes`), at half the host->device bytes."""
        n = feeder.pipeline.chunk_size
        shape = (n_streams, 2, n) if feeder.planar else (n_streams, n, 2)
        return cls(feeder.depth + 1, shape, dtype,
                   pin_memory=feeder.pipeline.device.type == "cuda")

    def next(self) -> np.ndarray:
        """Hand out the next buffer in rotation (caller fills then pushes)."""
        buf = self._bufs[self._i]
        self._i = (self._i + 1) % len(self._bufs)
        return buf

    def __len__(self) -> int:
        return len(self._bufs)


class DeviceFeeder:
    """Pipelined push loop over a host chunk source.

    chunk_source: callable returning the next [S, chunk, 2] numpy block (or
    None when exhausted) — e.g. RingBank.pop_matrix bound to the right size.
    on_rows: optional consumer called with each push's RGBA output (host
    numpy, forced — this is the point where latency is paid).

    `h2d` and `device_time` (`LatencyTracker`s, seconds) hold, for each
    drained push on a CUDA pipeline, its host->device copy time and its time
    on the compute stream, both from CUDA events.
    """

    def __init__(
        self,
        pipeline: SpectrogramPipeline,
        state: StreamState,
        depth: int = 2,
        on_rows: Optional[Callable[[np.ndarray], None]] = None,
        planar: bool = False,
        readback: str = "full",
        copy_chunks: bool = True,
    ):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        if readback not in ("full", "probe"):
            raise ValueError(f"readback must be 'full' or 'probe', got {readback!r}")
        self.pipeline = pipeline
        self.state = state
        self.depth = depth
        self.on_rows = on_rows
        # planar=True: chunks arrive [S, 2, n] (RingBank.pop_matrix_planar),
        # skipping the device-side transpose at the ingestion edge.
        self.planar = bool(planar)
        # readback="full" hands back a host numpy copy of the rows;
        # readback="probe" waits for the push's completion event and hands
        # back the DEVICE tensor instead — for consumers that keep rows on
        # the card (renderers, device-side sinks).
        self.readback = readback
        # copy_chunks=False is safe ONLY when the caller rotates >= depth+1
        # host buffers — use ChunkPool.for_feeder (see its safety contract).
        # The default pays one defensive host copy per push, which at 10k
        # streams is ~65 MB/push: production serve loops should rotate.
        self.copy_chunks = bool(copy_chunks)
        self.probe = ThroughputProbe()
        self.h2d = LatencyTracker()
        self.device_time = LatencyTracker()
        self._inflight: collections.deque = collections.deque()
        self._copy_stream: Optional[torch.cuda.Stream] = None

    def _to_device(self, chunk, owned: bool):
        """(chunk on the pipeline's device, (start event, end event, host
        tensor) of its host->device copy or None: the host tensor stays
        referenced until the copy is known to be over).  `owned`: the chunk
        is the feeder's own copy, which nothing else writes."""
        dev = self.pipeline.device
        if isinstance(chunk, torch.Tensor):
            if chunk.device == dev:
                return chunk, None
            host = chunk
        else:
            host = torch.from_numpy(np.asarray(chunk))
        if dev.type != "cuda":
            return (host if owned else host.clone()).to(dev), None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(dev)
        copy = self._copy_stream
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.device(dev), torch.cuda.stream(copy):
            start.record(copy)
            on_card = host.to(dev, non_blocking=True)
            end.record(copy)
        compute = torch.cuda.current_stream(dev)
        compute.wait_event(end)
        on_card.record_stream(compute)
        return on_card, (start, end, host)

    def _drain_one(self):
        rows, copy, start, done = self._inflight.popleft()
        if copy is not None:
            # the ChunkPool contract: this push's host buffer is free again
            copy[1].synchronize()
            self.h2d.record(copy[0].elapsed_time(copy[1]) * 1e-3)
        if self.readback == "probe":
            if done is not None:
                done.synchronize()   # force completion only
            host = rows              # stays on the device
        else:
            host = _host_copy(rows)  # forces completion
        if done is not None:
            self.device_time.record(start.elapsed_time(done) * 1e-3)
        if self.on_rows is not None:
            self.on_rows(host)
        return host

    def push(self, chunk):
        """Enqueue one chunk (numpy or tensor); returns a completed older
        result once the pipeline is primed (None during the first `depth-1`
        pushes)."""
        owned = self.copy_chunks and isinstance(chunk, np.ndarray)
        if owned:
            chunk = chunk.copy()
        x, copy = self._to_device(chunk, owned)
        start = done = None
        if self.pipeline.device.type == "cuda":
            compute = torch.cuda.current_stream(self.pipeline.device)
            start = torch.cuda.Event(enable_timing=True)
            start.record(compute)
        if self.planar:
            self.state, rgba = self.pipeline.push_planar(self.state, x)
            chunk_len = x.shape[2]
        else:
            self.state, rgba = self.pipeline.push(self.state, x)
            chunk_len = x.shape[1]
        if start is not None:
            done = torch.cuda.Event(enable_timing=True)
            done.record(compute)
        self._inflight.append((rgba, copy, start, done))
        self.probe.record_push(x.shape[0], chunk_len, self.pipeline.chunk_hops)
        if len(self._inflight) > self.depth - 1:
            return self._drain_one()
        return None

    def flush(self) -> list:
        """Force all in-flight pushes (end of stream / checkpoint point)."""
        out = []
        while self._inflight:
            out.append(self._drain_one())
        return out

    def run(self, chunk_source: Callable[[], Optional[np.ndarray]]) -> Iterator:
        """Drive until the source is exhausted, yielding completed row
        blocks in order."""
        while True:
            chunk = chunk_source()
            if chunk is None:
                break
            done = self.push(chunk)
            if done is not None:
                yield done
        yield from self.flush()
