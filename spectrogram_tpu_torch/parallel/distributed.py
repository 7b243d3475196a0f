"""Multi-process serving: a process group over ranks + rank-local ingest.

The port of `spectrogram_tpu/parallel/distributed.py`.  The reference is a
single-process desktop app; its one cross-thread boundary is the SPSC ring
from the audio callback to the UI thread (reference
src/devices/audio_input_list_model.rs:30).  At serving scale that boundary
crosses processes: every rank receives the PCM of ITS OWN stream slice,
drains it from a rank-local `RingBank16` and pushes its slice of the state;
samples never cross processes, only the row-count reduction does.

One process is one rank on one device (the torch idiom, in place of the JAX
package's one controller over every device): `initialize` brings up the
process group, `global_mesh` spans it, and rank r owns the contiguous
streams `local_stream_range` gives it.  A multi-card host runs it under
`torchrun --nproc-per-node=<cards>` (each rank on cuda:LOCAL_RANK); two
ranks may share one card when `device=` says so, over gloo (NCCL refuses
two ranks on one card).
"""

from __future__ import annotations

import datetime
import os
import pathlib
import subprocess
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from spectrogram_tpu_torch.parallel.mesh import (
    STREAM_AXIS,
    local_stream_range,
    make_mesh,
    mesh_rank,
    rank_device,
    resolve_device,
    set_rank_device,
)

__all__ = [
    "STREAM_AXIS", "initialize", "global_mesh", "local_stream_range",
    "make_global_chunk", "HostShardIngest", "run_ranks",
]

DEFAULT_TIMEOUT = datetime.timedelta(seconds=60)


def initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
    device=None,
) -> None:
    """Bring up the default process group (idempotent: a second call is a
    no-op).

    `init_method` is torch's: "env://" (what torchrun sets up; the default
    where world_size is not 1), "tcp://host:port" or "file:///path".  At
    world size 1 without one, the store lives in this process.  `device`
    fixes this rank's device (default cuda:LOCAL_RANK; see
    `mesh.resolve_device`).  `backend` defaults to "nccl" for a card and
    "gloo" for the CPU; a backend given is taken as given, and one that
    cannot serve the device raises (NCCL on the CPU) — it never quietly
    changes.  The arguments are checked before the no-op return."""
    dev = (resolve_device(device) if device is not None or not dist.is_initialized()
           else rank_device())
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"backend 'nccl' cannot serve device {dev}; use 'gloo'")
    if dist.is_initialized():
        return
    set_rank_device(dev)
    kw = dict(backend=backend, timeout=timeout)
    if init_method is None and world_size == 1:
        kw.update(store=dist.HashStore(), world_size=1, rank=0)
    else:
        kw.update(init_method=init_method)
        if world_size is not None:
            kw.update(world_size=world_size)
        if rank is not None:
            kw.update(rank=rank)
    dist.init_process_group(**kw)


def global_mesh(device=None):
    """1-D `streams` mesh over every rank of the process group."""
    return make_mesh(device=device)


def make_global_chunk(mesh, local_chunk, n_streams: int, global_view: bool = False):
    """This rank's [S/W, ...] chunk on its device, as the rank's push takes
    it; with `global_view`, wrapped as the `Shard(0)` DTensor of the
    [n_streams, ...] batch.  Pure rank-local data movement: no PCM crosses
    processes."""
    lo, hi = local_stream_range(mesh, n_streams)
    if local_chunk.shape[0] != hi - lo:
        raise ValueError(
            f"rank {mesh_rank(mesh)} owns {hi - lo} of {n_streams} streams; its "
            f"chunk holds {local_chunk.shape[0]}"
        )
    if not isinstance(local_chunk, torch.Tensor):
        local_chunk = torch.from_numpy(np.ascontiguousarray(local_chunk))
    local = local_chunk.to(rank_device())
    if not global_view:
        return local
    return DTensor.from_local(local, mesh, [Shard(0)], run_check=False,
                              shape=torch.Size((n_streams,) + tuple(local.shape[1:])),
                              stride=torch.empty((n_streams,) + tuple(local.shape[1:]),
                                                 device="meta").stride())


class HostShardIngest:
    """Rank-local ingest: a `RingBank16` over this rank's streams only,
    drained into its chunk on its device.

    Producers push by LOCAL index (0 .. local_streams).  `drain` pops one
    hop per stream (zero-filled on underrun) into pinned memory on a card
    and copies it to the rank's device: f32 [S/W, chunk, 2] as the JAX
    class drains, or with `wire_int16` the raw int16 [S/W, 2, chunk] words
    an `i16_planes` pipeline pushes (`push_planar`).  `dest` (the
    pipeline's `input_dest` of the rank's state) lands each stream in its
    presorted row."""

    def __init__(self, mesh, n_streams: int, chunk_size: int, capacity: int = 16384,
                 wire_int16: bool = False):
        from spectrogram_tpu_torch.io.ring import RingBank16

        self.mesh = mesh
        self.n_streams = int(n_streams)
        self.chunk_size = int(chunk_size)
        self.wire_int16 = bool(wire_int16)
        self.lo, self.hi = local_stream_range(mesh, n_streams)
        self.local_streams = self.hi - self.lo
        self.device = rank_device()
        self.bank = RingBank16(self.local_streams, capacity)
        shape, dtype = (((self.local_streams, 2, self.chunk_size), torch.int16)
                        if self.wire_int16
                        else ((self.local_streams, self.chunk_size, 2), torch.float32))
        self._buf = torch.zeros(shape, dtype=dtype, pin_memory=self.device.type == "cuda")

    def drain(self, dest: Optional[np.ndarray] = None) -> torch.Tensor:
        """One hop tick: pop every local ring into the rank's chunk on its
        device (a blocking copy, so the buffer is free again on return)."""
        buf = self._buf.numpy()
        if self.wire_int16:
            self.bank.pop_matrix_i16_planar(self.chunk_size, buf, dest=dest)
        else:
            self.bank.pop_matrix_f32(self.chunk_size, buf, dest=dest)
        return self._buf.to(self.device, copy=True)

    def metrics(self) -> dict:
        return {
            "process": dist.get_rank(),
            "streams": (self.lo, self.hi),
            "dropped": self.bank.dropped_total,
            "min_buffered": self.bank.min_size(),
        }


def run_ranks(argv: Callable[[int], Sequence[str]], world: int, timeout: float, log_dir,
              env: Optional[dict] = None, cwd=None) -> list[tuple[int, str]]:
    """Start one process per rank (`argv(rank)`, with RANK, LOCAL_RANK and
    WORLD_SIZE set in its environment as torchrun sets them), wait for all
    of them at most `timeout` seconds, and kill what is left: at the time
    limit, or as soon as one rank has failed (its peers would only wait on
    it).  Returns (exit code, output) per rank; a killed rank's code is
    negative.  Each rank's output goes to `log_dir/rank<r>.log`."""
    log_dir = pathlib.Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    logs = [log_dir / f"rank{r}.log" for r in range(world)]
    procs = []
    try:
        for r, log in enumerate(logs):
            rank_env = dict(os.environ if env is None else env,
                            RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world))
            with open(log, "w") as f:
                procs.append(subprocess.Popen(list(argv(r)), stdout=f, stderr=subprocess.STDOUT,
                                              env=rank_env, cwd=cwd))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.returncode for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return [(p.returncode, log.read_text()) for p, log in zip(procs, logs)]
