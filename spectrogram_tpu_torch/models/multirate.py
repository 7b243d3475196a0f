"""Multi-rate stream management: ragged stream populations.

The port of `spectrogram_tpu/models/multirate.py`.  Per-stream sample rates
and hops make row production rates differ across a batch (SURVEY.md §7
"Hard parts / Ragged time"), but a push wants one shape and a lockstep
batch.  The resolution is the standard serving pattern: **group streams by
geometry** — every stream with the same (sample_rate, window, hop, height)
config shares one `SpectrogramPipeline` and one lockstep state batch; groups
advance independently, each at its own hop cadence.

`StreamGroupManager` owns the groups: adding a stream with a new config spins
up a pipeline for that geometry (the FFTW-plan-cache analog); pushes are
per-group; global metrics aggregate across groups.  With `ingest=True` each
group drains its own `RingBank16` through a `DeviceFeeder` (io/ring.py,
io/feeder.py).  Every group runs on the manager's device: the card unless
the caller passes `device="cpu"`.

With `mesh=` (a `parallel.mesh` DeviceMesh) every geometry group's state is
sharded over the ranks: each rank runs the same manager (the same
`add_stream` calls give the same slots) and holds its slice of every group.
Palette edits take the whole batch's layout on every rank
(`parallel.mesh.sharded_set_palette`: the per-shard sort where the JAX
package takes it), and `push_group` runs `parallel.mesh.shard_map_step`.
Unlike the JAX manager, whose push takes the whole batch as one global
array, `push_group` takes the rank's own [capacity / W, chunk, 2] chunk and
returns the rank's rows: PCM never crosses processes.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from spectrogram_tpu_torch.config import SpectrogramConfig
from spectrogram_tpu_torch.models.spectrogram import (
    SpectrogramPipeline,
    StreamState,
    default_device,
)


@dataclasses.dataclass
class StreamGroup:
    """One geometry bucket: a pipeline + its lockstep state + the global ids
    of its member streams.  With ingest attached (bank, feeder, pinned
    non-None) the live state is owned by the feeder; `state` stays a synced
    snapshot."""

    cfg: SpectrogramConfig
    pipeline: SpectrogramPipeline
    state: StreamState
    stream_ids: list[int]
    bank: object = None          # io.ring.RingBank16 (ingest mode)
    feeder: object = None        # io.feeder.DeviceFeeder (ingest mode)
    pinned: object = None        # io.feeder.ChunkPool (rotating drain buffers)
    next_due: float = 0.0        # next hop-tick deadline (group clock)
    layout: object = None        # mesh mode: the whole batch's [capacity] palette ids
    steps: dict = dataclasses.field(default_factory=dict)  # mesh mode:
    # shard_map_step per table class, keyed on the tables' full shapes

    @property
    def n_streams(self) -> int:
        return len(self.stream_ids)

    @property
    def chunk_period(self) -> float:
        """Seconds of audio consumed per push (the group's cadence)."""
        return self.pipeline.chunk_size / self.cfg.sample_rate


class StreamGroupManager:
    """Routes a heterogeneous stream population onto uniform device batches.

    Capacity model: each group is created with a fixed capacity (fixed
    shapes); attach/detach flips slots within it.  Detached slots keep
    running on silence — the cost of a dead slot is one row of background
    color, which beats reshaping every tensor of the group (the reference
    analog: the GTK widget keeps rendering when the input pauses).

    `pipeline_kwargs` reach every group's `SpectrogramPipeline` (e.g.
    `chunk_hops`, `store_ring=False`: a 4,096-stream BENCH_CONFIG group
    with its 2,048-row ring would hold 68.7 GB).
    """

    def __init__(
        self,
        group_capacity: int = 256,
        ingest: bool = False,
        ring_capacity: int = 16384,
        feeder_depth: int = 2,
        wire_int16: bool = False,
        mesh=None,
        device=None,
        **pipeline_kwargs,
    ):
        self.group_capacity = int(group_capacity)
        self.pipeline_kwargs = dict(pipeline_kwargs)
        # mesh (direct mode): every geometry group's lockstep state is
        # sharded over the mesh's ranks.  Ingest ticking stays per process
        # BY DESIGN — PCM never crosses processes (one ingest manager per
        # rank over its own streams, parallel/distributed.py), so
        # mesh + ingest in one manager is a topology error, not a feature.
        if mesh is not None:
            if ingest:
                raise ValueError(
                    "mesh + ingest in one manager is unsupported: host "
                    "ingest shards are per-process (PCM never crosses "
                    "DCN) — run one ingest manager per process, or use "
                    "mesh mode with push_group"
                )
            n_dev = mesh.size()
            if self.group_capacity % n_dev:
                raise ValueError(
                    f"group_capacity {self.group_capacity} must divide "
                    f"evenly over the {n_dev}-device mesh"
                )
        self.mesh = mesh
        self.device = default_device(device)
        # ingest=True wires each geometry group to its own host RingBank16 +
        # DeviceFeeder: producers push int16 PCM by stream id, and `tick`
        # advances every group at ITS OWN hop cadence (the "ragged time"
        # resolution of SURVEY §7; the reference analog is one AudioTransform
        # consuming its ring per stride, audio_transform.rs:34-42).
        self.ingest = bool(ingest)
        self.ring_capacity = int(ring_capacity)
        self.feeder_depth = int(feeder_depth)
        # wire_int16: drain each group's bank as RAW int16 and scale on
        # device (half the host->device bytes per tick; bit-identical —
        # see RingBank16.pop_matrix_i16_planar)
        self.wire_int16 = bool(wire_int16)
        self._groups: dict[SpectrogramConfig, StreamGroup] = {}
        self._locations: dict[int, tuple[SpectrogramConfig, int]] = {}
        self._next_id = 0

    # -- membership -------------------------------------------------------------

    def add_stream(self, cfg: SpectrogramConfig, palette_id: int = 1) -> int:
        """Register a stream; returns its global id.  Creates the geometry
        group on first use."""
        group = self._groups.get(cfg)
        if group is None:
            pipeline = SpectrogramPipeline(cfg, device=self.device, **self.pipeline_kwargs)
            if self.mesh is not None:
                from spectrogram_tpu_torch.parallel import mesh as pmesh

                state = pmesh.sharded_init(pipeline, self.group_capacity, self.mesh,
                                           palette_id=palette_id)
            else:
                state = pipeline.init_state(self.group_capacity, palette_id=palette_id)
            group = StreamGroup(cfg, pipeline, state, [])
            if self.mesh is not None:
                group.layout = np.full(self.group_capacity, state.palette_id[0].item(),
                                       np.int32)
            if self.ingest:
                from spectrogram_tpu_torch.io.feeder import ChunkPool, DeviceFeeder
                from spectrogram_tpu_torch.io.ring import RingBank16

                group.bank = RingBank16(self.group_capacity, self.ring_capacity)
                # copy-free drain: the bank pops into a rotating depth+1
                # buffer pool (pinned on a card), so the feeder never pays
                # the defensive per-push host copy (ChunkPool safety
                # contract: draining push i waits for copy i's end event)
                group.feeder = DeviceFeeder(
                    pipeline, state, depth=self.feeder_depth, planar=True,
                    copy_chunks=False,
                )
                group.pinned = ChunkPool.for_feeder(
                    group.feeder, self.group_capacity,
                    dtype=np.int16 if self.wire_int16 else np.float32,
                )
            self._groups[cfg] = group
        # Reuse a tombstoned slot before growing (long-running services churn
        # streams; leaking slots would exhaust the group at low occupancy).
        if -1 in group.stream_ids:
            slot = group.stream_ids.index(-1)
            self._zero_slot(group, slot)
        elif group.n_streams < self.group_capacity:
            slot = group.n_streams
            group.stream_ids.append(-1)  # placeholder, set below
        else:
            raise RuntimeError(
                f"group for {cfg.sample_rate:.0f} Hz full "
                f"({self.group_capacity} slots); create a second manager shard"
            )
        stream_id = self._next_id
        self._next_id += 1
        group.stream_ids[slot] = stream_id
        self._locations[stream_id] = (cfg, slot)
        self._set_slot_palette(group, slot, palette_id)
        return stream_id

    def _zero_slot(self, group: StreamGroup, slot: int) -> None:
        """Zero a reused slot's device state: the new tenant must not inherit
        the dead stream's carry samples or retained viewport rows
        (cross-stream data leakage in a multi-tenant service).  The slot's
        row is zeroed in external stream order (a carry-sort state keeps its
        carry sorted).  The carry is replaced (a push never writes one in
        place); the ring row is zeroed in place, as a push writes the ring.
        The slot's host backlog is dropped too."""
        if group.bank is not None:
            group.bank.reset(slot)  # drop the dead tenant's backlog too
        st = self._state(group)
        if self.mesh is not None:
            # only the rank that holds the slot has anything to zero
            from spectrogram_tpu_torch.parallel import mesh as pmesh

            lo, hi = pmesh.local_stream_range(self.mesh, self.group_capacity)
            if not lo <= slot < hi:
                return
            slot -= lo
        pl = group.pipeline.palette_layout
        carry = pl.carry_to_external(st.carry, st.tables).index_fill(
            0, torch.tensor([slot], device=st.carry.device), 0)
        carry = pl.carry_from_external(carry, st.tables)
        if st.ring.shape[1]:
            st.ring[slot].zero_()
        self._set_state(group, st._replace(carry=carry))

    def _set_slot_palette(self, group: StreamGroup, slot: int, palette_id: int) -> None:
        # through pipeline.set_palette (not a raw _replace): the state's
        # pre-picked kernel tables must track palette_id
        st = self._state(group)
        if self.mesh is not None:
            # the whole batch's layout decides the tables' class on every
            # rank (the per-shard sort), as shard_state after a JAX edit
            from spectrogram_tpu_torch.parallel import mesh as pmesh

            group.layout[slot] = palette_id
            self._set_state(group, pmesh.sharded_set_palette(
                group.pipeline, st, group.layout, self.mesh))
            return
        ids = st.palette_id.cpu().numpy().copy()
        ids[slot] = palette_id
        self._set_state(group, group.pipeline.set_palette(st, ids))

    def _mesh_step(self, group: StreamGroup, st: StreamState):
        """The shard_map_step for the state's table class, cached on the
        tables' full shapes (per-stream, uniform, marked and sorted states
        differ in them)."""
        from spectrogram_tpu_torch.parallel import mesh as pmesh

        key = tuple(tuple(t.shape) for t in st.tables)
        step = group.steps.get(key)
        if step is None:
            step = group.steps[key] = pmesh.shard_map_step(group.pipeline, self.mesh)
        return step

    # The live state is owned by the feeder once ingest is attached; these
    # keep `group.state` a coherent snapshot either way.  Every mutation
    # goes through `_set_state`, or the feeder would push a stale state.
    def _state(self, group: StreamGroup) -> StreamState:
        return group.feeder.state if group.feeder is not None else group.state

    def _set_state(self, group: StreamGroup, st: StreamState) -> None:
        if group.feeder is not None:
            group.feeder.state = st
        group.state = st

    def remove_stream(self, stream_id: int) -> None:
        """Detach: the slot keeps computing silence until reused (no
        reshuffle of live neighbors)."""
        cfg, slot = self._locations.pop(stream_id)
        group = self._groups[cfg]
        group.stream_ids[slot] = -1  # tombstone

    def location(self, stream_id: int) -> tuple[SpectrogramConfig, int]:
        return self._locations[stream_id]

    # -- processing ---------------------------------------------------------------

    def groups(self) -> Iterator[StreamGroup]:
        return iter(self._groups.values())

    def push_group(self, cfg: SpectrogramConfig, chunk) -> torch.Tensor:
        """Advance one geometry group by one chunk (direct mode).

        chunk: [capacity, chunk_size, 2] (numpy or a tensor) — the host ring
        bank for this group supplies silence for unattached slots
        (RingBank.pop_matrix zero-fill).  Returns the group's RGBA rows on
        the manager's device.  With a mesh, the rank's own [capacity / W,
        chunk_size, 2] streams in, the rank's rows out.
        """
        group = self._groups[cfg]
        if not isinstance(chunk, torch.Tensor):
            chunk = torch.from_numpy(np.asarray(chunk))
        st = self._state(group)
        if self.mesh is not None:
            want = (st.palette_id.shape[0], group.pipeline.chunk_size, 2)
            if tuple(chunk.shape) != want:
                raise ValueError(
                    f"mesh push_group takes this rank's chunk {want}; got "
                    f"{tuple(chunk.shape)}"
                )
            st, rgba, _global_rows = self._mesh_step(group, st)(st, chunk)
            self._set_state(group, st)
            return rgba
        st, rgba = group.pipeline.push(st, chunk)
        self._set_state(group, st)
        return rgba

    def set_palette(self, stream_id: int, palette_id: int) -> None:
        cfg, slot = self._locations[stream_id]
        self._set_slot_palette(self._groups[cfg], slot, palette_id)

    # -- ingest mode ------------------------------------------------------------

    def push_pcm(self, stream_id: int, frames_i16) -> int:
        """Producer edge: int16 PCM frames [n, 2] for one stream, into its
        group's host ring (SPSC per slot; counted drops on overrun)."""
        if not self.ingest:
            raise RuntimeError("manager created without ingest=True")
        cfg, slot = self._locations[stream_id]
        return self._groups[cfg].bank.push(slot, frames_i16)

    def tick(self, now: float) -> dict:
        """Advance every group whose hop deadline has passed — each geometry
        at its own cadence.  Underrun slots get zero-fill (silence rows, like
        the reference widget on a paused input); overruns were already
        counted at push_pcm time.

        Returns {cfg: completed RGBA block} for pushes the async feeder
        finished this tick (depth-pipelined: a block completes one tick
        late at depth 2), as host numpy.
        """
        if not self.ingest:
            raise RuntimeError("manager created without ingest=True")
        out = {}
        for cfg, group in self._groups.items():
            if group.next_due == 0.0:
                group.next_due = now
            if now < group.next_due:
                continue
            buf = group.pinned.next()
            chunk, _counts = (
                group.bank.pop_matrix_i16_planar(
                    group.pipeline.chunk_size, buf)
                if self.wire_int16
                else group.bank.pop_matrix_f32_planar(
                    group.pipeline.chunk_size, buf)
            )
            done = group.feeder.push(chunk)
            group.state = group.feeder.state
            group.next_due += group.chunk_period
            if now - group.next_due > 2 * group.chunk_period:
                group.next_due = now + group.chunk_period  # fell behind: snap
            if done is not None:
                out[cfg] = done
        return out

    def gc_empty_groups(self) -> int:
        """Drop geometry groups whose every slot is tombstoned, releasing
        their state tensors, pipelines and host rings (an abandoned
        10k-slot group pins real device memory).  Returns the number of
        groups collected.

        What stays: PyTorch's caching allocator keeps the freed device
        blocks reserved for reuse by this process until
        `torch.cuda.empty_cache()` returns them to the card; a new group of
        the same geometry builds a new pipeline."""
        empty = [
            cfg for cfg, g in self._groups.items()
            if all(sid == -1 for sid in g.stream_ids)
        ]
        for cfg in empty:
            g = self._groups.pop(cfg)
            if g.feeder is not None:
                g.feeder.flush()
        return len(empty)

    def flush(self) -> dict:
        """Force all in-flight pushes (shutdown / checkpoint point)."""
        out = {}
        for cfg, group in self._groups.items():
            if group.feeder is not None:
                blocks = group.feeder.flush()
                group.state = group.feeder.state
                if blocks:
                    out[cfg] = blocks
        return out

    def metrics(self) -> dict:
        m = {
            "groups": len(self._groups),
            "streams": len(self._locations),
            "rows_produced": {
                f"{cfg.sample_rate:.0f}Hz/w{cfg.window_size}":
                    int(self._state(g).row_count)
                for cfg, g in self._groups.items()
            },
        }
        if self.ingest:
            m["dropped"] = {
                f"{cfg.sample_rate:.0f}Hz/w{cfg.window_size}": g.bank.dropped_total
                for cfg, g in self._groups.items()
            }
        return m
