"""Scale-out over ranks: the stream axis sharded with torch.distributed.

The port of `spectrogram_tpu/parallel/mesh.py`.  The JAX package drives a
1-D `streams` mesh of devices from one controller; the PyTorch idiom is one
process per device.  So here the mesh is a 1-D `DeviceMesh` named
("streams",) over the ranks of the process group, and each rank holds its
own slice of the batch:

* rank r of W owns the S / W contiguous streams [r S/W, (r+1) S/W)
  (`distributed.local_stream_range`);
* its state is an ordinary `StreamState` of that slice, on its device, so
  the kernels take it as they take any state.  A palette-sorted slice holds
  rank-local perm and inv (the JAX package keeps global values confined to
  the slice and subtracts the slice's minimum inside each push);
* the scalars shared by the lockstep batch (cursor, row count) are equal on
  every rank;
* a push needs no collective; `shard_map_step` adds the one the JAX
  package has, an all-reduce of the row count.

Placements (`Shard(0)` for per-stream leaves, `Replicate()` for the scalars,
uniform [1, R*4] tables and the zero-size marker) describe the leaves where
a global view is wanted: sharded checkpoints (`utils.checkpoint.
save_sharded`) and `global_metrics`.  `gather_streams` and `gather_state`
give that view on every rank.

A rank's device is `cuda:LOCAL_RANK` unless `make_mesh(device=...)` (or
`distributed.initialize(device=...)`) names another: two ranks share a card
only when asked, and without a card a device must be named.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline, StreamState

STREAM_AXIS = "streams"

# the device of this process's rank: one process is one rank
_rank_device: Optional[torch.device] = None


def resolve_device(device=None) -> torch.device:
    """`device`, or cuda:LOCAL_RANK.  Without a card and without a device,
    and where LOCAL_RANK names a card that is not there, this raises: a
    rank never lands on the CPU or on another card unless asked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is available, and a rank runs on the card by "
            "default; pass device='cpu' to run the ranks on the CPU"
        )
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if local >= torch.cuda.device_count():
        raise RuntimeError(
            f"LOCAL_RANK={local} but this host has {torch.cuda.device_count()} "
            "CUDA card(s); pass device= to place ranks on a shared card"
        )
    return torch.device("cuda", local)


def set_rank_device(device=None) -> torch.device:
    """Fix this process's device (`resolve_device`); a later call must name
    the same one.  Selects the card as PyTorch's current device."""
    global _rank_device
    dev = resolve_device(device) if device is not None or _rank_device is None else _rank_device
    if _rank_device is not None and dev != _rank_device:
        raise ValueError(
            f"this rank already runs on {_rank_device}; one process is one "
            f"rank on one device (asked for {dev})"
        )
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _rank_device = dev
    return dev


def rank_device() -> torch.device:
    """This rank's device, as `make_mesh` or `distributed.initialize` set
    it (cuda:LOCAL_RANK where neither was called)."""
    return _rank_device if _rank_device is not None else resolve_device()


def make_mesh(n_devices: Optional[int] = None, devices=None, device=None) -> DeviceMesh:
    """1-D mesh over the stream axis: the ranks `devices` (default every
    rank of the process group), the first `n_devices` of them.  Without a
    process group it sets one up at world size 1.  `device` fixes this
    rank's device (see `resolve_device`)."""
    dev = set_rank_device(device)
    if not dist.is_initialized():
        from spectrogram_tpu_torch.parallel.distributed import initialize

        initialize(world_size=1, rank=0, device=dev)
    ranks = list(devices) if devices is not None else list(range(dist.get_world_size()))
    if n_devices is not None:
        ranks = ranks[:n_devices]
    if dist.get_rank() not in ranks:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh's ranks {ranks}")
    return DeviceMesh(dev.type, ranks, mesh_dim_names=(STREAM_AXIS,))


def mesh_rank(mesh: DeviceMesh) -> int:
    """This rank's position along the stream axis."""
    return mesh.get_local_rank(STREAM_AXIS)


def state_shardings(
    mesh: DeviceMesh, carry_ndim: int = 3, n_tables: int = 0, bw_marker: bool = False,
) -> StreamState:
    """Placements of every StreamState leaf in the global view: per-stream
    leaves `Shard(0)` (the stream axis leads whatever the carry's format,
    so `carry_ndim` changes nothing and is kept for parity), scalars
    `Replicate()`.  `n_tables` per-stream [S, R*4] tables shard like every
    per-stream leaf; `bw_marker` appends the replicated zero-size
    blockwise marker."""
    shard, rep = (Shard(0),), (Replicate(),)
    return StreamState(
        carry=shard, ring=shard, cursor=rep, palette_id=shard, row_count=rep,
        tables=(shard,) * n_tables + ((rep,) if bw_marker else ()),
    )


def chunk_sharding(mesh: DeviceMesh) -> tuple:
    return (Shard(0),)


def rgba_sharding(mesh: DeviceMesh, packed: bool = False) -> tuple:
    """Output rows' placement: [S, k, H] int32 or [S, k, H, 4] u8, both
    sharded over streams."""
    return (Shard(0),)


def local_stream_range(mesh: DeviceMesh, n_streams: int) -> tuple[int, int]:
    """The global [lo, hi) streams of this rank: S / W consecutive streams
    in mesh order."""
    n_dev = mesh.size()
    if n_streams % n_dev:
        raise ValueError(f"{n_streams} streams not divisible by {n_dev} devices")
    per = n_streams // n_dev
    r = mesh_rank(mesh)
    return r * per, (r + 1) * per


# ----------------------------------------------------------- per-shard sort

def _per_shard_sort_applies(pipeline: SpectrogramPipeline, tables: tuple, s: int,
                            n_shards: int) -> bool:
    """The JAX package's gate of the per-shard sort: more than one shard
    dividing S, built-in per-stream tables with palette_sort, carry-sort
    mode, and blockwise palettes "auto" or True."""
    return (n_shards > 1 and not s % n_shards
            and pipeline._palette_sort_eligible(tables)
            and pipeline.carry_sort_mode
            and pipeline.blockwise_palettes in ("auto", True))


def _resort_per_shard(pipeline: SpectrogramPipeline, state: StreamState,
                      n_shards: int) -> StreamState:
    """PER-SHARD palette sort of a whole, external-order state about to be
    split over `n_shards` ranks: one stable argsort per shard slice (perm
    values global but confined to the slice, `_view_sorted_tables`), so
    every rank's slice is self-contained.  Where the gate fails, where the
    layout is already clustered (the marker path needs no gathers) or where
    the shard-sorted layout fails the blockwise test, the state passes
    through."""
    s = int(state.palette_id.shape[0])
    if not _per_shard_sort_applies(pipeline, state.tables, s, n_shards):
        return state
    layout = state.palette_id.cpu().numpy().astype(np.int64)
    if pipeline._blockwise_auto_decision(layout):
        return state
    st = pipeline._view_sorted_tables(state.tables, layout, s // n_shards)
    if st is None:
        return state
    return state._replace(tables=st, carry=state.carry.index_select(0, st[1]))


def _local_tables(tables: tuple, lo: int, hi: int, device) -> tuple:
    """Streams [lo, hi) of a whole state's tables: per-stream tables
    sliced, uniform tables and the marker as they are, a per-shard sorted
    tuple's perm and inv made rank-local."""
    if SpectrogramPipeline._tables_perm(tables) is not None:
        t, perm, inv, marker = tables
        return (t[lo:hi].contiguous().to(device), (perm[lo:hi] - lo).to(device),
                (inv[lo:hi] - lo).to(device), marker.to(device))
    return tuple(t.to(device) if t.ndim == 1 or t.shape[0] == 1
                 else t[lo:hi].contiguous().to(device) for t in tables)


def sharded_layout_tables(pipeline: SpectrogramPipeline, palette_id, n_shards: int) -> tuple:
    """The WHOLE batch's kernel tables for [S] palette ids in the layout
    class the JAX pipeline gives a state sharded over `n_shards` devices
    (its set_palette on a sharded state, or shard_state after a palette
    edit): the blockwise marker where the whole layout is clustered
    ("auto"), else the per-shard sort where its gate and the blockwise test
    pass, else per-row tables."""
    layout = np.asarray(palette_id, np.int32).reshape(-1)
    pipeline._check_ids(layout)
    tables = pipeline.state_tables_for(pipeline._device_index(layout))
    counters = pipeline.counters      # as the pipeline's own layout decisions count
    if len(tables) != 1:
        counters["layout.generic" if tables else "layout.unsorted"] += 1
        return tables
    if pipeline._blockwise_auto_decision(layout):
        counters["layout.clustered"] += 1
        return tables + ((pipeline._bw_marker(),) if pipeline.blockwise_palettes == "auto" else ())
    s = layout.shape[0]
    if _per_shard_sort_applies(pipeline, tables, s, n_shards):
        st = pipeline._view_sorted_tables(tables, layout, s // n_shards)
        if st is not None:
            return st
    counters["layout.unsorted"] += 1
    return tables


def sharded_set_palette(pipeline: SpectrogramPipeline, state: StreamState, palette_id,
                        mesh: DeviceMesh) -> StreamState:
    """`set_palette` of a rank's state: a scalar id for every stream, or
    the WHOLE batch's [S] ids (every rank passes the same), laid out as
    `sharded_layout_tables` decides; in carry-sort mode the rank's carry
    follows its new stream order."""
    ids = palette_id.cpu().numpy() if isinstance(palette_id, torch.Tensor) else np.asarray(palette_id)
    if ids.ndim == 0 or pipeline.static_table is not None:
        return pipeline.set_palette(state, ids)
    lo, hi = local_stream_range(mesh, int(ids.shape[0]))
    if hi - lo != state.palette_id.shape[0]:
        raise ValueError(
            f"{ids.shape[0]} ids over {mesh.size()} ranks give {hi - lo} streams a "
            f"rank; this rank's state holds {state.palette_id.shape[0]}"
        )
    tables = _local_tables(sharded_layout_tables(pipeline, ids, mesh.size()), lo, hi,
                           pipeline.device)
    return state._replace(palette_id=pipeline._device_index(ids[lo:hi]), tables=tables,
                          carry=pipeline._resorted_carry(state, tables))


# --------------------------------------------------------------- placement

def _slice_state(state: StreamState, lo: int, hi: int, device) -> StreamState:
    def cut(t):
        return t[lo:hi].contiguous().to(device)

    return StreamState(carry=cut(state.carry), ring=cut(state.ring),
                       cursor=state.cursor.to(device), palette_id=cut(state.palette_id),
                       row_count=state.row_count.to(device),
                       tables=_local_tables(state.tables, lo, hi, device))


def shard_state(state: StreamState, mesh: DeviceMesh,
                pipeline: SpectrogramPipeline | None = None) -> StreamState:
    """This rank's slice of a whole (unsharded) state, on the pipeline's
    device (the rank's without a pipeline).  Uniform [1, R*4] tables stay
    whole: there is no stream axis to split.  Palette-sorted states are
    unsorted and, with `pipeline`, re-sorted PER SHARD SLICE where the
    JAX gate sorts (`_resort_per_shard`); the rank keeps its slice's
    rank-local perm.  Without `pipeline`, sorted states raise: the stored
    permutation indexes across shard slices."""
    if SpectrogramPipeline._tables_perm(state.tables) is not None:
        if pipeline is None:
            raise ValueError(
                "palette-sorted states cannot be sharded: the stored sort "
                "permutation indexes across shard slices.  Pass the "
                "pipeline (shard_state(state, mesh, pipeline)) — it "
                "re-sorts per shard slice — or call "
                "pipeline.unsort_state(state) first."
            )
        state = pipeline.unsort_state(state)
    if pipeline is not None:
        state = _resort_per_shard(pipeline, state, mesh.size())
    _state_tables_specs(state.tables, mesh.size())
    lo, hi = local_stream_range(mesh, int(state.palette_id.shape[0]))
    device = pipeline.device if pipeline is not None else rank_device()
    return _slice_state(state, lo, hi, device)


def sharded_init(pipeline: SpectrogramPipeline, n_streams: int, mesh: DeviceMesh,
                 palette_id: int = 1) -> StreamState:
    """This rank's slice of `pipeline.init_state(n_streams)`, built
    directly on the pipeline's device (no whole state exists anywhere)."""
    lo, hi = local_stream_range(mesh, n_streams)
    return pipeline.init_state(hi - lo, palette_id=palette_id)


def _perm_shard_confined(perm, n_shards: int) -> bool:
    """True when a whole state's length-4 sort permutation keeps its values
    inside their own shard slice: the per-shard form `shard_state` builds.
    Whole-state global sorts (values crossing slices) fail."""
    p = perm.cpu().numpy() if isinstance(perm, torch.Tensor) else np.asarray(perm)
    s = p.shape[0]
    if n_shards <= 0 or s % n_shards:
        return False
    bs = s // n_shards
    blocks = p.reshape(n_shards, bs)
    lo = np.arange(n_shards, dtype=p.dtype)[:, None] * bs
    return bool(((blocks >= lo) & (blocks < lo + bs)).all())


def _state_tables_specs(tables: tuple, n_shards: int | None = None) -> tuple:
    """Placements of a WHOLE state's tables in the global view: per-stream
    [S, R*4] tables shard over streams; uniform [1, R*4] tables and the
    zero-size marker replicate.  A per-shard sorted tuple (perm values
    confined to their slice) shards perm and inv too; block-relative
    length-3 sorts and whole-state global sorts cannot be sharded."""
    if SpectrogramPipeline._tables_perm(tables) is not None:
        if SpectrogramPipeline._tables_perm_global(tables) and (
            n_shards is None or _perm_shard_confined(tables[1], n_shards)
        ):
            return ((Shard(0),), (Shard(0),), (Shard(0),), (Replicate(),))
        raise ValueError(
            "this palette-sorted state cannot be sharded: the stored sort "
            "permutation indexes across shard slices.  Re-shard through "
            "shard_state(state, mesh, pipeline) — it unsorts and re-sorts "
            "PER SHARD SLICE — or call pipeline.unsort_state first."
        )
    return tuple((Shard(0),) if t.ndim == 2 and t.shape[0] != 1 else (Replicate(),)
                 for t in tables)


# -------------------------------------------------------------------- push

def _collective_device(group) -> torch.device:
    """Where a collective's tensors live: on the card for NCCL, on the host
    for gloo (whose CUDA collectives not every build has)."""
    return rank_device() if dist.get_backend(group) == "nccl" else torch.device("cpu")


def _step(pipeline: SpectrogramPipeline, mesh: DeviceMesh, planar: bool, reduce: bool):
    push = pipeline.push_planar if planar else pipeline.push
    group = mesh.get_group(STREAM_AXIS)

    def step(state: StreamState, chunk: torch.Tensor):
        if chunk.shape[0] != state.palette_id.shape[0]:
            raise ValueError(
                f"this rank's chunk holds {chunk.shape[0]} streams; its state "
                f"{state.palette_id.shape[0]}: pass the rank-local chunk"
            )
        new_state, rows = push(state, chunk)
        if not reduce:
            return new_state, rows
        total = torch.tensor([rows.shape[0] * pipeline.chunk_hops], dtype=torch.int64,
                             device=_collective_device(group))
        dist.all_reduce(total, group=group)
        return new_state, rows, total[0]

    return step


def sharded_push(pipeline: SpectrogramPipeline, mesh: DeviceMesh,
                 state: StreamState | None = None, planar: bool = False):
    """The push of this rank's slice: step(state, chunk) -> (state, rows),
    with the rank-local [S/W, k*hop, 2] chunk ([S/W, 2, k*hop] with
    `planar`) and rows.  `state` is taken for parity with the JAX step,
    whose table shardings follow it: a rank's slice is an ordinary state,
    so one step pushes every table class."""
    return _step(pipeline, mesh, planar, reduce=False)


def shard_map_step(pipeline: SpectrogramPipeline, mesh: DeviceMesh,
                   state: StreamState | None = None, planar: bool = False):
    """As `sharded_push`, plus the one collective: step(state, chunk) ->
    (state, rows, global_rows), global_rows the all-reduced sum of every
    rank's rows (a 0-d int64 tensor, on the card under NCCL and on the host
    under gloo)."""
    return _step(pipeline, mesh, planar, reduce=True)


# ------------------------------------------------------------- global view

def gather_streams(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Every rank's [S/W, ...] slice, concatenated along the stream axis,
    on every rank and on `t`'s device.  Gathered as raw bytes, so any dtype
    crosses any backend."""
    group = mesh.get_group(STREAM_AXIS)
    x = t.contiguous().reshape(-1).view(torch.uint8).to(_collective_device(group))
    parts = [torch.empty_like(x) for _ in range(mesh.size())]
    dist.all_gather(parts, x, group=group)
    whole = torch.cat(parts).view(t.dtype)
    return whole.reshape((t.shape[0] * mesh.size(),) + tuple(t.shape[1:])).to(t.device)


def gather_state(state: StreamState, mesh: DeviceMesh,
                 pipeline: SpectrogramPipeline | None = None) -> StreamState:
    """The whole state on every rank, in EXTERNAL stream order (a sorted
    slice's carry unsorted first, which needs `pipeline`), with per-row
    tables: the global view of a sharded state."""
    if SpectrogramPipeline._tables_perm(state.tables) is not None:
        if pipeline is None:
            raise ValueError("gathering a palette-sorted state requires pipeline=")
        state = pipeline.unsort_state(state)
    pid = gather_streams(state.palette_id, mesh)
    tables = pipeline.state_tables_for(pid) if pipeline is not None else ()
    return StreamState(carry=gather_streams(state.carry, mesh),
                       ring=gather_streams(state.ring, mesh), cursor=state.cursor,
                       palette_id=pid, row_count=state.row_count, tables=tables)


def global_metrics(state: StreamState, mesh: DeviceMesh | None = None) -> dict:
    """Monitoring summary of a sharded (or whole) state: the batch's stream
    count, rows produced since init and the ring cursor.  The scalars are
    equal on every rank, so no collective runs."""
    n = mesh.size() if mesh is not None else 1
    return {
        "streams": int(state.palette_id.shape[0]) * n,
        "rows_produced": int(state.row_count),
        "cursor": int(state.cursor),
    }
