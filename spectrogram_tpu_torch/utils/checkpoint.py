"""Checkpoint / resume for streaming state: the JAX package's npz format.

The reference persists nothing — its scrolling texture is rebuilt empty on
every sample-rate change (gpu_spectrogram.rs:326) and all history dies with
the process (SURVEY.md §5).  Here the row ring + cursors + palette ids form
real resumable state: a long-running 10k-stream service should survive
restarts without blanking every client's viewport.

The port's counterpart of the npz path of `spectrogram_tpu/utils/
checkpoint.py` (`save_state` / `load_state`), writing the same `.npz` fields
and `.json` config sidecar, so that a checkpoint written by either package
loads in the other:

  * `carry` in the saving pipeline's format (planar [S, 2, C] f32 or int16,
    or transposed [S, 2, n1, C/n1] f32) and in EXTERNAL stream order (a
    carry-sort pipeline's sorted carry is unpermuted on save and permuted
    again on load);
  * `ring` as f32 (npz has no bfloat16; f32 holds bf16 exactly) with its
    dtype under JAX's name in `ring_dtype` ("bfloat16", "float32", ...);
  * `cursor`, `palette_id`, `row_count`;
  * no kernel tables: they are derived state (palette_id x the restoring
    pipeline's registry), recomputed by `restored_tables_for`, which also
    re-decides the blockwise marker and the palette sort.

A state sharded over ranks (`parallel.mesh`) is written either way:
`save_state(..., mesh=)` gathers it to rank 0 in external order and writes
the npz once, so npz files still cross between the packages; `save_sharded`
/ `load_sharded` (JAX's orbax pair) write and read it with
`torch.distributed.checkpoint` (DCP), every rank its own slice.  A DCP
directory is not an orbax one: the two packages do not read each other's
sharded checkpoints (orbax needs JAX).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import pathlib
import warnings

import numpy as np
import torch

from spectrogram_tpu_torch.config import SpectrogramConfig
from spectrogram_tpu_torch.models.convert import state_from_jax, state_to_numpy
from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline, StreamState


def _sidecar_payload(cfg: SpectrogramConfig, pipeline=None) -> str:
    """Config sidecar JSON.  Alongside the geometry it records the saving
    pipeline's chunk_hops/viewport_rows when known: cursor validity depends
    on them but they are not part of any array shape, so without the record
    a k=8 checkpoint restored at k=4 could pass the modular fallback check
    by luck (ADVICE r2)."""
    doc = dict(dataclasses.asdict(cfg))
    if pipeline is not None:
        doc["_pipeline"] = {
            "chunk_hops": pipeline.chunk_hops,
            "viewport_rows": pipeline.viewport_rows,
        }
    return json.dumps(doc, sort_keys=True)


def _parse_sidecar(text: str) -> tuple[SpectrogramConfig, dict]:
    doc = json.loads(text)
    pipeline_meta = doc.pop("_pipeline", {})
    return SpectrogramConfig(**doc), pipeline_meta


def _dtype_name(dtype: torch.dtype) -> str:
    """A torch floating dtype under its JAX / numpy name ("bfloat16")."""
    return str(dtype).removeprefix("torch.")


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not (isinstance(dtype, torch.dtype) and dtype.is_floating_point):
        raise ValueError(f"checkpoint ring_dtype {name!r} is not a floating dtype")
    return dtype


def save_state(
    path, state: StreamState, cfg: SpectrogramConfig, pipeline=None, mesh=None
) -> None:
    """Write state + config. `path` gets `.npz`; a `.json` sidecar holds the
    geometry (plus chunk_hops/viewport_rows when `pipeline` is given).
    With `mesh`, `state` is this rank's slice: every rank calls this, the
    whole state is gathered in external order and rank 0 writes it once;
    every rank returns once the files exist."""
    path = pathlib.Path(path)
    if mesh is not None:
        from spectrogram_tpu_torch.parallel import mesh as pmesh

        whole = pmesh.gather_state(state, mesh, pipeline)
        if pmesh.mesh_rank(mesh) == 0:
            save_state(path, whole, cfg, pipeline)
        torch.distributed.barrier(group=mesh.get_group(pmesh.STREAM_AXIS))
        return
    host = state_to_numpy(state)
    carry = host["carry"]
    # Palette-sorted states: checkpoints always persist the EXTERNAL stream
    # order (portable across palette_sort settings).  In carry-sort mode
    # (streaming pipelines) the carry is at rest in sorted order — undo the
    # stored block-relative permutation before writing.
    perm = SpectrogramPipeline._tables_perm(state.tables)
    if perm is not None and getattr(pipeline, "carry_sort_mode", None) is None:
        raise ValueError(
            "saving a palette-sorted state requires pipeline= (the carry "
            "order on disk depends on the pipeline's carry_sort_mode)"
        )
    if perm is not None and pipeline.carry_sort_mode:
        ginv = pipeline._global_perm(
            perm[1], carry.shape[0],
            SpectrogramPipeline._tables_perm_global(state.tables),
        )
        carry = carry[ginv.cpu().numpy()]
    np.savez_compressed(
        path.with_suffix(".npz"),
        carry=carry,
        ring=np.asarray(host["ring"], dtype=np.float32),  # bf16 -> f32 container
        cursor=host["cursor"],
        palette_id=host["palette_id"],
        row_count=host["row_count"],
        ring_dtype=_dtype_name(state.ring.dtype),
    )
    path.with_suffix(".json").write_text(_sidecar_payload(cfg, pipeline))


def load_config(path) -> SpectrogramConfig:
    path = pathlib.Path(path)
    return _parse_sidecar(path.with_suffix(".json").read_text())[0]


def expected_shapes(pipeline: SpectrogramPipeline, n_streams: int) -> dict:
    """The shapes `pipeline.init_state(n_streams)` would give each field
    (tables: its 2-D tables only), from the pipeline's geometry: nothing is
    allocated."""
    s = n_streams
    if pipeline.carry_is_transposed:
        n1 = pipeline.fft_plan.n1
        carry = (s, 2, n1, pipeline.carry_size // n1)
    else:
        carry = (s, 2, pipeline.carry_size)
    ring_rows = pipeline.viewport_rows if pipeline.store_ring else 0
    if pipeline.static_table is not None:
        tables = []
    else:
        registry = ((pipeline.builtin_tables,) if pipeline.builtin_tables is not None
                    else pipeline.generic_tables)
        tables = [(s, t.shape[1]) for t in registry]
    return {
        "carry": [carry],
        "ring": [(s, ring_rows, 2, pipeline.cfg.num_bins)],
        "cursor": [()],
        "palette_id": [(s,)],
        "row_count": [()],
        "tables": tables,
    }


def load_state(path, pipeline: SpectrogramPipeline) -> StreamState:
    """Restore state for `pipeline`, on its device; raises if the checkpoint
    geometry is incompatible (the analog of the reference's forced texture
    realloc on rate change — a changed geometry means a fresh state, not a
    bad load)."""
    path = pathlib.Path(path)
    saved_cfg, pipeline_meta = _parse_sidecar(
        path.with_suffix(".json").read_text()
    )
    if (
        saved_cfg.window_size != pipeline.cfg.window_size
        or saved_cfg.sample_rate != pipeline.cfg.sample_rate
        or saved_cfg.pad_factor != pipeline.cfg.pad_factor
    ):
        raise ValueError(
            f"checkpoint geometry {saved_cfg} incompatible with pipeline "
            f"{pipeline.cfg}; start a fresh state instead"
        )
    z = np.load(path.with_suffix(".npz"))
    ring_dtype = _torch_dtype(str(z["ring_dtype"]))
    carry = np.asarray(z["carry"])
    # carry-format migration: checkpoints store whichever format the saving
    # pipeline used (planar [S, 2, C] or transposed [S, 2, n1, C/n1]); the
    # two are a deterministic reshape+transpose apart, so a restore into a
    # pipeline of the other format converts instead of failing.
    want_t = pipeline.carry_is_transposed
    if carry.ndim == 3 and want_t:
        n1 = pipeline.fft_plan.n1
        s_, _, c_ = carry.shape
        carry = carry.reshape(s_, 2, c_ // n1, n1).swapaxes(2, 3)
    elif carry.ndim == 4 and not want_t:
        s_, _, n1_, cm = carry.shape
        carry = carry.swapaxes(2, 3).reshape(s_, 2, n1_ * cm)
    if carry.dtype != np.dtype(_dtype_name(pipeline.carry_dtype)):
        raise ValueError(
            f"checkpoint carry is {carry.dtype}; this pipeline keeps "
            f"{pipeline.carry_dtype} (i16_planes={pipeline.i16_planes}) — "
            f"start a fresh state"
        )
    palette_id = np.asarray(z["palette_id"])
    # kernel tables are DERIVED state (palette_id x the restoring
    # pipeline's registry) — recomputed, never persisted, so a checkpoint
    # restores cleanly into a pipeline with different schemes; the
    # blockwise-auto marker and the palette-sort class are re-decided from
    # the restored layout
    tables = pipeline.restored_tables_for(palette_id)
    # carry-sort pipelines keep the carry at rest in sorted order; the
    # checkpoint stores external order, so re-apply the (deterministic)
    # permutation the restored tables carry.
    perm = SpectrogramPipeline._tables_perm(tables)
    if perm is not None and pipeline.carry_sort_mode:
        gperm = pipeline._global_perm(
            perm[0], carry.shape[0], SpectrogramPipeline._tables_perm_global(tables))
        carry = carry[gperm.cpu().numpy()]
    state = state_from_jax(
        dict(carry=carry, ring=z["ring"], cursor=z["cursor"],
             palette_id=palette_id, row_count=z["row_count"]),
        device=pipeline.device, ring_dtype=ring_dtype,
    )._replace(tables=tables)
    expected = expected_shapes(pipeline, int(palette_id.shape[0]))
    for name in StreamState._fields:
        field = getattr(state, name)
        got = [tuple(t.shape) for t in (field if name == "tables" else (field,))]
        if name == "tables":
            # 1-D tables entries track the palette LAYOUT class, not
            # geometry — the zero-size blockwise-auto marker and the
            # palette-sort perm/inv vectors — exempt from the shape contract
            got = [s_ for s_ in got if len(s_) != 1]
        if got != expected[name]:
            raise ValueError(
                f"checkpoint field {name} shape {got} != pipeline "
                f"expectation {expected[name]}"
            )
    _check_cursor_alignment(state, pipeline, pipeline_meta)
    return state


@contextlib.contextmanager
def _one_process():
    """DCP in one process (`no_dist=True`), without its warning that no
    process group is in use: that is what was asked for."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        yield


def save_sharded(
    path, state: StreamState, cfg: SpectrogramConfig, pipeline=None, mesh=None
) -> None:
    """DCP save of a sharded state: with `mesh`, `state` is this rank's
    slice, every rank calls this and writes only its slice (per-stream
    leaves as `Shard(0)` DTensors, scalars replicated); without, a whole
    state from one process.  The config sidecar (`config.json`, written by
    rank 0) travels in the same directory.  `path` is a directory.  Kernel
    tables are derived state and are not saved; zero-size leaves (a
    streaming state's empty ring) are dropped, as the JAX package drops
    them."""
    import torch.distributed.checkpoint as dcp

    path = pathlib.Path(path).resolve()
    if SpectrogramPipeline._tables_perm(state.tables) is not None:
        raise ValueError(
            "palette-sorted states are not saved sharded: save with "
            "save_state, which persists the external carry order, or save "
            "pipeline.unsort_state(state)"
        )
    payload = {name: getattr(state, name) for name in StreamState._fields
               if name != "tables" and getattr(state, name).numel() > 0}
    if mesh is None:
        with _one_process():
            dcp.save(payload, checkpoint_id=path / "state", no_dist=True)
        (path / "config.json").write_text(_sidecar_payload(cfg, pipeline))
        return
    from torch.distributed.tensor import DTensor

    from spectrogram_tpu_torch.parallel import mesh as pmesh

    placements = pmesh.state_shardings(mesh)
    payload = {name: DTensor.from_local(t, mesh, getattr(placements, name), run_check=False)
               for name, t in payload.items()}
    group = mesh.get_group(pmesh.STREAM_AXIS)
    dcp.save(payload, checkpoint_id=path / "state", process_group=group)
    if pmesh.mesh_rank(mesh) == 0:
        (path / "config.json").write_text(_sidecar_payload(cfg, pipeline))
    torch.distributed.barrier(group=group)


def load_sharded(path, pipeline: SpectrogramPipeline, mesh=None) -> StreamState:
    """Restore a DCP checkpoint of `save_sharded` onto the pipeline's
    device: with `mesh`, this rank's slice of it (each rank reads its own
    streams, whatever mesh size saved it); with `mesh=None`, the whole
    state in one process (no process group needed).  Raises where the
    geometry or a shape differs from the pipeline's.  The tables are
    re-derived from the restored palette ids, in the layout class a state
    on this mesh takes (`parallel.mesh.sharded_layout_tables`: the
    blockwise marker, or the per-shard sort), or, unsharded, in the one
    `restored_tables_for` gives."""
    import torch.distributed.checkpoint as dcp

    path = pathlib.Path(path).resolve()
    saved_cfg, pipeline_meta = _parse_sidecar((path / "config.json").read_text())
    if (
        saved_cfg.window_size != pipeline.cfg.window_size
        or saved_cfg.sample_rate != pipeline.cfg.sample_rate
        or saved_cfg.pad_factor != pipeline.cfg.pad_factor
    ):
        raise ValueError(
            f"checkpoint geometry {saved_cfg} incompatible with pipeline "
            f"{pipeline.cfg}; start a fresh state instead"
        )
    reader = dcp.FileSystemReader(path / "state")
    stored = reader.read_metadata().state_dict_metadata
    n_streams = int(stored["palette_id"].size[0])
    expected = expected_shapes(pipeline, n_streams)
    for name, md in stored.items():
        if [tuple(md.size)] != expected[name]:
            raise ValueError(
                f"checkpoint field {name} shape {tuple(md.size)} != pipeline "
                f"expectation {expected[name][0]} (viewport/chunk geometry "
                f"changed; start a fresh state)"
            )
    carry_dtype = stored["carry"].properties.dtype
    if carry_dtype != pipeline.carry_dtype:
        raise ValueError(
            f"checkpoint carry is {carry_dtype}; this pipeline keeps "
            f"{pipeline.carry_dtype} (i16_planes={pipeline.i16_planes}) — "
            f"start a fresh state"
        )
    dev = pipeline.device
    lo, hi = 0, n_streams
    if mesh is not None:
        from torch.distributed.tensor import DTensor, Shard

        from spectrogram_tpu_torch.parallel import mesh as pmesh

        lo, hi = pmesh.local_stream_range(mesh, n_streams)
    targets = {}
    for name, md in stored.items():
        shape, dtype = tuple(md.size), md.properties.dtype
        if mesh is not None and name in ("carry", "ring"):
            local = torch.empty((hi - lo,) + shape[1:], dtype=dtype, device=dev)
            targets[name] = DTensor.from_local(local, mesh, [Shard(0)], run_check=False)
        else:
            # scalars, and the whole [S] palette layout on every rank: the
            # tables' class is decided on it
            targets[name] = torch.empty(shape, dtype=dtype, device=dev)
    if mesh is None:
        with _one_process():
            dcp.load(targets, storage_reader=reader, no_dist=True)
    else:
        dcp.load(targets, storage_reader=reader,
                 process_group=mesh.get_group(pmesh.STREAM_AXIS))
    restored = {name: t.to_local() if mesh is not None and isinstance(t, DTensor) else t
                for name, t in targets.items()}
    # zero-size leaves (a streaming state's empty ring) are never stored
    for name in StreamState._fields:
        if name == "tables" or name in restored:
            continue
        want = expected[name][0]
        if int(np.prod(want)):
            raise ValueError(
                f"checkpoint is missing field {name!r} but the pipeline "
                f"expects {want} (store_ring mismatch between save and load "
                f"pipelines?)"
            )
        local = (hi - lo,) + tuple(want[1:]) if name in ("carry", "ring") else want
        dtype = pipeline.ring_dtype if name == "ring" else pipeline.carry_dtype
        restored[name] = torch.zeros(local, dtype=dtype, device=dev)
    layout = restored["palette_id"].cpu().numpy()
    if mesh is not None:
        tables = pmesh._local_tables(
            pmesh.sharded_layout_tables(pipeline, layout, mesh.size()), lo, hi, dev)
        restored["palette_id"] = restored["palette_id"][lo:hi].contiguous()
    else:
        tables = pipeline.restored_tables_for(layout)
    state = StreamState(**restored, tables=tables)
    # carry-sort pipelines keep the carry at rest in sorted order; the
    # checkpoint stores external order
    perms = pipeline._global_perms(state)
    if perms is not None and pipeline.carry_sort_mode:
        state = state._replace(carry=state.carry.index_select(0, perms[0]))
    _check_cursor_alignment(state, pipeline, pipeline_meta)
    return state


def _check_cursor_alignment(
    state: StreamState, pipeline, pipeline_meta: dict | None = None
) -> None:
    """A restored cursor must sit on the restoring pipeline's chunk grid:
    chunk_hops is not part of the array shapes, and a misaligned cursor
    silently corrupts the ring (the write slice clamps at the wrap).

    Checkpoints written since round 3 record the saving pipeline's
    chunk_hops/viewport_rows in the sidecar — compared directly.  Older
    checkpoints fall back to the modular heuristic (which a lucky cursor,
    e.g. saved at k=8 restored at k=4, could pass undetected)."""
    meta = pipeline_meta or {}
    if meta:
        saved_k = meta.get("chunk_hops")
        if saved_k is not None and saved_k != pipeline.chunk_hops:
            raise ValueError(
                f"checkpoint was saved with chunk_hops={saved_k}; this "
                f"pipeline uses chunk_hops={pipeline.chunk_hops} — start a "
                f"fresh state"
            )
        saved_rows = meta.get("viewport_rows")
        if saved_rows is not None and saved_rows != pipeline.viewport_rows:
            raise ValueError(
                f"checkpoint was saved with viewport_rows={saved_rows}; "
                f"this pipeline uses {pipeline.viewport_rows} — start a "
                f"fresh state"
            )
    cursor = int(state.cursor)
    if cursor % pipeline.chunk_hops:
        raise ValueError(
            f"checkpoint cursor {cursor} is not a multiple of this "
            f"pipeline's chunk_hops={pipeline.chunk_hops}; it was saved "
            f"under a different chunking — start a fresh state"
        )
