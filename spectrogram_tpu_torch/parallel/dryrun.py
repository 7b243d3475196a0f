"""One full sharded streaming step over N ranks, on tiny shapes.

    python -m spectrogram_tpu_torch.parallel.dryrun --ranks N [--device cpu] [--backend gloo]

The port's counterpart of the JAX package's `dryrun_multichip`
(`__graft_entry__.py`).  It starts N rank processes over a `file://`
rendezvous in a temporary directory; each brings up the process group and
runs, on its slice of the batch: `shard_map_step` with the ring and
`render_viewport` on the sharded state, the packed kernel chain (no ring,
int32 rows), the generic two-table registry, the per-shard palette sort,
presorted input on it, `StreamGroupManager(mesh=...)` with two geometries
and a palette edit, and a `save_sharded` / `load_sharded` cycle followed by
one more step.  Every step's `global_rows` must equal the batch's rows
(N * 2 * k at two streams a rank).  Rank 0 prints one OK line; the command
exits non-zero when a rank fails or outlives the time limit.

Without `--device` each rank takes cuda:LOCAL_RANK (one card a rank, NCCL);
two ranks share one card only with `--device cuda:0 --backend gloo`.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import tempfile

import numpy as np
import torch

from spectrogram_tpu_torch.config import SpectrogramConfig

RANK_TIMEOUT_S = 300.0


def tiny_config(**kw) -> SpectrogramConfig:
    return SpectrogramConfig(sample_rate=8000.0, window_period=0.032, hop_period=0.008,
                             viewport_height=64, viewport_rows=16, **kw)


def _step_once(pmesh, pipeline, mesh, state, n_streams: int, chunk=None, planar=False):
    """One shard_map_step of zeros (or `chunk`); checks global_rows."""
    step = pmesh.shard_map_step(pipeline, mesh, planar=planar)
    if chunk is None:
        lo, hi = pmesh.local_stream_range(mesh, n_streams)
        chunk = torch.zeros((hi - lo, pipeline.chunk_size, 2), device=pipeline.device)
    state, rows, global_rows = step(state, chunk)
    want = n_streams * pipeline.chunk_hops
    if int(global_rows) != want:
        raise AssertionError(f"global_rows {int(global_rows)} != {want}")
    return state, rows


def rank_main(args) -> None:
    from spectrogram_tpu_torch.color.colorscheme import DEFAULT_COLOR_SCHEMES, FactoredScheme
    from spectrogram_tpu_torch.models.multirate import StreamGroupManager
    from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline
    from spectrogram_tpu_torch.parallel import distributed as pdist
    from spectrogram_tpu_torch.parallel import mesh as pmesh
    from spectrogram_tpu_torch.utils import checkpoint

    torch.set_num_threads(1)
    pdist.initialize(init_method=args.init, world_size=args.world, rank=args.rank,
                     backend=args.backend, device=args.device)
    mesh = pdist.global_mesh()
    dev = pmesh.rank_device()
    n = mesh.size()
    n_streams = 2 * n
    cfg = tiny_config()

    # the display step: ring, render_viewport on the sharded state
    pipe = SpectrogramPipeline(cfg, chunk_hops=4, device=dev)
    state = pmesh.shard_state(pipe.init_state(n_streams), mesh, pipe)
    state, rgba = _step_once(pmesh, pipe, mesh, state, n_streams)
    assert tuple(rgba.shape) == (2, 4, cfg.viewport_height, 4), rgba.shape
    viewport = pipe.render_viewport(state)
    assert tuple(viewport.shape) == (2, pipe.viewport_rows, cfg.viewport_height, 4)

    # the packed kernel chain, no ring
    kw = dict(packed_output=True, store_ring=False, device=dev)
    fused = SpectrogramPipeline(cfg, chunk_hops=4, **kw)
    fstate = pmesh.sharded_init(fused, n_streams, mesh)
    fstate, packed = _step_once(pmesh, fused, mesh, fstate, n_streams)
    assert tuple(packed.shape) == (2, 4, cfg.viewport_height) and packed.dtype == torch.int32

    # the generic two-table registry
    res = 32
    i01 = (np.arange(res) / (res - 1)).astype(np.float32)
    u, v = np.ones((res, 4), np.float32), np.ones((res, 4), np.float32)
    u[:, 0] = i01
    v[:, 3] = 0.25 + 0.75 * i01
    gpipe = SpectrogramPipeline(
        cfg, chunk_hops=2, schemes=DEFAULT_COLOR_SCHEMES + (FactoredScheme("dryrun-generic", u, v),),
        **kw)
    assert gpipe.generic_tables is not None
    _step_once(pmesh, gpipe, mesh, pmesh.sharded_init(gpipe, n_streams, mesh), n_streams)

    # the per-shard palette sort, and presorted input on it
    s_streams = 256 * n
    ids = (np.arange(s_streams) % 2).astype(np.int32)
    classes = []
    for presorted in (False, True):
        spipe = SpectrogramPipeline(cfg, chunk_hops=1, presorted_input=presorted, **kw)
        sstate = pmesh.shard_state(spipe.set_palette(spipe.init_state(s_streams), ids), mesh,
                                   spipe)
        # one rank is one shard: JAX's gate declines the per-shard sort there
        if spipe.palette_layout.read(sstate.tables).perm_global != (n > 1):
            raise AssertionError("the per-shard palette sort did not follow its gate")
        chunk = torch.zeros((s_streams // n, spipe.chunk_size, 2), device=dev)
        if presorted and n > 1:
            chunk[:, 0, 0] = torch.from_numpy(spipe.input_perm(sstate).astype(np.float32)).to(dev)
        _step_once(pmesh, spipe, mesh, sstate, s_streams, chunk)
        classes.append("presorted" if presorted else "shard_sorted")

    # StreamGroupManager on the mesh: two geometries, a palette edit
    mgr = StreamGroupManager(group_capacity=n_streams, mesh=mesh, chunk_hops=2, **kw)
    cfg_b = SpectrogramConfig(sample_rate=16000.0, window_period=0.016, hop_period=0.004,
                              viewport_height=128, viewport_rows=16)
    for _ in range(n_streams):
        mgr.add_stream(cfg)
    mgr.add_stream(cfg_b, palette_id=3)
    mgr.set_palette(1, 5)
    for g in mgr.groups():
        rows = mgr.push_group(g.cfg, torch.zeros((2, g.pipeline.chunk_size, 2), device=dev))
        assert rows.shape[0] == 2
    assert mgr.metrics()["groups"] == 2

    # a DCP save -> restore onto the mesh -> one more step
    ck_pipe = SpectrogramPipeline(cfg, chunk_hops=4, palette_sort=False, **kw)
    cks = pmesh.sharded_init(ck_pipe, n_streams, mesh)
    cks, _ = _step_once(pmesh, ck_pipe, mesh, cks, n_streams)
    ck_dir = pathlib.Path(args.workdir) / "ck"
    checkpoint.save_sharded(ck_dir, cks, cfg, pipeline=ck_pipe, mesh=mesh)
    rst = checkpoint.load_sharded(ck_dir, ck_pipe, mesh)
    if not torch.equal(rst.carry, cks.carry):
        raise AssertionError("the restored carry differs from the saved one")
    _step_once(pmesh, ck_pipe, mesh, rst, n_streams)

    torch.distributed.barrier()
    if pmesh.mesh_rank(mesh) == 0:
        print(f"dryrun OK: {n} ranks ({torch.distributed.get_backend()}, {dev}), "
              f"{n_streams} streams, rgba {tuple(rgba.shape)} a rank, viewport "
              f"{tuple(viewport.shape)}, packed {tuple(packed.shape)}, classes "
              f"{['display', 'packed', 'generic_tables'] + classes + ['multirate_mesh', 'dcp_mesh_cycle']}",
              flush=True)
    torch.distributed.destroy_process_group()


def launch(ranks: int, device=None, backend=None, timeout: float = RANK_TIMEOUT_S) -> int:
    """Start `ranks` rank processes of this module and wait for them;
    prints rank 0's OK line (every rank's output when one fails)."""
    from spectrogram_tpu_torch.parallel.distributed import run_ranks

    with tempfile.TemporaryDirectory() as td:
        def argv(r: int) -> list[str]:
            cmd = [sys.executable, "-m", "spectrogram_tpu_torch.parallel.dryrun", "--rank", str(r),
                   "--world", str(ranks), "--init", f"file://{td}/rendezvous", "--workdir", td]
            if device is not None:
                cmd += ["--device", device]
            if backend is not None:
                cmd += ["--backend", backend]
            return cmd

        results = run_ranks(argv, ranks, timeout, pathlib.Path(td) / "logs")
    if all(rc == 0 for rc, _ in results):
        print(next(line for line in results[0][1].splitlines() if line.startswith("dryrun OK")),
              flush=True)
        return 0
    for r, (rc, out) in enumerate(results):
        print(f"--- rank {r}: exit {rc}\n{out[-4000:]}", flush=True)
    return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2, help="rank processes to start")
    ap.add_argument("--device", default=None,
                    help="every rank's device (default cuda:LOCAL_RANK)")
    ap.add_argument("--backend", default=None, help="nccl or gloo (default by device)")
    ap.add_argument("--timeout", type=float, default=RANK_TIMEOUT_S,
                    help="seconds the ranks may take in all")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--workdir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        rank_main(args)
        return 0
    return launch(args.ranks, args.device, args.backend, args.timeout)


if __name__ == "__main__":
    sys.exit(main())
