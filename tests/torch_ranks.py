"""Rank processes for the port's mesh tests (not a pytest file).

    python tests/torch_ranks.py <group> <rank> <world> <init_method> <out_dir>

Each rank brings up a gloo process group on the CPU (group "card": NCCL on
the rank's card) over the given `file://` rendezvous, builds the `streams` mesh and runs every scenario of
`<group>` in order; scenario `name` writes `out_dir/<name>_r<rank>.npz`.
The test files start their ranks once per module (`spawn`) and read those
results in their checks.  The ranks import torch, numpy and the port only;
the JAX side of each comparison runs in the pytest process.  The inputs
come from numpy seeds (`pcm`), so both sides make the same samples.
"""

from __future__ import annotations

import json
import os
import pathlib
import sys

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from spectrogram_tpu_torch.config import SpectrogramConfig  # noqa: E402
from spectrogram_tpu_torch.models.multirate import StreamGroupManager  # noqa: E402
from spectrogram_tpu_torch.models.palette_layout import PaletteLayout  # noqa: E402
from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline  # noqa: E402
from spectrogram_tpu_torch.parallel import distributed as pdist  # noqa: E402
from spectrogram_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from spectrogram_tpu_torch.utils import checkpoint  # noqa: E402

RANK_TIMEOUT_S = 240.0
WORLD = 2

CFG_KW = dict(sample_rate=8000.0, window_period=0.032, hop_period=0.008,
              viewport_height=64, viewport_rows=16)
CFG_B_KW = dict(sample_rate=16000.0, window_period=0.016, hop_period=0.004,
                viewport_height=64, viewport_rows=16)
DIST_KW = dict(sample_rate=8000.0, window_period=0.032, hop_period=0.008,
               viewport_height=128, viewport_rows=16, max_frequency=3600.0)
CFG = SpectrogramConfig(**CFG_KW)
CFG_B = SpectrogramConfig(**CFG_B_KW)
DIST_CFG = SpectrogramConfig(**DIST_KW)
# the streaming serving mode: k=1, no ring, packed rows
STREAM_KW = dict(chunk_hops=1, store_ring=False, packed_output=True)
SORT_STREAMS = 512          # 256 a rank: alternating ids sort into 128-stream runs


def pcm(seed: int, s: int, n: int, scale: float = 0.2) -> np.ndarray:
    """[s, n, 2] f32 noise from a numpy seed."""
    return (np.random.default_rng(seed).standard_normal((s, n, 2)) * scale).astype(np.float32)


def alternating(s: int, shift: int = 0) -> np.ndarray:
    return ((np.arange(s) + shift) % 2).astype(np.int32)


def tones(lo: int, n_local: int, n: int, rate: float) -> np.ndarray:
    """[n_local, n, 2] int16 tones of global streams lo.., each stream its
    own pitch (the JAX package's two-process worker's PCM)."""
    t = np.arange(n) / rate
    out = np.empty((n_local, n, 2), np.int16)
    for i in range(n_local):
        x = (np.sin(2 * np.pi * 200.0 * (1 + (lo + i) % 8) * t) * 20000).astype(np.int16)
        out[i] = np.stack([x, x], axis=-1)
    return out


def _pipe(cfg=CFG, **kw) -> SpectrogramPipeline:
    return SpectrogramPipeline(cfg, device="cpu", **kw)


def _local(mesh, x: np.ndarray) -> torch.Tensor:
    lo, hi = pmesh.local_stream_range(mesh, x.shape[0])
    return torch.from_numpy(np.ascontiguousarray(x[lo:hi]))


def _gather(mesh, t: torch.Tensor) -> np.ndarray:
    return pmesh.gather_streams(t, mesh).numpy()


def _message(fn) -> str:
    try:
        fn()
    except (ValueError, RuntimeError) as exc:
        return f"{type(exc).__name__}: {exc}"
    return ""


def _global_perm(state, mesh) -> np.ndarray:
    """A per-shard sorted slice's perm in the global view (JAX's form)."""
    lo, _ = pmesh.local_stream_range(mesh, state.palette_id.shape[0] * mesh.size())
    return _gather(mesh, PaletteLayout.read(state.tables).perm + lo)


# ----------------------------------------------------------------- mesh

def mesh_info(mesh, out):
    return dict(size=mesh.size(), names=np.array(",".join(mesh.mesh_dim_names)),
                range=np.array(pmesh.local_stream_range(mesh, 16)),
                device=np.array(str(pmesh.rank_device())))


def sharded_vs_single(mesh, out):
    p = _pipe(chunk_hops=4)
    step = pmesh.sharded_push(p, mesh)
    s = pmesh.shard_state(p.init_state(16), mesh)
    s, rows = step(s, _local(mesh, pcm(1, 16, p.chunk_size)))
    return dict(rows=_gather(mesh, rows), cursor=int(s.cursor),
                ring_shape=np.array(s.ring.shape), carry=_gather(mesh, s.carry))


def global_rows(mesh, out):
    p = _pipe(chunk_hops=4)
    step = pmesh.shard_map_step(p, mesh)
    s = pmesh.shard_state(p.init_state(8), mesh)
    s, rows, g = step(s, _local(mesh, pcm(2, 8, p.chunk_size)))
    return dict(global_rows=int(g), rows_shape=np.array(rows.shape),
                metrics=np.array(json.dumps(pmesh.global_metrics(s, mesh))))


def ring_render(mesh, out):
    p = _pipe(chunk_hops=4)
    step = pmesh.sharded_push(p, mesh)
    s = pmesh.shard_state(p.init_state(8), mesh)
    for i in range(3):
        s, _ = step(s, _local(mesh, pcm(10 + i, 8, p.chunk_size)))
    return dict(viewport=_gather(mesh, p.render_viewport(s)),
                ring=_gather(mesh, s.ring.float()), cursor=int(s.cursor))


def packed(mesh, out):
    p = _pipe(chunk_hops=4, store_ring=False, packed_output=True)
    chunk = _local(mesh, pcm(3, 8, p.chunk_size))
    s, rows = pmesh.sharded_push(p, mesh)(pmesh.shard_state(p.init_state(8), mesh), chunk)
    s2, rows2, g = pmesh.shard_map_step(p, mesh)(pmesh.shard_state(p.init_state(8), mesh), chunk)
    return dict(rows=_gather(mesh, rows), rows2=_gather(mesh, rows2), global_rows=int(g),
                dtype=np.array(str(rows.dtype)))


def chain(mesh, out):
    p = _pipe(chunk_hops=4, packed_output=True)
    s = pmesh.sharded_init(p, 16, mesh)
    s, rows, g = pmesh.shard_map_step(p, mesh)(s, _local(mesh, pcm(4, 16, p.chunk_size, 0.3)))
    return dict(rows=_gather(mesh, rows), ring=_gather(mesh, s.ring.float()), global_rows=int(g))


def unsorts(mesh, out):
    p = _pipe(**STREAM_KW)
    s_n = 256
    ids = alternating(s_n)
    s = p.set_palette(p.init_state(s_n), ids)
    refused = _message(lambda: pmesh.shard_state(s, mesh))
    sh = pmesh.shard_state(s, mesh, p)
    sh1, rows = pmesh.sharded_push(p, mesh)(sh, _local(mesh, pcm(5, s_n, p.chunk_size)))
    sh2 = pmesh.sharded_set_palette(p, sh1, ids, mesh)
    return dict(whole_sorted=p.palette_layout.read(s.tables).sorted, refused=np.array(refused),
                sharded_sorted=p.palette_layout.read(sh.tables).sorted, rows=_gather(mesh, rows),
                resorted=p.palette_layout.read(sh2.tables).sorted)


def resorts(mesh, out):
    p = _pipe(**STREAM_KW)
    s_n = SORT_STREAMS
    ids, ids2 = alternating(s_n), alternating(s_n, 1)
    sh = pmesh.shard_state(p.set_palette(p.init_state(s_n), ids), mesh, p)
    res = dict(is_global=p.palette_layout.read(sh.tables).perm_global, perm=sh.tables[1].numpy(),
               inv=sh.tables[2].numpy(), carry_at_rest=sh.carry.numpy())
    sh1, rows, g = pmesh.shard_map_step(p, mesh)(sh, _local(mesh, pcm(6, s_n, p.chunk_size)))
    sh4 = pmesh.sharded_set_palette(p, sh1, ids2, mesh)
    res.update(rows=_gather(mesh, rows), global_rows=int(g),
               resorted=p.palette_layout.read(sh4.tables).perm_global)
    _, rows4 = pmesh.sharded_push(p, mesh)(sh4, _local(mesh, pcm(7, s_n, p.chunk_size)))
    sh5 = pmesh.sharded_set_palette(p, sh4, 3, mesh)
    u = p.unsort_state(sh4)
    res.update(rows4=_gather(mesh, rows4), uniform_sorted=p.palette_layout.read(sh5.tables).sorted,
               uniform_carry=_gather(mesh, sh5.carry), unsorted_carry=_gather(mesh, u.carry),
               unsort_is_plain=not p.palette_layout.read(u.tables).sorted)
    return res


def global_sort_refuses(mesh, out):
    p = _pipe(stream_blocks=128, **STREAM_KW)
    s_n = SORT_STREAMS
    s = p.set_palette(p.init_state(s_n), alternating(s_n))
    specs_refused = _message(lambda: pmesh._state_tables_specs(s.tables, mesh.size()))
    shard_refused = _message(lambda: pmesh.shard_state(s, mesh))
    sh = pmesh.shard_state(s, mesh, p)
    gp = _global_perm(sh, mesh)
    return dict(whole_global=p.palette_layout.read(s.tables).perm_global,
                whole_perm=s.tables[1].numpy(), specs_refused=np.array(specs_refused),
                shard_refused=np.array(shard_refused),
                sharded_global=p.palette_layout.read(sh.tables).perm_global,
                confined=pmesh._perm_shard_confined(gp, mesh.size()),
                whole_confined=pmesh._perm_shard_confined(s.tables[1], mesh.size()))


def sorted_npz_roundtrip(mesh, out):
    p = _pipe(**STREAM_KW)
    s_n = SORT_STREAMS
    sh = pmesh.shard_state(p.set_palette(p.init_state(s_n), alternating(s_n)), mesh, p)
    path = out / "sorted_ck.npz"
    checkpoint.save_state(path, sh, p.cfg, pipeline=p, mesh=mesh)
    r = checkpoint.load_state(path, p)
    rs = pmesh.shard_state(r, mesh, p)
    _, rows = pmesh.sharded_push(p, mesh)(rs, _local(mesh, pcm(8, s_n, p.chunk_size)))
    return dict(restored_sorted=p.palette_layout.read(r.tables).sorted,
                confined=pmesh._perm_shard_confined(_global_perm(rs, mesh), mesh.size()),
                rows=_gather(mesh, rows))


# ----------------------------------------------------------- distributed

def end_to_end(mesh, out):
    p = _pipe(DIST_CFG, chunk_hops=2, packed_output=True)
    s_n = 8 * mesh.size()
    ingest = pdist.HostShardIngest(mesh, s_n, p.chunk_size, capacity=4096)
    for i, x in enumerate(tones(ingest.lo, ingest.local_streams, p.chunk_size,
                                DIST_CFG.sample_rate)):
        ingest.bank.push(i, x)
    state = pmesh.sharded_init(p, s_n, mesh)
    state, rows, g = pmesh.shard_map_step(p, mesh)(state, ingest.drain())
    return dict(global_rows=int(g), range=np.array((ingest.lo, ingest.hi)),
                local_rows=rows.numpy(), rows=_gather(mesh, rows),
                unique=len(np.unique(rows.numpy())),
                metrics=np.array(json.dumps(ingest.metrics())),
                not_divisible=np.array(_message(lambda: pdist.local_stream_range(mesh, s_n + 1))))


def initialize_again(mesh, out):
    group = torch.distributed.group.WORLD
    pdist.initialize()
    pdist.initialize(init_method="file:///nonexistent", world_size=5, rank=3, device="cpu")
    nccl = _message(lambda: pdist.initialize(backend="nccl", device="cpu"))
    return dict(world=torch.distributed.get_world_size(),
                same_group=torch.distributed.group.WORLD is group, nccl=np.array(nccl))


# -------------------------------------------------------------- multirate

def manager(mesh, out):
    """StreamGroupManager on the mesh: four streams of CFG, one of CFG_B on
    palette 3, pushed; a palette edit; pushed again."""
    res = dict(
        ingest=np.array(_message(lambda: StreamGroupManager(
            group_capacity=4, mesh=mesh, ingest=True, device="cpu"))),
        divide=np.array(_message(lambda: StreamGroupManager(
            group_capacity=3, mesh=mesh, device="cpu"))),
    )
    mgr = StreamGroupManager(group_capacity=4, mesh=mesh, device="cpu", chunk_hops=2)
    for _ in range(4):
        mgr.add_stream(CFG)
    mgr.add_stream(CFG_B, palette_id=3)
    chunks = {}
    for i, cfg in enumerate((CFG, CFG_B)):
        g = next(g for g in mgr.groups() if g.cfg == cfg)
        chunks[cfg] = pcm(20 + i, 4, g.pipeline.chunk_size)
        res[f"rows{i}"] = _gather(mesh, mgr.push_group(cfg, _local(mesh, chunks[cfg])))
        res[f"local{i}"] = np.array(g.state.palette_id.shape[0])
    mgr.set_palette(1, 5)
    res["rows_after"] = _gather(mesh, mgr.push_group(CFG, _local(mesh, chunks[CFG])))
    res["metrics"] = np.array(json.dumps(mgr.metrics()))
    res["wrong_chunk"] = np.array(_message(lambda: mgr.push_group(CFG, chunks[CFG])))
    return res


def manager_sorted(mesh, out):
    """A carry-sort group (k=1, no ring) of 512 slots on palettes i % 2:
    the per-shard sort; a slot reused onto the other palette."""
    s_n = SORT_STREAMS
    mgr = StreamGroupManager(group_capacity=s_n, mesh=mesh, device="cpu", **STREAM_KW)
    sids = [mgr.add_stream(CFG, palette_id=int(i)) for i in alternating(s_n)]
    g = next(mgr.groups())
    res = dict(sorted=g.pipeline.palette_layout.read(g.state.tables).perm_global)
    hops = [pcm(30 + i, s_n, g.pipeline.chunk_size) for i in range(3)]
    res["rows0"] = _gather(mesh, mgr.push_group(CFG, _local(mesh, hops[0])))
    mgr.remove_stream(sids[300])
    mgr.add_stream(CFG, palette_id=1 - int(alternating(s_n)[300]))
    mgr.set_palette(sids[7], 4)
    for i in (1, 2):
        res[f"rows{i}"] = _gather(mesh, mgr.push_group(CFG, _local(mesh, hops[i])))
    res["sorted_after"] = g.pipeline.palette_layout.read(g.state.tables).perm_global
    return res


# ------------------------------------------------------------- checkpoints

def npz_from_sharded(mesh, out):
    p = _pipe(chunk_hops=4)
    step = pmesh.sharded_push(p, mesh)
    chunk = _local(mesh, pcm(40, 8, p.chunk_size))
    s, _ = step(pmesh.shard_state(p.init_state(8, palette_id=3), mesh), chunk)
    checkpoint.save_state(out / "sharded", s, p.cfg, mesh=mesh)
    restored = pmesh.shard_state(checkpoint.load_state(out / "sharded", p), mesh)
    restored, rows = step(restored, chunk)
    return dict(row_count=int(restored.row_count), rows=_gather(mesh, rows),
                local_ring=np.array(restored.ring.shape))


def dcp_cycle(mesh, out):
    p = _pipe(chunk_hops=2)
    st = pmesh.sharded_init(p, 16, mesh)
    step = pmesh.sharded_push(p, mesh)
    st, _ = step(st, _local(mesh, pcm(41, 16, p.chunk_size)))
    checkpoint.save_sharded(out / "ckpt", st, p.cfg, pipeline=p, mesh=mesh)
    st2 = checkpoint.load_sharded(out / "ckpt", p, mesh)
    res = dict(same=all(torch.equal(getattr(st, f).float(), getattr(st2, f).float())
                        for f in ("carry", "ring", "cursor", "palette_id", "row_count")),
               tables_equal=len(st.tables) == len(st2.tables)
               and all(torch.equal(a, b) for a, b in zip(st.tables, st2.tables)),
               carry=_gather(mesh, st.carry), ring=_gather(mesh, st.ring.float()))
    # a push writes the ring in place: gather the saved state first
    nxt = _local(mesh, pcm(42, 16, p.chunk_size))
    _, rows = step(st, nxt)
    _, rows2 = step(st2, nxt)
    return dict(res, rows=_gather(mesh, rows), rows2=_gather(mesh, rows2))


def dcp_sorted_streaming(mesh, out):
    """The serving mode's checkpoint: a per-shard sorted streaming state
    (no ring: the zero-size leaf is dropped), saved unsorted, restored onto
    the mesh in the per-shard sorted class again."""
    p = _pipe(**STREAM_KW)
    s_n = SORT_STREAMS
    st = pmesh.shard_state(p.set_palette(p.init_state(s_n), alternating(s_n)), mesh, p)
    step = pmesh.sharded_push(p, mesh)
    st, _ = step(st, _local(mesh, pcm(43, s_n, p.chunk_size)))
    refused = _message(lambda: checkpoint.save_sharded(out / "sorted_dcp", st, p.cfg,
                                                       pipeline=p, mesh=mesh))
    checkpoint.save_sharded(out / "sorted_dcp", p.unsort_state(st), p.cfg, pipeline=p,
                            mesh=mesh)
    st2 = checkpoint.load_sharded(out / "sorted_dcp", p, mesh)
    nxt = _local(mesh, pcm(44, s_n, p.chunk_size))
    _, rows = step(st, nxt)
    _, rows2 = step(st2, nxt)
    return dict(refused=np.array(refused), sorted=p.palette_layout.read(st2.tables).perm_global,
                carry_equal=torch.equal(st.carry, st2.carry), rows=_gather(mesh, rows),
                rows2=_gather(mesh, rows2))


def jax_npz_into_mesh(mesh, out):
    """An npz the JAX package wrote from its sharded state (the test
    writes it before starting the ranks), restored onto this mesh."""
    p = _pipe(chunk_hops=4)
    s = pmesh.shard_state(checkpoint.load_state(out / "jax_sharded", p), mesh)
    s, rows = pmesh.sharded_push(p, mesh)(s, _local(mesh, pcm(46, 8, p.chunk_size)))
    return dict(rows=_gather(mesh, rows), carry=_gather(mesh, s.carry))


# ------------------------------------------------------------------ card

def card_world1(mesh, out):
    """One rank under NCCL on the card: the mesh's push against the
    unsharded pipeline, the row count summed on the card, a DCP cycle."""
    dev = pmesh.rank_device()
    kw = dict(STREAM_KW, device=dev)
    p, rp = SpectrogramPipeline(CFG, **kw), SpectrogramPipeline(CFG, **kw)
    s_n = 1024
    ids = np.arange(s_n) % 19
    st = pmesh.sharded_set_palette(p, pmesh.sharded_init(p, s_n, mesh), ids, mesh)
    rs = rp.set_palette(rp.init_state(s_n), ids)
    step = pmesh.shard_map_step(p, mesh)
    same, total = True, 0
    for seed in range(3):
        chunk = torch.from_numpy(pcm(50 + seed, s_n, p.chunk_size)).to(dev)
        st, rows, g = step(st, chunk)
        rs, want = rp.push(rs, chunk)
        same &= torch.equal(rows, want)
        total += int(g)
    checkpoint.save_sharded(out / "card_dcp", p.unsort_state(st), CFG, pipeline=p, mesh=mesh)
    r = checkpoint.load_sharded(out / "card_dcp", p, mesh)
    return dict(same=same, total=total, backend=np.array(torch.distributed.get_backend()),
                sum_device=np.array(g.device.type), restored=torch.equal(r.carry, st.carry))


GROUPS = {
    "mesh": (mesh_info, sharded_vs_single, global_rows, ring_render, packed, chain, unsorts,
             resorts, global_sort_refuses, sorted_npz_roundtrip),
    "distributed": (end_to_end, initialize_again),
    "multirate": (manager, manager_sorted),
    "checkpoint": (npz_from_sharded, dcp_cycle, dcp_sorted_streaming, jax_npz_into_mesh),
    "card": (card_world1,),
}


def main() -> None:
    group, rank, world, init, out = sys.argv[1:6]
    torch.set_num_threads(1)
    out = pathlib.Path(out)
    # the "card" group takes the rank's card and NCCL, the others the CPU
    pdist.initialize(init_method=init, world_size=int(world), rank=int(rank),
                     device=None if group == "card" else "cpu")
    mesh = pdist.global_mesh()
    for fn in GROUPS[group]:
        np.savez(out / f"{fn.__name__}_r{rank}.npz", **fn(mesh, out))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"RANK_OK {rank}", flush=True)


def spawn(group: str, out: pathlib.Path, world: int = WORLD) -> dict:
    """Run `group`'s scenarios in `world` gloo ranks on the CPU, each
    process under RANK_TIMEOUT_S (killed when a peer fails).  Returns
    {"ok": bool, "log": text, "out": out}."""
    out = pathlib.Path(out)
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    results = pdist.run_ranks(
        lambda r: [sys.executable, str(pathlib.Path(__file__).resolve()), group, str(r),
                   str(world), f"file://{out}/rendezvous", str(out)],
        world, RANK_TIMEOUT_S, out / "logs", env=env, cwd=str(REPO))
    ok = all(rc == 0 for rc, _ in results)
    log = "\n".join(f"--- rank {r}: exit {rc}\n{text[-3000:]}"
                    for r, (rc, text) in enumerate(results))
    return dict(ok=ok, log=log, out=out)


def result(run: dict, name: str, rank: int = 0) -> dict:
    """Scenario `name`'s arrays from rank `rank`; fails the calling test
    with the ranks' output where the ranks failed."""
    path = run["out"] / f"{name}_r{rank}.npz"
    if not path.exists():
        raise AssertionError(f"no result {path.name}; the ranks said:\n{run['log']}")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


if __name__ == "__main__":
    main()
