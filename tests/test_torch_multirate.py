"""The port's StreamGroupManager against the JAX package's, on the CPU.

The same seeded numpy PCM goes through both managers: the JAX one as
`tests/test_multirate.py` runs it (its CPU pipelines, or its Pallas kernels
in interpret mode where the palette sort must engage), the port's with
`device="cpu"` (the plain versions).  The geometries are that file's:
CFG_A / CFG_B (8 and 16 kHz) and its three ingest rates (48, 44.1 and
96 kHz; 44.1 kHz has N=1410, which the card serves on the Bluestein body),
and one BENCH_CONFIG-width group (N=4096, hop 800) at H=64 with a few
streams.  The bars:

  * rows within 1 u8 per channel of JAX's over what the image shows
    (`testing.rgba_u8_diff`); carries exactly equal;
  * inside the port: int16 wire rows equal the f32 drain's bit for bit, and
    a reused slot's next rows equal a fresh stream's bit for bit;
  * membership, locations, metrics and drop counts equal to JAX's.

Mesh mode runs in two gloo ranks (`tests/torch_ranks.py`, group
"multirate"), each holding its slice of every group: the gathered rows
equal the port's single manager's bit for bit and lie within 1 u8 of the
JAX manager's on a 2-device mesh.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectrogram_tpu.config as jcfg
from spectrogram_tpu.models.multirate import StreamGroupManager as JaxManager

import torch_ranks as tr

import spectrogram_tpu_torch.config as tcfg
from spectrogram_tpu_torch import testing
from spectrogram_tpu_torch.config import BENCH_CONFIG, SpectrogramConfig
from spectrogram_tpu_torch.io import ring as ring_mod
from spectrogram_tpu_torch.models.multirate import StreamGroupManager
from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline

torch.set_num_threads(2)

A_KW = dict(sample_rate=8000.0, window_period=0.032, hop_period=0.008,
            viewport_height=64, viewport_rows=16)
B_KW = dict(sample_rate=16000.0, window_period=0.016, hop_period=0.004,
            viewport_height=64, viewport_rows=16)
CFG_A, JCFG_A = SpectrogramConfig(**A_KW), jcfg.SpectrogramConfig(**A_KW)
CFG_B, JCFG_B = SpectrogramConfig(**B_KW), jcfg.SpectrogramConfig(**B_KW)
# the JAX Pallas chain in interpret mode: where JAX's palette sort engages
JAX_KW = dict(stft_backend="pallas", colormap_backend="pallas", kernel_interpret=True)


def _managers(**kw):
    """(port manager on the CPU, JAX manager) with the same arguments."""
    return StreamGroupManager(device="cpu", **kw), JaxManager(**kw)


def _group(mgr, cfg):
    return next(g for g in mgr.groups() if g.cfg == cfg)


def _assert_rows_close(port_rows, jax_rows):
    port_rows = port_rows.numpy() if isinstance(port_rows, torch.Tensor) else port_rows
    jax_rows = np.asarray(jax_rows)
    assert port_rows.shape == jax_rows.shape
    assert testing.rgba_u8_diff(port_rows, jax_rows) <= 1


def _push_both(tm, jm, tcfg, jcfg_, chunk):
    """One push_group on both managers: rows within the bar, carries equal."""
    tr = tm.push_group(tcfg, chunk)
    jr = jm.push_group(jcfg_, jnp.asarray(chunk))
    _assert_rows_close(tr, jr)
    np.testing.assert_array_equal(_group(tm, tcfg).state.carry.numpy(),
                                  np.asarray(_group(jm, jcfg_).state.carry))
    return tr, jr


def _chunk(mgr, cfg, seed, kind="noise"):
    g = _group(mgr, cfg)
    return testing.make(kind, len(g.state.palette_id), g.pipeline.chunk_size,
                        cfg.sample_rate, seed=seed)


def test_groups_by_geometry():
    for mgr, (a, b) in ((StreamGroupManager(group_capacity=4, chunk_hops=2, device="cpu"),
                         (CFG_A, CFG_B)),
                        (JaxManager(group_capacity=4, chunk_hops=2), (JCFG_A, JCFG_B))):
        a0 = mgr.add_stream(a)
        a1 = mgr.add_stream(a, palette_id=2)
        b0 = mgr.add_stream(b)
        assert len(list(mgr.groups())) == 2
        assert mgr.location(a0)[1] == 0 and mgr.location(a1)[1] == 1
        assert mgr.location(b0)[0] == b
        m = mgr.metrics()
        assert m["groups"] == 2 and m["streams"] == 3
        assert m["rows_produced"] == {"8000Hz/w256": 0, "16000Hz/w256": 0}


def test_groups_advance_independently():
    tm, jm = _managers(group_capacity=2, chunk_hops=2)
    for mgr, (a, b) in ((tm, (CFG_A, CFG_B)), (jm, (JCFG_A, JCFG_B))):
        mgr.add_stream(a)
        mgr.add_stream(b, palette_id=0)
    chunk = _chunk(tm, CFG_A, seed=1, kind="chirp_tone")
    tr, _ = _push_both(tm, jm, CFG_A, JCFG_A, chunk)
    assert tr.shape == (2, 2, 64, 4)
    assert int(_group(tm, CFG_A).state.row_count) == 2
    assert int(_group(tm, CFG_B).state.row_count) == 0  # untouched group unchanged
    _push_both(tm, jm, CFG_B, JCFG_B, _chunk(tm, CFG_B, seed=2, kind="chirp_tone"))
    _push_both(tm, jm, CFG_A, JCFG_A, _chunk(tm, CFG_A, seed=3))
    assert tm.metrics() == jm.metrics()


def test_capacity_and_detach():
    for mgr, a in ((StreamGroupManager(group_capacity=2, chunk_hops=2, device="cpu"), CFG_A),
                   (JaxManager(group_capacity=2, chunk_hops=2), JCFG_A)):
        s0 = mgr.add_stream(a)
        mgr.add_stream(a)
        with pytest.raises(RuntimeError, match="full"):
            mgr.add_stream(a)
        mgr.remove_stream(s0)
        with pytest.raises(KeyError):
            mgr.location(s0)


def test_per_stream_palette_update():
    tm, jm = _managers(group_capacity=2, chunk_hops=2)
    ids = {}
    for mgr, a in ((tm, CFG_A), (jm, JCFG_A)):
        ids[mgr] = (mgr.add_stream(a, palette_id=1), mgr.add_stream(a, palette_id=0))
        mgr.set_palette(ids[mgr][0], 7)
    g = _group(tm, CFG_A)
    assert g.state.palette_id.tolist() == [7, 0]
    np.testing.assert_array_equal(g.state.palette_id.numpy(),
                                  np.asarray(_group(jm, JCFG_A).state.palette_id))
    _push_both(tm, jm, CFG_A, JCFG_A, _chunk(tm, CFG_A, seed=4, kind="chirp_tone"))
    # one stream's palette changes, the other's rows do not
    tm.set_palette(ids[tm][1], 12)
    jm.set_palette(ids[jm][1], 12)
    _push_both(tm, jm, CFG_A, JCFG_A, _chunk(tm, CFG_A, seed=5, kind="chirp_tone"))


def test_slot_reuse_after_detach():
    mgr = StreamGroupManager(group_capacity=2, chunk_hops=2, device="cpu")
    s0 = mgr.add_stream(CFG_A)
    s1 = mgr.add_stream(CFG_A)
    mgr.remove_stream(s0)
    s2 = mgr.add_stream(CFG_A)           # must reuse s0's slot
    assert mgr.location(s2)[1] == 0
    mgr.remove_stream(s1)
    s3 = mgr.add_stream(CFG_A)           # reuses s1's slot
    assert mgr.location(s3)[1] == 1
    with pytest.raises(RuntimeError):
        mgr.add_stream(CFG_A)            # now genuinely full


# (capacity, palette of stream i, the slot detached and reused, arguments):
# per-row tables with the ring, and the carry-sort mode (palette_sort, no
# ring), where the carry rests in sorted stream order
REUSE = {
    "per_row": (2, lambda i: 1 + i, 0, dict(chunk_hops=2)),
    "carry_sort": (256, lambda i: i % 2, 5,
                   dict(chunk_hops=1, store_ring=False, palette_sort=True, **JAX_KW)),
}


@pytest.mark.parametrize("mode", sorted(REUSE))
def test_slot_reuse_zeroes_state(mode):
    """A reused slot inherits neither the dead stream's carry samples nor
    its ring rows, the survivors keep theirs, and the new tenant's first
    rows equal a fresh stream's bit for bit; rows within 1 u8 of JAX's
    manager, carries equal."""
    cap, palette, slot, kw = REUSE[mode]
    tm, jm = _managers(group_capacity=cap, **kw)
    sids = {tm: [], jm: []}
    for mgr, a in ((tm, CFG_A), (jm, JCFG_A)):
        sids[mgr] = [mgr.add_stream(a, palette_id=palette(i)) for i in range(cap)]
    g, jg = _group(tm, CFG_A), _group(jm, JCFG_A)
    sorted_state = g.pipeline.palette_layout.read(g.state.tables).sorted
    assert sorted_state == (mode == "carry_sort")
    assert sorted_state == (jg.pipeline._state_perm(jg.state) is not None)
    _push_both(tm, jm, CFG_A, JCFG_A, _chunk(tm, CFG_A, seed=6))
    crow = slot
    if sorted_state:
        inv = g.pipeline.palette_layout.global_perms(g.state.tables)[1]
        crow = int(inv[slot])
        assert crow != slot
    before = g.state.carry.clone()
    assert float(before[crow].abs().max()) > 0.0
    for mgr, a in ((tm, CFG_A), (jm, JCFG_A)):
        mgr.remove_stream(sids[mgr][slot])
        new = mgr.add_stream(a, palette_id=palette(slot))
        assert mgr.location(new)[1] == slot
    assert float(g.state.carry[crow].abs().max()) == 0.0
    if g.state.ring.shape[1]:
        assert float(g.state.ring[slot].float().abs().max()) == 0.0
    keep = torch.arange(cap) != crow
    torch.testing.assert_close(g.state.carry[keep], before[keep], rtol=0, atol=0)
    np.testing.assert_array_equal(g.state.carry.numpy(), np.asarray(jg.state.carry))

    chunk = _chunk(tm, CFG_A, seed=7, kind="chirp_tone")
    rows, _ = _push_both(tm, jm, CFG_A, JCFG_A, chunk)
    fresh_p = SpectrogramPipeline(CFG_A, device="cpu", **kw)
    fresh = fresh_p.set_palette(fresh_p.init_state(cap),
                                np.array([palette(i) for i in range(cap)]))
    _, want = fresh_p.push(fresh, torch.from_numpy(chunk))
    assert torch.equal(rows[slot], want[slot])


def test_gc_empty_groups():
    for mgr, (a, b) in ((StreamGroupManager(group_capacity=2, chunk_hops=2, device="cpu"),
                         (CFG_A, CFG_B)),
                        (JaxManager(group_capacity=2, chunk_hops=2), (JCFG_A, JCFG_B))):
        sa = mgr.add_stream(a)
        sb = mgr.add_stream(b)
        assert mgr.metrics()["groups"] == 2
        mgr.remove_stream(sa)
        assert mgr.gc_empty_groups() == 1          # CFG_A group collected
        assert mgr.metrics()["groups"] == 1
        mgr.remove_stream(sb)
        assert mgr.gc_empty_groups() == 1
        assert mgr.metrics()["groups"] == 0
        # a fresh add after GC rebuilds the group cleanly
        c = mgr.add_stream(a)
        assert mgr.location(c)[1] == 0


def _ingest_cfgs(config):
    mk = lambda fs, hp: config.SpectrogramConfig(
        sample_rate=fs, window_period=0.016, hop_period=hp,
        viewport_height=64, viewport_rows=16, max_frequency=min(fs / 2 - 100, 22030),
    )
    return mk(48000.0, 0.004), mk(44100.0, 0.006), mk(96000.0, 0.002)


def _tones(cfg, seconds, j):
    n = int(seconds * cfg.sample_rate)
    t = np.arange(n) / cfg.sample_rate
    x = (np.sin(2 * np.pi * 440.0 * (j + 1) * t) * 20000).astype(np.int16)
    return np.stack([x, x], axis=-1)


@pytest.mark.parametrize("wire_int16", [False, True])
def test_ingest_end_to_end_three_geometries(wire_int16):
    """Three geometries at 8 / 12 / 4 ms cadences, each group ticking from
    its own RingBank16 (N=1410 at 44.1 kHz); the same blocks as JAX's
    manager fed the same PCM on the same clock, per-group drop counters."""
    from spectrogram_tpu.io import ring as jring

    if not (ring_mod.native_available() and jring.native_available()):
        pytest.skip("native ring library unavailable")
    cfgs = {"port": _ingest_cfgs(tcfg),
            "jax": _ingest_cfgs(jcfg)}
    assert cfgs["port"][1].padded_size == 1410
    kw = dict(group_capacity=2, chunk_hops=2, ingest=True, ring_capacity=32768,
              feeder_depth=2, wire_int16=wire_int16)
    mgrs = {"port": StreamGroupManager(device="cpu", **kw), "jax": JaxManager(**kw)}
    blocks = {}
    for side, mgr in mgrs.items():
        ids = {cfg: [mgr.add_stream(cfg), mgr.add_stream(cfg)] for cfg in cfgs[side]}
        for cfg in cfgs[side]:
            for j, sid in enumerate(ids[cfg]):
                assert mgr.push_pcm(sid, _tones(cfg, 0.3, j)) == int(0.3 * cfg.sample_rate)
        got, now = {}, 100.0
        for _ in range(25):                    # 25 x 4 ms = 100 ms simulated
            for cfg, blk in mgr.tick(now).items():
                got.setdefault(cfg.sample_rate, []).append(np.asarray(blk))
            now += 0.004
        for cfg, blks in mgr.flush().items():
            got.setdefault(cfg.sample_rate, []).extend(np.asarray(b) for b in blks)
        blocks[side] = got
        m = mgr.metrics()
        rows = {k.split("/")[0]: v for k, v in m["rows_produced"].items()}
        assert rows == {"48000Hz": 2 * 13, "44100Hz": 2 * 9, "96000Hz": 2 * 25}, rows
        assert all(v == 0 for v in m["dropped"].values()), m
        # overrun is counted per group: flood one 32768-frame ring
        mgr.push_pcm(ids[cfgs[side][0]][0], np.zeros((70000, 2), np.int16))
        assert mgr.metrics()["dropped"]["48000Hz/w768"] > 0
    assert blocks["port"].keys() == blocks["jax"].keys()
    for rate, blks in blocks["port"].items():
        assert len(blks) == len(blocks["jax"][rate])
        for a, b in zip(blks, blocks["jax"][rate]):
            assert a.shape == b.shape and a.shape[0] == 2 and a.shape[2:] == (64, 4)
            assert testing.rgba_u8_diff(a, b) <= 1
    assert len(np.unique(blocks["port"][48000.0][0])) > 4   # tones, not silence


def test_slot_reuse_resets_backlog():
    if not ring_mod.native_available():
        pytest.skip("native ring library unavailable")
    mgr = StreamGroupManager(group_capacity=2, chunk_hops=2, ingest=True, device="cpu")
    s0 = mgr.add_stream(CFG_A)
    mgr.add_stream(CFG_A)
    mgr.push_pcm(s0, np.ones((500, 2), np.int16) * 1000)
    g = next(mgr.groups())
    assert g.bank.size(0) == 500
    mgr.remove_stream(s0)
    s2 = mgr.add_stream(CFG_A)
    assert mgr.location(s2)[1] == 0
    assert g.bank.size(0) == 0  # dead tenant's backlog discarded
    # every mutation reached the feeder's state: the state it pushes next
    assert g.feeder.state is g.state
    mgr.set_palette(s2, 9)
    assert g.feeder.state is g.state and int(g.feeder.state.palette_id[0]) == 9


def _wire_run(make_mgr, cfg, wire):
    rng = np.random.default_rng(3)
    mgr = make_mgr(group_capacity=2, ingest=True, wire_int16=wire, chunk_hops=2,
                   store_ring=False)
    sid = mgr.add_stream(cfg)
    mgr.push_pcm(sid, rng.integers(-32768, 32768, size=(6000, 2)).astype(np.int16))
    outs, now = [], 0.0
    for _ in range(4):
        now += 10.0
        outs.extend(np.asarray(r) for r in mgr.tick(now).values())
    return outs


def test_int16_wire_matches_f32():
    """wire_int16=True ticks out the f32 drain's rows bit for bit; both
    within 1 u8 of JAX's f32 drain."""
    if not ring_mod.native_available():
        pytest.skip("native ring library unavailable")
    port = lambda **kw: StreamGroupManager(device="cpu", **kw)
    a, b = _wire_run(port, CFG_A, False), _wire_run(port, CFG_A, True)
    want = _wire_run(JaxManager, JCFG_A, False)
    assert len(a) == len(b) == len(want) > 0
    for x, y, w in zip(a, b, want):
        np.testing.assert_array_equal(x, y)
        assert testing.rgba_u8_diff(x, w) <= 1


def test_bench_width_group_matches_jax():
    """A BENCH_CONFIG-width group (W=2048, N=4096, hop 800) at H=64, four
    streams on scattered palettes, k=1, no ring, beside an 8 kHz group."""
    b64 = dataclasses.replace(BENCH_CONFIG, viewport_height=64)
    jb64 = dataclasses.replace(jcfg.BENCH_CONFIG, viewport_height=64)
    kw = dict(group_capacity=4, chunk_hops=1, store_ring=False)
    tm, jm = _managers(**kw)
    for mgr, (b, a) in ((tm, (b64, CFG_A)), (jm, (jb64, JCFG_A))):
        for i in range(4):
            mgr.add_stream(b, palette_id=(5 * i) % 19)
        mgr.add_stream(a)
    assert _group(tm, b64).state.ring.shape[1] == 0       # pipeline_kwargs reach it
    for seed in range(3):
        _push_both(tm, jm, b64, jb64, _chunk(tm, b64, seed=10 + seed, kind="chirp_tone"))
    assert tm.metrics() == jm.metrics()


@pytest.fixture(scope="module")
def mesh_ranks(tmp_path_factory):
    """The port's mesh managers in two gloo ranks on the CPU
    (`tests/torch_ranks.py`, group "multirate")."""
    return tr.spawn("multirate", tmp_path_factory.mktemp("multirate_ranks"))


@pytest.fixture(scope="module")
def mesh_reference():
    """The JAX manager on a 2-device mesh and the port's single manager,
    driven as the ranks drive theirs (`torch_ranks.manager`): rows before
    and after `set_palette(1, 5)`, and metrics."""
    from spectrogram_tpu.parallel import mesh as jmesh

    tm = StreamGroupManager(group_capacity=4, chunk_hops=2, device="cpu")
    jm = JaxManager(group_capacity=4, chunk_hops=2, mesh=jmesh.make_mesh(2))
    rows = {"port": [], "jax": []}
    for mgr, (a, b), key in ((tm, (CFG_A, CFG_B), "port"), (jm, (JCFG_A, JCFG_B), "jax")):
        for _ in range(4):
            mgr.add_stream(a)
        mgr.add_stream(b, palette_id=3)
        chunks = [tr.pcm(20 + i, 4, _group(mgr, cfg).pipeline.chunk_size)
                  for i, cfg in enumerate((a, b))]
        for cfg, ch in zip((a, b), chunks):
            rows[key].append(np.asarray(mgr.push_group(cfg, _wrap(key, ch))))
        mgr.set_palette(1, 5)
        rows[key].append(np.asarray(mgr.push_group(a, _wrap(key, chunks[0]))))
    return rows, tm.metrics(), jm.metrics()


def _wrap(key, chunk):
    return torch.from_numpy(chunk) if key == "port" else jnp.asarray(chunk)


@pytest.mark.parametrize("when", ["before_set_palette", "after_set_palette"])
def test_mesh_manager_matches_single_manager(mesh_ranks, mesh_reference, when):
    """Mesh mode: every geometry group's state split over two ranks, each
    push_group the rank's own streams; the gathered rows equal the single
    manager's bit for bit and lie within 1 u8 of the JAX mesh manager's,
    before and after a mid-stream palette edit."""
    got = tr.result(mesh_ranks, "manager")
    rows, _, _ = mesh_reference
    keys = ("rows0", "rows1") if when == "before_set_palette" else ("rows_after",)
    idx = (0, 1) if when == "before_set_palette" else (2,)
    for k, i in zip(keys, idx):
        np.testing.assert_array_equal(got[k], rows["port"][i])
        _assert_rows_close(got[k], rows["jax"][i])
    assert int(got["local0"]) == 2


def test_mesh_manager_metrics(mesh_ranks, mesh_reference):
    got = tr.result(mesh_ranks, "manager")
    _, port_metrics, jax_metrics = mesh_reference
    assert json.loads(str(got["metrics"])) == port_metrics == jax_metrics
    assert "this rank's chunk" in str(got["wrong_chunk"])


@pytest.mark.parametrize("error", ["ingest", "divide"])
def test_mesh_manager_errors(mesh_ranks, error):
    """JAX's two refusals: mesh + ingest, and a capacity the mesh cannot
    split evenly."""
    got = str(tr.result(mesh_ranks, "manager")[error])
    assert ("mesh + ingest" if error == "ingest" else "must divide evenly over the 2-device mesh") in got


def test_mesh_manager_sorts_per_shard(mesh_ranks):
    """A carry-sort group (k=1, no ring) of 512 slots on palettes i % 2:
    each rank holds a per-shard sorted slice; a reused slot and a palette
    edit keep it sorted, and the gathered rows equal the single manager's
    bit for bit throughout."""
    got = tr.result(mesh_ranks, "manager_sorted")
    assert bool(got["sorted"]) and bool(got["sorted_after"])
    s_n = tr.SORT_STREAMS
    mgr = StreamGroupManager(group_capacity=s_n, device="cpu", **tr.STREAM_KW)
    ids = tr.alternating(s_n)
    sids = [mgr.add_stream(CFG_A, palette_id=int(i)) for i in ids]
    g = _group(mgr, CFG_A)
    hops = [tr.pcm(30 + i, s_n, g.pipeline.chunk_size) for i in range(3)]
    np.testing.assert_array_equal(got["rows0"], mgr.push_group(CFG_A, hops[0]).numpy())
    mgr.remove_stream(sids[300])
    mgr.add_stream(CFG_A, palette_id=1 - int(ids[300]))
    mgr.set_palette(sids[7], 4)
    for i in (1, 2):
        np.testing.assert_array_equal(got[f"rows{i}"], mgr.push_group(CFG_A, hops[i]).numpy())


def test_manager_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        assert StreamGroupManager().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamGroupManager()
    mgr = StreamGroupManager(device="cpu", chunk_hops=2)
    mgr.add_stream(CFG_A)
    assert next(mgr.groups()).pipeline.device == torch.device("cpu")
