"""npz checkpoints between the port and the JAX package, on the CPU.

`spectrogram_tpu_torch/utils/checkpoint.py` writes and reads the JAX
package's `.npz` + `.json` sidecar format.  For every state kind that
`models/convert.py` carries — the int16 carry, the transposed carry, the
palette-sorted 3-tuple (carry-sort mode, and with a ring) and 4-tuple
(global sort), the blockwise marker, a static palette's (), a generic
registry's (u, v), a bf16 ring and an f32 ring — in both directions:

  * JAX `save_state` -> port `load_state`: the restored fields equal the JAX
    state's (the ring exactly, the carry in the restoring pipeline's order),
    the derived tables equal those JAX's own `load_state` derives, and the
    next push's rows are within 1 u8 per channel of JAX continuing over
    what the image shows (`testing.rgba_u8_diff`), carries exact;
  * port `save_state` -> JAX `load_state`: the same, the other way round;
  * the two packages write the same file for the same state: equal fields,
    dtypes and shapes, and the same sidecar text.

Then the guards: geometry, `chunk_hops`, `viewport_rows`, `store_ring` and
carry-dtype mismatches raise, as `tests/test_session.py` checks for JAX; a
sorted state needs `pipeline=` to be saved; the carry converts between the
planar and transposed forms; the shapes are checked without building a
state (`init_state` is never called).

The JAX side runs its Pallas chain in interpret mode (the palette sort and
the int16 planes engage only there), at W=256, hop 64, H=64 and, for the
int16 planes, BENCH_CONFIG's W=2048 with H=64.
"""

import dataclasses
import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectrogram_tpu.config as jcfg
from spectrogram_tpu.color import colorscheme as jcs
from spectrogram_tpu.models.spectrogram import SpectrogramPipeline as JaxPipeline
from spectrogram_tpu.utils import checkpoint as jck

from spectrogram_tpu_torch import testing
from spectrogram_tpu_torch.color import colorscheme as tcs
from spectrogram_tpu_torch.config import BENCH_CONFIG, SpectrogramConfig
from spectrogram_tpu_torch.models.convert import state_from_jax, state_to_numpy
from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline
from spectrogram_tpu_torch.ops.cuda.colormap_kernel import unpack_rgba
from spectrogram_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(2)

SMALL = dict(sample_rate=8000.0, window_period=0.032, hop_period=0.008,
             viewport_height=64, viewport_rows=6)          # W=256, hop 64
BENCH64 = dict(dataclasses.asdict(BENCH_CONFIG), viewport_height=64)
JAX_KW = dict(stft_backend="pallas", colormap_backend="pallas", kernel_interpret=True)
STREAMING = dict(chunk_hops=1, store_ring=False)
IDS4 = np.array([0, 1, 3, 8])
# kind -> (geometry, pipeline arguments, streams, set_palette ids or None,
#          the state's tables structure)
KINDS = {
    "int16": (BENCH64, dict(STREAMING, i16_planes=True), 4, IDS4, "per_row"),
    "transposed": (SMALL, dict(chunk_hops=3, transposed_carry=True), 4, IDS4, "per_row"),
    "sorted": (SMALL, STREAMING, 256, np.arange(256) % 2, "sorted3"),
    "sorted_ring": (SMALL, dict(chunk_hops=2, viewport_rows=4), 256, np.arange(256) % 2,
                    "sorted3"),
    "global_sorted": (SMALL, dict(STREAMING, stream_blocks=128), 576, np.arange(576) % 2,
                      "sorted4"),
    "marked": (SMALL, STREAMING, 256, np.arange(256) // 128, "marked"),
    "static": (SMALL, dict(chunk_hops=2, static_palette="Magma"), 3, None, "static"),
    "generic": (SMALL, dict(STREAMING, generic=True), 4, IDS4 % 4, "generic"),
    "bf16_ring": (SMALL, dict(chunk_hops=2), 3, IDS4[:3], "per_row"),
    "f32_ring": (SMALL, dict(chunk_hops=2, ring_dtype="float32"), 3, IDS4[:3], "per_row"),
}


def _registry(mod):
    """smoke-custom (outside the built-in structure) and three built-ins."""
    return (mod.FactoredScheme("smoke-custom", *testing.custom_factors(),
                               background=(10, 10, 10)),
            *mod.DEFAULT_COLOR_SCHEMES[:3])


@functools.lru_cache(maxsize=None)
def _pipelines(kind: str):
    """(JAX pipeline, port pipeline) of `kind`, shared so that each JAX
    push structure compiles once."""
    geometry, kw, *_ = KINDS[kind]
    kw = dict(kw, packed_output=True)
    generic = kw.pop("generic", False)
    ring = kw.pop("ring_dtype", "bfloat16")
    jp = JaxPipeline(jcfg.SpectrogramConfig(**geometry), **JAX_KW, ring_dtype=getattr(jnp, ring),
                     schemes=_registry(jcs) if generic else None, **kw)
    tp = SpectrogramPipeline(SpectrogramConfig(**geometry), device="cpu",
                             ring_dtype=getattr(torch, ring),
                             schemes=_registry(tcs) if generic else None, **kw)
    return jp, tp


def _start(p, kind: str):
    _, _, s, ids, _ = KINDS[kind]
    state = p.init_state(s)
    return state if ids is None else p.set_palette(state, ids)


def _chunks(tp, kind: str, n: int, seed: int):
    s = KINDS[kind][2]
    pcm = testing.chirp_tone(s, n * tp.chunk_size, tp.cfg.sample_rate, seed=seed)
    if tp.i16_planes:
        pcm = np.round(pcm * 32767.0).astype(np.int16)
    return [np.ascontiguousarray(pcm[:, i * tp.chunk_size : (i + 1) * tp.chunk_size])
            for i in range(n)]


def _jnp(d) -> dict:
    out = {k: np.asarray(v) for k, v in d._asdict().items() if k != "tables"}
    out["tables"] = tuple(np.asarray(t) for t in d.tables)
    return out


def _structure(tables) -> str:
    tables = [np.asarray(t) for t in tables]
    if not tables:
        return "static"
    two_d = [t.ndim == 2 for t in tables]
    if len(tables) == 2 and all(two_d):
        return "generic"
    if len(tables) == 2:
        return "marked"
    return {1: "per_row", 3: "sorted3", 4: "sorted4"}[len(tables)]


def _assert_same_state(port, jax_state):
    """Every field equal: carry and ring exactly (the ring as f32), tables
    by structure and value."""
    got, want = state_to_numpy(port), _jnp(jax_state)
    for name in ("carry", "cursor", "palette_id", "row_count"):
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name])
    np.testing.assert_array_equal(got["ring"], want["ring"].astype(np.float32))
    assert port.ring.dtype == getattr(torch, str(jax_state.ring.dtype))
    assert [t.shape for t in got["tables"]] == [t.shape for t in want["tables"]]
    for a, b in zip(got["tables"], want["tables"]):
        np.testing.assert_array_equal(a, b)


def _push_both(jp, tp, js, ts, chunk):
    js, jr = jp.push(js, jnp.asarray(chunk))
    ts, tr = tp.push(ts, torch.from_numpy(chunk))
    assert testing.rgba_u8_diff(unpack_rgba(tr), unpack_rgba(np.asarray(jr))) <= 1
    np.testing.assert_array_equal(ts.carry.numpy(), np.asarray(js.carry))
    return js, ts


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_jax_checkpoint_loads_in_the_port(kind, tmp_path):
    jp, tp = _pipelines(kind)
    first, second = _chunks(tp, kind, 2, seed=21)
    js, _ = jp.push(_start(jp, kind), jnp.asarray(first))
    assert _structure(js.tables) == KINDS[kind][4]
    jck.save_state(tmp_path / "ck", js, jp.cfg, pipeline=jp)

    ts = tck.load_state(tmp_path / "ck", tp)
    jback = jck.load_state(tmp_path / "ck", jp)      # JAX's own restore
    _assert_same_state(ts, jback)
    _assert_same_state(ts, js)
    saved = _jnp(js)                 # the JAX push below donates js's buffers
    _push_both(jp, tp, js, ts, second)

    # the port writes the file JAX wrote, for the same state
    tck.save_state(tmp_path / "port", state_from_jax(saved, device="cpu",
                                                      ring_dtype=ts.ring.dtype),
                   tp.cfg, pipeline=tp)
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "ck.npz")
    assert sorted(a.files) == sorted(b.files)
    for name in b.files:
        assert a[name].dtype == b[name].dtype and a[name].shape == b[name].shape, name
        np.testing.assert_array_equal(a[name], b[name])
    assert (tmp_path / "port.json").read_text() == (tmp_path / "ck.json").read_text()


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_port_checkpoint_loads_in_jax(kind, tmp_path):
    jp, tp = _pipelines(kind)
    first, second = _chunks(tp, kind, 2, seed=22)
    ts, _ = tp.push(_start(tp, kind), torch.from_numpy(first))
    tck.save_state(tmp_path / "ck", ts, tp.cfg, pipeline=tp)
    z = np.load(tmp_path / "ck.npz")
    assert str(z["ring_dtype"]) == ("float32" if kind == "f32_ring" else "bfloat16")
    assert z["ring"].dtype == np.float32
    assert json.loads((tmp_path / "ck.json").read_text())["_pipeline"] == {
        "chunk_hops": tp.chunk_hops, "viewport_rows": tp.viewport_rows}

    js = jck.load_state(tmp_path / "ck", jp)
    _assert_same_state(ts, js)
    tback = tck.load_state(tmp_path / "ck", tp)     # the port's own restore
    _assert_same_state(tback, js)
    _push_both(jp, tp, js, ts, second)


@pytest.mark.parametrize("saved,restored", [("planar", "transposed"),
                                            ("transposed", "planar")])
def test_carry_converts_between_forms(saved, restored, tmp_path):
    """A planar checkpoint restores into a transposed_carry pipeline and the
    other way round; the next push equals the saving pipeline's."""
    kw = dict(chunk_hops=3, packed_output=True, device="cpu", palette_sort=False)
    cfg = SpectrogramConfig(**SMALL)
    make = {"planar": lambda: SpectrogramPipeline(cfg, **kw),
            "transposed": lambda: SpectrogramPipeline(cfg, transposed_carry=True, **kw)}
    a, b = make[saved](), make[restored]()
    first, second = _chunks(a, "transposed", 2, seed=23)
    sa, _ = a.push(a.set_palette(a.init_state(4), IDS4), torch.from_numpy(first))
    tck.save_state(tmp_path / "ck", sa, cfg, pipeline=a)
    sb = tck.load_state(tmp_path / "ck", b)
    assert sb.carry.ndim == (4 if restored == "transposed" else 3)
    torch.testing.assert_close(_planar(sb.carry), _planar(sa.carry), atol=0, rtol=0)
    sa, ra = a.push(sa, torch.from_numpy(second))
    sb, rb = b.push(sb, torch.from_numpy(second))
    # the packed and split-real STFTs differ by rounding only
    assert testing.rgba_u8_diff(unpack_rgba(ra), unpack_rgba(rb)) <= 1
    torch.testing.assert_close(_planar(sb.carry), _planar(sa.carry), atol=0, rtol=0)


def _planar(carry: torch.Tensor) -> torch.Tensor:
    """A carry in the planar [S, 2, C] form (sample t*n1 + j1 of a
    transposed carry sits at [j1, t])."""
    if carry.ndim == 3:
        return carry
    return carry.transpose(2, 3).reshape(carry.shape[0], 2, -1)


def test_shapes_checked_without_building_a_state(tmp_path, monkeypatch):
    jp, tp = _pipelines("sorted")
    ts = _start(tp, "sorted")
    tck.save_state(tmp_path / "ck", ts, tp.cfg, pipeline=tp)

    def refuse(*a, **k):
        raise AssertionError("load_state built a throwaway state")

    monkeypatch.setattr(tp, "init_state", refuse)
    back = tck.load_state(tmp_path / "ck", tp)
    torch.testing.assert_close(back.carry, ts.carry, atol=0, rtol=0)
    monkeypatch.undo()
    want = tp.init_state(256)
    shapes = tck.expected_shapes(tp, 256)
    assert shapes["carry"] == [tuple(want.carry.shape)]
    assert shapes["ring"] == [tuple(want.ring.shape)]
    assert shapes["tables"] == [tuple(t.shape) for t in want.tables if t.ndim == 2]


def test_mismatches_raise(tmp_path):
    """Geometry, chunk_hops, viewport_rows, store_ring and carry dtype:
    each restores into a wrong pipeline with ValueError (tests/
    test_session.py:88, :185 for JAX); a sorted state needs pipeline= to be
    saved."""
    cfg = SpectrogramConfig(**SMALL)
    p = SpectrogramPipeline(cfg, chunk_hops=2, viewport_rows=8, device="cpu")
    s, _ = p.push(p.init_state(2), torch.zeros(2, p.chunk_size, 2))
    tck.save_state(tmp_path / "ck", s, cfg, pipeline=p)
    assert tck.load_config(tmp_path / "ck") == cfg
    wrong = {
        "geometry": SpectrogramPipeline(dataclasses.replace(cfg, sample_rate=16000.0),
                                        chunk_hops=2, viewport_rows=8, device="cpu"),
        "chunk_hops=4": SpectrogramPipeline(cfg, chunk_hops=4, viewport_rows=8, device="cpu"),
        "viewport_rows": SpectrogramPipeline(cfg, chunk_hops=2, viewport_rows=16,
                                             device="cpu"),
        "ring": SpectrogramPipeline(cfg, chunk_hops=2, viewport_rows=8, store_ring=False,
                                    device="cpu"),
    }
    match = {"geometry": "geometry", "chunk_hops=4": "chunk_hops=2",
             "viewport_rows": "field ring shape", "ring": "field ring shape"}
    for name, other in wrong.items():
        with pytest.raises(ValueError, match=match[name]):
            tck.load_state(tmp_path / "ck", other)
    # without a ring the shapes agree: the sidecar's viewport_rows decides
    kw = dict(chunk_hops=2, store_ring=False, device="cpu")
    p8 = SpectrogramPipeline(cfg, viewport_rows=8, **kw)
    tck.save_state(tmp_path / "noring", p8.init_state(2), cfg, pipeline=p8)
    with pytest.raises(ValueError, match="viewport_rows=8"):
        tck.load_state(tmp_path / "noring", SpectrogramPipeline(cfg, viewport_rows=16, **kw))
    # a checkpoint without the pipeline record: the cursor's chunk grid
    s8, _ = p8.push(p8.init_state(2), torch.zeros(2, p8.chunk_size, 2))   # cursor 2
    tck.save_state(tmp_path / "bare", s8, cfg)
    k3 = SpectrogramPipeline(cfg, viewport_rows=8, **dict(kw, chunk_hops=3))
    with pytest.raises(ValueError, match="not a multiple"):
        tck.load_state(tmp_path / "bare", k3)
    # an int16 carry into an f32 pipeline
    _, t16 = _pipelines("int16")
    s16 = _start(t16, "int16")
    tck.save_state(tmp_path / "i16", s16, t16.cfg, pipeline=t16)
    f32 = SpectrogramPipeline(t16.cfg, chunk_hops=1, store_ring=False, device="cpu")
    with pytest.raises(ValueError, match="carry is int16"):
        tck.load_state(tmp_path / "i16", f32)
    # JAX refuses the port's file on the same mismatch
    jp = JaxPipeline(jcfg.SpectrogramConfig(**dict(SMALL, sample_rate=16000.0)),
                     chunk_hops=2, viewport_rows=8)
    with pytest.raises(ValueError):
        jck.load_state(tmp_path / "ck", jp)
    _, tsorted = _pipelines("sorted")
    with pytest.raises(ValueError, match="pipeline="):
        tck.save_state(tmp_path / "x", _start(tsorted, "sorted"), tsorted.cfg)


# ------------------------------------------------ states sharded over ranks
#
# The port of tests/test_session.py:101-212.  Two gloo ranks on the CPU
# (`tests/torch_ranks.py`, group "checkpoint") save and restore; the
# one-rank and unsharded restores run in this process.  Before the ranks
# start, the JAX package writes an npz from its 8-device sharded state,
# which the ranks restore onto their mesh.

@pytest.fixture(scope="module")
def ck_ranks(tmp_path_factory):
    import jax

    from spectrogram_tpu.parallel import mesh as jmesh

    import torch_ranks as tr

    out = tmp_path_factory.mktemp("checkpoint_ranks")
    jp = JaxPipeline(jcfg.SpectrogramConfig(**tr.CFG_KW), chunk_hops=4)
    m = jmesh.make_mesh()
    js = jmesh.shard_state(jp.init_state(8, palette_id=3), m)
    js, _ = jmesh.sharded_push(jp, m)(
        js, jax.device_put(jnp.asarray(tr.pcm(45, 8, jp.chunk_size)), jmesh.chunk_sharding(m)))
    jck.save_state(out / "jax_sharded", js, jp.cfg, pipeline=jp)
    return tr.spawn("checkpoint", out)


def _tr():
    import torch_ranks as tr

    return tr


def test_npz_from_sharded_state_continues_bit_for_bit(ck_ranks):
    """save_state of a state split over two ranks writes the whole state
    once (rank 0, external order); restored and re-split, it continues as
    the unsharded pipeline does, and the JAX package reads the file."""
    tr = _tr()
    got = tr.result(ck_ranks, "npz_from_sharded")
    p = SpectrogramPipeline(tr.CFG, chunk_hops=4, device="cpu")
    chunk = torch.from_numpy(tr.pcm(40, 8, p.chunk_size))
    s, _ = p.push(p.init_state(8, palette_id=3), chunk)
    s, want = p.push(s, chunk)
    assert int(got["row_count"]) == 8 == int(s.row_count)
    assert tuple(got["local_ring"]) == (4, p.viewport_rows, 2, tr.CFG.num_bins)
    np.testing.assert_array_equal(got["rows"], want.numpy())
    js = jck.load_state(ck_ranks["out"] / "sharded", JaxPipeline(jcfg.SpectrogramConfig(
        **tr.CFG_KW), chunk_hops=4))
    assert int(js.row_count) == 4 and np.asarray(js.palette_id).tolist() == [3] * 8


@pytest.mark.parametrize("restore", ["two_ranks", "one_rank", "unsharded"])
def test_dcp_saved_by_two_ranks_restores(ck_ranks, restore):
    """save_sharded from two ranks (each its own slice, DCP): restored on
    the same two ranks, on a one-rank mesh in this process and unsharded
    (no process group), the state equals the saved one and its next push
    equals the saved state's next push bit for bit."""
    tr = _tr()
    got = tr.result(ck_ranks, "dcp_cycle")
    if restore == "two_ranks":
        assert bool(got["same"]) and bool(got["tables_equal"])
        np.testing.assert_array_equal(got["rows2"], got["rows"])
        return
    p = SpectrogramPipeline(tr.CFG, chunk_hops=2, device="cpu")
    mesh = None
    if restore == "one_rank":
        from spectrogram_tpu_torch.parallel import mesh as pmesh

        mesh = pmesh.make_mesh(device="cpu")
    st = tck.load_sharded(ck_ranks["out"] / "ckpt", p, mesh)
    np.testing.assert_array_equal(st.carry.numpy(), got["carry"])
    np.testing.assert_array_equal(st.ring.float().numpy(), got["ring"])
    assert int(st.row_count) == 2 and int(st.cursor) == 2
    _, rows = p.push(st, torch.from_numpy(tr.pcm(42, 16, p.chunk_size)))
    np.testing.assert_array_equal(rows.numpy(), got["rows"])


def test_dcp_serving_state_resumes_per_shard_sorted(ck_ranks):
    """The serving mode's checkpoint: a per-shard sorted streaming state is
    refused as it is, saved unsorted (its empty ring dropped), and restored
    onto the two ranks in the per-shard sorted class, the carry back in
    each slice's sorted order; the next push equals the uninterrupted one
    bit for bit, also from an unsharded restore in one process."""
    tr = _tr()
    got = tr.result(ck_ranks, "dcp_sorted_streaming")
    assert "palette-sorted" in str(got["refused"])
    assert bool(got["sorted"]) and bool(got["carry_equal"])
    np.testing.assert_array_equal(got["rows2"], got["rows"])
    p = SpectrogramPipeline(tr.CFG, device="cpu", **tr.STREAM_KW)
    st = tck.load_sharded(ck_ranks["out"] / "sorted_dcp", p)
    assert p._state_perm(st) is not None
    _, rows = p.push(st, torch.from_numpy(tr.pcm(44, tr.SORT_STREAMS, p.chunk_size)))
    np.testing.assert_array_equal(rows.numpy(), got["rows"])


def test_dcp_guards(ck_ranks, tmp_path):
    """The geometry guard, a chunk_hops change, a store_ring change and a
    palette-sorted state each raise ValueError; an aligned restore works."""
    tr = _tr()
    other = SpectrogramPipeline(SpectrogramConfig(**tr.CFG_B_KW), chunk_hops=2, device="cpu")
    with pytest.raises(ValueError, match="geometry"):
        tck.load_sharded(ck_ranks["out"] / "ckpt", other)
    p2 = SpectrogramPipeline(tr.CFG, chunk_hops=2, device="cpu")
    s, _ = p2.push(p2.init_state(1), torch.from_numpy(tr.pcm(47, 1, p2.chunk_size)))
    tck.save_sharded(tmp_path / "d", s, tr.CFG)
    with pytest.raises(ValueError, match="chunk_hops"):
        tck.load_sharded(tmp_path / "d", SpectrogramPipeline(tr.CFG, chunk_hops=4, device="cpu"))
    assert int(tck.load_sharded(tmp_path / "d", p2).cursor) == 2
    streaming = SpectrogramPipeline(tr.CFG, device="cpu", **tr.STREAM_KW)
    tck.save_sharded(tmp_path / "e", streaming.init_state(2), tr.CFG, pipeline=streaming)
    with pytest.raises(ValueError, match="missing field 'ring'"):
        tck.load_sharded(tmp_path / "e", SpectrogramPipeline(tr.CFG, chunk_hops=1, device="cpu"))
    sorted_state = streaming.set_palette(streaming.init_state(256), tr.alternating(256))
    assert streaming._state_perm(sorted_state) is not None
    with pytest.raises(ValueError, match="palette-sorted"):
        tck.save_sharded(tmp_path / "f", sorted_state, tr.CFG, pipeline=streaming)


def test_jax_sharded_npz_loads_into_the_port_mesh(ck_ranks):
    """An npz the JAX package wrote from its 8-device sharded state,
    restored onto the port's two ranks: the next push is within 1 u8 of
    JAX continuing, the carry exact."""
    import jax

    from spectrogram_tpu.parallel import mesh as jmesh

    tr = _tr()
    got = tr.result(ck_ranks, "jax_npz_into_mesh")
    jp = JaxPipeline(jcfg.SpectrogramConfig(**tr.CFG_KW), chunk_hops=4)
    m = jmesh.make_mesh()
    js = jmesh.shard_state(jck.load_state(ck_ranks["out"] / "jax_sharded", jp), m)
    js, jrows = jmesh.sharded_push(jp, m)(
        js, jax.device_put(jnp.asarray(tr.pcm(46, 8, jp.chunk_size)), jmesh.chunk_sharding(m)))
    assert testing.rgba_u8_diff(got["rows"], np.asarray(jrows)) <= 1
    np.testing.assert_array_equal(got["carry"], np.asarray(js.carry))
