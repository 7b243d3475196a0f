"""The port's multi-tenant serving mode against the JAX pipeline, on the CPU.

The serving mode: the blockwise marker, `palette_sort` (block-relative and
global), the sorted-carry push and the ring mode's mag-bridge,
`sorted_output`, `presorted_input`, `i16_planes`, `stream_blocks`,
`sanitize_input`, the host-side order API (`output_perm`, `input_perm`,
`input_dest`, `unsort_state`) and the states of all of these carried across
with `models/convert.py`.

The JAX side runs as its own tests run it, on its Pallas kernels in
interpret mode (the sort engages only on that chain), at the sizes of
`tests/test_pipeline.py`: W=256, hop 64, H=64.  The int16 planes need the
geometry whose TPU plan is packed, BENCH_CONFIG's W=2048, N=4096, hop 800,
here with H=64 to keep the interpreted colormap short.  The bars:

  * decisions (tables-tuple structure, perm, inv, the blockwise flag and the
    host-side orders) equal to JAX's;
  * rows within 1 u8 per channel of JAX's over what the image shows
    (`testing.rgba_u8_diff`), carries exactly equal;
  * inside the port, sorted rows equal per-row rows and int16 rows equal
    the f32 rows of x / 32768, bit for bit.
"""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectrogram_tpu.config as jcfg
from spectrogram_tpu.models.spectrogram import SpectrogramPipeline as JaxPipeline
from spectrogram_tpu.models.spectrogram import StreamState as JaxState

from spectrogram_tpu_torch import testing
from spectrogram_tpu_torch.config import BENCH_CONFIG, DEFAULT_CONFIG, SpectrogramConfig
from spectrogram_tpu_torch.models.convert import state_from_jax, state_to_numpy
from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline
from spectrogram_tpu_torch.ops.cuda.colormap_kernel import unpack_rgba

torch.set_num_threads(2)

SMALL = dict(sample_rate=8000.0, window_period=0.032, hop_period=0.008,
             viewport_height=64, viewport_rows=32)      # W=256, hop 64, H=64
CFG, JCFG = SpectrogramConfig(**SMALL), jcfg.SpectrogramConfig(**SMALL)
BENCH64 = dataclasses.replace(BENCH_CONFIG, viewport_height=64)
JBENCH64 = dataclasses.replace(jcfg.BENCH_CONFIG, viewport_height=64)
JAX_KW = dict(stft_backend="pallas", colormap_backend="pallas",
              kernel_interpret=True)
STREAMING = dict(chunk_hops=1, store_ring=False, packed_output=True)

# (streams, palette ids, pipeline arguments) of the layouts the decisions
# are held on: what each must give is in test_layout_decisions_equal_jax
LAYOUTS = {
    "init_state": (256, None, {}),
    "clustered": (256, np.arange(256) // 128, {}),
    "scattered_sortable": (256, np.arange(256) % 2, {}),
    "scattered_unsortable": (256, np.arange(256) % 19, {}),
    "one_palette": (256, 3, {}),
    "blocked_uneven_tail": (600, np.arange(600) % 2,
                            dict(chunk_hops=4, stream_blocks=256)),
    "global": (576, np.arange(576) % 2, dict(stream_blocks=128)),
    "global_4_palettes": (512, np.arange(512) % 4, dict(stream_blocks=256)),
    "block_relative_runs": (512, (np.arange(512) // 64) % 2,
                            dict(stream_blocks=256)),
    "ring": (256, np.arange(256) % 2, dict(store_ring=True, viewport_rows=4)),
}


def _np_state(state) -> dict:
    d = {k: np.asarray(v) for k, v in state._asdict().items() if k != "tables"}
    d["tables"] = tuple(np.asarray(t) for t in state.tables)
    return d


def _jax_state(d: dict) -> JaxState:
    return JaxState(
        carry=jnp.asarray(d["carry"]),
        ring=jnp.asarray(d["ring"]).astype(jnp.bfloat16),
        cursor=jnp.asarray(d["cursor"]), palette_id=jnp.asarray(d["palette_id"]),
        row_count=jnp.asarray(d["row_count"]),
        tables=tuple(jnp.asarray(t) for t in d["tables"]),
    )


def _pipelines(s_kw: dict, cfg=CFG, jc=JCFG, **kw):
    """(JAX pipeline, port pipeline) with the same arguments."""
    args = dict(STREAMING, **s_kw, **kw)
    return JaxPipeline(jc, **JAX_KW, **args), SpectrogramPipeline(cfg, device="cpu", **args)


def _chunks(p, s: int, n: int, kind: str = "noise", seed: int = 1):
    pcm = testing.make(kind, s, n * p.chunk_size, p.cfg.sample_rate, seed=seed)
    return [pcm[:, i * p.chunk_size : (i + 1) * p.chunk_size] for i in range(n)]


def _assert_rows_close(port_rows, jax_rows):
    assert port_rows.shape == tuple(jax_rows.shape)
    assert testing.rgba_u8_diff(unpack_rgba(port_rows), unpack_rgba(np.asarray(jax_rows))) <= 1


def _push_both(jp, tp, js, ts, chunk):
    """One push on both pipelines: rows within the bar, carries equal."""
    js, jr = jp.push(js, jnp.asarray(chunk))
    ts, tr = tp.push(ts, torch.from_numpy(np.ascontiguousarray(chunk)))
    _assert_rows_close(tr, jr)
    np.testing.assert_array_equal(ts.carry.numpy(), np.asarray(js.carry))
    return js, ts, tr


def _assert_same_class(jp, tp, js, ts):
    """Tables-tuple structure and values, blockwise flag and host orders."""
    jt, tt = _np_state(js)["tables"], state_to_numpy(ts)["tables"]
    assert [t.shape for t in tt] == [t.shape for t in jt]
    for a, b in zip(tt, jt):
        np.testing.assert_array_equal(a, b)
    assert tp.palette_layout.blockwise(ts.tables) == jp._state_blockwise(js)
    assert tp.palette_layout.read(ts.tables).perm_global == jp._tables_perm_global(js.tables)
    for name in ("output_perm", "input_perm", "input_dest"):
        want, got = getattr(jp, name)(js), getattr(tp, name)(ts)
        assert (got is None) == (want is None), name
        if want is not None:
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ surface

def test_constructor_defaults_equal_jax():
    jsig = inspect.signature(JaxPipeline).parameters
    tsig = inspect.signature(SpectrogramPipeline).parameters
    for name in ("palette_sort", "blockwise_palettes", "stream_blocks",
                 "sorted_output", "presorted_input", "i16_planes",
                 "sanitize_input", "chunk_hops", "packed_output"):
        assert name in tsig, name
    common = [n for n in tsig if n in jsig and n not in ("cfg", "ring_dtype")]
    assert len(common) >= 15
    for name in common:
        assert tsig[name].default == jsig[name].default, name
    assert str(tsig["ring_dtype"].default) == "torch." + jnp.dtype(
        jsig["ring_dtype"].default).name
    # process(): the pinned static palette, else Magma, when no id is given
    for method in ("process", "init_state"):
        jm = inspect.signature(getattr(JaxPipeline, method)).parameters
        tm = inspect.signature(getattr(SpectrogramPipeline, method)).parameters
        assert tm["palette_id"].default == jm["palette_id"].default, method
    assert tsig["static_palette"].default is None


def test_serving_arguments_are_checked_as_in_jax():
    for kw, match in ((dict(sorted_output=True, palette_sort=False), "sorted_output requires"),
                      (dict(presorted_input=True, palette_sort=False), "presorted_input requires"),
                      (dict(presorted_input=True, store_ring=True), "presorted_input requires"),
                      (dict(blockwise_palettes="sometimes"), "blockwise_palettes"),
                      (dict(stream_blocks=2.5), "stream_blocks")):
        args = dict(STREAMING, **kw)
        with pytest.raises(ValueError, match=match):
            JaxPipeline(JCFG, **JAX_KW, **args)
        with pytest.raises(ValueError, match=match):
            SpectrogramPipeline(CFG, device="cpu", **args)


@pytest.mark.parametrize("geometry", ["bench", "default", "small"])
def test_cmap_ts_equals_jax(geometry):
    """The colormap row block the sort's economics are counted in: the port
    sizes it from the unpadded resample matrix, the JAX package from its
    (at DEFAULT_CONFIG lane-padded) kernel plan; the blocks agree."""
    cfg, jc = {"bench": (BENCH_CONFIG, jcfg.BENCH_CONFIG),
               "default": (DEFAULT_CONFIG, jcfg.DEFAULT_CONFIG),
               "small": (CFG, JCFG)}[geometry]
    jp, tp = _pipelines({}, cfg, jc)
    assert jp.fused_chain
    for n in (1, 4, 100, 128, 256, 600, 2048, 2400, 4096, 10240, 16384, 32768, 81920):
        assert tp.palette_layout.block_rows(n) == jp._cmap_ts(n), n
    assert tp.palette_layout.block_rows(10240) == 128


# ----------------------------------------------------------------- decisions

@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_layout_decisions_equal_jax(layout):
    s, ids, kw = LAYOUTS[layout]
    jp, tp = _pipelines(kw, sorted_output=True)
    js, ts = jp.init_state(s), tp.init_state(s)
    if ids is not None:
        js, ts = jp.set_palette(js, ids), tp.set_palette(ts, ids)
    _assert_same_class(jp, tp, js, ts)
    tables = ts.tables
    want_len = {"init_state": 2, "clustered": 2, "scattered_sortable": 3,
                "scattered_unsortable": 1, "one_palette": 1,
                "blocked_uneven_tail": 3, "global": 4, "global_4_palettes": 4,
                "block_relative_runs": 3, "ring": 3}[layout]
    assert len(tables) == want_len
    if layout == "blocked_uneven_tail":        # blocks 256 + 256 + 88
        perm = tables[1].numpy()
        assert perm[:256].max() < 256 and perm[512:].max() < 88
    if layout == "one_palette":
        assert tables[0].shape[0] == 1
    np.testing.assert_array_equal(np.asarray(js.carry), ts.carry.numpy())


# --------------------------------------------------------------------- pushes

@pytest.fixture(scope="module")
def carry_sort():
    """The JAX and port carry-sort pipelines (k=1, no ring), shared so that
    each JAX push structure compiles once."""
    return _pipelines({})


@pytest.mark.parametrize("layout", ["scattered_sortable", "blocked_uneven_tail", "global"])
def test_sorted_pushes_match_jax_and_per_row(layout):
    """Two pushes: the port's sorted pipeline against JAX's, and bit for bit
    against the port's per-row pipeline; the carry at rest in sorted order,
    carry[inv] the per-row carry, which `carry_to_external` gives and
    `carry_from_external` takes back."""
    s, ids, kw = LAYOUTS[layout]
    jp, tp = _pipelines(kw)
    plain = SpectrogramPipeline(CFG, device="cpu", **dict(STREAMING, **kw),
                                palette_sort=False, blockwise_palettes=False)
    js, ts = jp.set_palette(jp.init_state(s), ids), tp.set_palette(tp.init_state(s), ids)
    ps = plain.set_palette(plain.init_state(s), ids)
    assert tp.palette_layout.read(ts.tables).sorted and tp.carry_sort_mode
    assert len(ps.tables) == 1
    for chunk in _chunks(tp, s, 2, "chirp_tone", seed=3):
        js, ts, tr = _push_both(jp, tp, js, ts, chunk)
        ps, pr = plain.push(ps, torch.from_numpy(np.ascontiguousarray(chunk)))
        torch.testing.assert_close(tr, pr, atol=0, rtol=0)
    pl = tp.palette_layout
    ginv = pl.global_perms(ts.tables)[1].long()
    torch.testing.assert_close(ts.carry[ginv], ps.carry, atol=0, rtol=0)
    torch.testing.assert_close(pl.carry_to_external(ts.carry, ts.tables), ps.carry,
                               atol=0, rtol=0)
    torch.testing.assert_close(pl.carry_from_external(ps.carry, ts.tables), ts.carry,
                               atol=0, rtol=0)
    unsorted = tp.unsort_state(ts)
    assert not tp.palette_layout.read(unsorted.tables).sorted
    torch.testing.assert_close(unsorted.carry, ps.carry, atol=0, rtol=0)
    torch.testing.assert_close(unsorted.tables[0], ps.tables[0], atol=0, rtol=0)


@pytest.mark.parametrize("k", [1, 3])
def test_ring_mode_mag_bridge_equals_per_row(k):
    """With a ring the carry and ring stay in external order and the
    magnitude planes are permuted into the sorted tables' order: rows, ring
    and viewports bit for bit those of the per-row pipeline."""
    s, ids = 256, np.arange(256) % 2
    kw = dict(chunk_hops=k, store_ring=True, viewport_rows=6, packed_output=True,
              device="cpu")
    tp = SpectrogramPipeline(CFG, **kw)
    plain = SpectrogramPipeline(CFG, palette_sort=False, blockwise_palettes=False, **kw)
    ts, ps = tp.set_palette(tp.init_state(s), ids), plain.set_palette(plain.init_state(s), ids)
    assert tp.palette_layout.read(ts.tables).sorted and not tp.carry_sort_mode
    for chunk in _chunks(tp, s, 3, seed=5):
        c = torch.from_numpy(np.ascontiguousarray(chunk))
        ts, tr = tp.push(ts, c)
        ps, pr = plain.push(ps, c)
        torch.testing.assert_close(tr, pr, atol=0, rtol=0)
    for name in ("carry", "ring", "cursor", "row_count"):
        torch.testing.assert_close(getattr(ts, name), getattr(ps, name), atol=0, rtol=0)
    for width in (None, 5):
        torch.testing.assert_close(tp.render_viewport(ts, width),
                                   plain.render_viewport(ps, width), atol=0, rtol=0)


@pytest.mark.parametrize("layout", ["scattered_sortable", "global"])
def test_sorted_output_and_presorted_input(layout):
    """sorted_output leaves the rows in sorted order, output_perm indexes
    them; presorted_input takes the chunk in input_perm order (input_dest
    scatters external rows there); both bit for bit the plain sorted
    pipeline, carries included."""
    s, ids, kw = LAYOUTS[layout]
    args = dict(STREAMING, device="cpu", **kw)
    tp = SpectrogramPipeline(CFG, **args)
    fast = SpectrogramPipeline(CFG, sorted_output=True, presorted_input=True, **args)
    ts, fs = tp.set_palette(tp.init_state(s), ids), fast.set_palette(fast.init_state(s), ids)
    perm, dest, out = fast.input_perm(fs), fast.input_dest(fs), fast.output_perm(fs)
    assert perm is not None and dest.dtype == np.uint64 and out is not None
    assert (np.arange(s)[perm][dest] == np.arange(s)).all()
    assert tp.output_perm(ts) is None           # not a sorted_output pipeline
    for chunk in _chunks(tp, s, 2, seed=6):
        sorted_chunk = np.empty_like(chunk)
        sorted_chunk[dest.astype(np.int64)] = chunk         # the drain's scatter
        np.testing.assert_array_equal(sorted_chunk, chunk[perm])
        ts, tr = tp.push(ts, torch.from_numpy(np.ascontiguousarray(chunk)))
        fs, fr = fast.push(fs, torch.from_numpy(sorted_chunk))
        torch.testing.assert_close(fr[torch.from_numpy(out).long()], tr, atol=0, rtol=0)
    torch.testing.assert_close(fs.carry, ts.carry, atol=0, rtol=0)
    # an unsorted state: external order in and out, no orders to query
    fu = fast.set_palette(fs, 2)
    assert fast.input_perm(fu) is None and fast.output_perm(fu) is None
    assert fast.input_dest(fu) is None


def test_transitions_match_jax(carry_sort):
    """external -> sorted -> re-sorted -> unsort_state -> sorted -> one
    palette: the carry follows every order change, and each step's push
    matches JAX's through the same transitions."""
    jp, tp = carry_sort
    s = 256
    chunks = iter(_chunks(tp, s, 6, "chirp_tone", seed=7))
    js, ts = jp.init_state(s), tp.init_state(s)
    js, ts, _ = _push_both(jp, tp, js, ts, next(chunks))         # external
    for step in (np.arange(s) % 2, (np.arange(s) // 2) % 2, "unsort",
                 np.arange(s) % 2, 3):
        if isinstance(step, str):
            js, ts = jp.unsort_state(js), tp.unsort_state(ts)
            assert not tp.palette_layout.read(ts.tables).sorted
        else:
            js, ts = jp.set_palette(js, step), tp.set_palette(ts, step)
        _assert_same_class(jp, tp, js, ts)
        np.testing.assert_array_equal(ts.carry.numpy(), np.asarray(js.carry))
        js, ts, _ = _push_both(jp, tp, js, ts, next(chunks))
    assert ts.tables[0].shape[0] == 1


# ---------------------------------------------------------------- int16 planes

@pytest.mark.parametrize("k", [1, 8])
def test_i16_planes_match_f32_and_jax(k):
    """i16_planes at BENCH_CONFIG's geometry: an int16 carry, rows bit for
    bit the f32 pipeline's on x / 32768 (and its carry x 2^-15), rows and
    carries matching JAX's i16_planes pipeline; a float chunk raises."""
    s = 4 if k == 1 else 2
    jp, tp = _pipelines({}, BENCH64, JBENCH64, chunk_hops=k, i16_planes=True)
    f32 = SpectrogramPipeline(BENCH64, device="cpu", **dict(STREAMING, chunk_hops=k))
    js, ts, fs = jp.init_state(s), tp.init_state(s), f32.init_state(s)
    assert ts.carry.dtype == torch.int16 and js.carry.dtype == jnp.int16
    rng = np.random.default_rng(k)
    for _ in range(2 if k == 1 else 1):
        words = (testing.chirp_tone(s, tp.chunk_size, BENCH64.sample_rate, seed=k)
                 * 32767 + rng.integers(-99, 99, (s, tp.chunk_size, 2))).astype(np.int16)
        js, ts, tr = _push_both(jp, tp, js, ts, words)
        fs, fr = f32.push(fs, torch.from_numpy(words))
        torch.testing.assert_close(tr, fr, atol=0, rtol=0)
    torch.testing.assert_close(ts.carry.to(torch.float32) * 2.0 ** -15, fs.carry,
                               atol=0, rtol=0)
    with pytest.raises(ValueError, match="int16 chunks"):
        tp.push(ts, torch.zeros(s, tp.chunk_size, 2))
    with pytest.raises(ValueError, match="carry is torch.float32"):
        tp.push(fs, torch.from_numpy(words))


def test_full_serving_mode_equals_f32_sorted():
    """i16_planes + presorted_input + sorted_output with int16 chunks in
    input_perm order: rows[output_perm] bit for bit the f32 sorted
    pipeline's on x / 32768, at k=1 and through the all-windows path."""
    s, ids = 256, np.arange(256) % 2
    for k in (1, 2):
        args = dict(STREAMING, chunk_hops=k, device="cpu")
        full = SpectrogramPipeline(CFG, i16_planes=True, presorted_input=True,
                                   sorted_output=True, **args)
        ref = SpectrogramPipeline(CFG, **args)
        fs, rs = full.set_palette(full.init_state(s), ids), ref.set_palette(ref.init_state(s), ids)
        perm, out = full.input_perm(fs), torch.from_numpy(full.output_perm(fs)).long()
        rng = np.random.default_rng(k)
        for _ in range(2):
            words = rng.integers(-32768, 32768, (s, full.chunk_size, 2), dtype=np.int16)
            fs, fr = full.push(fs, torch.from_numpy(words[perm]))
            rs, rr = ref.push(rs, torch.from_numpy(words.astype(np.float32) / 32768.0))
            torch.testing.assert_close(fr[out], rr, atol=0, rtol=0)
        torch.testing.assert_close(fs.carry.to(torch.float32) * 2.0 ** -15, rs.carry,
                                   atol=0, rtol=0)


# ------------------------------------------------------------------ sanitize

def test_sanitize_input_zeroes_non_finite_samples():
    """NaN and inf in a float chunk become zeros at the edge: the push is
    bit for bit that of the chunk with zeros there, and matches JAX's
    sanitizing pipeline; process() applies the same guard."""
    s = 4
    jp = JaxPipeline(JCFG, **STREAMING, stft_backend="xla", colormap_backend="xla",
                     sanitize_input=True, palette_sort=False)
    tp = SpectrogramPipeline(CFG, **STREAMING, sanitize_input=True, device="cpu")
    clean = SpectrogramPipeline(CFG, **STREAMING, device="cpu")
    ids = np.array([0, 1, 3, 8])
    js = jp.set_palette(jp.init_state(s), ids)
    ts = state_from_jax(_np_state(js), device="cpu")
    cs = clean.set_palette(clean.init_state(s), ids)
    for i, chunk in enumerate(_chunks(tp, s, 2, "chirp_tone", seed=8)):
        dirty = chunk.copy()
        dirty[0, 5 + i, 0] = np.nan
        dirty[2, 9, 1] = np.inf
        dirty[3, 17, 0] = -np.inf
        zeroed = np.where(np.isfinite(dirty), dirty, 0.0).astype(np.float32)
        js, ts, tr = _push_both(jp, tp, js, ts, dirty)
        cs, cr = clean.push(cs, torch.from_numpy(zeroed))
        torch.testing.assert_close(tr, cr, atol=0, rtol=0)
        assert torch.isfinite(ts.carry).all()
    pcm = testing.chirp_tone(1, 3 * CFG.window_size, CFG.sample_rate, seed=2)
    pcm[0, 100, 0] = np.nan
    torch.testing.assert_close(
        tp.process(torch.from_numpy(pcm)),
        clean.process(torch.from_numpy(np.nan_to_num(pcm, nan=0.0))), atol=0, rtol=0)


# ------------------------------------------------------------------- convert

@pytest.mark.parametrize("kind", ["marked", "sorted", "global_sorted", "int16"])
def test_states_carry_across_both_ways(kind, carry_sort):
    """A JAX state of each serving class loads into the port and pushes on
    as JAX does; the port's state loads back into JAX and pushes as the JAX
    state does."""
    if kind == "int16":
        s, ids = 4, np.array([0, 1, 3, 8])
        jp, tp = _pipelines({}, BENCH64, JBENCH64, i16_planes=True)
    elif kind == "global_sorted":
        s, ids, kw = LAYOUTS["global"]
        jp, tp = _pipelines(kw)
    else:
        (jp, tp), s = carry_sort, 256
        ids = None if kind == "marked" else np.arange(s) % 2
    js = jp.init_state(s) if ids is None else jp.set_palette(jp.init_state(s), ids)
    first, second = _chunks(tp, s, 2, "chirp_tone", seed=11)
    if kind == "int16":
        first, second = ((c * 32767).astype(np.int16) for c in (first, second))
    js, _ = jp.push(js, jnp.asarray(first))
    d = _np_state(js)
    ts = state_from_jax(d, device="cpu")
    back = state_to_numpy(ts)
    for name in ("carry", "ring", "cursor", "palette_id", "row_count"):
        assert back[name].dtype == np.asarray(d[name]).dtype or name == "ring"
        np.testing.assert_array_equal(back[name], np.asarray(d[name], back[name].dtype))
    assert [t.dtype for t in back["tables"]] == [t.dtype for t in d["tables"]]
    want_len = {"marked": 2, "sorted": 3, "global_sorted": 4, "int16": 1}[kind]
    assert len(ts.tables) == want_len
    _assert_same_class(jp, tp, js, ts)
    # port -> JAX: the loaded state pushes the JAX state's rows exactly
    js_back, jr_back = jp.push(_jax_state(back), jnp.asarray(second))
    js, jr = jp.push(js, jnp.asarray(second))
    np.testing.assert_array_equal(np.asarray(jr_back), np.asarray(jr))
    np.testing.assert_array_equal(np.asarray(js_back.carry), np.asarray(js.carry))
    # JAX -> port: the loaded state pushes on as JAX does
    ts, tr = tp.push(ts, torch.from_numpy(np.ascontiguousarray(second)))
    _assert_rows_close(tr, jr)
    np.testing.assert_array_equal(ts.carry.numpy(), np.asarray(js.carry))
