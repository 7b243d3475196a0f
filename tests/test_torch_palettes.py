"""User-defined and static palettes in the port against the JAX pipeline, on
the CPU.

A registry holding a `FactoredScheme` outside the built-in mono/stereo
structure takes the generic two-table colormap (per-row tables, or one
(u, v) pair after a scalar `set_palette`); `static_palette=` takes the
static colormap, built-in or generic.  The JAX side runs on its Pallas
kernels in interpret mode (`_generic_kernel`, `_uniform_generic_kernel`,
`_static_builtin_kernel`, `_static_generic_kernel`) at the W=256, H=64
geometry of `tests/test_torch_serving.py`, and at BENCH_CONFIG widths with
H=64 on the same planes.  The schemes are the JAX tests' own:
`MagColor-PanAlpha` (rgb from magnitude, alpha from pan; a copy of
`tests/test_custom_palettes.py`'s) and `smoke-custom` (rgb from magnitude
and pan, alpha from magnitude; `testing.custom_factors`, a copy of
`spectrogram_tpu/smoke.py`'s), beside three built-ins.

The bars:

  * the colormap on identical magnitude planes: within 1 u8 per channel
    everywhere;
  * whole pushes on noise: within 1 u8 per channel everywhere; on
    chirp+tone, within 1 u8 over the pixels both STFTs put above the dB
    floor (`testing.rgba_u8_diff_above_floor`: below the floor a pan-alpha
    palette shows the pan of rounding noise), and over what the image shows
    (`testing.rgba_u8_diff`) for the built-in static palettes;
  * next carry exact, tables tuples equal to JAX's (no blockwise marker, no
    palette sort for a generic or static state);
  * inside the port: streamed rows equal `process()`, and a static
    pipeline's rows equal the uniform pipeline's, bit for bit.

Each case runs against JAX at k=1 without a ring (noise) and at k=8 with
the ring and `render_viewport` (chirp+tone; at R and at another width, the
two generic cases one width each, since each width is an interpreted
compile of the generic body); the other two combinations of k and ring run
inside the port.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectrogram_tpu.config as jcfg
from spectrogram_tpu.color import colorscheme as jcs
from spectrogram_tpu.models.spectrogram import SpectrogramPipeline as JaxPipeline
from spectrogram_tpu.models.spectrogram import StreamState as JaxState
from spectrogram_tpu.ops import stft as jstft
from spectrogram_tpu.ops.pallas import colormap_kernel as jck

from spectrogram_tpu_torch import testing
from spectrogram_tpu_torch.color import colorscheme as tcs
from spectrogram_tpu_torch.config import BENCH_CONFIG, SpectrogramConfig
from spectrogram_tpu_torch.models.convert import state_from_jax, state_to_numpy
from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline
from spectrogram_tpu_torch.ops import colormap as tcm
from spectrogram_tpu_torch.ops import stft as tstft
from spectrogram_tpu_torch.ops.cuda import colormap_kernel as tck
from spectrogram_tpu_torch.ops.cuda import stft_kernel as tsk

torch.set_num_threads(2)

SMALL = dict(sample_rate=8000.0, window_period=0.032, hop_period=0.008,
             viewport_height=64)                         # W=256, hop 64, H=64
CFG, JCFG = SpectrogramConfig(**SMALL), jcfg.SpectrogramConfig(**SMALL)
BENCH64 = dataclasses.replace(BENCH_CONFIG, viewport_height=64)
JBENCH64 = dataclasses.replace(jcfg.BENCH_CONFIG, viewport_height=64)
JAX_KW = dict(stft_backend="pallas", colormap_backend="pallas", kernel_interpret=True)
RES = 32
S = 5                                          # one stream per registry entry
STFT_ATOL = 3e-5


def _amber(t):
    """black -> amber -> white (tests/test_custom_palettes.py)."""
    t = np.clip(np.asarray(t, dtype=np.float64), 0.0, 1.0)
    return np.stack([np.minimum(1.0, 1.6 * t), np.clip(1.4 * t - 0.2, 0.0, 1.0),
                     np.clip(2.5 * t - 1.5, 0.0, 1.0)], axis=-1)


def _nonseparable_factors():
    """rgb = amber(magnitude), alpha = 0.25 + 0.75 pan: outside the built-in
    structure (tests/test_custom_palettes.py `_nonseparable_builtin_scheme`)."""
    i = np.arange(RES) / (RES - 1)
    u = np.ones((RES, 4), np.float32)
    v = np.ones((RES, 4), np.float32)
    u[:, :3] = _amber(i).astype(np.float32)
    v[:, 3] = (0.25 + 0.75 * i).astype(np.float32)
    return u, v


def _registry(mod):
    """The generic registry in package `mod` (the JAX or the port's
    colorscheme module): ids 0 smoke-custom, 1 MagColor-PanAlpha, 2
    Blue-Yellow-Red (Stereo), 3 Magma, 4 Viridis."""
    return (mod.FactoredScheme("smoke-custom", *testing.custom_factors(),
                               background=(10, 10, 10)),
            mod.FactoredScheme("MagColor-PanAlpha", *_nonseparable_factors(),
                               background=(0, 20, 40)),
            *mod.DEFAULT_COLOR_SCHEMES[:3])


# case -> (generic registry, set_palette ids or None, static_palette)
CASES = {
    "generic_per_row": (True, np.arange(S) % S, None),
    "generic_uniform": (True, 1, None),
    "static_mono": (False, None, "Magma"),
    "static_stereo": (False, None, "Blue-Yellow-Red (Stereo)"),
    "static_generic": (True, None, "MagColor-PanAlpha"),
}
MODES = {
    "k1": dict(chunk_hops=1, store_ring=False),
    "k8_ring": dict(chunk_hops=8, store_ring=True, viewport_rows=16),
}


@functools.lru_cache(maxsize=None)
def _pipelines(case: str, mode: str):
    """(JAX pipeline, port pipeline) with the same arguments, shared so that
    each JAX push structure compiles once."""
    generic, _, static = CASES[case]
    kw = dict(MODES[mode], packed_output=True, static_palette=static)
    return (JaxPipeline(JCFG, schemes=_registry(jcs) if generic else None, **JAX_KW, **kw),
            SpectrogramPipeline(CFG, schemes=_registry(tcs) if generic else None,
                                device="cpu", **kw))


def _states(case: str, jp, tp):
    js, ts = jp.init_state(S), tp.init_state(S)
    ids = CASES[case][1]
    if ids is not None:
        js, ts = jp.set_palette(js, ids), tp.set_palette(ts, ids)
    return js, ts


def _np_state(state) -> dict:
    d = {k: np.asarray(v) for k, v in state._asdict().items() if k != "tables"}
    d["tables"] = tuple(np.asarray(t) for t in state.tables)
    return d


def _jax_state(d: dict) -> JaxState:
    return JaxState(
        carry=jnp.asarray(d["carry"]), ring=jnp.asarray(d["ring"]).astype(jnp.bfloat16),
        cursor=jnp.asarray(d["cursor"]), palette_id=jnp.asarray(d["palette_id"]),
        row_count=jnp.asarray(d["row_count"]),
        tables=tuple(jnp.asarray(t) for t in d["tables"]),
    )


def _u8(packed) -> np.ndarray:
    return tck.unpack_rgba(np.asarray(packed)).astype(np.int32)


def _assert_tables_like_jax(jp, tp, js, ts):
    """The tables tuple's structure and values are JAX's; a generic or
    static state carries no marker and no palette sort."""
    jt, tt = _np_state(js)["tables"], state_to_numpy(ts)["tables"]
    assert [t.shape for t in tt] == [t.shape for t in jt]
    for a, b in zip(tt, jt):
        np.testing.assert_array_equal(a, b)
    assert len(tt) in (0, 2) and all(t.ndim == 2 for t in tt)
    assert not tp.palette_layout.read(ts.tables).sorted and jp._state_perm(js) is None
    assert tp.palette_layout.blockwise(ts.tables) == jp._state_blockwise(js)


def _padded(p, pcm: np.ndarray) -> np.ndarray:
    """The PCM behind a fresh state's pushes: C zero samples, then pcm."""
    return np.concatenate([np.zeros((pcm.shape[0], p.carry_size, 2), np.float32), pcm], 1)


def _view_texels(ring, cursor: int, width, cfg) -> np.ndarray:
    """Magnitude texels of a viewport rendered from `ring` ([S, R, 2, B])."""
    ordered = np.roll(np.asarray(ring, np.float32), -cursor, axis=1)
    if width is not None:
        m = tcm.time_resample_matrix(ordered.shape[1], width)
        ordered = np.einsum("rw,srcb->swcb", m, ordered)
    return testing.magnitude_texels(ordered, cfg)


def _assert_close(case, got, want, texels=None):
    """The bar of the module docstring: everywhere without texels (noise),
    above the floor with them (chirp+tone)."""
    assert got.shape == want.shape
    if texels is None:
        assert np.abs(got - want).max() <= 1
        return
    assert testing.rgba_u8_diff_above_floor(got, want, *texels) <= 1
    if case in ("static_mono", "static_stereo"):
        assert testing.rgba_u8_diff(got, want) <= 1


# -------------------------------------------------------------- the colormap

def _planes(cfg, kind: str, rows: int):
    """[rows, N/2] magnitude planes; the last row silence (the pan guard),
    the first loud enough to saturate."""
    w = cfg.window_size
    frames = testing.make(kind, 1, rows * w, cfg.sample_rate, seed=7)[0]
    frames = frames.reshape(rows, w, 2).copy()
    frames[-1] = 0.0
    frames[0] *= 40.0
    return tsk.stft_mag_packed_plain(
        torch.from_numpy(np.ascontiguousarray(frames[..., 0])),
        torch.from_numpy(np.ascontiguousarray(frames[..., 1])),
        torch.from_numpy(tsk.packed_hann(w)), cfg.padded_size)


# every case at W=256; at BENCH widths the three that reach each kernel body
# not met there yet (the interpreted generic body costs seconds per call)
PLANE_CASES = [(c, "small") for c in sorted(CASES)] + [
    (c, "bench") for c in ("generic_per_row", "static_generic", "static_stereo")]


@pytest.mark.parametrize("case,geometry", PLANE_CASES)
def test_colormap_plain_matches_jax_on_same_planes(case, geometry):
    """The plain versions of the generic and static colormaps against the
    JAX colormap entries in interpret mode: the dense entry at W=256 (no
    band plan pays there, so the JAX pipeline takes it), the banded entry
    at BENCH_CONFIG widths (H=64: the banded and dense entries give the same
    bits, and the interpreted generic body takes 19 s at H=1024)."""
    cfg, jc = (CFG, JCFG) if geometry == "small" else (BENCH64, JBENCH64)
    rows = 6 if geometry == "small" else 3
    ml, mr = _planes(cfg, "chirp_tone" if rows == 6 else "noise", rows)
    generic, ids, static = CASES[case]
    schemes = _registry(tcs) if generic else tcs.DEFAULT_COLOR_SCHEMES
    names = [s.name for s in schemes]
    full = tcm.resample_matrix_full(cfg)
    taps = tck.resample_taps(full)
    if static is not None:
        pid = names.index(static)
        if generic:
            u, v = tck.generic_color_tables(RES, schemes)
            table, jtable, jstatic = (u[pid], v[pid]), None, (
                tuple(map(float, u[pid])), tuple(map(float, v[pid])))
        else:
            table = tck.builtin_color_tables(RES, schemes)[pid]
            jtable, jstatic = None, tuple(map(float, table))
        got = tck.colormap_static_plain(ml, mr, taps, table, cfg)
        assert torch.equal(got, tck.colormap_static(ml, mr, taps, table, cfg))
    else:
        u, v = tck.generic_color_tables(RES, schemes)
        sel = np.arange(rows) % S if np.ndim(ids) else [ids]
        u, v = u[sel], v[sel]
        got = tck.colormap_generic_plain(ml, mr, taps, *map(torch.from_numpy, (u, v)), cfg)
        jtable, jstatic = (jnp.asarray(u), jnp.asarray(v)), None
    matrix_t = jnp.asarray(full.T)
    args = (jnp.asarray(ml.numpy()), jnp.asarray(mr.numpy()), jtable, matrix_t, jc)
    if geometry == "small":
        want = jck.colormap_planes_builtin(*args, interpret=True, static_table=jstatic)
    else:
        want = jck.colormap_planes_banded(*args, jck.band_segments(full.T),
                                          interpret=True, static_table=jstatic)
    assert got.dtype == torch.int32 and got.shape == (rows, cfg.viewport_height)
    assert np.abs(_u8(got) - _u8(want)).max() <= 1


def test_generic_over_builtin_structure_is_kernel_b():
    """The generic colormap over the built-in palettes' own factors: within
    1 u8 of kernel B's plain version on every channel (the two read the
    same LUT, one as a product of factors)."""
    cfg = CFG
    ml, mr = _planes(cfg, "chirp_tone", 19)
    taps = tck.resample_taps(tcm.resample_matrix_full(cfg))
    u, v = (torch.from_numpy(t) for t in tck.generic_color_tables(RES))
    builtin = torch.from_numpy(tck.builtin_color_tables(RES))
    got = tck.colormap_generic(ml, mr, taps, u, v, cfg)
    want = tck.colormap_builtin(ml, mr, taps, builtin, cfg)
    assert np.abs(_u8(got) - _u8(want)).max() <= 1
    # one table for all rows, and rows_per_table, as the viewport reads them
    one = tck.colormap_generic(ml, mr, taps, u[4:5], v[4:5], cfg)
    assert np.abs(_u8(one) - _u8(tck.colormap_builtin(ml, mr, taps, builtin[4:5], cfg))).max() <= 1
    torch.testing.assert_close(
        tck.colormap_generic(ml[:18], mr[:18], taps, u[:3], v[:3], cfg, rows_per_table=6),
        tck.colormap_generic(ml[:18], mr[:18], taps, u[:3].repeat_interleave(6, 0),
                             v[:3].repeat_interleave(6, 0), cfg), atol=0, rtol=0)


def test_wrappers_check_their_operands():
    cfg = CFG
    ml, mr = _planes(cfg, "noise", 2)
    taps = tck.resample_taps(tcm.resample_matrix_full(cfg))
    u, v = (torch.from_numpy(t) for t in tck.generic_color_tables(RES))
    with pytest.raises(ValueError, match="differ"):
        tck.colormap_generic(ml, mr, taps, u, v[:3], cfg)
    with pytest.raises(ValueError, match="no colormap kernel"):
        tck.colormap_generic(ml.to("meta"), mr.to("meta"), taps, u, v, cfg)
    with pytest.raises(ValueError, match="no colormap kernel"):
        tck.colormap_static(ml.to("meta"), mr.to("meta"), taps, u[0].numpy(), cfg)
    for bad in (np.zeros(65 * 4, np.float32), np.zeros(6, np.float32),
                (u[0].numpy(), v[0, :64].numpy())):
        with pytest.raises(ValueError, match="R <= 64"):
            tck.colormap_static(ml, mr, taps, bad, cfg)


# ------------------------------------------------------------------- pushes

@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_pushes_match_jax(case, mode):
    jp, tp = _pipelines(case, mode)
    js, ts = _states(case, jp, tp)
    _assert_tables_like_jax(jp, tp, js, ts)
    kind, n = ("noise", 2) if mode == "k1" else ("chirp_tone", 3)
    t = tp.chunk_size
    pcm = testing.make(kind, S, n * t, CFG.sample_rate, seed=1)
    texels = None
    if kind == "chirp_tone":
        padded = _padded(tp, pcm)
        texels = (testing.magnitude_texels(tstft.stft_rows_planar(torch.from_numpy(padded), CFG), CFG),
                  testing.magnitude_texels(np.asarray(jstft.stft_rows_planar(jnp.asarray(padded), JCFG)), CFG))
    jrows, trows = [], []
    for i in range(n):
        chunk = pcm[:, i * t : (i + 1) * t]
        js, jr = jp.push(js, jnp.asarray(chunk))
        ts, tr = tp.push(ts, torch.from_numpy(chunk))
        np.testing.assert_array_equal(ts.carry.numpy(), np.asarray(js.carry))
        jrows.append(_u8(jr))
        trows.append(_u8(tr))
    _assert_close(case, np.concatenate(trows, 1), np.concatenate(jrows, 1), texels)
    _assert_tables_like_jax(jp, tp, js, ts)
    if not tp.store_ring:
        return
    assert n * tp.chunk_hops > tp.viewport_rows                      # the ring wrapped
    assert testing.bf16_ulps(ts.ring, np.asarray(js.ring), STFT_ATOL) <= 1
    widths = {"generic_per_row": (None,), "generic_uniform": (9,)}.get(case, (None, 9))
    for width in widths:
        got = _u8(tp.render_viewport(ts, width))
        want = _u8(jp.render_viewport(js, width))
        view = (_view_texels(ts.ring.float(), int(ts.cursor), width, CFG),
                _view_texels(np.asarray(js.ring, np.float32), int(js.cursor), width, CFG))
        assert got.shape == (S, width or tp.viewport_rows, CFG.viewport_height, 4)
        _assert_close(case, got, want, view)


@pytest.mark.parametrize("mode", ["k1_ring", "k8"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_streamed_equals_process_and_static_equals_uniform(case, mode):
    """Inside the port, at the k and ring combinations the JAX comparison
    leaves out: streamed rows equal process() exactly; a static pipeline's
    rows, next carry and viewports equal those of the same registry with
    one palette set by a scalar set_palette, bit for bit."""
    generic, ids, static = CASES[case]
    k, ring = (1, True) if mode == "k1_ring" else (8, False)
    kw = dict(chunk_hops=k, store_ring=ring, viewport_rows=16, packed_output=True,
              device="cpu", schemes=_registry(tcs) if generic else None)
    tp = SpectrogramPipeline(CFG, static_palette=static, **kw)
    ts = tp.init_state(S)
    if ids is not None:
        ts = tp.set_palette(ts, ids)
    twin = twin_state = None
    if static is not None:
        twin = SpectrogramPipeline(CFG, **kw)
        twin_state = twin.set_palette(twin.init_state(S), tp.static_palette_id)
        assert twin_state.tables[0].shape[0] == 1 and ts.tables == ()
    t, n = tp.chunk_size, 24 // k
    pcm = testing.chirp_tone(S, n * t, CFG.sample_rate, seed=4)
    rows = []
    for i in range(n):
        chunk = torch.from_numpy(pcm[:, i * t : (i + 1) * t])
        ts, r = tp.push(ts, chunk)
        rows.append(r)
        if twin is not None:
            twin_state, tr = twin.push(twin_state, chunk)
            torch.testing.assert_close(r, tr, atol=0, rtol=0)
    streamed = torch.cat(rows, dim=1)
    padded = torch.from_numpy(_padded(tp, pcm))
    layout = np.broadcast_to(ts.palette_id.numpy(), (S,))
    for pid in np.unique(layout):
        sel = torch.from_numpy(np.flatnonzero(layout == pid))
        one = tp.process(padded.index_select(0, sel), palette_id=int(pid))
        torch.testing.assert_close(one, streamed.index_select(0, sel), atol=0, rtol=0)
    if static is not None:
        torch.testing.assert_close(tp.process(padded), streamed, atol=0, rtol=0)
        torch.testing.assert_close(ts.carry, twin_state.carry, atol=0, rtol=0)
        if ring:
            for width in (None, 9):
                torch.testing.assert_close(tp.render_viewport(ts, width),
                                           twin.render_viewport(twin_state, width),
                                           atol=0, rtol=0)


# --------------------------------------------------------------- the surface

def test_registries_and_static_arguments_as_in_jax():
    """The registry's kind, static_palette by name or index, its range
    check, set_palette's refusal and composite over a FactoredScheme's
    background, each as the JAX pipeline gives them; the port's own limit
    of 64 LUT entries for a static palette."""
    jp, tp = _pipelines("static_generic", "k1")
    assert tp.builtin_tables is None and jp.builtin_tables is None
    assert [t.shape for t in tp.generic_tables] == [t.shape for t in jp.generic_tables]
    assert tp.static_palette_id == jp.static_palette_id == 1
    np.testing.assert_array_equal(tp.static_table[0], np.asarray(jp.static_table[0], np.float32))
    np.testing.assert_array_equal(tp.static_table[1], np.asarray(jp.static_table[1], np.float32))
    js, ts = jp.init_state(S, palette_id=3), tp.init_state(S, palette_id=3)
    assert ts.palette_id.tolist() == np.asarray(js.palette_id).tolist() == [1] * S
    with pytest.raises(ValueError) as jerr:
        jp.set_palette(js, 2)
    with pytest.raises(ValueError) as terr:
        tp.set_palette(ts, 2)
    assert str(terr.value) == str(jerr.value)
    by_int = SpectrogramPipeline(CFG, static_palette=1, device="cpu")
    np.testing.assert_array_equal(
        by_int.static_table, SpectrogramPipeline(CFG, static_palette="Magma", device="cpu").static_table)
    for bad in (19, -1):
        with pytest.raises(ValueError, match="out of range"):
            JaxPipeline(JCFG, static_palette=bad)
        with pytest.raises(ValueError, match="out of range"):
            SpectrogramPipeline(CFG, static_palette=bad, device="cpu")
    with pytest.raises(ValueError):
        SpectrogramPipeline(CFG, static_palette="no such palette", device="cpu")
    with pytest.raises(ValueError, match="at most 64"):
        SpectrogramPipeline(CFG, static_palette=1, lut_resolution=128, device="cpu")
    # composite blends over each stream's own background, custom ones included
    jg, tg = _pipelines("generic_per_row", "k1")
    rgba = np.random.default_rng(8).integers(0, 256, (S, 3, 16, 4), dtype=np.uint8)
    ids = np.arange(S)
    want = np.asarray(jg.composite(jnp.asarray(rgba), jnp.asarray(ids)))
    got = tg.composite(torch.from_numpy(rgba), torch.from_numpy(ids)).numpy()
    assert got.shape == want.shape and np.abs(got.astype(int) - want.astype(int)).max() <= 1
    np.testing.assert_array_equal(tg.backgrounds[:2].numpy(), [[10, 10, 10], [0, 20, 40]])


@pytest.mark.parametrize("case", ["generic_per_row", "generic_uniform", "static_generic"])
def test_states_cross_load_both_ways(case):
    """A JAX generic (per-row, uniform) or static state loads into the
    port and pushes on as JAX does; state_to_numpy gives its tables tuple
    back exactly, and that loads back into JAX and pushes as the JAX state
    does."""
    jp, tp = _pipelines(case, "k1")
    js, _ = _states(case, jp, tp)
    first, second = (testing.noise(S, tp.chunk_size, seed=s) for s in (11, 12))
    js, _ = jp.push(js, jnp.asarray(first))
    d = _np_state(js)
    ts = state_from_jax(d, device="cpu")
    back = state_to_numpy(ts)
    assert len(back["tables"]) == (0 if case == "static_generic" else 2)
    for a, b in zip(back["tables"], d["tables"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for name in ("carry", "ring", "cursor", "palette_id", "row_count"):
        np.testing.assert_array_equal(back[name], np.asarray(d[name], back[name].dtype))
    js_back, jr_back = jp.push(_jax_state(back), jnp.asarray(second))
    js, jr = jp.push(js, jnp.asarray(second))
    np.testing.assert_array_equal(np.asarray(jr_back), np.asarray(jr))
    ts, tr = tp.push(ts, torch.from_numpy(second))
    _assert_close(case, _u8(tr), _u8(jr))
    np.testing.assert_array_equal(ts.carry.numpy(), np.asarray(js.carry))
    with pytest.raises(ValueError, match="generic"):
        state_from_jax(dict(d, tables=(d["carry"][:, 0], d["carry"][:, 0, :3])), device="cpu")
