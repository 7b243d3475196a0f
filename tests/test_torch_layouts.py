"""The port's split-real STFT layouts against the JAX pipeline, on the CPU.

The three knobs `stft_packed=False`, `transposed_carry=True` and
`framing="tsplit"`, their gates, their kernels' plain versions, whole pushes,
streamed == `process()`, and their states carried across with
`models/convert.py`.  The JAX side runs on its Pallas chain
(`stft_backend="pallas"`) in interpret mode, as its own tests run it, at
W=256, hop 64, H=64 (plan 16x32), and for tsplit, which needs a plan whose
n2 fills the TPU's 128 lanes, at W=2048, hop 800, H=128 (plan 32x128, the
geometry of `tests/test_pipeline.py`'s tsplit test).  The bars:

  * gates: both packages accept or both raise, with the same resolved
    attributes and the same initial carry;
  * kernels' plain versions against JAX's kernels: atol 3e-5 / rtol 1e-4
    (two f32 FFTs of different factorizations); next carry exactly;
  * pushes: rows within 1 u8 per channel over what the image shows
    (`testing.rgba_u8_diff`), carries exactly equal, rings within 1 bf16
    ulp beyond atol 3e-5 (`testing.bf16_ulps`);
  * inside the port: streamed == `process()` and sorted == per-row bit for
    bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectrogram_tpu.config as jcfg
from spectrogram_tpu.models.spectrogram import SpectrogramPipeline as JaxPipeline
from spectrogram_tpu.models.spectrogram import StreamState as JaxState
from spectrogram_tpu.ops.mxu_fft import FftPlan
from spectrogram_tpu.ops.pallas import stft_kernel as jsk

from spectrogram_tpu_torch import testing
from spectrogram_tpu_torch.config import BENCH_CONFIG, DEFAULT_CONFIG, SpectrogramConfig
from spectrogram_tpu_torch.models.convert import state_from_jax, state_to_numpy
from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline
from spectrogram_tpu_torch.ops.cuda import stft_kernel as tsk
from spectrogram_tpu_torch.ops.cuda.colormap_kernel import unpack_rgba

torch.set_num_threads(2)

SMALL = dict(sample_rate=8000.0, window_period=0.032, hop_period=0.008,
             viewport_height=64, viewport_rows=6)          # W=256, hop 64
TSPLIT = dict(sample_rate=48000.0, window_period=2048 / 48000.0,
              hop_period=800 / 48000.0, viewport_rows=8, viewport_height=128)
JAX_KW = dict(stft_backend="pallas", colormap_backend="pallas", kernel_interpret=True)
FLIP_PLAN = FftPlan(512, 4, 128, 64)   # a W=256 plan with a flip-capable n2
IDS = np.array([0, 1, 3, 8])           # stereo, mono, stereo, mono
STFT_ATOL, STFT_RTOL = 3e-5, 1e-4


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


def _configs(kw: dict):
    return SpectrogramConfig(**kw), jcfg.SpectrogramConfig(**kw)


def _pipelines(geometry: dict, **kw):
    """(JAX pipeline on its interpreted Pallas chain, port pipeline)."""
    tc, jc = _configs(geometry)
    return JaxPipeline(jc, **JAX_KW, **kw), SpectrogramPipeline(tc, device="cpu", **kw)


def _chunks(p, s: int, n: int, kind: str = "chirp_tone", seed: int = 1):
    pcm = testing.make(kind, s, n * p.chunk_size, p.cfg.sample_rate, seed=seed)
    return [np.ascontiguousarray(pcm[:, i * p.chunk_size : (i + 1) * p.chunk_size])
            for i in range(n)]


def _start(jp, ids, kind: str = "chirp_tone"):
    """A JAX state with per-stream palettes `ids` and a nonzero carry, and
    the same state in the port."""
    s = len(ids)
    js = jp.set_palette(jp.init_state(s), ids)
    carry = jnp.asarray(testing.make(kind, s, jp.carry_size, jp.cfg.sample_rate, seed=9)
                        .transpose(0, 2, 1).copy())
    if jp.carry_is_transposed:
        n1 = jp.fft_plan.n1
        carry = jnp.swapaxes(carry.reshape(s, 2, -1, n1), 2, 3)
    if jp.carry_sort_mode and jp._state_perm(js) is not None:
        carry = jnp.take(carry, jp._state_perm(js)[0], axis=0)
    js = js._replace(carry=carry)
    return js, state_from_jax(_np_state(js), device="cpu")


def _push_both(jp, tp, js, ts, chunk):
    js, jr = jp.push(js, jnp.asarray(chunk))
    ts, tr = tp.push(ts, torch.from_numpy(chunk))
    assert tr.shape == tuple(jr.shape)
    assert testing.rgba_u8_diff(unpack_rgba(tr), unpack_rgba(np.asarray(jr))) <= 1
    np.testing.assert_array_equal(ts.carry.numpy(), np.asarray(js.carry))
    if tp.store_ring:
        assert testing.bf16_ulps(ts.ring, np.asarray(js.ring), STFT_ATOL) <= 1
    return js, ts, tr


# ------------------------------------------------------------- (a) gates

GATE_GEOMETRIES = {
    "bench": (BENCH_CONFIG, jcfg.BENCH_CONFIG),
    "default": (DEFAULT_CONFIG, jcfg.DEFAULT_CONFIG),
    "tsplit_test": _configs(TSPLIT),
}
KNOBS = {
    "defaults": {},
    "split_real": dict(stft_packed=False),
    "packed": dict(stft_packed=True),
    "transposed": dict(transposed_carry=True),
    "transposed_split_real": dict(transposed_carry=True, stft_packed=False),
    "allk": dict(framing="allk"),
    "planes": dict(framing="planes"),
    "tsplit": dict(framing="tsplit"),
    "tsplit_split_real": dict(framing="tsplit", stft_packed=False),
    "transposed_tsplit": dict(transposed_carry=True, framing="tsplit"),
    "unpack_0": dict(stft_unpack_split=0),
    "unpack_2": dict(stft_unpack_split=2),
    "split_real_unpack_2": dict(stft_packed=False, stft_unpack_split=2),
    "split_real_unpack_0": dict(stft_packed=False, stft_unpack_split=0),
    "i16_split_real": dict(i16_planes=True, stft_packed=False),
    "i16_transposed": dict(i16_planes=True, transposed_carry=True),
    "i16_tsplit": dict(i16_planes=True, framing="tsplit"),
    "unknown_framing": dict(framing="buf"),
    "unknown_packed": dict(stft_packed="yes"),
    "unknown_unpack": dict(stft_unpack_split=1),
}
# what the knobs give at BENCH_CONFIG and DEFAULT_CONFIG (True: accepted)
EXPECTED = {
    ("bench", 1, "transposed"): True, ("bench", 8, "transposed"): True,
    ("default", 1, "transposed"): False, ("default", 8, "transposed"): False,
    ("bench", 1, "tsplit"): True, ("bench", 8, "tsplit"): False,
    ("default", 1, "tsplit"): False, ("default", 8, "allk"): False,
    ("bench", 8, "allk"): True,
}


@pytest.mark.parametrize("geometry", sorted(GATE_GEOMETRIES))
@pytest.mark.parametrize("k", [1, 8])
def test_knob_gates_equal_jax(geometry, k):
    tc, jc = GATE_GEOMETRIES[geometry]
    for name, kw in KNOBS.items():
        args = dict(chunk_hops=k, store_ring=False, **kw)
        errors = []
        for make in (lambda: JaxPipeline(jc, stft_backend="pallas", **args),
                     lambda: SpectrogramPipeline(tc, device="cpu", **args)):
            try:
                errors.append((make(), None))
            except ValueError as e:
                errors.append((None, e))
        (jp, jerr), (tp, terr) = errors
        assert (jerr is None) == (terr is None), (name, jerr, terr)
        if (geometry, k, name) in EXPECTED:
            assert (terr is None) == EXPECTED[geometry, k, name], name
        if kw.get("i16_planes"):
            assert terr is not None, name
        if terr is not None:
            continue
        assert dataclasses.astuple(tp.fft_plan) == dataclasses.astuple(jp.fft_plan)
        for attr in ("carry_transposed", "tsplit_framing", "carry_is_transposed",
                     "stft_unpack_split"):
            assert getattr(tp, attr) == getattr(jp, attr), (name, attr)
        if kw.get("stft_packed") is False:
            assert tp.stft_packed is False and jp.stft_packed is False
        tcarry, jcarry = tp.init_state(2).carry, jp.init_state(2).carry
        assert tuple(tcarry.shape) == jcarry.shape, name
        assert str(tcarry.dtype).split(".")[-1] == str(jcarry.dtype), name


def test_stft_packed_auto_is_packed_everywhere():
    """"auto" resolves to the packed kernels on every geometry the kernels
    take (the TPU's flat-2D gate has no counterpart), so the default paths
    do not move; split_real follows the knobs."""
    small, _ = _configs(SMALL)
    for cfg in (small, BENCH_CONFIG, DEFAULT_CONFIG):
        p = SpectrogramPipeline(cfg, chunk_hops=1, device="cpu")
        assert p.stft_packed and not p.split_real and p.stft_unpack_split == 3
    assert SpectrogramPipeline(small, stft_packed=False, device="cpu").split_real
    assert SpectrogramPipeline(small, transposed_carry=True, device="cpu").split_real


# ---------------------------------------------------- (b) kernels' plain

def _windows(cfg, kind: str, rows: int, seed: int = 2):
    pcm = testing.make(kind, rows, cfg.window_size, cfg.sample_rate, seed=seed)
    return tuple(np.ascontiguousarray(pcm[..., c]) for c in range(2))


def _assert_stft_close(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(g, np.asarray(w), atol=STFT_ATOL, rtol=STFT_RTOL)


@pytest.mark.parametrize("kind", ["chirp_tone", "noise"])
def test_split_plain_matches_jax_planes_and_allk(kind):
    tc, jc = _configs(SMALL)
    n = tc.padded_size
    hann = torch.from_numpy(tsk.split_hann(tc.window_size))
    left, right = _windows(tc, kind, 5)
    got = tsk.stft_mag_split_plain(torch.from_numpy(left), torch.from_numpy(right), hann, n)
    assert got[0].shape == (5, n // 2)
    # both TPU bodies: the default plan's (`_kernel2`) and a flip plan's
    # (`_kernel2_2d`)
    for plan in (None, FLIP_PLAN):
        want = jsk.stft_mag_fused2(jnp.asarray(left), jnp.asarray(right), jc,
                                   slice_bins=False, interpret=True, plan=plan)
        _assert_stft_close(got, want)
    k, s, h = 3, 2, tc.hop_size
    pcm = testing.make(kind, s, tc.window_size + (k - 1) * h, tc.sample_rate, seed=4)
    buf_l, buf_r = (np.ascontiguousarray(pcm[..., c]) for c in range(2))
    got = tsk.stft_mag_split_allk_plain(torch.from_numpy(buf_l), torch.from_numpy(buf_r),
                                        hann, n, k, h)
    want = jsk.stft_mag_fused2_allk(jnp.asarray(buf_l), jnp.asarray(buf_r), jc, k=k,
                                    interpret=True, packed=False)
    assert got[0].shape == (k * s, n // 2)
    _assert_stft_close(got, want)


@pytest.mark.parametrize("kind", ["chirp_tone", "noise"])
def test_split_plain_matches_jax_transposed(kind):
    tc, jc = _configs(SMALL)
    n, n1 = tc.padded_size, 16                     # the geometry's plan, 16x32
    hann = torch.from_numpy(tsk.split_hann(tc.window_size))
    left, right = _windows(tc, kind, 5)
    x = np.ascontiguousarray(np.stack([left, right], 1)
                             .reshape(5, 2, -1, n1).transpose(0, 1, 3, 2))
    got = tsk.stft_mag_split_t_plain(torch.from_numpy(x), hann, n)
    _assert_stft_close(got, jsk.stft_mag_fused2_t(jnp.asarray(x), jc, interpret=True))
    # the same windows as planes give the same bits
    planes = tsk.stft_mag_split_plain(torch.from_numpy(left), torch.from_numpy(right), hann, n)
    for a, b in zip(got, planes):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("hop", [64, 192])        # t_cols < c_cols, and >=
@pytest.mark.parametrize("kind", ["chirp_tone", "noise"])
def test_split_plain_matches_jax_tsplit(hop, kind):
    tc, jc = _configs(dict(SMALL, hop_period=hop / 8000.0))
    assert tc.hop_size == hop
    n, n1 = tc.padded_size, FLIP_PLAN.n1
    c_cols, t_cols = tc.window_size // n1 - hop // n1, hop // n1
    assert (t_cols >= c_cols) == (hop == 192)
    hann = torch.from_numpy(tsk.split_hann(tc.window_size))
    left, right = _windows(tc, kind, 3)
    x = np.stack([left, right], 1).reshape(3, 2, -1, n1).transpose(0, 1, 3, 2)
    carry = np.ascontiguousarray(x[..., :c_cols])
    chunk = np.ascontiguousarray(x[..., c_cols:])
    got = tsk.stft_mag_split_tsplit_plain(torch.from_numpy(carry), torch.from_numpy(chunk),
                                          hann, n)
    want = jsk.stft_mag_fused2_tsplit(jnp.asarray(carry), jnp.asarray(chunk), jc,
                                      interpret=True, plan=FLIP_PLAN)
    _assert_stft_close(got[:2], want[:2])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_split_wrappers_on_cpu_and_their_checks():
    tc, _ = _configs(SMALL)
    n, w, n1 = tc.padded_size, tc.window_size, 16
    hann = torch.from_numpy(tsk.split_hann(w))
    tw = tsk.fft_constants(n)
    left, right = (torch.from_numpy(a) for a in _windows(tc, "noise", 3))
    x = torch.stack([left, right], 1).reshape(3, 2, -1, n1).transpose(2, 3).contiguous()
    carry, chunk = x[..., :12].contiguous(), x[..., 12:].contiguous()
    planes = tsk.stft_mag_split(left, right, hann, tw)
    t = tsk.stft_mag_split_t(x, hann, tw)
    ts = tsk.stft_mag_split_tsplit(carry, chunk, hann, tw)
    allk = tsk.stft_mag_split_allk(left, right, hann, tw, 1, 64)
    for got in (t, ts[:2], allk):
        for a, b in zip(got, planes):
            torch.testing.assert_close(a, b, atol=0, rtol=0)
    torch.testing.assert_close(ts[2], torch.cat([carry, chunk], 3)[..., 4:], atol=0, rtol=0)
    # scale: twice the packed window, so twice the packed kernel's mags
    np.testing.assert_array_equal(tsk.split_hann(w), 2 * tsk.packed_hann(w))
    meta = [a.to("meta") for a in (left, right, x, carry, chunk)]
    for call in (lambda: tsk.stft_mag_split(meta[0], meta[1], hann, tw),
                 lambda: tsk.stft_mag_split_allk(meta[0], meta[1], hann, tw, 1, 64),
                 lambda: tsk.stft_mag_split_t(meta[2], hann, tw),
                 lambda: tsk.stft_mag_split_tsplit(meta[3], meta[4], hann, tw)):
        with pytest.raises(ValueError, match="no STFT kernel"):
            call()
    for call in (lambda: tsk.stft_mag_split(left, right[:, 1:], hann, tw),
                 lambda: tsk.stft_mag_split_allk(left, right, hann, tw, 2, 64),
                 lambda: tsk.stft_mag_split_t(x[..., 1:], hann, tw),
                 lambda: tsk.stft_mag_split_tsplit(carry, chunk[:2], hann, tw)):
        with pytest.raises(ValueError, match="do not fit"):
            call()


# ------------------------------------------------------------- (c) pushes

PUSHES = {
    # name: (geometry, pipeline arguments, pushes)
    "split_real_k1": (SMALL, dict(chunk_hops=1, store_ring=False, stft_packed=False), 3),
    "split_real_k3_ring": (SMALL, dict(chunk_hops=3, stft_packed=False), 3),
    "transposed_k1": (SMALL, dict(chunk_hops=1, store_ring=False, transposed_carry=True), 3),
    "transposed_k3_ring": (SMALL, dict(chunk_hops=3, transposed_carry=True), 3),
    "tsplit_k1": (TSPLIT, dict(chunk_hops=1, store_ring=False, framing="tsplit"), 3),
}


@pytest.mark.parametrize("name", sorted(PUSHES))
def test_pushes_match_jax(name):
    geometry, kw, n = PUSHES[name]
    jp, tp = _pipelines(geometry, packed_output=True, palette_sort=False, **kw)
    ids = IDS if geometry is SMALL else IDS[:2]
    js, ts = _start(jp, ids)
    assert ts.carry.ndim == (4 if tp.carry_is_transposed else 3)
    for chunk in _chunks(tp, len(ids), n):
        js, ts, _ = _push_both(jp, tp, js, ts, chunk)
    if tp.store_ring:
        assert n * tp.chunk_hops > tp.viewport_rows                  # wrapped
        want = unpack_rgba(np.asarray(jp.render_viewport(js, 9)))
        assert testing.rgba_u8_diff(unpack_rgba(tp.render_viewport(ts, 9)), want) <= 1


@pytest.mark.parametrize("name", sorted(PUSHES))
def test_streamed_equals_process_and_plain(name):
    """Inside the port: streamed == process() bit for bit (the push's
    kernel and process()'s share the split-real row), and the
    with_plain_kernels() twin pushes the same rows."""
    geometry, kw, n = PUSHES[name]
    tc, _ = _configs(geometry)
    p = SpectrogramPipeline(tc, packed_output=True, device="cpu", **kw)
    ids = IDS if geometry is SMALL else IDS[:2]
    s = len(ids)
    state = p.set_palette(p.init_state(s), ids)
    twin, twin_state = p.with_plain_kernels(), state
    pcm = testing.chirp_tone(s, n * p.chunk_size, tc.sample_rate, seed=4)
    rows = []
    for i in range(n):
        chunk = torch.from_numpy(pcm[:, i * p.chunk_size : (i + 1) * p.chunk_size])
        state, r = p.push(state, chunk)
        twin_state, tr = twin.push(twin_state, chunk)
        torch.testing.assert_close(tr, r, atol=0, rtol=0)
        rows.append(r)
    streamed = torch.cat(rows, dim=1)
    padded = np.concatenate([np.zeros((s, p.carry_size, 2), np.float32), pcm], axis=1)
    for i, pid in enumerate(ids):
        one = p.process(torch.from_numpy(padded[i]), palette_id=int(pid))
        torch.testing.assert_close(one, streamed[i], atol=0, rtol=0)


def test_split_real_rows_within_a_u8_of_packed():
    """The split-real and the packed STFT differ by FFT rounding only: the
    same process() rows within 1 u8 over what the image shows."""
    tc, _ = _configs(SMALL)
    kw = dict(chunk_hops=1, store_ring=False, packed_output=False, device="cpu")
    packed = SpectrogramPipeline(tc, **kw)
    split = SpectrogramPipeline(tc, stft_packed=False, **kw)
    pcm = torch.from_numpy(testing.chirp_tone(2, 5 * tc.hop_size + tc.window_size,
                                              tc.sample_rate, seed=3))
    a, b = packed.process(pcm, 0), split.process(pcm, 0)
    assert testing.rgba_u8_diff(a.numpy(), b.numpy()) <= 1


# --------------------------------------------------- (d) palette sort

SORTED = {
    "transposed": (SMALL, dict(transposed_carry=True)),
    "tsplit": (TSPLIT, dict(framing="tsplit")),
}


@pytest.mark.parametrize("name", sorted(SORTED))
def test_sorted_state_matches_jax_and_per_row(name):
    """Carry-sort mode on a 4-D carry: the sorted state's pushes match
    JAX's and equal the per-row pipeline's bit for bit, carry[inv] included;
    presorted_input + sorted_output give the same rows through output_perm;
    unsort_state gives the per-row carry back."""
    geometry, knob = SORTED[name]
    kw = dict(chunk_hops=1, store_ring=False, packed_output=True, **knob)
    jp, tp = _pipelines(geometry, **kw)
    tc, _ = _configs(geometry)
    per_row = SpectrogramPipeline(tc, palette_sort=False, device="cpu", **kw)
    full = SpectrogramPipeline(tc, presorted_input=True, sorted_output=True,
                               device="cpu", **kw)
    s = 256
    ids = np.arange(s) % 2
    js, ts = _start(jp, ids)
    assert tp.palette_layout.read(ts.tables).sorted and ts.carry.ndim == 4
    for a, b in zip(state_to_numpy(ts)["tables"], _np_state(js)["tables"]):
        np.testing.assert_array_equal(a, b)
    rs = per_row.set_palette(per_row.init_state(s), ids)
    inv = tp.palette_layout.global_perms(ts.tables)[1]
    rs = rs._replace(carry=ts.carry.index_select(0, inv))
    fs = full.set_palette(full.init_state(s), ids)._replace(carry=ts.carry)
    perm, out = full.input_perm(fs), torch.from_numpy(full.output_perm(fs))
    for chunk in _chunks(tp, s, 2, kind="noise"):
        js, ts, tr = _push_both(jp, tp, js, ts, chunk)
        rs, rr = per_row.push(rs, torch.from_numpy(chunk))
        fs, fr = full.push(fs, torch.from_numpy(chunk[perm]))
        torch.testing.assert_close(tr, rr, atol=0, rtol=0)
        torch.testing.assert_close(fr.index_select(0, out), rr, atol=0, rtol=0)
    torch.testing.assert_close(ts.carry.index_select(0, inv), rs.carry, atol=0, rtol=0)
    torch.testing.assert_close(fs.carry, ts.carry, atol=0, rtol=0)
    torch.testing.assert_close(tp.unsort_state(ts).carry, rs.carry, atol=0, rtol=0)


# ------------------------------------------------------------ (e) convert

CONVERT = {
    "transposed": (SMALL, dict(transposed_carry=True), False),
    "transposed_sorted": (SMALL, dict(transposed_carry=True), True),
    "tsplit": (TSPLIT, dict(framing="tsplit"), False),
    "tsplit_sorted": (TSPLIT, dict(framing="tsplit"), True),
}


@pytest.mark.parametrize("name", sorted(CONVERT))
def test_transposed_states_carry_across_both_ways(name):
    """A transposed-carry state goes JAX -> port -> JAX unchanged; pushing
    the converted state in both packages gives the same rows within the bar
    and the same next carry exactly; a planar state pushed into a
    transposed pipeline raises."""
    geometry, knob, sort = CONVERT[name]
    kw = dict(chunk_hops=1, store_ring=False, packed_output=True, palette_sort=sort, **knob)
    jp, tp = _pipelines(geometry, **kw)
    s = 256 if sort else 3
    ids = np.arange(s) % 2 if sort else IDS[:3]
    chunks = _chunks(tp, s, 2, kind="noise", seed=7)
    js = jp.set_palette(jp.init_state(s), ids)
    js, _ = jp.push(js, jnp.asarray(chunks[0]))
    d = _np_state(js)
    ts = state_from_jax(d, device="cpu")
    assert ts.carry.dtype == torch.float32 and ts.carry.ndim == 4
    assert (tp.palette_layout.read(ts.tables).sorted) == sort
    back = state_to_numpy(ts)
    for key in ("carry", "ring", "cursor", "palette_id", "row_count"):
        np.testing.assert_array_equal(back[key], np.asarray(d[key], back[key].dtype))
    for a, b in zip(back["tables"], d["tables"]):
        np.testing.assert_array_equal(a, b)
    js2, jr = jp.push(_jax_state(back), jnp.asarray(chunks[1]))
    ts, tr = tp.push(ts, torch.from_numpy(chunks[1]))
    assert testing.rgba_u8_diff(unpack_rgba(tr), unpack_rgba(np.asarray(jr))) <= 1
    np.testing.assert_array_equal(ts.carry.numpy(), np.asarray(js2.carry))
    planar = SpectrogramPipeline(tp.cfg, device="cpu",
                                 **dict(kw, transposed_carry=False, framing="auto"))
    with pytest.raises(ValueError, match="transposed"):
        tp.push(planar.init_state(s), torch.from_numpy(chunks[1]))
    with pytest.raises(ValueError, match="planar"):
        planar.push(ts, torch.from_numpy(chunks[1]))
