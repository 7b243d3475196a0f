"""The port's display path against the JAX pipeline, on the CPU.

The display path: a push of k = chunk_hops hops per stream on the
all-windows STFT, the bf16 row ring, `render_viewport` and `composite`.
Both pipelines start from the same state (a nonzero carry and scattered
per-stream palettes, carried over with `state_from_jax`) and push the same
chunks, enough to wrap the ring.  The bars:

  * rows and rendered viewports within 1 u8 per channel over what the image
    shows (`testing.rgba_u8_diff`);
  * next carry, cursor and row_count exactly equal;
  * ring within 1 bf16 ulp beyond the STFT bar's atol (`testing.bf16_ulps`):
    two f32 STFTs that agree to 3e-5 round to neighbouring bf16 values at
    worst.

Plain kernels are held against the JAX kernels in interpret mode with the
bars the JAX suite itself uses: atol 3e-5 / rtol 1e-4 for two packed STFTs
of different factorizations, rtol 1e-3 / atol 1e-6 against a split-real one
(tests/test_pallas_stft.py).
"""

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
from spectrogram_tpu_torch.models import spectrogram as tspec
from spectrogram_tpu_torch.models.convert import state_from_jax, state_to_numpy
from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline
from spectrogram_tpu_torch.ops.cuda import stft_kernel as tsk
from spectrogram_tpu_torch.ops.cuda.colormap_kernel import unpack_rgba

torch.set_num_threads(2)

SMALL = dict(sample_rate=8000.0, window_period=0.032, hop_period=0.008)  # W=256, hop 64
PACKED_PLAN = FftPlan(512, 4, 128, 64)
IDS = np.array([0, 1, 3, 8])            # stereo, mono, stereo, mono
STFT_ATOL, STFT_RTOL = 3e-5, 1e-4


def _np_state(state) -> dict:
    d = {k: np.asarray(v) for k, v in state._asdict().items() if k != "tables"}
    d["tables"] = tuple(np.asarray(t) for t in state.tables)
    return d


def _jax_state(d: dict) -> JaxState:
    ring = jnp.asarray(d["ring"]).astype(jnp.bfloat16)
    return JaxState(
        carry=jnp.asarray(d["carry"]), ring=ring, cursor=jnp.asarray(d["cursor"]),
        palette_id=jnp.asarray(d["palette_id"]),
        row_count=jnp.asarray(d["row_count"]),
        tables=tuple(jnp.asarray(t) for t in d["tables"]),
    )


def _buffers(cfg, k: int, s: int, seed: int = 3):
    """[S, W + (k-1)*hop] f32 left and right sample buffers."""
    n = cfg.window_size + (k - 1) * cfg.hop_size
    pcm = testing.chirp_tone(s, n, cfg.sample_rate, seed=seed)
    return (np.ascontiguousarray(pcm[..., 0]), np.ascontiguousarray(pcm[..., 1]))


def _check_step(js, ts, jr, tr):
    np.testing.assert_array_equal(ts.carry.numpy(), np.asarray(js.carry))
    assert int(ts.cursor) == int(js.cursor)
    assert int(ts.row_count) == int(js.row_count)
    assert tr.shape == jr.shape
    assert testing.rgba_u8_diff(unpack_rgba(tr), unpack_rgba(np.asarray(jr))) <= 1
    assert testing.bf16_ulps(ts.ring, np.asarray(js.ring), STFT_ATOL) <= 1


def _run_both(jp, tp, cfg, kind, n_pushes, widths, ids=IDS):
    """Push the same chunks through both pipelines, checking every step,
    then render the viewport at each width on both."""
    s = len(ids)
    js = jp.set_palette(jp.init_state(s), ids)
    carry = testing.make(kind, s, jp.carry_size, cfg.sample_rate, seed=9)
    js = js._replace(carry=jnp.asarray(carry.transpose(0, 2, 1).copy()))
    ts = state_from_jax(_np_state(js), device="cpu")
    t = jp.chunk_size
    pcm = testing.make(kind, s, n_pushes * t, cfg.sample_rate, seed=1)
    for i in range(n_pushes):
        chunk = pcm[:, i * t : (i + 1) * t]
        js, jr = jp.push(js, jnp.asarray(chunk))
        ts, tr = tp.push(ts, torch.from_numpy(chunk))
        _check_step(js, ts, jr, tr)
    assert n_pushes * tp.chunk_hops > tp.viewport_rows      # the ring wrapped
    for width in widths:
        want = unpack_rgba(np.asarray(jp.render_viewport(js, width)))
        got = unpack_rgba(tp.render_viewport(ts, width))
        rows = width or tp.viewport_rows
        assert got.shape == want.shape == (s, rows, cfg.viewport_height, 4)
        assert testing.rgba_u8_diff(got, want) <= 1
    return js, ts


# --------------------------------------------------------------- (a) kernels

def test_allk_plain_matches_tpu_allk_and_buf():
    cfg, jc = SpectrogramConfig(**SMALL), jcfg.SpectrogramConfig(**SMALL)
    k, s = 3, 5
    buf_l, buf_r = _buffers(cfg, k, s)
    hann = torch.from_numpy(tsk.packed_hann(cfg.window_size))
    got = tsk.stft_mag_packed_allk_plain(
        torch.from_numpy(buf_l), torch.from_numpy(buf_r), hann,
        cfg.padded_size, k, cfg.hop_size)
    assert got[0].shape == (k * s, cfg.padded_size // 2)
    packed = jsk.stft_mag_fused2_allk(
        jnp.asarray(buf_l), jnp.asarray(buf_r), jc, k=k, interpret=True,
        plan=PACKED_PLAN, packed=True)
    buf = jsk.stft_mag_fused2_buf(
        jnp.asarray(buf_l), jnp.asarray(buf_r), jc, k=k, interpret=True,
        plan=PACKED_PLAN)
    for g, p, b in zip(got, packed, buf):
        np.testing.assert_allclose(g.numpy(), np.asarray(p), atol=STFT_ATOL, rtol=STFT_RTOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(b), atol=1e-6, rtol=1e-3)


def test_allk_wrapper_on_cpu_and_its_checks():
    cfg = SpectrogramConfig(**SMALL)
    k, s, h = 3, 2, cfg.hop_size
    buf_l, buf_r = (torch.from_numpy(b) for b in _buffers(cfg, k, s, seed=5))
    hann = torch.from_numpy(tsk.packed_hann(cfg.window_size))
    tw = tsk.fft_constants(cfg.padded_size)
    got = tsk.stft_mag_packed_allk(buf_l, buf_r, hann, tw, k, h)
    # window r of stream s at row r*S + s, as the window-plane kernel gives it
    for r in range(k):
        want = tsk.stft_mag_packed(buf_l[:, r * h : r * h + cfg.window_size].contiguous(),
                                   buf_r[:, r * h : r * h + cfg.window_size].contiguous(),
                                   hann, tw)
        for g, w in zip(got, want):
            torch.testing.assert_close(g[r * s : (r + 1) * s], w, atol=0, rtol=0)
    with pytest.raises(ValueError, match="no STFT kernel"):
        tsk.stft_mag_packed_allk(buf_l.to("meta"), buf_r.to("meta"), hann, tw, k, h)
    with pytest.raises(ValueError, match="do not fit"):
        tsk.stft_mag_packed_allk(buf_l, buf_r, hann, tw, k + 1, h)


def test_rows_per_table_reads_stream_major_rows():
    """Row n reads tables[(n // R') % T]: the viewport's R' rows per stream
    share their stream's table, with no repeated copy of the tables."""
    from spectrogram_tpu_torch.ops import colormap as tcm
    from spectrogram_tpu_torch.ops.cuda import colormap_kernel as tck

    cfg = SpectrogramConfig(**SMALL)
    s, rows = 3, 4
    rng = np.random.default_rng(4)
    ml, mr = (torch.from_numpy(np.abs(rng.standard_normal((s * rows, cfg.num_bins)))
                               .astype(np.float32) * 0.05) for _ in range(2))
    taps = tck.resample_taps(tcm.resample_matrix(cfg))
    tables = torch.from_numpy(tck.builtin_color_tables()[[2, 9, 0]])
    got = tck.colormap_builtin(ml, mr, taps, tables, cfg, rows_per_table=rows)
    want = tck.colormap_builtin_plain(ml, mr, taps, tables.repeat_interleave(rows, 0), cfg)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    with pytest.raises(ValueError, match="do not fit"):
        tck.colormap_builtin(ml, mr, taps, tables, cfg, rows_per_table=0)


# ------------------------------------------------------------ (b), (c) push

@pytest.mark.parametrize("kind", ["chirp_tone", "noise"])
@pytest.mark.parametrize("plan", ["default", "packed"])
def test_display_path_matches_jax_pallas_small(kind, plan):
    jp = JaxPipeline(
        jcfg.SpectrogramConfig(**SMALL), chunk_hops=3, viewport_rows=6,
        store_ring=True, packed_output=True, stft_backend="pallas",
        colormap_backend="pallas", kernel_interpret=True, palette_sort=False,
    )
    if plan == "packed":
        jp.override_plan(PACKED_PLAN)
        assert jp.stft_packed and jp.allk_framing
    cfg = SpectrogramConfig(**SMALL)
    tp = SpectrogramPipeline(cfg, chunk_hops=3, viewport_rows=6, packed_output=True,
                             device="cpu")
    # each width compiles its own interpret-mode render (~3 s): magnify on
    # the tonal input, minify on noise
    widths = (None, 9) if kind == "chirp_tone" else (4,)
    _run_both(jp, tp, cfg, kind, n_pushes=3, widths=widths)


@pytest.mark.parametrize("geometry", ["bench", "default"])
def test_display_path_matches_jax_xla(geometry):
    cfg = {"bench": BENCH_CONFIG, "default": DEFAULT_CONFIG}[geometry]
    jc = {"bench": jcfg.BENCH_CONFIG, "default": jcfg.DEFAULT_CONFIG}[geometry]
    jp = JaxPipeline(jc, chunk_hops=8, viewport_rows=16, store_ring=True,
                     packed_output=True, stft_backend="xla",
                     colormap_backend="xla", palette_sort=False)
    tp = SpectrogramPipeline(cfg, chunk_hops=8, viewport_rows=16, packed_output=True,
                             device="cpu")
    # 2 streams: one stereo, one mono
    _run_both(jp, tp, cfg, "chirp_tone", n_pushes=3, widths=(None, 24), ids=IDS[:2])


# ------------------------------------------------ (d) streamed == one-shot

@pytest.mark.parametrize("geometry", ["small", "default"])
def test_streamed_k8_equals_one_shot(geometry):
    cfg = SpectrogramConfig(**SMALL) if geometry == "small" else DEFAULT_CONFIG
    p = SpectrogramPipeline(cfg, chunk_hops=8, viewport_rows=16, packed_output=True,
                            device="cpu")
    s, n = 3, 3
    state = p.set_palette(p.init_state(s), IDS[:s])
    pcm = testing.chirp_tone(s, n * p.chunk_size, cfg.sample_rate, seed=4)
    rows = []
    for i in range(n):
        state, r = p.push(state, torch.from_numpy(pcm[:, i * p.chunk_size : (i + 1) * p.chunk_size]))
        assert r.shape == (s, 8, cfg.viewport_height)
        rows.append(r)
    streamed = torch.cat(rows, dim=1)
    padded = np.concatenate([np.zeros((s, p.carry_size, 2), np.float32), pcm], axis=1)
    for i, pid in enumerate(IDS[:s]):
        one = p.process(torch.from_numpy(padded[i]), palette_id=int(pid))
        torch.testing.assert_close(one, streamed[i], atol=0, rtol=0)


def test_k8_push_equals_eight_k1_pushes():
    cfg = SpectrogramConfig(**SMALL)
    p8 = SpectrogramPipeline(cfg, chunk_hops=8, viewport_rows=16, packed_output=True,
                             device="cpu")
    p1 = SpectrogramPipeline(cfg, chunk_hops=1, viewport_rows=16, packed_output=True,
                             device="cpu")
    s = 3
    a = p8.set_palette(p8.init_state(s), IDS[:s])
    b = p1.set_palette(p1.init_state(s), IDS[:s])
    pcm = testing.noise(s, 3 * p8.chunk_size, seed=6)
    hop = cfg.hop_size
    for i in range(3):
        a, ra = p8.push(a, torch.from_numpy(pcm[:, i * p8.chunk_size : (i + 1) * p8.chunk_size]))
        rb = []
        for j in range(8):
            at = i * p8.chunk_size + j * hop
            b, r = p1.push_planar(b, torch.from_numpy(pcm[:, at : at + hop]).transpose(1, 2))
            rb.append(r)
        torch.testing.assert_close(ra, torch.cat(rb, dim=1), atol=0, rtol=0)
        for name in ("carry", "ring", "cursor", "row_count"):
            torch.testing.assert_close(getattr(a, name), getattr(b, name), atol=0, rtol=0)


# --------------------------------------------------------- render, composite

def test_render_blocks_and_wrap(monkeypatch):
    """Rendering in blocks of one stream gives the same viewport, and the
    viewport is the ring rolled by the cursor: the newest row last."""
    cfg = SpectrogramConfig(**SMALL, viewport_height=32)
    p = SpectrogramPipeline(cfg, chunk_hops=2, viewport_rows=5, device="cpu",
                            packed_output=False)
    assert p.viewport_rows == 6
    state = p.set_palette(p.init_state(3), 4)
    pcm = testing.chirp_tone(3, 4 * p.chunk_size, cfg.sample_rate, seed=2)
    for i in range(4):
        state, rows = p.push(state, torch.from_numpy(pcm[:, i * p.chunk_size : (i + 1) * p.chunk_size]))
    whole = {w: p.render_viewport(state, w) for w in (None, 11)}
    assert whole[None].dtype == torch.uint8 and whole[None].shape == (3, 6, 32, 4)
    assert whole[11].shape == (3, 11, 32, 4)
    # the last push's rows are the newest two: the ring's bf16 rounding
    # moves them by at most 1 u8 from the pushed f32 rows
    assert testing.rgba_u8_diff(whole[None][:, -2:].numpy(), rows.numpy()) <= 1
    monkeypatch.setattr(tspec, "RENDER_BLOCK_BYTES", 1)
    for w, want in whole.items():
        torch.testing.assert_close(p.render_viewport(state, w), want, atol=0, rtol=0)
    with pytest.raises(ValueError, match="no ring"):
        SpectrogramPipeline(cfg, store_ring=False, device="cpu").render_viewport(state)
    # a ringless state cannot feed a pipeline that keeps a ring
    ringless = SpectrogramPipeline(cfg, chunk_hops=2, store_ring=False, device="cpu")
    with pytest.raises(ValueError, match="ring has 0 rows"):
        p.push(ringless.init_state(3), torch.from_numpy(pcm[:, : p.chunk_size]))


@pytest.mark.parametrize("shape", ["rows", "viewport"])
def test_composite_matches_jax(shape):
    jp = JaxPipeline(jcfg.SpectrogramConfig(**SMALL), chunk_hops=1,
                     store_ring=False, palette_sort=False)
    tp = SpectrogramPipeline(SpectrogramConfig(**SMALL), chunk_hops=1, device="cpu")
    rng = np.random.default_rng(8)
    dims = (4, 3, 16) if shape == "rows" else (4, 16)
    rgba = rng.integers(0, 256, dims + (4,), dtype=np.uint8)
    ids = np.array([0, 1, 5, 18])
    want = np.asarray(jp.composite(jnp.asarray(rgba), jnp.asarray(ids)))
    got = tp.composite(torch.from_numpy(rgba), torch.from_numpy(ids)).numpy()
    assert got.shape == want.shape == dims + (3,)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


# -------------------------------------------------------------- (e) convert

def test_ringed_state_cross_loads_both_ways():
    """A JAX state with a wrapped ring loads into the port, and the port's
    state loads back into JAX; both then push on in step."""
    cfg, jc = SpectrogramConfig(**SMALL), jcfg.SpectrogramConfig(**SMALL)
    jp = JaxPipeline(jc, chunk_hops=3, viewport_rows=6, store_ring=True,
                     packed_output=True, stft_backend="xla",
                     colormap_backend="xla", palette_sort=False)
    tp = SpectrogramPipeline(cfg, chunk_hops=3, viewport_rows=6, packed_output=True,
                             device="cpu")
    s, t = len(IDS), jp.chunk_size
    pcm = testing.chirp_tone(s, 5 * t, cfg.sample_rate, seed=12)
    chunks = [pcm[:, i * t : (i + 1) * t] for i in range(5)]
    js = jp.set_palette(jp.init_state(s), IDS)
    for c in chunks[:3]:
        js, _ = jp.push(js, jnp.asarray(c))
    d = _np_state(js)
    ts = state_from_jax(d, device="cpu")
    back = state_to_numpy(ts)
    for k in ("carry", "ring", "cursor", "palette_id", "row_count"):
        np.testing.assert_array_equal(back[k], np.asarray(d[k], back[k].dtype))
    assert back["ring"].shape == (s, 6, 2, cfg.num_bins) and int(back["cursor"]) == 3
    # JAX -> port, pushed on by the port; port -> JAX, pushed on by JAX
    js, jr = jp.push(js, jnp.asarray(chunks[3]))
    ts, tr = tp.push(ts, torch.from_numpy(chunks[3]))
    _check_step(js, ts, jr, tr)
    js2, jr2 = jp.push(_jax_state(state_to_numpy(ts)), jnp.asarray(chunks[4]))
    js, jr = jp.push(js, jnp.asarray(chunks[4]))
    np.testing.assert_array_equal(np.asarray(jr2), np.asarray(jr))
    assert testing.bf16_ulps(np.asarray(js2.ring), np.asarray(js.ring), STFT_ATOL) <= 1


# ----------------------------------------------------------- default device

def test_pipeline_runs_on_the_card_by_default():
    """Without a device the pipeline and the state loader take the card;
    with no card they raise rather than run on the CPU."""
    cfg = SpectrogramConfig(**SMALL)
    if torch.cuda.is_available():
        assert SpectrogramPipeline(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SpectrogramPipeline(cfg)
    state = _np_state(JaxPipeline(jcfg.SpectrogramConfig(**SMALL), chunk_hops=1,
                                  palette_sort=False).init_state(2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        state_from_jax(state)
    assert SpectrogramPipeline(cfg, device="cpu").device == torch.device("cpu")
