"""The port's oscilloscope, spectrum analyzer and live-view composition
against the JAX package's, on the CPU.

Mirrors `tests/test_visualizers.py`.  The same seeded numpy inputs go
through the JAX models (their jitted CPU functions) and the port's
(`device="cpu"`).  The bars:

  * scope envelopes exactly equal (the same values' min / max), cursors
    equal;
  * analyzer levels within 1e-5 absolute of JAX's (the band products
    differ: JAX's f32 matmul against the port's float64 product rounded to
    f32), and within 1e-6 of a float64 band product followed by the same
    f32 law;
  * `rasterize`, `rasterize_levels`, `StreamScroller`, `tile_grid` on
    equal numpy inputs exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectrogram_tpu.config as jcfg
from spectrogram_tpu.color.colorscheme import DEFAULT_COLOR_SCHEMES as JSCHEMES
from spectrogram_tpu.models.oscilloscope import Oscilloscope as JaxScope
from spectrogram_tpu.models.spectrum_analyzer import SpectrumAnalyzer as JaxAnalyzer
from spectrogram_tpu.ops import stft as jstft
from spectrogram_tpu.utils import liveview as jlive

from spectrogram_tpu_torch.color.colorscheme import DEFAULT_COLOR_SCHEMES, scheme_by_name
from spectrogram_tpu_torch.config import SpectrogramConfig
from spectrogram_tpu_torch.models import spectrum_analyzer as tsa
from spectrogram_tpu_torch.models.oscilloscope import Oscilloscope
from spectrogram_tpu_torch.models.spectrum_analyzer import SpectrumAnalyzer
from spectrogram_tpu_torch.ops import stft as tstft
from spectrogram_tpu_torch.utils import liveview as tlive

torch.set_num_threads(2)

KW = dict(sample_rate=8000.0, window_period=0.032, hop_period=0.008)
CFG, JCFG = SpectrogramConfig(**KW), jcfg.SpectrogramConfig(**KW)
LEVELS_ATOL = 1e-5


def _scopes(push_size, buffer_size):
    return (Oscilloscope(push_size, buffer_size, device="cpu"),
            JaxScope(push_size, buffer_size))


def test_scope_push_and_envelope():
    scope, jscope = _scopes(64, 256)
    s, js = scope.init_state(2), jscope.init_state(2)
    ramp = np.linspace(-1, 1, 64, dtype=np.float32)
    chunk = np.stack(
        [np.stack([ramp, -ramp], -1), np.stack([ramp * 0.5, ramp * 0.0], -1)]
    )
    s = scope.push(s, torch.from_numpy(chunk))
    js = jscope.push(js, jnp.asarray(chunk))
    assert int(s.cursor) == int(js.cursor) == 64
    env = scope.envelope(s, width=8).numpy()
    assert env.shape == (2, 8, 2, 2)
    np.testing.assert_array_equal(env, np.asarray(jscope.envelope(js, 8)))
    # chronological: cursor=64, so columns 0..5 are the (zero) unwritten tail,
    # columns 6..7 hold the ramp
    np.testing.assert_allclose(env[:, :6], 0.0)
    assert env[0, 6, 0, 0] == pytest.approx(-1.0)   # left min of first half
    assert env[0, 7, 0, 1] == pytest.approx(1.0)    # left max of second half
    assert env[0, 6, 1, 1] == pytest.approx(1.0)    # right = -ramp
    # wrap: 3 more pushes fills the ring; cursor returns to 0
    for _ in range(3):
        s = scope.push(s, torch.from_numpy(chunk))
    assert int(s.cursor) == 0
    assert s.cursor.dtype == torch.int32 and s.cursor.ndim == 0


@pytest.mark.parametrize("width", [1, 7, 8, 100, 300])
def test_scope_envelope_after_wraps_equals_jax(width):
    """Random pushes past several wraps (a 100-sample push, the buffer
    rounded up to 300): envelopes equal JAX's exactly at dividing and
    non-dividing widths."""
    scope, jscope = _scopes(100, 256)
    assert scope.buffer_size == jscope.buffer_size == 300
    rng = np.random.default_rng(width)
    s, js = scope.init_state(3), jscope.init_state(3)
    for _ in range(7):
        chunk = rng.standard_normal((3, 100, 2)).astype(np.float32)
        s = scope.push(s, chunk)
        js = jscope.push(js, jnp.asarray(chunk))
        np.testing.assert_array_equal(scope.envelope(s, width).numpy(),
                                      np.asarray(jscope.envelope(js, width)))
    assert int(s.cursor) == int(js.cursor) == 100


def test_scope_validation():
    # buffer rounds up to a push_size multiple
    assert Oscilloscope(push_size=100, buffer_size=256, device="cpu").buffer_size == 300
    scope = Oscilloscope(push_size=64, buffer_size=256, device="cpu")
    with pytest.raises(ValueError):
        scope.envelope(scope.init_state(1), width=0)
    with pytest.raises(ValueError):
        scope.envelope(scope.init_state(1), width=scope.buffer_size + 1)
    env = scope.envelope(scope.init_state(1), width=7)
    assert env.shape == (1, 7, 2, 2)
    with pytest.raises(ValueError, match="chunk"):
        scope.push(scope.init_state(1), torch.zeros(1, 32, 2))


def test_scope_line_colors():
    for scheme, jscheme in zip(DEFAULT_COLOR_SCHEMES, JSCHEMES):
        left, right = Oscilloscope.line_colors(scheme)
        jleft, jright = JaxScope.line_colors(jscheme)
        np.testing.assert_array_equal(left, jleft)
        np.testing.assert_array_equal(right, jright)
    left, right = Oscilloscope.line_colors(scheme_by_name("Blue-Yellow-Red (Stereo)"))
    assert not np.array_equal(left, right)


@pytest.mark.parametrize("palette", [1, 0, 12])
def test_scope_rasterize_equals_jax(palette):
    rng = np.random.default_rng(palette)
    env = np.sort(rng.uniform(-1.3, 1.3, (40, 2, 2)).astype(np.float32), axis=-1)
    env[5] = 0.0
    scheme, jscheme = DEFAULT_COLOR_SCHEMES[palette], JSCHEMES[palette]
    scope, jscope = _scopes(64, 256)
    for height in (41, 64):
        img = scope.rasterize(env, height, scheme)
        np.testing.assert_array_equal(img, jscope.rasterize(env, height, jscheme))
        # a tensor envelope rasterizes the same
        np.testing.assert_array_equal(scope.rasterize(torch.from_numpy(env), height, scheme),
                                      img)


def test_scope_rasterize_vectorized():
    scope = Oscilloscope(push_size=64, buffer_size=256, device="cpu")
    scheme = scheme_by_name("Magma")
    env = np.zeros((8, 2, 2), np.float32)
    env[:, :, 0], env[:, :, 1] = -0.5, 0.5    # full-width band
    env[3] = 0.0                              # column 3: a single point
    img = scope.rasterize(env, height=41, scheme=scheme)
    assert img.shape == (41, 8, 3)
    lcol, rcol = scope.line_colors(scheme)
    np.testing.assert_array_equal(img[20, 0], rcol)
    bg = np.asarray(scheme.background_color(), np.uint8)
    np.testing.assert_array_equal(img[5, 0], bg)
    np.testing.assert_array_equal(img[35, 0], bg)
    np.testing.assert_array_equal(img[10, 0], rcol)
    np.testing.assert_array_equal(img[30, 0], rcol)
    painted = (img[:, 3] != bg).any(axis=-1)
    assert painted.sum() == 1 and painted[20]


def _analyzers(n_bands):
    return SpectrumAnalyzer(CFG, n_bands, device="cpu"), JaxAnalyzer(JCFG, n_bands)


def test_analyzer_tone_hits_expected_band():
    ana, jana = _analyzers(64)
    np.testing.assert_array_equal(ana.band_matrix.numpy(), np.asarray(jana.band_matrix))
    w = CFG.window_size
    t = np.arange(w) / CFG.sample_rate
    tone = (0.5 * np.sin(2 * np.pi * 1000.0 * t)).astype(np.float32)
    pcm = np.stack([tone, tone], axis=-1)[None]
    rows = tstft.stft_rows(torch.from_numpy(pcm), CFG)         # [1, 1, B, 2]
    levels = ana.push_rows(ana.init_levels(1), rows).numpy()
    assert levels.shape == (1, 64)
    # on equal rows (JAX's STFT), the levels are within the bar of JAX's
    jrows = np.array(jstft.stft_rows(jnp.asarray(pcm), JCFG))
    got = ana.push_rows(ana.init_levels(1), torch.from_numpy(jrows)).numpy()
    want = np.asarray(jana.push_rows(jana.init_levels(1), jnp.asarray(jrows)))
    np.testing.assert_allclose(got, want, rtol=0, atol=LEVELS_ATOL)
    from spectrogram_tpu_torch.ops.resample import log_space_edges

    edges = log_space_edges(32.0, max(CFG.sample_rate / 2, 22050.0), 64)
    peak = int(np.argmax(levels[0]))
    assert edges[peak] <= 1000.0 <= edges[peak + 2]  # within a band of slack


def test_analyzer_peak_decay():
    """Silence decays levels by 0.99 per row (spectrum_analyzer.rs:67)."""
    ana, jana = _analyzers(16)
    out = ana.push_rows(torch.full((1, 16), 0.8), torch.zeros(1, 3, CFG.num_bins, 2)).numpy()
    np.testing.assert_allclose(out, 0.8 * 0.99**3, rtol=1e-5)
    want = jana.push_rows(jnp.full((1, 16), 0.8, jnp.float32),
                          jnp.zeros((1, 3, CFG.num_bins, 2), jnp.float32))
    np.testing.assert_array_equal(out, np.asarray(want))


def test_analyzer_rows_order_matters_like_sequential():
    """Batch push of k rows == k sequential pushes, bit for bit; within the
    bar of JAX's."""
    rng = np.random.default_rng(3)
    ana, jana = _analyzers(16)
    rows = rng.random((2, 4, CFG.num_bins, 2)).astype(np.float32) * 0.1
    batched = ana.push_rows(ana.init_levels(2), torch.from_numpy(rows))
    seq = ana.init_levels(2)
    for k in range(4):
        seq = ana.push_rows(seq, torch.from_numpy(rows[:, k : k + 1]))
    assert torch.equal(batched, seq)
    want = np.asarray(jana.push_rows(jana.init_levels(2), jnp.asarray(rows)))
    np.testing.assert_allclose(batched.numpy(), want, rtol=0, atol=LEVELS_ATOL)


def _f64_levels(matrix, levels, rows):
    """The analyzer's law with a float64 band product, the rest in f32."""
    bands = np.einsum("gb,skbc->kgsc", matrix.astype(np.float64),
                      rows.astype(np.float64)).astype(np.float32)
    norm = np.sqrt(bands[..., 0] ** 2 + bands[..., 1] ** 2)
    db = np.float32(10.0) * np.log10(norm + np.float32(1e-7))
    new = np.clip((db - np.float32(-70.0)) / np.float32(60.0), 0.0, 1.0)
    lv = levels.astype(np.float32)
    for v in new:
        lv = np.maximum(v.T, lv * np.float32(0.99))
    return lv


@pytest.mark.parametrize("n_bands", [16, 128])
def test_analyzer_band_product_is_true_f32(n_bands):
    """The band product is a float64 product rounded to f32, which no TF32
    or reduced-precision switch reaches: levels within 1e-6 of a float64
    product on chirp + noise rows, whatever the matmul precision switches
    say."""
    ana = SpectrumAnalyzer(CFG, n_bands, device="cpu")
    rng = np.random.default_rng(n_bands)
    rows = (10.0 ** rng.uniform(-5, -0.5, (3, 8, CFG.num_bins, 2))).astype(np.float32)
    start = rng.uniform(0, 1, (3, n_bands)).astype(np.float32)
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        got = ana.push_rows(torch.from_numpy(start), torch.from_numpy(rows)).numpy()
    finally:
        torch.set_float32_matmul_precision(prev)
    want = _f64_levels(ana.band_matrix.numpy(), start, rows)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the product itself: within one f32 ulp of numpy's float64 product
    # (TF32 would be 2^-11 off)
    m = ana.band_matrix
    flat = torch.from_numpy(rows).permute(0, 1, 3, 2).reshape(-1, CFG.num_bins)
    ref = flat.numpy().astype(np.float64) @ m.numpy().astype(np.float64).T
    got = tsa.band_product(m, flat)
    assert got.dtype == torch.float32
    assert np.all(np.abs(got.numpy() - ref) <= np.abs(ref) * 2.0**-23)


def test_analyzer_rasterize_levels():
    levels = np.array([0.0, 0.5, 1.0], np.float32)
    for scheme, jscheme in zip(DEFAULT_COLOR_SCHEMES, JSCHEMES):
        img = SpectrumAnalyzer.rasterize_levels(levels, height=10, scheme=scheme)
        np.testing.assert_array_equal(img, JaxAnalyzer.rasterize_levels(levels, 10, jscheme))
    scheme = scheme_by_name("Viridis")
    img = SpectrumAnalyzer.rasterize_levels(torch.from_numpy(levels), height=10, scheme=scheme)
    assert img.shape == (10, 3, 3)
    fg = np.asarray(scheme.foreground_color(), np.uint8)
    bg = np.asarray(scheme.background_color(), np.uint8)
    col_fill = (img == fg).all(axis=-1).sum(axis=0)
    np.testing.assert_array_equal(img[:, 0], np.broadcast_to(bg, (10, 3)))
    assert col_fill[1] == 5 and col_fill[2] == 10
    rng = np.random.default_rng(9)
    lv = rng.uniform(-0.2, 1.2, 128).astype(np.float32)
    np.testing.assert_array_equal(SpectrumAnalyzer.rasterize_levels(lv, 37, scheme),
                                  JaxAnalyzer.rasterize_levels(lv, 37, JSCHEMES[2]))


def test_stream_scroller_and_tile_grid():
    sc, jsc = tlive.StreamScroller(2, height=8, width=10), jlive.StreamScroller(2, 8, 10)
    rows = np.zeros((2, 3, 16, 3), np.uint8)
    rows[0, :, :, 0] = 200      # stream 0: red columns
    rows[1, :, :, 2] = 200      # stream 1: blue columns
    rng = np.random.default_rng(4)
    for batch in (rows, rows, rng.integers(0, 256, (2, 12, 16, 3), dtype=np.uint8)):
        sc.push(batch)
        jsc.push(batch)
        np.testing.assert_array_equal(sc.buf, jsc.buf)
    sc2 = tlive.StreamScroller(2, height=8, width=10)
    sc2.push(rows)
    img0 = sc2.image(0)
    assert img0.shape == (8, 10, 3)
    assert (img0[:, -3:, 0] == 200).all() and (img0[:, :-3] == 0).all()
    frame = tlive.tile_grid([sc.image(0), sc.image(1)], 20, 30, highlight=1)
    assert frame.shape == (20, 30, 3)
    np.testing.assert_array_equal(
        frame, jlive.tile_grid([jsc.image(0), jsc.image(1)], 20, 30, highlight=1))
    assert (frame[0, 15:] == 255).all(axis=-1).any()
    imgs = [rng.integers(0, 256, (9, 13, 3), dtype=np.uint8) for _ in range(5)]
    np.testing.assert_array_equal(tlive.tile_grid(imgs, 31, 47, highlight=4),
                                  jlive.tile_grid(imgs, 31, 47, highlight=4))
    with pytest.raises(ValueError):
        tlive.tile_grid([], 20, 30)


def test_scroller_frequency_flip():
    sc = tlive.StreamScroller(1, height=4, width=2)
    rows = np.zeros((1, 1, 8, 3), np.uint8)
    rows[0, 0, -1] = 255        # highest-frequency pixel lit
    sc.push(rows)
    assert (sc.image(0)[0, -1] == 255).all()    # ...lands on the top row
    assert (sc.image(0)[-1, -1] == 0).all()


def test_visualizers_run_on_the_card_by_default():
    if torch.cuda.is_available():
        assert Oscilloscope(64).device.type == "cuda"
        assert SpectrumAnalyzer(CFG).band_matrix.is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Oscilloscope(64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SpectrumAnalyzer(CFG)
