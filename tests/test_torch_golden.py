"""The port's golden renderer against the JAX package's, on the CPU.

Mirrors `tests/test_golden.py`.  `models/golden.py` is a numpy copy of the
JAX module in which only `render`'s STFT changes (the port's `torch.fft`
`stft_rows` in place of `jnp.fft`).  The bars:

  * every other function has the JAX module's source, and gives the same
    numbers on the same numpy inputs, exactly;
  * `render` within 1 u8 per channel of JAX's over what the image shows
    (`testing.rgba_u8_diff`): the two STFTs differ in f32 rounding only.
"""

import inspect
import math

import numpy as np
import pytest
import torch

import spectrogram_tpu.config as jcfg
from spectrogram_tpu.color.colorscheme import DEFAULT_COLOR_SCHEMES as JSCHEMES
from spectrogram_tpu.models import golden as jgolden

from spectrogram_tpu_torch import testing
from spectrogram_tpu_torch.color.colorscheme import DEFAULT_COLOR_SCHEMES
from spectrogram_tpu_torch.config import SpectrogramConfig
from spectrogram_tpu_torch.models import golden
from spectrogram_tpu_torch.ops import resample

torch.set_num_threads(2)

KW = dict(sample_rate=8000.0, window_period=0.032, hop_period=0.008, viewport_height=64)
CFG, JCFG = SpectrogramConfig(**KW), jcfg.SpectrogramConfig(**KW)


def test_copy_has_the_jax_source():
    """Every function and method but `render` is the JAX module's, line for
    line (the module docstring and the package name in imports differ)."""
    names = ["default_golden_config", "pixel_band_edges", "cubic_interpolate",
             "cosine_interpolate"]
    for name in names:
        assert inspect.getsource(getattr(golden, name)) == inspect.getsource(
            getattr(jgolden, name)), name
    for cls in ("InterpolatedFrequencySample", "GoldenSpectrogram"):
        tcls, jcls = getattr(golden, cls), getattr(jgolden, cls)
        for name, member in vars(jcls).items():
            if name == "render" or not (inspect.isfunction(member)
                                        or isinstance(member, property)):
                continue
            fn = member.fget if isinstance(member, property) else member
            if fn.__code__.co_filename != jgolden.__file__:
                continue                    # made by @dataclass
            tm = vars(tcls)[name]
            tfn = tm.fget if isinstance(tm, property) else tm
            assert inspect.getsource(tfn) == inspect.getsource(fn), (cls, name)
    assert (golden.TEXTURE_WIDTH, golden.TEXTURE_HEIGHT) == (
        jgolden.TEXTURE_WIDTH, jgolden.TEXTURE_HEIGHT)


def test_cubic_interpolate_exact_at_integers(rng):
    data = rng.standard_normal((20, 2))
    idx = np.arange(1, 19, dtype=np.float64)
    out = golden.cubic_interpolate(data, idx)
    np.testing.assert_allclose(out, data[1:19], atol=1e-12)
    frac = rng.uniform(0, 19, 57)
    np.testing.assert_array_equal(golden.cubic_interpolate(data, frac),
                                  jgolden.cubic_interpolate(data, frac))


def test_cosine_interpolate_endpoints(rng):
    data = np.array([[0.0], [10.0], [4.0]])
    np.testing.assert_allclose(
        golden.cosine_interpolate(data, np.array([0.0, 1.0]))[:, 0], [0.0, 10.0]
    )
    assert golden.cosine_interpolate(data, np.array([0.5]))[0, 0] == pytest.approx(5.0)
    data = rng.standard_normal((30, 2))
    frac = rng.uniform(0, 29, 41)
    np.testing.assert_array_equal(golden.cosine_interpolate(data, frac),
                                  jgolden.cosine_interpolate(data, frac))


def test_band_matrix_equals_scalar_magnitude_in(rng):
    """The port's cubic_band_matrix reproduces the scalar magnitude_in, and
    the port's magnitude_in is JAX's exactly."""
    mags = rng.standard_normal((CFG.num_bins, 2)) * 0.1
    sample = golden.InterpolatedFrequencySample(mags, CFG.sample_rate)
    jsample = jgolden.InterpolatedFrequencySample(mags, JCFG.sample_rate)
    edges = resample.log_space_edges(32.0, max(CFG.sample_rate / 2, 22050.0), 16)
    m = resample.cubic_band_matrix(edges, CFG.num_bins, CFG.sample_rate)
    via_matrix = m @ mags
    for band in range(16):
        scalar = sample.magnitude_in(edges[band], edges[band + 1])
        np.testing.assert_allclose(via_matrix[band], scalar, rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(scalar, jsample.magnitude_in(edges[band], edges[band + 1]))


def test_golden_pixel_matrix_matches_render_spectrum(rng):
    mags = np.abs(rng.standard_normal((CFG.num_bins, 2))) * 0.05
    m = resample.golden_pixel_matrix(CFG)
    via_matrix = m @ mags
    sample = golden.InterpolatedFrequencySample(mags, CFG.sample_rate)
    edges = golden.pixel_band_edges(CFG, CFG.viewport_height)
    np.testing.assert_array_equal(edges, jgolden.pixel_band_edges(JCFG, JCFG.viewport_height))
    for py in range(0, CFG.viewport_height, 7):
        scalar = sample.magnitude_in(edges[py], edges[py + 1])
        np.testing.assert_allclose(via_matrix[py], scalar, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("palette", [1, 0])
def test_render_spectrum_equals_jax(rng, palette):
    """One column from the same magnitudes: exactly JAX's (numpy law)."""
    mags = (10.0 ** rng.uniform(-4.5, -0.5, (CFG.num_bins, 2)))
    g = golden.GoldenSpectrogram(CFG, scheme=DEFAULT_COLOR_SCHEMES[palette])
    jg = jgolden.GoldenSpectrogram(JCFG, scheme=JSCHEMES[palette])
    np.testing.assert_array_equal(g.render_spectrum(mags), jg.render_spectrum(mags))


@pytest.mark.parametrize("palette", [1, 0])
def test_render_matches_jax(palette):
    """A chirp plus a tone: the port's render within 1 u8 of JAX's over
    what the image shows, and its composite likewise."""
    cfg_kw = dict(sample_rate=8000.0, window_period=0.032, hop_period=0.016,
                  viewport_height=48)
    tc, jc = SpectrogramConfig(**cfg_kw), jcfg.SpectrogramConfig(**cfg_kw)
    pcm = testing.chirp_tone(1, int(0.25 * tc.sample_rate), tc.sample_rate, seed=2)[0]
    g = golden.GoldenSpectrogram(tc, scheme=DEFAULT_COLOR_SCHEMES[palette])
    jg = jgolden.GoldenSpectrogram(jc, scheme=JSCHEMES[palette])
    got, want = g.render(pcm), jg.render(pcm)
    assert got.shape == want.shape == (14, 48, 4) and got.dtype == np.uint8
    assert testing.rgba_u8_diff(got, want) <= 1
    shown = np.abs(g.composite(got).astype(int) - jg.composite(want).astype(int))
    assert shown.max() <= 1


def test_golden_render_sine_peak():
    """A 440 Hz tone renders a bright band at the expected pixel row."""
    cfg = SpectrogramConfig(
        sample_rate=8000.0,
        window_period=0.064,
        hop_period=0.032,
        viewport_height=128,
    )
    g = golden.GoldenSpectrogram(cfg)
    t = np.arange(int(0.3 * cfg.sample_rate)) / cfg.sample_rate
    tone = (0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
    pcm = np.stack([tone, tone], axis=-1)
    cols = g.render(pcm, device="cpu")
    assert cols.shape[1:] == (128, 4)
    lum = cols[2, :, :3].astype(int).sum(axis=-1)
    peak_row = int(np.argmax(lum))
    expected = (
        (math.log(440.0) - math.log(cfg.min_frequency))
        / (math.log(cfg.max_frequency) - math.log(cfg.min_frequency))
        * 128
    )
    assert abs(peak_row - expected) <= 2


def test_golden_composite():
    g = golden.GoldenSpectrogram(CFG)
    rgba = np.zeros((2, 4, 4), np.uint8)
    out = g.composite(rgba)
    np.testing.assert_array_equal(out[0, 0], g.scheme.background_color())
    rgba = np.random.default_rng(5).integers(0, 256, (3, 7, 4), dtype=np.uint8)
    np.testing.assert_array_equal(out := g.composite(rgba),
                                  jgolden.GoldenSpectrogram(JCFG).composite(rgba))
    assert out.shape == (3, 7, 3)
    assert golden.default_golden_config(44100.0) == SpectrogramConfig(
        **vars(jgolden.default_golden_config(44100.0)))
