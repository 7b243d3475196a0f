"""The port's functional surface and `colormap_rows_fused` against the JAX
package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function (on its
CPU backend; `colormap_rows_fused` in Pallas interpret mode, as
`tests/test_pallas_colormap.py` runs it) and the port's counterpart.  The
bars: STFT magnitudes atol 3e-5 / rtol 1e-4 (two f32 FFTs); f32 RGBA atol
1e-6 (the same laws, rounding each op alike); u8 images within 1 u8 per
channel (a rounding at .5 can land either side).  `colormap_rows_fused`
mirrors the JAX tests: the 8 kHz H=128 geometry, a ragged row count, the
silence floor, packed and u8 output, one BENCH-width case at H=64 and a
matrix with four taps per pixel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectrogram_tpu as jsg
import spectrogram_tpu.config as jcfg
from spectrogram_tpu.color import colorscheme as jcs
from spectrogram_tpu.ops import colormap as jcm
from spectrogram_tpu.ops.pallas import colormap_kernel as jck

import spectrogram_tpu_torch as tsg
from spectrogram_tpu_torch import testing
from spectrogram_tpu_torch.color import colorscheme as tcs
from spectrogram_tpu_torch.config import SpectrogramConfig
from spectrogram_tpu_torch.ops import colormap as tcm
from spectrogram_tpu_torch.ops import stft as tstft
from spectrogram_tpu_torch.ops.cuda import colormap_kernel as tck

torch.set_num_threads(2)

STFT_ATOL, STFT_RTOL = 3e-5, 1e-4
CFG_KW = dict(sample_rate=8000.0, window_period=0.032, hop_period=0.008,
              viewport_height=128)
BENCH_H64 = dict(sample_rate=48000.0, window_period=2048 / 48000.0,
                 hop_period=800 / 48000.0, viewport_height=64)
# the names JAX exports lazily that come with later modules: none left
LAZY = set()


def _cfgs(kw):
    return SpectrogramConfig(**kw), jcfg.SpectrogramConfig(**kw)


def _u8_diff(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int)).max())


# ------------------------------------------------------------------- STFT

@pytest.mark.parametrize("kind", ["chirp_tone", "noise"])
def test_stft_rows_and_frame_match_jax(kind):
    """Interleaved [..., rows, bins, 2], batched over a leading axis, and
    one frame."""
    tc, jc = _cfgs(CFG_KW)
    pcm = testing.make(kind, 3, 5 * tc.hop_size + tc.window_size, tc.sample_rate, seed=7)
    got = tsg.stft_rows(torch.from_numpy(pcm), tc)
    want = np.asarray(jsg.stft_rows(jnp.asarray(pcm), jc))
    assert got.shape == want.shape == (3, 6, tc.num_bins, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=STFT_ATOL, rtol=STFT_RTOL)
    planar = tstft.stft_rows_planar(torch.from_numpy(pcm), tc)
    np.testing.assert_array_equal(planar.numpy(), got.transpose(-1, -2).numpy())
    frame = pcm[1, : tc.window_size]
    got = tsg.stft_frame(torch.from_numpy(frame), tc)
    want = np.asarray(jsg.stft_frame(jnp.asarray(frame), jc))
    assert got.shape == want.shape == (tc.num_bins, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=STFT_ATOL, rtol=STFT_RTOL)


# --------------------------------------------------------------- colormap

def _pixels_and_coords(tc, rng, n=6):
    """Resampled magnitudes [n, H, 2] spanning the dB window, pan and mag
    coordinates past both ends of [0, 1]."""
    pixels = (10.0 ** rng.uniform(-4.5, -0.2, (n, tc.viewport_height, 2))).astype(np.float32)
    pixels[0] = 0.0                       # silence: the pan guard, the floor
    coords = rng.uniform(-0.2, 1.2, (2, n, tc.viewport_height)).astype(np.float32)
    return pixels, coords


@pytest.mark.parametrize("palette", [0, 1, 12])
def test_lut_and_colormap_functions_match_jax(palette):
    """sample_lut_bilinear, colormap_resampled, colormap_rows,
    composite_over_background and rgba_f32_to_u8 on one palette's LUT."""
    tc, jc = _cfgs(CFG_KW)
    rng = np.random.default_rng(palette)
    lut = jcs.DEFAULT_COLOR_SCHEMES[palette].lookup_table(32)
    np.testing.assert_array_equal(tcs.DEFAULT_COLOR_SCHEMES[palette].lookup_table(32), lut)
    tlut, jlut = torch.from_numpy(lut), jnp.asarray(lut)
    pixels, (pan, mag) = _pixels_and_coords(tc, rng)
    got = tcm.sample_lut_bilinear(tlut, torch.from_numpy(pan), torch.from_numpy(mag))
    want = np.asarray(jcm.sample_lut_bilinear(jlut, jnp.asarray(pan), jnp.asarray(mag)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    got = tcm.colormap_resampled(torch.from_numpy(pixels), tlut, tc)
    want = np.asarray(jcm.colormap_resampled(jnp.asarray(pixels), jlut, jc))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tsg.rgba_f32_to_u8(got).numpy(),
                                  np.asarray(jsg.rgba_f32_to_u8(jnp.asarray(got.numpy()))))
    rows = (10.0 ** rng.uniform(-4.5, -0.5, (4, tc.num_bins, 2))).astype(np.float32)
    m = tsg.resample_matrix(tc)
    np.testing.assert_array_equal(m, jsg.resample_matrix(jc))
    got = tsg.colormap_rows(torch.from_numpy(rows), torch.from_numpy(m), tlut, tc)
    want = np.asarray(jsg.colormap_rows(jnp.asarray(rows), jnp.asarray(m), jlut, jc))
    assert got.shape == want.shape == (4, tc.viewport_height, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    bg = jcs.DEFAULT_COLOR_SCHEMES[palette].background_color()
    bg = np.array(bg, np.uint8)
    img = tsg.composite_over_background(got, torch.from_numpy(bg))
    jimg = np.asarray(jsg.composite_over_background(jnp.asarray(got.numpy()), jnp.asarray(bg)))
    assert img.dtype == torch.uint8 and img.shape == (4, tc.viewport_height, 3)
    np.testing.assert_array_equal(img.numpy(), jimg)


def test_stacked_lookup_tables_match_jax():
    for res in (16, 32):
        np.testing.assert_array_equal(tsg.stacked_lookup_tables(res),
                                      jsg.stacked_lookup_tables(res))
    np.testing.assert_array_equal(tsg.stacked_backgrounds(), jsg.stacked_backgrounds())
    # built in numpy (JAX's: jnp.cos, within an f32 ulp)
    np.testing.assert_allclose(tsg.hann_window(256).numpy(),
                               np.asarray(jsg.hann_window(256)), atol=1e-7, rtol=0)


def test_functional_recipe_matches_jax():
    """The verify recipe at the 8 kHz geometry: chirp + tone -> stft_rows
    -> colormap_rows -> composite_over_background, within 1 u8."""
    tc, jc = _cfgs(dict(CFG_KW, viewport_height=64))
    fs = tc.sample_rate
    t = np.arange(int(0.5 * fs)) / fs
    phase = 2 * np.pi * 100.0 * (np.exp(t * np.log(30) / t[-1]) - 1) * t[-1] / np.log(30)
    pcm = np.stack([0.5 * np.sin(phase), 0.2 * np.sin(2 * np.pi * 440 * t)], -1)
    pcm = pcm.astype(np.float32)
    scheme = jcs.scheme_by_name("Blue-Yellow-Red (Stereo)")
    lut = scheme.lookup_table(32)
    bg = np.array(scheme.background_color(), np.uint8)
    m = jsg.resample_matrix(jc)
    want = np.asarray(jsg.composite_over_background(
        jsg.colormap_rows(jsg.stft_rows(jnp.asarray(pcm), jc), jnp.asarray(m),
                          jnp.asarray(lut), jc), jnp.asarray(bg)))
    got = tsg.composite_over_background(
        tsg.colormap_rows(tsg.stft_rows(torch.from_numpy(pcm), tc), torch.from_numpy(m),
                          torch.from_numpy(lut), tc), torch.from_numpy(bg))
    assert got.shape == want.shape and got.shape[-1] == 3
    assert _u8_diff(got.numpy(), want) <= 1


def test_exports_are_jax_s():
    assert set(tsg.__all__) >= set(jsg.__all__) - LAZY
    assert not LAZY & set(tsg.__all__)
    for name in set(jsg.__all__) - LAZY:
        assert hasattr(tsg, name), name
    assert {"DeviceFeeder", "ChunkPool"} <= set(tsg.__all__)
    # the port's `__all__` is the JAX package's, name for name
    assert tsg.__all__ == jsg.__all__
    assert tsg.LiveSession.__module__ == "spectrogram_tpu_torch.session"
    assert tsg.StreamGroupManager.__module__ == "spectrogram_tpu_torch.models.multirate"


# ---------------------------------------------------- colormap_rows_fused

def _fused_case(kw, n, rng, pid=None, scale=0.1, matrix=None):
    tc, jc = _cfgs(kw)
    u, v = jcs.stacked_factored_tables(32)
    pid = rng.integers(0, 19, n) if pid is None else pid
    rows = (rng.random((n, 2, tc.num_bins)) * scale).astype(np.float32)
    mat_t = (jcm.resample_matrix(jc).T if matrix is None else matrix).astype(np.float32)
    return tc, jc, rows, u[pid], v[pid], mat_t


def _run_fused(tc, jc, rows, u, v, mat_t, **jax_kw):
    """(port u8, JAX u8): JAX's u8 form (its packed words are the same
    bytes, tests/test_pallas_colormap.py), the port's u8 form, whose packed
    form must be the same bytes, and both the plain version's (the CPU
    takes it)."""
    want = np.asarray(jck.colormap_rows_fused(
        jnp.asarray(rows), jnp.asarray(u), jnp.asarray(v), jnp.asarray(mat_t), jc,
        interpret=True, **jax_kw))
    args = (torch.from_numpy(rows), torch.from_numpy(u), torch.from_numpy(v))
    got = tck.colormap_rows_fused(*args, mat_t, tc)
    packed = tck.colormap_rows_fused(*args, mat_t, tc, packed=True)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert packed.dtype == torch.int32 and packed.shape == want.shape[:2]
    np.testing.assert_array_equal(tck.unpack_rgba(packed), got.numpy())
    for form, out in ((False, got), (True, packed)):
        plain = tck.colormap_rows_fused_plain(*args, torch.from_numpy(mat_t), tc, packed=form)
        assert torch.equal(out, plain)
    return got.numpy(), want


def test_fused_matches_jax(rng):
    tc, jc, rows, u, v, m = _fused_case(CFG_KW, 8, rng)
    got, want = _run_fused(tc, jc, rows, u, v, m, block_rows=8, block_cols=64)
    assert got.shape == (8, tc.viewport_height, 4)
    assert _u8_diff(got, want) <= 1


def test_fused_ragged_rows_match_jax(rng):
    tc, jc, rows, u, v, m = _fused_case(CFG_KW, 5, rng, pid=np.ones(5, np.int64),
                                        scale=0.05)
    got, want = _run_fused(tc, jc, rows, u, v, m, block_rows=4, block_cols=128)
    assert _u8_diff(got, want) <= 1


def test_fused_silence_floor(rng):
    tc, jc, rows, u, v, m = _fused_case(CFG_KW, 4, rng, pid=np.full(4, 2), scale=0.0)
    got, want = _run_fused(tc, jc, rows, u, v, m, block_rows=4, block_cols=128)
    expected = np.round(np.array([68, 1, 84]) / 256.0 * 255.0)     # Viridis at 0
    np.testing.assert_array_equal(got[..., :3], np.broadcast_to(expected, got[..., :3].shape))
    np.testing.assert_array_equal(got[..., 3], 255)
    np.testing.assert_array_equal(got, want)


def test_fused_bench_width_matches_jax(rng):
    tc, jc, rows, u, v, m = _fused_case(BENCH_H64, 6, rng, scale=0.01)
    assert rows.shape == (6, 2, 2047)
    got, want = _run_fused(tc, jc, rows, u, v, m)
    assert _u8_diff(got, want) <= 1


def test_fused_four_tap_matrix_matches_jax(rng):
    """A matrix with four nonzeros per pixel (two resample matrices'
    average, one shifted a bin): K = 4 taps."""
    tc, jc = _cfgs(CFG_KW)
    m = jcm.resample_matrix(jc)
    m4 = (0.5 * (m + np.roll(m, 2, axis=1))).T.astype(np.float32)
    taps = tck.resample_taps_k(m4)
    assert taps.j.shape == (tc.viewport_height, 4) and taps.bins == tc.num_bins
    np.testing.assert_array_equal(tck.taps_dense(taps).numpy(), m4)
    *_, rows, u, v, _ = _fused_case(CFG_KW, 6, rng)
    got, want = _run_fused(tc, jc, rows, u, v, m4, block_rows=8, block_cols=64)
    assert _u8_diff(got, want) <= 1


def test_resample_taps_k_forms():
    """Every matrix the package builds has K = 2, and then the K-tap form is
    the two-tap one; a pixel clamped onto one bin pads with its own bin."""
    for kw in (CFG_KW, BENCH_H64, dict(CFG_KW, sample_rate=11025.0)):
        tc, _ = _cfgs(kw)
        for m in (tcm.resample_matrix(tc), tcm.resample_matrix(tc, shader_compat=True),
                  tcm.resample_matrix_full(tc), tcm.resample_matrix_planes(tc)):
            k_taps = tck.resample_taps_k(m.T)
            two = tck.resample_taps(m)
            assert k_taps.j.shape == (m.shape[0], 2) and k_taps.bins == m.shape[1]
            for got, want in zip((k_taps.j[:, 0], k_taps.j[:, 1], k_taps.w[:, 0],
                                  k_taps.w[:, 1]), two[:4]):
                assert torch.equal(got, want)
    empty = np.zeros((5, 3), np.float32)
    empty[2, 1] = 0.25
    t = tck.resample_taps_k(empty)
    assert t.j.tolist() == [[0], [2], [0]] and t.w.tolist() == [[0.0], [0.25], [0.0]]


def test_resample_taps_k_span_and_pairs():
    """The K-tap form keeps the taps' span (highest bin + 1, `resample_taps`'
    at K = 2) and, at K = 2 only, its taps tap-major for the row tile."""
    for kw in (CFG_KW, BENCH_H64):
        tc, _ = _cfgs(kw)
        for m in (tcm.resample_matrix(tc), tcm.resample_matrix_full(tc)):
            k_taps = tck.resample_taps_k(m.T)
            assert k_taps.span == tck.resample_taps(m).span == int(np.nonzero(m)[1].max()) + 1
            pj, pw = k_taps.pairs
            assert torch.equal(pj, k_taps.j.t()) and torch.equal(pw, k_taps.w.t())
            assert pj.is_contiguous() and pw.is_contiguous()
            m4 = 0.5 * (m + np.roll(m, 2, axis=1))
            four = tck.resample_taps_k(m4.T)
            assert four.j.shape[1] == 4 and four.pairs is None
            assert four.span == int(np.nonzero(m4)[1].max()) + 1


def test_fused_raises_where_jax_raises(rng):
    tc, jc, rows, u, v, m = _fused_case(CFG_KW, 2, rng)
    for fn, args, cfg in ((jck.colormap_rows_fused, (jnp.asarray(rows), jnp.asarray(u),
                                                     jnp.asarray(v)), jc),
                          (tck.colormap_rows_fused, (torch.from_numpy(rows),
                                                     torch.from_numpy(u),
                                                     torch.from_numpy(v)), tc)):
        with pytest.raises(ValueError, match="bins but resample matrix expects"):
            fn(*args, m[:-1], cfg, interpret=True)
    wide = 20481
    rows_w = np.zeros((1, 2, wide), np.float32)
    mat_w = np.zeros((wide, 8), np.float32)
    uu, vv = u[:1], v[:1]
    with pytest.raises(ValueError, match="exceeds"):
        jck.colormap_rows_fused(jnp.asarray(rows_w), jnp.asarray(uu), jnp.asarray(vv),
                                jnp.asarray(mat_w), jc, interpret=True)
    for blocks in ({}, dict(block_rows=8, block_cols=8)):
        with pytest.raises(ValueError, match="exceeds"):
            tck.colormap_rows_fused(torch.from_numpy(rows_w), torch.from_numpy(uu),
                                    torch.from_numpy(vv), mat_w, tc, **blocks)
    for bad in (dict(block_rows=0), dict(block_cols=-8)):
        with pytest.raises(ValueError, match="positive"):
            tck.colormap_rows_fused(torch.from_numpy(rows), torch.from_numpy(u),
                                    torch.from_numpy(v), m, tc, **bad)
    # precision and interpret change nothing
    base = tck.colormap_rows_fused(torch.from_numpy(rows), torch.from_numpy(u),
                                   torch.from_numpy(v), m, tc)
    same = tck.colormap_rows_fused(torch.from_numpy(rows), torch.from_numpy(u),
                                   torch.from_numpy(v), m, tc, block_rows=8, block_cols=64,
                                   precision=jax.lax.Precision.DEFAULT, interpret=True)
    assert torch.equal(base, same)
