"""The PyTorch port's copied constants equal the JAX package's exactly.

The port cannot import the JAX package (its `__init__` imports JAX), so it
carries copies of the numpy-only config, palette and table functions.  These
tests pin every copy against the original, and check that importing the port
never loads JAX.
"""

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import spectrogram_tpu.config as jcfg
from spectrogram_tpu.color import colorscheme as jcs
from spectrogram_tpu.color import gradients as jgr
from spectrogram_tpu.ops import colormap as jcm
from spectrogram_tpu.ops import mxu_fft as jfft
from spectrogram_tpu.ops import stft as jstft
from spectrogram_tpu.ops.pallas import colormap_kernel as jck
from spectrogram_tpu.ops.pallas import stft_kernel as jsk

import spectrogram_tpu_torch.config as tcfg
from spectrogram_tpu_torch.color import colorscheme as tcs
from spectrogram_tpu_torch.color import gradients as tgr
from spectrogram_tpu_torch.ops import colormap as tcm
from spectrogram_tpu_torch.ops import fft_plan as tfp
from spectrogram_tpu_torch.ops import stft as tstft
from spectrogram_tpu_torch.ops.cuda import colormap_kernel as tck
from spectrogram_tpu_torch.ops.cuda import stft_kernel as tsk

torch.set_num_threads(2)

SMALL = dict(sample_rate=8000.0, window_period=0.032, hop_period=0.008)
CONFIGS = {
    "bench": ("BENCH_CONFIG", None),
    "default": ("DEFAULT_CONFIG", None),
    "small": (None, SMALL),
    "small_h64": (None, dict(SMALL, viewport_height=64)),
}


def _configs(name):
    const, kw = CONFIGS[name]
    if const is not None:
        return getattr(jcfg, const), getattr(tcfg, const)
    return jcfg.SpectrogramConfig(**kw), tcfg.SpectrogramConfig(**kw)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_copy(name):
    j, t = _configs(name)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    for prop in ("window_size", "padded_size", "hop_size", "num_bins",
                 "rows_per_second", "bin_hz"):
        assert getattr(j, prop) == getattr(t, prop), prop
    assert j.log_frequency_fracs(17) == t.log_frequency_fracs(17)


@pytest.mark.parametrize("name", sorted(jgr.GRADIENTS))
def test_gradient_copy(name):
    x = np.linspace(-0.1, 1.1, 257)
    np.testing.assert_array_equal(jgr.GRADIENTS[name](x), tgr.GRADIENTS[name](x))


@pytest.mark.parametrize("res", [16, 32])
def test_palette_tables_copy(res):
    assert [s.name for s in jcs.DEFAULT_COLOR_SCHEMES] == [
        s.name for s in tcs.DEFAULT_COLOR_SCHEMES
    ]
    ju, jv = jcs.stacked_factored_tables(res)
    tu, tv = tcs.stacked_factored_tables(res)
    np.testing.assert_array_equal(ju, tu)
    np.testing.assert_array_equal(jv, tv)
    np.testing.assert_array_equal(jcs.stacked_backgrounds(), tcs.stacked_backgrounds())
    np.testing.assert_array_equal(
        jck.builtin_color_tables(res), tck.builtin_color_tables(res)
    )
    for a, b in zip(jck.generic_color_tables(res), tck.generic_color_tables(res)):
        np.testing.assert_array_equal(a, b)
    name = "Green-Pink (Stereo)"
    assert tcs.scheme_by_name(name).name == name
    assert tcs.scheme_index(name) == jcs.scheme_index(name)


def test_factored_scheme_copy():
    """FactoredScheme: validation, factors, is_stereo, background and LUT as
    the JAX package's, and the registry kind both packages detect."""
    rng = np.random.default_rng(3)
    u, v = rng.random((2, 32, 4)).astype(np.float32)
    flat_v = np.ones((32, 4), np.float32)
    for args in ((u, v, (1, 2, 3)), (u, flat_v)):
        j, t = jcs.FactoredScheme("x", *args), tcs.FactoredScheme("x", *args)
        assert (t.name, t.u, t.v, t.background) == (j.name, j.u, j.v, j.background)
        assert t.is_stereo == j.is_stereo
        assert t.background_color() == j.background_color()
        np.testing.assert_array_equal(t.lookup_table(32), j.lookup_table(32))
        for a, b in zip(t.factored_tables(32), j.factored_tables(32)):
            np.testing.assert_array_equal(a, b)
        with pytest.raises(ValueError, match="res 32"):
            t.factored_tables(16)
    assert tcs.FactoredScheme("x", u, v).is_stereo and not tcs.FactoredScheme("x", u, flat_v).is_stereo
    for bad in ((u, v[:16]), (u[:, :3], v[:, :3])):
        with pytest.raises(ValueError, match="same-shape"):
            tcs.FactoredScheme("bad", *bad)
    schemes = [tcs.FactoredScheme("x", u, v)] + list(tcs.DEFAULT_COLOR_SCHEMES[:2])
    jschemes = [jcs.FactoredScheme("x", u, v)] + list(jcs.DEFAULT_COLOR_SCHEMES[:2])
    with pytest.raises(ValueError):
        tck.builtin_color_tables(32, schemes)
    for a, b in zip(tck.generic_color_tables(32, schemes), jck.generic_color_tables(32, jschemes)):
        np.testing.assert_array_equal(a, b)
    # a FactoredScheme of a built-in's own factors is detected as built-in
    fs = tcs.FactoredScheme("m", *tcs.DEFAULT_COLOR_SCHEMES[1].factored_tables(32))
    np.testing.assert_array_equal(tck.builtin_color_tables(32, [fs]),
                                  tck.builtin_color_tables(32)[1:2])
    from spectrogram_tpu_torch import FactoredScheme

    assert FactoredScheme is tcs.FactoredScheme


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_resample_matrices_copy(name):
    j, t = _configs(name)
    np.testing.assert_array_equal(jcm.resample_matrix(j), tcm.resample_matrix(t))
    np.testing.assert_array_equal(
        jcm.resample_matrix(j, shader_compat=True),
        tcm.resample_matrix(t, shader_compat=True),
    )
    full = tcm.resample_matrix_full(t)
    np.testing.assert_array_equal(jcm.resample_matrix_full(j), full)
    # the tap table is the full matrix's nonzeros, weights included
    taps = tck.resample_taps(full)
    dense = np.zeros_like(full)
    rows = np.arange(full.shape[0])
    np.add.at(dense, (rows, taps.j0.numpy()), taps.w0.numpy())
    np.add.at(dense, (rows, taps.j1.numpy()), taps.w1.numpy())
    np.testing.assert_array_equal(dense, full)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_band_plan_copies(name):
    """The colormap's banding plan and row-block choice, which the
    palette-sort economics count in, are the JAX kernel module's."""
    j, t = _configs(name)
    full_t = tcm.resample_matrix_full(t).T
    for m in (full_t, tcm.resample_matrix(t).T):
        for tile in (64, 128):
            segs = tck.band_segments(m, tile_px=tile)
            assert segs == jck.band_segments(m, tile_px=tile)
            for threshold in (0.25, 0.75):
                assert (tck._banded_worthwhile(segs, *m.shape, threshold)
                        == jck._banded_worthwhile(segs, *m.shape, threshold))
    for b in (1, 2560, 2561, 5120, 5121, 10240, 10241, 20480):
        for rows, cols in ((None, None), (8, None), (None, 16)):
            assert tck._auto_blocks(b, rows, cols) == jck._auto_blocks(b, rows, cols)
    with pytest.raises(ValueError, match="exceeds"):
        tck._auto_blocks(20481, None, None)


@pytest.mark.parametrize("w", [256, 2048, 2400])
def test_hann_copies(w):
    np.testing.assert_array_equal(jstft.hann_window_np(w), tstft.hann_window_np(w))
    np.testing.assert_array_equal(
        tstft.hann_window(w).numpy(), jstft.hann_window_np(w)
    )
    np.testing.assert_allclose(
        tstft.hann_window(w).numpy(), np.asarray(jstft.hann_window(w)), atol=1e-7
    )
    # the packed kernel's window constant, as the TPU kernel folds it
    n1 = 16 if w % 16 == 0 else 8
    jh = jsk._packed_hann(w, w // n1, n1, transposed=False)[: w // n1]
    np.testing.assert_array_equal(jh.reshape(-1), tsk.packed_hann(w))
    # the int16 planes' window: the wire scale folded in, as the TPU kernel
    # folds it for int16 operands
    np.testing.assert_array_equal(
        (jh * np.float32(2.0 ** -15)).reshape(-1), tsk.packed_hann_i16(w))
    # the split-real kernels' window: 2/W folded in, as `_scaled_hann`
    js = jsk._scaled_hann(w, w // n1, n1)
    np.testing.assert_array_equal(js.reshape(-1), tsk.split_hann(w))
    assert tsk.split_hann(w).dtype == js.dtype == np.float32


@pytest.mark.parametrize("rows,width", [(2048, 2048), (2048, 800), (6, 9), (16, 24)])
def test_time_resample_matrix_copy(rows, width):
    from spectrogram_tpu.models.spectrogram import _time_resample_matrix

    m = tcm.time_resample_matrix(rows, width)
    np.testing.assert_array_equal(_time_resample_matrix(rows, width), m)
    # every column is a one- or two-tap read, as the viewport's taps assume
    taps = tck.resample_taps(m.T)
    assert taps.bins == rows and taps.j0.shape == (width,)


def test_config_default_geometry():
    """The reference geometry the display path runs at (fft.rs:33,44,65)."""
    cfg = tcfg.DEFAULT_CONFIG
    assert (cfg.window_size, cfg.padded_size, cfg.hop_size, cfg.num_bins) == (
        2400, 4800, 58, 2399)


def test_twiddle_table():
    n = 512
    tw = tsk.twiddle_table(n)
    k = np.arange(n)
    ref = np.exp(-2j * np.pi * k / n)
    np.testing.assert_array_equal(tw[:, 0], ref.real.astype(np.float32))
    np.testing.assert_array_equal(tw[:, 1], ref.imag.astype(np.float32))


# (sample rate, window, hop, pad): BENCH, DEFAULT, the test geometries, and
# plans where lane_pad_default and flip_supported differ (n2 = 100, 64, 128,
# 120, 32, 75), an odd n1, and a window with no plan
PLAN_SWEEP = [
    (48000.0, 2048, 800, 2), (48000.0, 2400, 58, 2), (8000.0, 256, 64, 2),
    (8000.0, 256, 192, 2), (48000.0, 2048, 256, 2), (48000.0, 1024, 512, 2),
    (48000.0, 4800, 2400, 2), (48000.0, 2400, 480, 2), (48000.0, 1200, 300, 2),
    (48000.0, 3000, 600, 2), (48000.0, 1000, 250, 2), (48000.0, 2048, 800, 1),
    (48000.0, 2048, 2048, 2), (48000.0, 2250, 450, 2), (48000.0, 97, 10, 2), (48000.0, 509, 100, 2),
]


def _sweep_configs(rate, w, hop, pad):
    kw = dict(sample_rate=rate, window_period=w / rate, hop_period=hop / rate,
              pad_factor=pad)
    j, t = jcfg.SpectrogramConfig(**kw), tcfg.SpectrogramConfig(**kw)
    assert (t.window_size, t.hop_size) == (w, hop)
    return j, t


@pytest.mark.parametrize("geometry", PLAN_SWEEP)
def test_fft_plan_and_gates_copy(geometry):
    """`ops/fft_plan.py` against `mxu_fft.py` and the gates of
    `stft_kernel.py`, over plans where each gate goes both ways."""
    j, t = _sweep_configs(*geometry)
    n, w = t.padded_size, t.window_size
    assert tfp.choose_factors(n, w) == jfft.choose_factors(n, w)
    jp, tp = jfft.make_plan(j), tfp.make_plan(t)
    assert (jp is None) == (tp is None)
    if tp is None:
        return
    assert dataclasses.astuple(tp) == dataclasses.astuple(jp)
    assert tp.complex_macs == jp.complex_macs
    for fn in ("flip_supported", "padded_n2", "lane_pad_default"):
        assert getattr(tfp, fn)(tp) == getattr(jsk, fn)(jp), fn
    for lane_pad in (False, True):
        assert tfp.packed_supported(tp, lane_pad) == jsk.packed_supported(jp, lane_pad)
    assert tfp.carry_transposed_supported(t) == jsk.carry_transposed_supported(j)
    assert tfp.carry_transposed_supported(t, tp) == jsk.carry_transposed_supported(j, jp)
    for k in (1, 2, 8):
        for fn in ("split_framing_supported", "buf_framing_supported"):
            assert getattr(tfp, fn)(t, k) == getattr(jsk, fn)(j, k), (fn, k)
            assert getattr(tfp, fn)(t, k, tp) == getattr(jsk, fn)(j, k, jp), (fn, k)
        for lane_pad in (False, True):
            assert (tfp.tsplit_supported(t, k, tp, lane_pad=lane_pad)
                    == jsk.tsplit_supported(j, k, jp, lane_pad=lane_pad)), (k, lane_pad)


def test_plan_sweep_covers_both_sides_of_each_gate():
    plans = [tfp.make_plan(_sweep_configs(*g)[1]) for g in PLAN_SWEEP]
    plans = [p for p in plans if p is not None]
    for fn in (tfp.flip_supported, tfp.lane_pad_default):
        assert {fn(p) for p in plans} == {False, True}, fn
    assert {p.n1 % 2 for p in plans} == {0, 1}
    assert None in [tfp.make_plan(_sweep_configs(*g)[1]) for g in PLAN_SWEEP]


@pytest.mark.parametrize("res", [16, 32])
def test_lookup_tables_copy(res):
    """The full [P, R, R, 4] LUTs of the registry, of a FactoredScheme, and
    of a gradient given as a function."""
    np.testing.assert_array_equal(tcs.stacked_lookup_tables(res),
                                  jcs.stacked_lookup_tables(res))
    grey = dict(gradient_fn=lambda t: np.stack([t, t ** 2, 1 - t], -1))
    for args in (("g", "", None), ("g", "", (1, 2, 3))):
        np.testing.assert_array_equal(tcs.ColorScheme(*args, **grey).lookup_table(res),
                                      jcs.ColorScheme(*args, **grey).lookup_table(res))
    # every palette's LUT is its factors' outer product, as JAX's is
    u, v = tcs.stacked_factored_tables(res)
    np.testing.assert_array_equal(tcs.stacked_lookup_tables(res),
                                  u[:, :, None, :] * v[:, None, :, :])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_log_scale_and_resample_copies(name):
    """`ops/log_scale.py` and `ops/resample.py`: the axis mapping, its
    inverse and ticks, and every band matrix."""
    from spectrogram_tpu.ops import log_scale as jls
    from spectrogram_tpu.ops import resample as jrs
    from spectrogram_tpu_torch.ops import log_scale as tls
    from spectrogram_tpu_torch.ops import resample as trs

    j, t = _configs(name)
    for height in (None, 100):
        ja, ta = jls.display_scale(j, height), tls.display_scale(t, height)
        assert dataclasses.asdict(ta) == dataclasses.asdict(ja)
        for points in (3, 6, 12, 40):
            assert ta.key_points(points) == ja.key_points(points)
            assert ta.labeled_ticks(points) == ja.labeled_ticks(points)
        for v in (32.0, 440.0, 1000.0, 22030.0):
            assert ta.position_of(v) == ja.position_of(v)
        for pos in (0.0, 17.5, ta.extent):
            assert ta.value_of(pos) == ja.value_of(pos)
    wide = (tls.LogScale(20.0, 20000.0, 512, 10.0), jls.LogScale(20.0, 20000.0, 512, 10.0))
    assert wide[0].key_points(2) == wide[1].key_points(2)
    np.testing.assert_array_equal(trs.analyzer_band_matrix(t), jrs.analyzer_band_matrix(j))
    np.testing.assert_array_equal(trs.analyzer_band_matrix(t, 16),
                                  jrs.analyzer_band_matrix(j, 16))
    np.testing.assert_array_equal(trs.golden_pixel_matrix(t, 64), jrs.golden_pixel_matrix(j, 64))
    np.testing.assert_array_equal(trs.log_space_edges(32.0, 24000.0, 10),
                                  jrs.log_space_edges(32.0, 24000.0, 10))
    edges = np.array([100.0, 150.0, 151.0, 3000.0])
    np.testing.assert_array_equal(trs.cubic_band_matrix(edges, t.num_bins, t.sample_rate),
                                  jrs.cubic_band_matrix(edges, j.num_bins, j.sample_rate))


def test_import_leaves_jax_out():
    code = (
        "import sys, spectrogram_tpu_torch\n"
        "import spectrogram_tpu_torch.models.convert\n"
        "import spectrogram_tpu_torch.ops.fft_plan\n"
        "import spectrogram_tpu_torch.ops.cuda.stft_kernel\n"
        "import spectrogram_tpu_torch.ops.log_scale\n"
        "import spectrogram_tpu_torch.ops.resample\n"
        "import spectrogram_tpu_torch.profile_push\n"
        "import spectrogram_tpu_torch.io.feeder, spectrogram_tpu_torch.io.registry\n"
        "import spectrogram_tpu_torch.io.ring, spectrogram_tpu_torch.io.sources\n"
        "import spectrogram_tpu_torch.utils.checkpoint\n"
        "import spectrogram_tpu_torch.utils.profiling, spectrogram_tpu_torch.utils.probe\n"
        "spectrogram_tpu_torch.DeviceFeeder, spectrogram_tpu_torch.ChunkPool\n"
        "import spectrogram_tpu_torch.models.multirate, spectrogram_tpu_torch.session\n"
        "import spectrogram_tpu_torch.app, spectrogram_tpu_torch.models.golden\n"
        "import spectrogram_tpu_torch.models.oscilloscope\n"
        "import spectrogram_tpu_torch.models.spectrum_analyzer\n"
        "import spectrogram_tpu_torch.utils.image, spectrogram_tpu_torch.utils.terminal\n"
        "import spectrogram_tpu_torch.utils.liveview\n"
        "spectrogram_tpu_torch.LiveSession, spectrogram_tpu_torch.StreamGroupManager\n"
        "import spectrogram_tpu_torch.parallel.mesh, spectrogram_tpu_torch.parallel.distributed\n"
        "import spectrogram_tpu_torch.parallel.dryrun\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'orbax' or m.startswith('orbax.')"
        " or m == 'spectrogram_tpu' or m.startswith('spectrogram_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run(
        [sys.executable, "-c", code], check=True, timeout=120,
        cwd=pathlib.Path(__file__).resolve().parents[1],
    )


@pytest.mark.parametrize("module", ["image", "terminal", "liveview"])
def test_utils_copies_have_the_jax_source(module):
    """`utils/image.py`, `utils/terminal.py` and `utils/liveview.py` are the
    JAX package's modules with the package name changed and nothing else,
    and they draw the same frames."""
    root = pathlib.Path(__file__).resolve().parents[1]
    jsrc = (root / "spectrogram_tpu" / "utils" / f"{module}.py").read_text()
    tsrc = (root / "spectrogram_tpu_torch" / "utils" / f"{module}.py").read_text()
    assert tsrc == jsrc.replace("spectrogram_tpu.", "spectrogram_tpu_torch.")
    import importlib

    jmod = importlib.import_module(f"spectrogram_tpu.utils.{module}")
    tmod = importlib.import_module(f"spectrogram_tpu_torch.utils.{module}")
    img = np.random.default_rng(len(module)).integers(0, 256, (21, 34, 3), dtype=np.uint8)
    if module == "image":
        np.testing.assert_array_equal(tmod.rows_to_image(img), jmod.rows_to_image(img))
    elif module == "terminal":
        assert tmod.render_ansi(img, 9, 5) == jmod.render_ansi(img, 9, 5)
    else:
        np.testing.assert_array_equal(tmod.tile_grid([img, img[::-1]], 30, 40, highlight=0),
                                      jmod.tile_grid([img, img[::-1]], 30, 40, highlight=0))
