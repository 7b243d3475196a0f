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
from spectrogram_tpu.ops import stft as jstft
from spectrogram_tpu.ops.pallas import colormap_kernel as jck
from spectrogram_tpu.ops.pallas import stft_kernel as jsk

import spectrogram_tpu_torch.config as tcfg
from spectrogram_tpu_torch.color import colorscheme as tcs
from spectrogram_tpu_torch.color import gradients as tgr
from spectrogram_tpu_torch.ops import colormap as tcm
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


def test_import_leaves_jax_out():
    code = (
        "import sys, spectrogram_tpu_torch\n"
        "import spectrogram_tpu_torch.models.convert\n"
        "import spectrogram_tpu_torch.profile_push\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'spectrogram_tpu' or m.startswith('spectrogram_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run(
        [sys.executable, "-c", code], check=True, timeout=120,
        cwd=pathlib.Path(__file__).resolve().parents[1],
    )
