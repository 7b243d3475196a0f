"""Kernel A's plain version and the golden STFT against the JAX package.

The port's packed STFT (`stft_mag_packed_plain`, what the CUDA kernel is held
to on the card) against the TPU kernel `stft_mag_fused2(packed=True,
slice_bins=False)` run in interpret mode, and the torch.fft golden path
against the JAX golden path.  Tolerance atol 3e-5 / rtol 1e-4, the bar the
JAX suite holds its own fused STFT to (tests/test_pallas_stft.py): both
sides are f32 FFTs of different factorizations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrogram_tpu.config import SpectrogramConfig as JaxConfig
from spectrogram_tpu.ops import stft as jstft
from spectrogram_tpu.ops.mxu_fft import FftPlan
from spectrogram_tpu.ops.pallas import stft_kernel as jsk

from spectrogram_tpu_torch import testing
from spectrogram_tpu_torch.config import SpectrogramConfig
from spectrogram_tpu_torch.ops import stft as tstft
from spectrogram_tpu_torch.ops.cuda import stft_kernel as tsk

torch.set_num_threads(2)

KW = dict(sample_rate=8000.0, window_period=0.032, hop_period=0.008)  # W=256
CFG = SpectrogramConfig(**KW)
JCFG = JaxConfig(**KW)
ATOL, RTOL = 3e-5, 1e-4


def _windows(kind: str, rows: int) -> np.ndarray:
    """[rows, W, 2] windows cut from one long signal."""
    w = CFG.window_size
    return testing.make(kind, 1, rows * w, CFG.sample_rate, seed=3)[0].reshape(rows, w, 2)


def _plain(frames: np.ndarray, cfg=CFG):
    left = torch.from_numpy(np.ascontiguousarray(frames[..., 0]))
    right = torch.from_numpy(np.ascontiguousarray(frames[..., 1]))
    hann = torch.from_numpy(tsk.packed_hann(cfg.window_size))
    ml, mr = tsk.stft_mag_packed_plain(left, right, hann, cfg.padded_size)
    return ml.numpy(), mr.numpy()


@pytest.mark.parametrize("kind", ["chirp_tone", "noise"])
def test_packed_plain_matches_tpu_kernel(kind):
    frames = _windows(kind, 8)
    jl, jr = jsk.stft_mag_fused2(
        jnp.asarray(frames[..., 0]), jnp.asarray(frames[..., 1]), JCFG,
        block_rows=4, interpret=True, slice_bins=False, packed=True,
        plan=FftPlan(512, 4, 128, 64),
    )
    tl, tr = _plain(frames)
    assert tl.shape == tr.shape == (8, CFG.padded_size // 2)
    np.testing.assert_allclose(tl, np.asarray(jl), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tr, np.asarray(jr), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("kind", ["chirp_tone", "noise"])
def test_golden_matches_jax_golden(kind):
    pcm = testing.make(kind, 2, 4 * CFG.window_size, CFG.sample_rate, seed=5)
    got = tstft.stft_rows_planar(torch.from_numpy(pcm), CFG).numpy()
    want = np.asarray(jstft.stft_rows_planar(jnp.asarray(pcm), JCFG))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("kind", ["chirp_tone", "noise"])
def test_packed_plain_matches_golden_bins(kind):
    """Bins 1..W-1 of the packed planes are the golden rows."""
    frames = _windows(kind, 6)
    tl, tr = _plain(frames)
    golden = tstft.stft_frame_planar(torch.from_numpy(frames), CFG).numpy()
    w = CFG.window_size
    np.testing.assert_allclose(tl[:, 1:w], golden[:, 0], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tr[:, 1:w], golden[:, 1], atol=ATOL, rtol=RTOL)


def test_frame_signal_matches_jax():
    pcm = testing.noise(2, 5 * CFG.hop_size + CFG.window_size + 7, seed=1)
    got = tstft.frame_signal(torch.from_numpy(pcm), CFG).numpy()
    want = np.asarray(jstft.frame_signal(jnp.asarray(pcm), JCFG))
    np.testing.assert_array_equal(got, want)
    assert tstft.num_rows(pcm.shape[1], CFG) == jstft.num_rows(pcm.shape[1], JCFG)
    assert tstft.carry_size(CFG) == jstft.carry_size(JCFG)
    short = torch.zeros(1, CFG.window_size - 1, 2)
    assert tstft.frame_signal(short, CFG).shape == (1, 0, CFG.window_size, 2)


def test_wrapper_takes_plain_version_on_cpu():
    frames = _windows("noise", 3)
    left = torch.from_numpy(np.ascontiguousarray(frames[..., 0]))
    right = torch.from_numpy(np.ascontiguousarray(frames[..., 1]))
    hann = torch.from_numpy(tsk.packed_hann(CFG.window_size))
    tw = torch.from_numpy(tsk.twiddle_table(CFG.padded_size))
    got = tsk.stft_mag_packed(left, right, hann, tw)
    want = tsk.stft_mag_packed_plain(left, right, hann, CFG.padded_size)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


def test_wrapper_refuses_other_devices_and_sizes():
    meta = torch.empty((2, 256), device="meta")
    hann = torch.empty(256, device="meta")
    tw = torch.empty((256, 2), device="meta")
    with pytest.raises(ValueError, match="no STFT kernel"):
        tsk.stft_mag_packed(meta, meta, hann, tw)
    # odd, a prime factor of 7, out of range
    for n in (4801, 4802, 128, 32768):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tsk.check_fft_size(n)
    for n in (256, 480, 4096, 4800, 9600, 16384):
        tsk.check_fft_size(n)
