"""The fused push against the JAX package, on the CPU.

The port's `push_fused_single` (on CPU tensors, the fused kernel's plain
version: the split-real STFT, then kernel B's plain version) against JAX's
`push_fused_single` in interpret mode, at the 8 kHz geometry of
tests/test_pallas_colormap.py (W=256, N=512, H=128) with scattered per-row
built-in tables, with and without `emit_mags`.  Rows within 1 u8 over what
the image shows (`testing.rgba_u8_diff`); the planes at 1e-6 absolute / 1e-4
relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrogram_tpu.config import SpectrogramConfig as JaxConfig
from spectrogram_tpu.ops import colormap as jcm
from spectrogram_tpu.ops.pallas import colormap_kernel as jck
from spectrogram_tpu.ops.pallas import push_kernel as jpk

from spectrogram_tpu_torch import testing
from spectrogram_tpu_torch.config import SpectrogramConfig
from spectrogram_tpu_torch.ops import colormap as tcm
from spectrogram_tpu_torch.ops.cuda import colormap_kernel as tck
from spectrogram_tpu_torch.ops.cuda import push_kernel as tpk
from spectrogram_tpu_torch.ops.cuda import stft_kernel as tsk

torch.set_num_threads(2)

KW = dict(sample_rate=8000.0, window_period=0.032, hop_period=0.008,
          viewport_height=128, max_frequency=3600.0)
CFG, JCFG = SpectrogramConfig(**KW), JaxConfig(**KW)


def _inputs(kind: str, rows: int = 5):
    rng = np.random.default_rng(7)
    frames = testing.make(kind, rows, CFG.window_size, CFG.sample_rate, seed=3)
    left, right = (np.ascontiguousarray(frames[..., c]) for c in range(2))
    tables = tck.builtin_color_tables(32)[rng.integers(0, 19, rows)]
    return left, right, tables


@pytest.mark.parametrize("kind", ["chirp_tone", "noise"])
@pytest.mark.parametrize("emit_mags", [False, True])
def test_fused_push_matches_jax(kind, emit_mags):
    left, right, tables = _inputs(kind)
    mt = jcm.resample_matrix_full(JCFG).T
    want = jpk.push_fused_single(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(tables), jnp.asarray(mt), JCFG,
        jck.band_segments(mt), block_rows=4, interpret=True, emit_mags=emit_mags)
    got = tpk.push_fused_single(torch.from_numpy(left), torch.from_numpy(right),
                                torch.from_numpy(tables), tcm.resample_matrix_full(CFG).T,
                                CFG, emit_mags=emit_mags)
    if emit_mags:
        (got, *got_mags), (want, *want_mags) = got, want
        for g, x in zip(got_mags, want_mags):
            assert g.shape == (5, CFG.padded_size // 2)
            np.testing.assert_allclose(g.numpy(), np.asarray(x), atol=1e-6, rtol=1e-4)
    assert got.shape == (5, CFG.viewport_height) and got.dtype == torch.int32
    assert testing.rgba_u8_diff(tck.unpack_rgba(got), tck.unpack_rgba(np.asarray(want))) <= 1


def test_fused_push_is_the_chain():
    """The plain fused push is the split-real STFT followed by kernel B's
    plain version, tables read per row (and one table broadcast)."""
    left, right, tables = (torch.from_numpy(a) for a in _inputs("chirp_tone"))
    hann = torch.from_numpy(tsk.split_hann(CFG.window_size))
    consts = tsk.fft_constants(CFG.padded_size)
    taps = tck.resample_taps(tcm.resample_matrix_full(CFG))
    ml, mr = tsk.stft_mag_split(left, right, hann, consts)
    for tab in (tables, tables[2:3]):
        rows, gl, gr = tpk.push_fused(left, right, hann, consts, tab, taps, CFG, emit_mags=True)
        torch.testing.assert_close(rows, tck.colormap_builtin(ml, mr, taps, tab, CFG),
                                   atol=0, rtol=0)
        torch.testing.assert_close(gl, ml, atol=0, rtol=0)
        torch.testing.assert_close(gr, mr, atol=0, rtol=0)


def test_fused_push_refuses_as_jax():
    left, right, tables = _inputs("noise")
    mt = tcm.resample_matrix_full(CFG).T
    pf1 = dict(KW, pad_factor=1)
    with pytest.raises(ValueError, match="pad_factor"):
        jpk.push_fused_single(jnp.asarray(left), jnp.asarray(right), jnp.asarray(tables),
                              jnp.asarray(mt), JaxConfig(**pf1), ((0, 128, 0, 128),),
                              interpret=True)
    with pytest.raises(ValueError, match="pad_factor"):
        tpk.push_fused_single(torch.from_numpy(left), torch.from_numpy(right),
                              torch.from_numpy(tables), mt, SpectrogramConfig(**pf1))
    with pytest.raises(ValueError, match="resample matrix expects"):
        tpk.push_fused_single(torch.from_numpy(left), torch.from_numpy(right),
                              torch.from_numpy(tables), mt[1:], CFG)
    with pytest.raises(ValueError, match="no STFT kernel"):
        tpk.push_fused_single(torch.from_numpy(left).to("meta"),
                              torch.from_numpy(right).to("meta"),
                              torch.from_numpy(tables).to("meta"), mt, CFG)
