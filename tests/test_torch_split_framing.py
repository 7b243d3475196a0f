"""The carry+chunk STFT pair against the JAX package, on the CPU.

The port's `stft_mag_fused2_split` (the split kernel's plain version on a
CPU tensor) against JAX's `stft_mag_fused2_split`, and the port's
all-windows wrappers with `emit_carry` (packed f32, packed int16,
split-real) against JAX's `stft_mag_fused2_allk(emit_carry=True)`, all in
interpret mode at the geometry of tests/test_pallas_stft.py (W=256, hop
64).  Magnitudes at 1e-6 absolute / 1e-4 relative (two f32 FFTs of
different factorizations on values up to ~0.3); the next carry exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrogram_tpu.config import SpectrogramConfig as JaxConfig
from spectrogram_tpu.ops.mxu_fft import FftPlan
from spectrogram_tpu.ops.pallas import stft_kernel as jsk

from spectrogram_tpu_torch import testing
from spectrogram_tpu_torch.config import SpectrogramConfig
from spectrogram_tpu_torch.ops.cuda import stft_kernel as tsk

torch.set_num_threads(2)

KW = dict(sample_rate=8000.0, window_period=0.032, hop_period=0.008)   # W=256, hop 64
CFG, JCFG = SpectrogramConfig(**KW), JaxConfig(**KW)
ATOL, RTOL = 1e-6, 1e-4
PACKED_PLAN = FftPlan(512, 4, 128, 64)   # the W=256 plan JAX's packed body takes


def _carry_chunk(kind: str, s: int, k: int, seed: int):
    """[S, 2, C] carry and [S, 2, k*hop] chunk of one signal."""
    c, t = tsk.carry_len(CFG.window_size, CFG.hop_size), k * CFG.hop_size
    pcm = testing.make(kind, s, c + t, CFG.sample_rate, seed=seed).transpose(0, 2, 1)
    return np.ascontiguousarray(pcm[:, :, :c]), np.ascontiguousarray(pcm[:, :, c:])


def _close(got, want):
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("kind", ["chirp_tone", "noise"])
def test_split_framing_matches_jax(k, kind):
    carry, chunk = _carry_chunk(kind, 4, k, seed=k)
    want = jsk.stft_mag_fused2_split(jnp.asarray(carry), jnp.asarray(chunk), JCFG, k=k,
                                     interpret=True)
    got = tsk.stft_mag_fused2_split(torch.from_numpy(carry), torch.from_numpy(chunk), CFG, k=k)
    assert got[0].shape == (k * 4, CFG.padded_size // 2)
    _close(got[:2], want[:2])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # the rows are the all-windows function's on the concatenated buffers
    buf = np.concatenate([carry, chunk], axis=2)
    hann = torch.from_numpy(tsk.split_hann(CFG.window_size))
    allk = tsk.stft_mag_split_allk(*(torch.from_numpy(np.ascontiguousarray(buf[:, c]))
                                     for c in range(2)),
                                   hann, tsk.fft_constants(CFG.padded_size), k, CFG.hop_size)
    for g, a in zip(got, allk):
        torch.testing.assert_close(g, a, atol=0, rtol=0)


@pytest.mark.parametrize("form", ["packed", "packed_i16", "split"])
@pytest.mark.parametrize("k", [1, 4])
def test_allk_emit_carry_matches_jax(form, k):
    """The next carry [S, 2, W - hop], in the buffers' dtype, is the last
    W - hop samples of each buffer; the magnitudes are the same as without
    the flag."""
    w, h = CFG.window_size, CFG.hop_size
    rng = np.random.default_rng(k)
    shape = (3, w + (k - 1) * h)
    if form == "packed_i16":
        bufs = [rng.integers(-32768, 32768, shape, dtype=np.int16) for _ in range(2)]
        hann = tsk.packed_hann_i16(w)
    else:
        bufs = [(rng.standard_normal(shape) * 0.3).astype(np.float32) for _ in range(2)]
        hann = tsk.packed_hann(w) if form == "packed" else tsk.split_hann(w)
    packed = form != "split"
    want = jsk.stft_mag_fused2_allk(
        *map(jnp.asarray, bufs), JCFG, k=k, interpret=True, emit_carry=True, packed=packed,
        plan=PACKED_PLAN if packed else None)
    wrapper = tsk.stft_mag_packed_allk if packed else tsk.stft_mag_split_allk
    args = (*map(torch.from_numpy, bufs), torch.from_numpy(hann),
            tsk.fft_constants(CFG.padded_size), k, h)
    got = wrapper(*args, emit_carry=True)
    _close(got[:2], want[:2])
    assert got[2].dtype == torch.from_numpy(bufs[0]).dtype
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    c = w - h
    np.testing.assert_array_equal(got[2].numpy(), np.stack([b[:, -c:] for b in bufs], 1))
    for g, x in zip(got, wrapper(*args)):
        torch.testing.assert_close(g, x, atol=0, rtol=0)


def test_split_framing_refuses_as_jax():
    """JAX's gate `split_framing_supported` (hop a multiple of the plan's
    n1, pad_factor >= 2) refuses the same geometries in both; operands that
    do not fit raise."""
    for kw in (dict(KW, hop_period=0.008 + 1 / 8000.0), dict(KW, pad_factor=1)):
        cfg, jcfg = SpectrogramConfig(**kw), JaxConfig(**kw)
        c = tsk.carry_len(cfg.window_size, cfg.hop_size)
        carry = np.zeros((2, 2, c), np.float32)
        chunk = np.zeros((2, 2, cfg.hop_size), np.float32)
        with pytest.raises(ValueError, match="split framing unsupported"):
            jsk.stft_mag_fused2_split(jnp.asarray(carry), jnp.asarray(chunk), jcfg,
                                      interpret=True)
        with pytest.raises(ValueError, match="split framing unsupported"):
            tsk.stft_mag_fused2_split(torch.from_numpy(carry), torch.from_numpy(chunk), cfg)
    carry, chunk = (torch.from_numpy(a) for a in _carry_chunk("noise", 2, 2, seed=0))
    with pytest.raises(ValueError, match="do not fit"):
        tsk.stft_mag_fused2_split(carry[:, :, 1:], chunk, CFG, k=2)
    with pytest.raises(ValueError, match="do not fit"):
        tsk.stft_mag_fused2_split(carry, chunk, CFG, k=1)
    with pytest.raises(ValueError, match="no STFT kernel"):
        tsk.stft_mag_fused2_split(carry.to("meta"), chunk.to("meta"), CFG, k=2)
