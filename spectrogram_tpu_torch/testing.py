"""Test signals made with numpy from a seed, and the comparison rules for
RGBA rows and for the bf16 row ring.

Tonal content is the precision probe: noise has no spectral-leakage floors,
so it hides FFT precision faults that a chirp exposes (the JAX package's
`benchmarks/precision_check.py` uses the same chirp plus tone).
"""

from __future__ import annotations

import numpy as np
import torch


def chirp_tone(n_streams: int, n_samples: int, sample_rate: float,
               seed: int = 0) -> np.ndarray:
    """[S, T, 2] f32: left an exponential chirp from 100 Hz up to 0.4 fs,
    right a 440 Hz tone; each stream starts at its own random phase offset."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / sample_rate
    span = max(t[-1], 1.0 / sample_rate)
    ratio = min(80.0, 0.4 * sample_rate / 100.0)
    phase = 2 * np.pi * 100.0 * (np.exp(t * np.log(ratio) / span) - 1) * span / np.log(ratio)
    out = np.empty((n_streams, n_samples, 2), np.float32)
    for s, offset in enumerate(rng.uniform(0.0, 2 * np.pi, n_streams)):
        out[s, :, 0] = 0.5 * np.sin(phase + offset)
        out[s, :, 1] = 0.2 * np.sin(2 * np.pi * 440.0 * t + offset)
    return out


def noise(n_streams: int, n_samples: int, seed: int = 0) -> np.ndarray:
    """[S, T, 2] f32 Gaussian noise, standard deviation 0.3."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_streams, n_samples, 2)) * 0.3).astype(np.float32)


def make(kind: str, n_streams: int, n_samples: int, sample_rate: float,
         seed: int = 0) -> np.ndarray:
    """`chirp_tone` or `noise` by name."""
    if kind == "chirp_tone":
        return chirp_tone(n_streams, n_samples, sample_rate, seed)
    if kind == "noise":
        return noise(n_streams, n_samples, seed)
    raise ValueError(f"unknown signal {kind!r}")


def rgba_u8_diff(a, b) -> int:
    """Largest per-channel difference between two [..., 4] u8 RGBA images
    (numpy arrays, or tensors on one device) over what they show: alpha
    everywhere, and r, g, b wherever either image's alpha is nonzero.

    A stereo palette colors a pixel by its pan, r/(l+r), and sets alpha from
    its level.  Below the dB floor (alpha 0) both magnitudes are the FFT's
    f32 rounding noise, so their pan, and with it r, g, b, differs between
    any two FFT implementations, while the pixel stays fully transparent.
    """
    if isinstance(a, torch.Tensor):       # on the tensors' device
        d = (a.to(torch.int32) - b.to(torch.int32)).abs()
        shown = (a[..., 3] > 0) | (b[..., 3] > 0)
        worst = [d[..., 3].flatten(), d[shown].flatten(), d.new_zeros(1)]
        return int(torch.cat(worst).max())
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    shown = (a[..., 3] > 0) | (b[..., 3] > 0)
    return int(max(d[..., 3].max(initial=0), d[shown].max(initial=0)))


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32)
    return torch.from_numpy(np.asarray(x, np.float32))


def bf16_ulps(a, b, atol: float = 0.0) -> float:
    """Largest difference between two rings of bf16 values (arrays, or
    tensors on one device), in bf16 ulps at the larger magnitude of each
    pair, after forgiving `atol` of absolute difference.

    Two f32 STFTs that agree to within atol round to bf16 values at most one
    ulp apart, except where the values are so small that atol spans many
    ulps: those lie far below the dB floor and show nothing.
    """
    a, b = _f32(a), _f32(b)
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    if not a.numel():
        return 0.0
    _, exp = torch.frexp(torch.maximum(a.abs(), b.abs()))
    ulp = torch.ldexp(torch.ones_like(a), exp - 8)   # 8 significant bits
    excess = ((a - b).abs() - atol).clamp(min=0.0)
    return float((excess / ulp).max())
