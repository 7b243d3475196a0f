"""Test signals made with numpy from a seed, and the RGBA comparison rule.

Tonal content is the precision probe: noise has no spectral-leakage floors,
so it hides FFT precision faults that a chirp exposes (the JAX package's
`benchmarks/precision_check.py` uses the same chirp plus tone).
"""

from __future__ import annotations

import numpy as np


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


def rgba_u8_diff(a: np.ndarray, b: np.ndarray) -> int:
    """Largest per-channel difference between two [..., 4] u8 RGBA images
    over what they show: alpha everywhere, and r, g, b wherever either
    image's alpha is nonzero.

    A stereo palette colors a pixel by its pan, r/(l+r), and sets alpha from
    its level.  Below the dB floor (alpha 0) both magnitudes are the FFT's
    f32 rounding noise, so their pan, and with it r, g, b, differs between
    any two FFT implementations, while the pixel stays fully transparent.
    """
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    shown = (a[..., 3] > 0) | (b[..., 3] > 0)
    return int(max(d[..., 3].max(initial=0), d[shown].max(initial=0)))
