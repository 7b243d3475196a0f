"""Test signals made with numpy from a seed, a user-defined test palette,
and the comparison rules for RGBA rows and for the bf16 row ring.

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


def chirp_tone_planes(n_streams: int, n_samples: int, sample_rate: float, seed: int,
                      device, dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """(left, right) [S, T] sample planes of `chirp_tone` on `device`; for
    int16 the PCM words round(x * 32767)."""
    pcm = chirp_tone(n_streams, n_samples, sample_rate, seed=seed)
    if dtype == torch.int16:
        pcm = np.round(pcm * 32767.0).astype(np.int16)
    return tuple(torch.from_numpy(np.ascontiguousarray(pcm[..., c])).to(device)
                 for c in range(2))


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time in ms of fn() on the current CUDA card over `iters`
    calls, after one warm-up, with the card held by a spin kernel while the
    host enqueues the calls: host time between launches (the wrappers'
    checks, the allocator) does not count.  The spin is lengthened until it
    outlasts the enqueueing."""
    import time

    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    while True:
        hold, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        hold.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if hold.elapsed_time(start) > 1.2 * enqueue_ms:
            return start.elapsed_time(end) / iters
        if cycles > 1 << 34:
            raise RuntimeError("device_ms: the timed calls wait for the card")
        cycles *= 4


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


def custom_factors(resolution: int = 32) -> tuple[np.ndarray, np.ndarray]:
    """(U, V) [R, 4] factors of a palette outside the built-in mono/stereo
    structure, the JAX package's on-chip gate's (`spectrogram_tpu/smoke.py`
    class_generic): r, g, b from magnitude and pan, alpha from magnitude."""
    ramp = np.linspace(0.0, 1.0, resolution, dtype=np.float32)
    one = np.ones(resolution, np.float32)
    u = np.stack([ramp, ramp**2, np.sqrt(ramp), ramp], axis=1)
    v = np.stack([1 - 0.3 * ramp, one, 0.5 + 0.5 * ramp, one], axis=1)
    return u, v


def custom_scheme():
    """`custom_factors` as the FactoredScheme "smoke-custom"."""
    from spectrogram_tpu_torch.color.colorscheme import FactoredScheme

    return FactoredScheme("smoke-custom", *custom_factors(), background=(10, 10, 10))


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


def magnitude_texels(planes, cfg) -> np.ndarray:
    """[..., 2, B] magnitude rows of bins 1..W-1 (either package's STFT;
    numpy or a tensor) -> [..., H] each pixel's coordinate on the LUT's
    magnitude axis, in texels, by the colormap's resample and dB laws: 0 at
    and below the dB floor."""
    from spectrogram_tpu_torch.ops import colormap as cmap_ops

    rows = _f32(planes).transpose(-1, -2)                      # [..., B, 2]
    px = cmap_ops.resample_rows(rows, torch.from_numpy(cmap_ops.resample_matrix(cfg)))
    mag = cmap_ops.db_normalize(px[..., 0], px[..., 1], cfg)
    return cmap_ops.texel_coord(mag, cfg.lut_resolution).numpy()


def rgba_u8_diff_above_floor(a, b, texels_a, texels_b) -> int:
    """Largest per-channel difference between two [..., H, 4] u8 RGBA images
    over the pixels whose magnitude texel coordinate (`magnitude_texels` of
    each image's own STFT) is above 0 in both: every channel there, nothing
    below the dB floor.

    `rgba_u8_diff` forgives r, g, b where alpha is 0, which covers the
    built-in palettes, whose alpha is 0 below the floor.  A generic palette
    can make alpha, or any channel, depend on pan: in a scheme with alpha =
    0.25 + 0.75 pan, a pixel below the floor is shown, colored by the pan of
    two magnitudes that are f32 rounding noise and differ between any two
    FFTs.  Such pixels say nothing about the port, so this reading holds
    the pixels both STFTs put above the floor, all four channels.
    """
    a, b = np.asarray(a).astype(np.int32), np.asarray(b).astype(np.int32)
    shown = (np.asarray(texels_a) > 0) & (np.asarray(texels_b) > 0)
    return int(np.abs(a - b)[shown].max(initial=0))


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32)
    return torch.from_numpy(np.array(x, np.float32))


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
