"""Seeded traffic: the PCM every stream sends and the palette each stream
shows, from a traffic file's parameters and the run's seed.

The signal extends the port's test signal (`testing.chirp_tone`: an
exponential chirp on the left channel, a tone on the right) with seeded
band-limited noise on both channels and a level that changes every
`segment_s` seconds, so that tonal leakage floors, noise, every colormap tap and both dB
clamps (below `min_db` and above `max_db`) see use.  Every stream draws
its own chirp range, tone, noise band, levels and phase.  The PCM is made
on the device with a seeded `torch.Generator`, in blocks of streams, as
one pool of `pushes` chunks per stream that a loop cycles through: the
noise is periodic over the pool, so that the cycle has no seam in it.

Every seed gives the same sizes and the same work: the seed moves levels,
frequencies, phases, and which stream takes which palette, never how many
streams take each palette.  The palettes' popularity follows a law over a
fixed order of palettes (`ranks`, most popular first), and every run of
`stratum` consecutive streams holds the law's counts exactly, by largest
remainder: the seed shuffles the streams within each run, so every
palette layout rule sees the same block counts on every seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

BLOCK_STREAMS = 1024


def _uniform(gen, n, lo_hi, device) -> torch.Tensor:
    lo, hi = lo_hi
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=device, dtype=torch.float64)


def pool(signal: dict, sample_rate: float, hop: int, chunk_hops: int, streams: int,
         pushes: int, dtype: torch.dtype, seed: int, device) -> torch.Tensor:
    """[pushes, streams, 2, chunk_hops * hop] planar PCM in external stream
    order (left, right), float32 in [-1, 1] or int16 words round(x * 32767)."""
    device = torch.device(device)
    t_len = chunk_hops * hop
    length = pushes * t_len
    out = torch.empty((pushes, streams, 2, t_len), dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    t = torch.arange(length, device=device, dtype=torch.float64) / sample_rate
    span = length / sample_rate
    seg = max(int(round(signal["segment_s"] * sample_rate)), 1)
    n_seg = -(-length // seg)
    nyq = sample_rate / 2.0
    for s0 in range(0, streams, BLOCK_STREAMS):
        n = min(BLOCK_STREAMS, streams - s0)
        ch, tone, noise = signal["chirp"], signal["tone"], signal["noise"]
        f0 = _uniform(gen, n, ch["start_hz"], device)[:, None]
        ratio = _uniform(gen, n, ch["end_frac"], device)[:, None] * nyq / f0
        phase0 = _uniform(gen, n, (0.0, 2.0 * math.pi), device)[:, None]
        chirp = torch.sin(2.0 * math.pi * f0 * span / torch.log(ratio)
                          * (torch.exp(t * torch.log(ratio) / span) - 1.0) + phase0)
        chirp *= 10.0 ** (_uniform(gen, n, ch["level_db"], device)[:, None] / 20.0)
        f_tone = _uniform(gen, n, tone["hz"], device)[:, None]
        right = torch.sin(2.0 * math.pi * f_tone * t + phase0)
        right *= 10.0 ** (_uniform(gen, n, tone["level_db"], device)[:, None] / 20.0)
        # band-limited noise, periodic over the pool: a random spectrum in
        # each stream's band, inverse-transformed and scaled to its level
        lo_hz = _uniform(gen, n, noise["low_hz"], device)[:, None]
        hi_hz = lo_hz * _uniform(gen, n, noise["width_ratio"], device)[:, None]
        freqs = torch.arange(length // 2 + 1, device=device, dtype=torch.float64) / span
        band = (freqs >= lo_hz) & (freqs <= torch.clamp(hi_hz, max=nyq))
        level = 10.0 ** (_uniform(gen, n, noise["level_db"], device)[:, None] / 20.0)
        planes = []
        for base in (chirp, right):
            spec = torch.complex(
                torch.randn((n, freqs.numel()), generator=gen, device=device, dtype=torch.float64),
                torch.randn((n, freqs.numel()), generator=gen, device=device, dtype=torch.float64),
            ) * band
            x = torch.fft.irfft(spec, n=length)
            x *= level / torch.clamp(x.pow(2).mean(dim=1, keepdim=True).sqrt(), min=1e-30)
            planes.append(base + x)
        gain_db = _uniform(gen, n * n_seg, signal["gain_db"], device).reshape(n, n_seg)
        gain = torch.repeat_interleave(10.0 ** (gain_db / 20.0), seg, dim=1)[:, :length]
        x = torch.clamp(torch.stack(planes, dim=1) * gain[:, None, :], -1.0, 1.0)
        if dtype == torch.int16:
            x = torch.round(x * 32767.0)
        block = x.to(dtype).reshape(n, 2, pushes, t_len).permute(2, 0, 1, 3)
        out[:, s0: s0 + n] = block
    return out


def palettes(law: dict, streams: int, n_palettes: int, seed: int):
    """Per-stream palette ids (numpy int32 [S]) by the traffic's law, or one
    int where every stream shows the same palette (law "one")."""
    if law["law"] == "one":
        return int(law["palette"])
    if law["law"] != "zipf":
        raise ValueError(f"unknown palette law {law['law']!r}")
    ranks = np.asarray(law["ranks"], dtype=np.int32)
    if sorted(ranks) != list(range(n_palettes)):
        raise ValueError(f"ranks must order the {n_palettes} palettes once each")
    stratum = min(int(law["stratum"]), streams)
    if streams % stratum:
        raise ValueError(f"{streams} streams are no whole number of strata of {stratum}")
    p = 1.0 / np.arange(1, n_palettes + 1, dtype=np.float64) ** float(law["exponent"])
    raw = stratum * p / p.sum()
    counts = np.floor(raw).astype(np.int64)
    counts[np.argsort(-(raw - counts), kind="stable")[: stratum - counts.sum()]] += 1
    rng = np.random.default_rng(int(seed))
    run = np.repeat(ranks, counts)
    return np.concatenate([rng.permutation(run) for _ in range(streams // stratum)])
