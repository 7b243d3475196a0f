"""The plain reference of the spectrogram pipeline, in plain PyTorch.

It computes, from the generated PCM alone, what every layer of a push must
produce: the framing of each stream's history into windows and the next
carry, the STFT magnitudes, the two-tap log-frequency resample, the dB,
pan and palette laws, the u8 quantisation, the palette-sort order the
deployment's layout rule gives, and the bf16 ring rows.  The laws are those
of spectrogram-rs (src/fourier/fft.rs:43-99, src/widgets/gpu_spectrogram.rs
:150-190, src/colorscheme.rs:55-91) as the configuration states them.  It
imports nothing of the program it judges and takes none of its tables: it
writes out the Hann window, the resample taps, the palette tables and the
sort again.

The STFT is computed two ways.  `precision="f32"` is the reference: each
channel's windowed samples through `torch.fft.rfft` in float32, |X_k| * 2/W
(the stereo-packed complex FFT of fft.rs gives the same magnitudes).
`precision="bf16"` is the control, the step below the configuration's
float32 that would tempt a faster kernel: the DFT as a bfloat16 matrix
product on the tensor cores (float32 accumulation, bfloat16 result).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class Geometry(NamedTuple):
    sample_rate: float
    window: int        # W
    hop: int
    n_fft: int         # N = W * pad_factor
    carry: int         # C = W - hop (0 where hop >= W)
    bins: int          # B = W - 1: output bins 1 .. W-1
    height: int        # H pixels
    resolution: int    # LUT side R
    min_db: float
    max_db: float
    db_epsilon: float
    min_frequency: float
    max_frequency: float
    viewport_rows: int


def geometry(spec: dict) -> Geometry:
    """The geometry of a configuration's "spectrogram" block, by fft.rs's
    truncating rules."""
    fs = float(spec["sample_rate"])
    w = int(spec["window_period"] * fs)
    hop = max(int(spec["hop_period"] * fs), 1)
    return Geometry(
        sample_rate=fs, window=w, hop=hop, n_fft=w * int(spec["pad_factor"]),
        carry=w - hop if w > hop else 0, bins=w - 1,
        height=int(spec["viewport_height"]), resolution=int(spec["lut_resolution"]),
        min_db=float(spec["min_db"]), max_db=float(spec["max_db"]),
        db_epsilon=float(spec["db_epsilon"]),
        min_frequency=float(spec["min_frequency"]),
        max_frequency=float(spec["max_frequency"]),
        viewport_rows=int(spec["viewport_rows"]),
    )


class Taps(NamedTuple):
    """Pixel p reads w0[p] * bin k0[p] + w1[p] * bin k1[p] of a row
    (k = padded-FFT bin index, k >= 1)."""

    k0: torch.Tensor
    k1: torch.Tensor
    w0: torch.Tensor
    w1: torch.Tensor


def taps(g: Geometry, device) -> Taps:
    """The shader's log-frequency fetch (gpu_spectrogram.rs:158-174): pixel
    y at frequency exp(lerp(ln f_min, ln f_max, (y + 0.5) / H)), sampled
    linearly between output bins (bin j holds padded bin j + 1, fft.rs:81),
    clamped to the first and last output bin."""
    lo, hi = math.log(g.min_frequency), math.log(g.max_frequency)
    y = (np.arange(g.height, dtype=np.float64) + 0.5) / g.height
    pos = np.exp(lo + y * (hi - lo)) / (g.sample_rate / g.n_fft) - 1.0
    base = np.floor(pos)
    w = pos - base
    j0 = np.clip(base, 0, g.bins - 1).astype(np.int64)
    j1 = np.clip(base + 1, 0, g.bins - 1).astype(np.int64)

    def dev(a):
        return torch.from_numpy(a).to(device)

    return Taps(dev(j0 + 1), dev(j1 + 1), dev((1.0 - w).astype(np.float32)),
                dev(w.astype(np.float32)))


def tapped_bins(t: Taps) -> torch.Tensor:
    """The distinct padded bins the taps read, ascending."""
    return torch.unique(torch.cat([t.k0, t.k1]))


def hann(window: int, device) -> torch.Tensor:
    """Periodic Hann, denominator W (fft.rs:60-63), in float64 rounded once."""
    i = np.arange(window, dtype=np.float64)
    return torch.from_numpy((0.5 * (1.0 - np.cos(2.0 * np.pi * i / window)))
                            .astype(np.float32)).to(device)


# ----------------------------------------------------------------- framing

def samples(words: torch.Tensor) -> torch.Tensor:
    """Wire words as f32 samples: int16 PCM is x / 32768, exactly."""
    if words.dtype == torch.int16:
        return words.to(torch.float32) * (1.0 / 32768.0)
    return words.to(torch.float32)


def history(pool: torch.Tensor, push: int, g: Geometry, k: int,
            streams: torch.Tensor | None = None) -> torch.Tensor:
    """[n, 2, C + k*hop] wire words: the carry before push `push` followed
    by its chunk, for the selected streams (all where None).  `pool` is the
    generated [P, S, 2, k*hop] planar PCM in external stream order; push i
    carries chunk pool[i % P].  Samples before the first push are zeros."""
    p, s, _, t = pool.shape
    need = g.carry + t
    parts = []
    for m in range(-(-need // t) - 1, -1, -1):
        j = push - m
        chunk = pool[j % p] if j >= 0 else torch.zeros_like(pool[0])
        parts.append(chunk if streams is None else chunk.index_select(0, streams))
    return torch.cat(parts, dim=-1)[..., -need:]


def next_carry(pool: torch.Tensor, push: int, g: Geometry, k: int,
               streams: torch.Tensor | None = None) -> torch.Tensor:
    """[n, 2, C] wire words: the carry after push `push`."""
    h = history(pool, push, g, k, streams)
    return h[..., h.shape[-1] - g.carry:]


def windows(hist: torch.Tensor, g: Geometry, k: int) -> torch.Tensor:
    """[n, k, 2, W] f32 samples: window r of a push starts at r * hop of its
    history (audio_transform.rs:34-42)."""
    x = samples(hist)
    return torch.stack([x[..., r * g.hop: r * g.hop + g.window] for r in range(k)], dim=1)


# -------------------------------------------------------------------- STFT

def magnitudes(win: torch.Tensor, g: Geometry, bins: torch.Tensor,
               precision: str = "f32") -> torch.Tensor:
    """[..., W] f32 windowed-to-be samples -> [..., len(bins)] f32 |X_k| *
    2/W at the padded bins `bins`, channel by channel (a stereo pair's two
    channels are two rows)."""
    lead = win.shape[:-1]
    x = win.reshape(-1, g.window) * hann(g.window, win.device)
    if precision == "f32":
        spec = torch.fft.rfft(x, n=g.n_fft)
        mag = torch.abs(spec.index_select(1, bins))
    elif precision == "bf16":
        mag = _bf16_dft_magnitudes(x, g, bins)
    else:
        raise ValueError(f"unknown precision {precision!r}")
    return (mag * np.float32(2.0 / g.window)).reshape(*lead, bins.numel())


def _bf16_dft_magnitudes(x: torch.Tensor, g: Geometry, bins: torch.Tensor,
                         rows: int = 8192) -> torch.Tensor:
    """|DFT_N| at `bins` as a bfloat16 matrix product (the control)."""
    n = np.arange(g.window, dtype=np.float64)[:, None]
    k = bins.cpu().numpy().astype(np.float64)[None, :]
    angle = -2.0 * np.pi * ((n * k) % g.n_fft) / g.n_fft
    cos = torch.from_numpy(np.cos(angle)).to(x.device, torch.bfloat16)
    sin = torch.from_numpy(np.sin(angle)).to(x.device, torch.bfloat16)
    out = []
    for r0 in range(0, x.shape[0], rows):
        xb = x[r0: r0 + rows].to(torch.bfloat16)
        re = (xb @ cos).to(torch.float32)
        im = (xb @ sin).to(torch.float32)
        out.append(torch.sqrt(re * re + im * im))
    return torch.cat(out)


# ---------------------------------------------------------------- colormap

def _texel(coord: torch.Tensor, r: int) -> torch.Tensor:
    """The GL sampler's clamped texel position."""
    return torch.clamp(torch.clamp(coord, 0.0, 1.0) * r - 0.5, 0.0, r - 1.0)


def colormap(mag_l: torch.Tensor, mag_r: torch.Tensor, bins: torch.Tensor,
             t: Taps, luts: torch.Tensor, pid: torch.Tensor, g: Geometry) -> torch.Tensor:
    """[n, len(bins)] magnitudes at padded bins `bins` (ascending, holding
    every tap), a palette id per row -> [n, H, 4] u8 RGBA: the two-tap
    resample, dB (gpu_spectrogram.rs:177-179), pan r/(l+r) with a centre
    guard at l+r = 0 (:182), the clamped bilinear sample of the palette's
    [R, R, 4] table at (pan, dB) (:185), round half to even of 255 v."""
    c0 = torch.searchsorted(bins, t.k0)
    c1 = torch.searchsorted(bins, t.k1)
    pl = t.w0 * mag_l.index_select(1, c0) + t.w1 * mag_l.index_select(1, c1)
    pr = t.w0 * mag_r.index_select(1, c0) + t.w1 * mag_r.index_select(1, c1)
    power = pl * pl + pr * pr
    db = 10.0 * torch.log10(power + g.db_epsilon)
    mag = (db - g.min_db) / (g.max_db - g.min_db)
    denom = pl + pr
    nonzero = denom != 0.0
    pan = torch.where(nonzero, pr / torch.where(nonzero, denom, 1.0), 0.5)
    r = g.resolution
    py, px = _texel(mag, r), _texel(pan, r)
    y0, x0 = torch.floor(py).long(), torch.floor(px).long()
    y1, x1 = torch.clamp(y0 + 1, max=r - 1), torch.clamp(x0 + 1, max=r - 1)
    wy = (py - y0.to(py.dtype))[..., None]
    wx = (px - x0.to(px.dtype))[..., None]
    flat = luts.reshape(-1, 4)
    base = pid.to(torch.int64)[:, None] * (r * r)

    def at(y, x):
        return flat.index_select(0, (base + y * r + x).reshape(-1)).reshape(*y.shape, 4)

    top = at(y0, x0) * (1 - wx) + at(y0, x1) * wx
    bot = at(y1, x0) * (1 - wx) + at(y1, x1) * wx
    v = top * (1 - wy) + bot * wy
    return torch.clamp(torch.round(v * 255.0), 0, 255).to(torch.uint8)


# ------------------------------------------------------------ palette order

def sort_order(ids: np.ndarray, k: int, rule: dict, ring: bool) -> np.ndarray:
    """The stream order the deployment's palette layout rule gives for
    per-stream ids (external order): sorted[i] = external[order[i]].

    The rule: a layout is "blockwise" where at least `min_uniform_share` of
    its blocks of `row_block` streams (or of all the streams, where k*S is
    not a multiple of it) hold one palette.  A blockwise external layout
    stays as it is.  Otherwise the streams are stably sorted by palette
    within blocks of `block_streams` (from `blocks_from_streams` streams at
    k = 1 without a ring; one block otherwise), kept where that layout is
    blockwise; else, without a ring, one whole-state sort, kept where
    blockwise; else the external order."""
    s = ids.shape[0]
    ts = rule["row_block"] if (s * k) % rule["row_block"] == 0 else min(rule["row_block"], s * k)

    def blockwise(layout):
        nb = s // ts
        if nb == 0:
            return bool(layout.size) and bool((layout == layout[0]).all())
        head = layout[: nb * ts].reshape(nb, ts)
        return float((head == head[:, :1]).all(axis=1).mean()) >= rule["min_uniform_share"]

    identity = np.arange(s)
    if blockwise(ids):
        return identity
    bs = rule["block_streams"] if (k == 1 and not ring
                                   and s >= rule["blocks_from_streams"]) else s
    order = np.concatenate([b0 + np.argsort(ids[b0: b0 + bs], kind="stable")
                            for b0 in range(0, s, bs)])
    if blockwise(ids[order]):
        return order
    if bs < s and not ring:
        order = np.argsort(ids, kind="stable")
        if blockwise(ids[order]):
            return order
    return identity


# -------------------------------------------------------------- comparisons

def rgba_gap(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int, int]:
    """Two [..., 4] u8 images -> (largest per-channel gap over what they
    show, pixels with any shown channel off, pixels): alpha everywhere,
    r, g, b wherever either alpha is above 0 (below the dB floor a stereo
    palette's pixel is transparent, and its pan is rounding noise)."""
    d = (a.to(torch.int16) - b.to(torch.int16)).abs()
    shown = ((a[..., 3] > 0) | (b[..., 3] > 0))[..., None]
    d = torch.where(torch.cat([shown.expand(*shown.shape[:-1], 3),
                               torch.ones_like(shown)], dim=-1), d, 0)
    worst = d.amax(dim=-1)
    return int(worst.max()) if worst.numel() else 0, int((worst > 0).sum()), worst.numel()


def bf16_ulps(a: torch.Tensor, b: torch.Tensor, floor: float) -> tuple[int, int]:
    """Two bf16 arrays of magnitudes (>= 0) -> (largest distance in bf16
    steps over the entries where b is at least `floor`, entries counted)."""
    ia = a.contiguous().view(torch.int16).to(torch.int32)
    ib = b.contiguous().view(torch.int16).to(torch.int32)
    mask = b.to(torch.float32) >= floor
    d = (ia - ib).abs()[mask]
    return (int(d.max()) if d.numel() else 0), int(mask.sum())
