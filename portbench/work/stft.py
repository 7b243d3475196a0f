"""The STFT layer's work per push.

Inputs: each stream's carry and hop samples, C + k * hop per channel in the
wire's dtype, read once (the k windows overlap inside them).  Outputs: the
magnitudes the layers after it read, f32, once per window and channel: the
distinct bins the colormap's taps read, and with a ring every bin 1..W-1.
Operations: per window, 5 N log2 N for the length-N transform of the
stereo pair (two real transforms of N, the usual count), 2 W for the Hann
window and 8 per channel and output bin for the unpack and the magnitude.

At both configurations the bytes bind (serve-bench48k: 248.6 MB against
4.32 GF a push, 74.2 us against 64.5 us; display-ref48k: 360.4 MB against
5.52 GF, 107.6 us against 82.3 us).
"""

from __future__ import annotations

import math

import torch

from portbench.reference import law


def work(run) -> tuple[float, float]:
    g, k, s = run.geometry, run.k, run.streams
    taps = law.taps(g, "cpu")
    bins = law.tapped_bins(taps)
    if run.store_ring:
        bins = torch.unique(torch.cat([bins, torch.arange(1, g.window)]))
    wire = torch.empty(0, dtype=getattr(torch, run.wire["dtype"])).element_size()
    windows = k * s
    nbytes = s * 2 * (g.carry + k * g.hop) * wire + windows * 2 * bins.numel() * 4
    flops = windows * (5 * g.n_fft * math.log2(g.n_fft) + 2 * g.window + 8 * 2 * bins.numel())
    return float(nbytes), float(flops)
