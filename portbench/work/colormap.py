"""The colormap layer's work per push.

Inputs: per row and channel the distinct bins the taps read, f32, once;
each stream's palette id (4 bytes) and the palette registry's tables once
(P x R x 4 f32, the built-in palettes' factor rows); the taps (two bin
indices and two weights a pixel).  Outputs: the packed rows, H int32 words
a row.  Operations: 40 a pixel (the two-tap resample of both channels 6,
power and dB 6, normalisation 2, pan 3, the two texel coordinates 10, the
four channels' two-tap table reads 12, quantisation 1).

The bytes bind at both configurations (serve-bench48k: 181.6 MB against
0.67 GF a push, 54.2 us against 10.0 us; display-ref48k: 188.0 MB, 56.1
us against 10.0 us).
"""

from __future__ import annotations

from portbench.reference import law, palettes

FLOPS_PER_PIXEL = 40


def work(run) -> tuple[float, float]:
    g, k, s = run.geometry, run.k, run.streams
    bins = law.tapped_bins(law.taps(g, "cpu")).numel()
    rows = k * s
    nbytes = (rows * 2 * bins * 4 + s * 4 + len(palettes.SCHEMES) * g.resolution * 4 * 4
              + g.height * 16 + rows * g.height * 4)
    return float(nbytes), float(rows * g.height * FLOPS_PER_PIXEL)
