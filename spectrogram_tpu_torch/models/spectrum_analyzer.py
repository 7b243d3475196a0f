"""Spectrum analyzer: per-band level meters with peak decay, batched.

The port of `spectrogram_tpu/models/spectrum_analyzer.py`, a redesign of the
reference `SpectrumAnalyzer` widget (src/widgets/spectrum_analyzer.rs): 128
log-spaced bands from 32 Hz to max(fs/2, 22050) (:53-59), each bar showing
`10*log10(|m| + 1e-7)` normalized to [-70, -10] (:61-66 — note the
reference's law uses the complex NORM here, not power, unlike the
spectrogram's dB law) with peak decay `max(new, prev * 0.99)` (:67).

Device-side the whole band query (cubic band-mean over the spectrum,
C7's `magnitude_in`) is one precomputed [bands, bins] product
(ops/resample.analyzer_band_matrix); the decay is a running state tensor.

The band product runs in true f32 as JAX's (`Precision.HIGHEST`): a
broadcast multiply and a sum, never a matrix multiply, so no TF32 setting a
caller may flip applies to it.  It is plain torch, as it is plain JAX in
the JAX package.  Without a `device` the analyzer lives on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from spectrogram_tpu_torch.config import SpectrogramConfig
from spectrogram_tpu_torch.models.spectrogram import StreamState, default_device
from spectrogram_tpu_torch.ops.resample import analyzer_band_matrix

MIN_DB = -70.0  # spectrum_analyzer.rs:49
MAX_DB = -10.0  # spectrum_analyzer.rs:50
DECAY = 0.99    # spectrum_analyzer.rs:67

def band_product(matrix: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """sum_b matrix[g, b] * rows[n, b] for [G, B] f32 `matrix` and [N, B] f32
    `rows` -> [N, G] f32, as a float64 product rounded to f32: TF32 never
    applies to float64, so the product is true f32 or better on every
    device, whatever the matmul precision settings."""
    return (rows.double() @ matrix.double().T).float()


def ring_rows(state: StreamState, k: int) -> torch.Tensor:
    """The k newest rows of a pipeline state's ring (the rows its last push
    wrote), [S, k, B, 2] f32 in time order: ring rows (cursor - k + i) %
    R, indexed on the device so the cursor is never read to the host."""
    r = state.ring.shape[1]
    at = (state.cursor.to(torch.int64) - k
          + torch.arange(k, device=state.ring.device)) % r
    rows = state.ring.index_select(1, at).to(torch.float32)       # [S, k, 2, B]
    return rows.transpose(-1, -2)


class SpectrumAnalyzer:
    """Batched bar meters: push spectrogram rows, read bar levels in [0, 1]."""

    def __init__(self, cfg: SpectrogramConfig, n_bands: int = 128, device=None):
        self.cfg = cfg
        self.n_bands = int(n_bands)
        self.device = default_device(device)
        self.band_matrix = torch.from_numpy(
            analyzer_band_matrix(cfg, n_bands).astype(np.float32)).to(self.device)

    def init_levels(self, n_streams: int) -> torch.Tensor:
        # LevelBar initial value 0.3 (spectrum_analyzer.rs:95)
        return torch.full((n_streams, self.n_bands), 0.3, dtype=torch.float32,
                          device=self.device)

    def push_rows(self, levels: torch.Tensor, rows) -> torch.Tensor:
        """Update levels with a batch of spectrogram rows.

        levels: [S, bands]; rows: [S, k, bins, 2].  Each row applies one
        band-magnitude measurement followed by one decay step, in order (a
        loop over k, JAX's lax.scan) — identical to pushing rows one at a
        time.  Returns new levels; `levels` is not written.
        """
        rows = torch.as_tensor(rows).to(device=self.device, dtype=torch.float32)
        s, k, b, _ = rows.shape
        planar = rows.permute(0, 1, 3, 2).reshape(s * k * 2, b)
        bands_lr = band_product(self.band_matrix, planar).view(s, k, 2, self.n_bands)
        norm = torch.sqrt(
            bands_lr[:, :, 0] ** 2 + bands_lr[:, :, 1] ** 2
        )  # |c| — the analyzer's law uses norm, not power (:63)
        db = 10.0 * torch.log10(norm + 1e-7)
        new_vals = torch.clamp((db - MIN_DB) / (MAX_DB - MIN_DB), 0.0, 1.0)
        levels = levels.to(self.device)
        for i in range(k):                                        # time order
            levels = torch.maximum(new_vals[:, i], levels * DECAY)
        return levels

    @staticmethod
    def rasterize_levels(levels, height: int, scheme) -> np.ndarray:
        """Host-side raster of one stream's levels [bands] -> [height, bands,
        3] u8 bar image — the live-view analog of the reference's LevelBar
        column (spectrum_analyzer.rs:48-69, 88-99): one vertical bar per band
        rising from the bottom, colored by the scheme's foreground (GTK
        LevelBar chrome has no device analog; the bar geometry is the parity
        surface).  Vectorized (one mask over the [height, bands] grid)."""
        if isinstance(levels, torch.Tensor):
            levels = levels.detach().cpu().numpy()
        lv = np.clip(np.asarray(levels, np.float32), 0.0, 1.0)
        bands = lv.shape[0]
        bg = np.asarray(scheme.background_color(), np.uint8)
        fg = np.asarray(scheme.foreground_color(), np.uint8)
        img = np.broadcast_to(bg, (height, bands, 3)).copy()
        ys = np.arange(height)[:, None]  # row 0 = top
        img[ys >= ((1.0 - lv[None, :]) * height)] = fg
        return img
