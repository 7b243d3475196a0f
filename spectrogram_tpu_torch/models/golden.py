"""Golden model: the reference's CPU rendering path, transcribed exactly.

`SimpleSpectrogram` (reference src/widgets/simple_spectrogram.rs) is the
reference's own "golden" renderer: per STFT column it reverse-translates each
of 1024 pixel rows to a frequency band through the invertible log coordinate
(src/log_scaling.rs:114-119), band-averages cubic-interpolated point samples
(src/fourier/interpolated_frequency_sample.rs:60-75,89-105), colors via
`ColorScheme::color_for` (src/colorscheme.rs:55-71), and writes a scrolling
pixbuf column.

This module transcribes that math in numpy/f64 — deliberately NOT the
production path (that is the shader-law pipeline in models/spectrogram.py;
the two differ in interpolation scheme and pan law, see colorscheme.color_for
docstring).  Roles:

* numerical authority for tests of the band-resampling ops;
* the "SimpleSpectrogram" product capability: offline high-quality stills.

Deviations from the Rust, all guards of latent bugs, none behavioral in the
reference's operating range:
* cubic_interpolate's `x0 = floor(i)-1` underflows usize for i < 1
  (interpolated_frequency_sample.rs:92); we clamp to 0.  Unreachable in
  practice (32 Hz maps to index > 3 at any supported rate).
* `magnitude_in` divides by a zero band width if f0 == f1; unreachable for
  monotone log coordinates.

The port's copy of `spectrogram_tpu/models/golden.py`: the same numpy law,
function for function; only `render`'s STFT runs on `torch.fft`, on the CPU
unless the caller names the card.  `tests/test_torch_golden.py` pins it
against the original.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from spectrogram_tpu_torch.color.colorscheme import ColorScheme, scheme_by_name
from spectrogram_tpu_torch.config import SpectrogramConfig

# SimpleSpectrogram's own geometry (simple_spectrogram.rs:34-35, :102, :107).
TEXTURE_WIDTH = 1024
TEXTURE_HEIGHT = 1024


def default_golden_config(sample_rate: float = 48_000.0) -> SpectrogramConfig:
    """The config SimpleSpectrogram runs: window 0.05 s, stride 2/1024 s."""
    return SpectrogramConfig(
        sample_rate=sample_rate,
        window_period=0.05,
        hop_period=2.0 / TEXTURE_WIDTH,
        viewport_height=TEXTURE_HEIGHT,
        viewport_rows=TEXTURE_WIDTH,
    )


def pixel_band_edges(cfg: SpectrogramConfig, height: int) -> np.ndarray:
    """[height+1] band-edge frequencies f(py) = exp(lerp(ln fmin, ln fmax, py/H)).

    The reverse translation of the plotters log coordinate
    (log_scaling.rs:114-119) evaluated at pixel rows 0..H — edges, not
    centers (simple_spectrogram.rs:142-144 queries py and py+1).
    """
    lo, hi = math.log(cfg.min_frequency), math.log(cfg.max_frequency)
    py = np.arange(height + 1, dtype=np.float64)
    return np.exp(lo + (py / height) * (hi - lo))


def cubic_interpolate(data: np.ndarray, index: np.ndarray) -> np.ndarray:
    """Catmull-like cubic (interpolated_frequency_sample.rs:89-105), batched.

    data: [B, C] per-bin values; index: [n] fractional positions (clamped by
    the caller).  Returns [n, C].
    """
    b = data.shape[0]
    mu = index - np.floor(index)
    x1 = np.floor(index).astype(np.int64)
    x0 = np.maximum(x1 - 1, 0)          # usize-underflow guard
    x2 = np.minimum(x1 + 1, b - 1)
    x3 = np.minimum(x1 + 2, b - 1)
    y0, y1, y2, y3 = data[x0], data[x1], data[x2], data[x3]
    a0 = y3 - y2 - y0 + y1
    a1 = y0 - y1 - a0
    a2 = y2 - y0
    a3 = y1
    mu = mu[:, None]
    return a0 * mu**3 + a1 * mu**2 + a2 * mu + a3


def cosine_interpolate(data: np.ndarray, index: np.ndarray) -> np.ndarray:
    """Cosine interpolation (interpolated_frequency_sample.rs:79-86) — dead
    code in the reference but README-advertised; kept as a capability."""
    b = data.shape[0]
    low = np.floor(index).astype(np.int64)
    high = np.clip(np.ceil(index).astype(np.int64), low + 1, b - 1)
    low = np.minimum(low, b - 1)
    offset = index - low
    offset = (1.0 - np.cos(offset * np.pi)) / 2.0
    return data[low] * (1.0 - offset[:, None]) + data[high] * offset[:, None]


@dataclasses.dataclass
class InterpolatedFrequencySample:
    """One spectrum queryable by frequency band (the FrequencySample trait,
    src/fourier/mod.rs:17-25, as implemented by
    interpolated_frequency_sample.rs)."""

    magnitudes: np.ndarray  # [B, 2] (left, right)
    sample_rate: float
    interpolation: str = "cubic"  # active choice (:47); "cosine" available

    @property
    def period(self) -> float:
        # interpolated_frequency_sample.rs:52-54
        return 2.0 * len(self.magnitudes) / self.sample_rate

    def index_of(self, frequency: np.ndarray) -> np.ndarray:
        # :24-31 — clamp into [0, B-1]
        return np.clip(frequency * self.period, 0.0, len(self.magnitudes) - 1.0)

    def magnitude_at(self, frequency: np.ndarray) -> np.ndarray:
        interp = cubic_interpolate if self.interpolation == "cubic" else cosine_interpolate
        return interp(self.magnitudes, self.index_of(np.atleast_1d(frequency)))

    def magnitude_in(self, f0: float, f1: float) -> np.ndarray:
        """Band magnitude = mean of interpolated point samples on a lin_space
        (:60-75).  lin_space over an exclusive range yields n points at
        f0 + i*(f1-f0)/n."""
        i0, i1 = self.index_of(np.array([f0, f1]))
        num = max(int(np.floor(i1 - i0)), 1)
        freqs = f0 + np.arange(num) * (f1 - f0) / num
        return self.magnitude_at(freqs).mean(axis=0)


class GoldenSpectrogram:
    """The SimpleSpectrogram widget as an offline renderer.

    render(pcm) -> [n_cols, H, 4] u8 RGBA columns (column = one STFT hop;
    row 0 = lowest frequency, matching models/spectrogram.py orientation;
    the widget's pixbuf flip (simple_spectrogram.rs:150) is display-side).
    """

    def __init__(
        self,
        cfg: SpectrogramConfig | None = None,
        scheme: ColorScheme | None = None,
        interpolation: str = "cubic",
    ):
        self.cfg = cfg or default_golden_config()
        self.scheme = scheme or scheme_by_name("Magma")  # widget default (:98)
        self.interpolation = interpolation
        self._edges = pixel_band_edges(self.cfg, self.cfg.viewport_height)

    def render_spectrum(self, magnitudes: np.ndarray) -> np.ndarray:
        """One STFT row [B, 2] -> one pixel column [H, 4] u8."""
        cfg = self.cfg
        sample = InterpolatedFrequencySample(
            np.asarray(magnitudes, np.float64), cfg.sample_rate, self.interpolation
        )
        h = cfg.viewport_height
        out = np.zeros((h, 4), dtype=np.uint8)
        for py in range(h):
            # Band for display row py counted from the top (py_out = H-1-py);
            # we emit row 0 = lowest frequency, so band py -> out[py].
            l, r = sample.magnitude_in(self._edges[py], self._edges[py + 1])
            (red, green, blue), alpha = self.scheme.color_for(l, r)
            out[py] = (red, green, blue, np.clip(alpha * 255.0, 0, 255))
        return out

    def render(self, pcm: np.ndarray, device="cpu") -> np.ndarray:
        """[T, 2] PCM -> [n_cols, H, 4] u8 RGBA (one column per hop).

        The STFT is the port's `ops.stft.stft_rows` (`torch.fft`) on
        `device`: the CPU unless the caller names the card.  The band means
        and colors are the numpy law above, on the host."""
        import torch

        from spectrogram_tpu_torch.ops import stft as stft_ops

        pcm = torch.as_tensor(np.asarray(pcm, np.float32), device=device)
        rows = stft_ops.stft_rows(pcm, self.cfg).cpu().numpy()
        return np.stack([self.render_spectrum(row) for row in rows], axis=0)

    def composite(self, rgba: np.ndarray) -> np.ndarray:
        """Alpha-blend over the scheme background (the widget's background
        fill + textured draw, simple_spectrogram.rs:168-178)."""
        bg = np.asarray(self.scheme.background_color(), np.float64)
        a = rgba[..., 3:4].astype(np.float64) / 255.0
        rgb = rgba[..., :3].astype(np.float64) * a + bg * (1.0 - a)
        return np.clip(np.round(rgb), 0, 255).astype(np.uint8)
