"""Frozen configuration for the spectrogram pipeline.

The reference (`spectrogram-rs`) scatters its knobs across hardcoded literals:
window period 0.05 s (src/widgets/gpu_spectrogram.rs:323), viewport 2048 rows /
2.5 s (gpu_spectrogram.rs:21-23), dB range -70/-10 duplicated in three places
(src/colorscheme.rs:16-17, gpu_spectrogram.rs:307-308), frequency range
32..22030 Hz (gpu_spectrogram.rs:152-153, simple_spectrogram.rs:107), LUT
resolution 32 (gpu_spectrogram.rs:235), and the `+1e-7` dB epsilon
(colorscheme.rs:60).  Here they live in one frozen (hence hashable) dataclass.

A copy of `spectrogram_tpu/config.py`: importing that module runs
`spectrogram_tpu/__init__.py`, which imports JAX, so the PyTorch port carries
its own.  `tests/test_torch_tables.py` pins the two against each other.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SpectrogramConfig:
    """All parameters of the STFT -> log-frequency -> colormap pipeline.

    Defaults reproduce the reference geometry at 48 kHz: window 2400 samples
    (0.05 s), zero-padded x2 to 4800, hop 58 samples (819.2 rows/s), 2399
    output bins (src/fourier/fft.rs:33,44,65; src/widgets/gpu_spectrogram.rs:21-23).
    """

    # --- STFT geometry (src/fourier/fft.rs) ---
    sample_rate: float = 48_000.0
    window_period: float = 0.05          # gpu_spectrogram.rs:323
    hop_period: float = 2.5 / 2048.0     # 1/819.2 s; gpu_spectrogram.rs:21-23
    pad_factor: int = 2                  # fft.rs:44 (padded = 2 * window)

    # --- presentation (colorscheme.rs, gpu_spectrogram.rs shader) ---
    min_db: float = -70.0                # colorscheme.rs:16
    max_db: float = -10.0                # colorscheme.rs:17
    db_epsilon: float = 1e-7             # colorscheme.rs:60
    min_frequency: float = 32.0          # gpu_spectrogram.rs:152
    max_frequency: float = 22_030.0      # gpu_spectrogram.rs:153 / simple_spectrogram.rs:107

    # --- viewport / display (gpu_spectrogram.rs:21-23, simple_spectrogram.rs:34-35) ---
    viewport_rows: int = 2048            # time extent of the scrolling ring
    viewport_height: int = 1024          # output pixels along the frequency axis
    lut_resolution: int = 32             # palette LUT side; gpu_spectrogram.rs:235

    # ------------------------------------------------------------------ derived
    @property
    def window_size(self) -> int:
        """Samples per analysis window: `(period * sample_rate) as usize`
        (truncating, fft.rs:19,41)."""
        return int(self.window_period * self.sample_rate)

    @property
    def padded_size(self) -> int:
        """Zero-padded FFT length (fft.rs:44)."""
        return self.window_size * self.pad_factor

    @property
    def hop_size(self) -> int:
        """Samples consumed per output row: `(stride * sample_rate) as usize`
        (truncating, audio_transform.rs:35)."""
        return max(int(self.hop_period * self.sample_rate), 1)

    @property
    def num_bins(self) -> int:
        """Output frequency bins per row = window_size - 1 (fft.rs:33)."""
        return self.window_size - 1

    @property
    def rows_per_second(self) -> float:
        return self.sample_rate / self.hop_size

    @property
    def bin_hz(self) -> float:
        """Frequency step between adjacent FFT bins of the padded transform."""
        return self.sample_rate / self.padded_size

    def frequency_of_bin(self, k) -> float:
        """Center frequency of output bin index k (0-based).

        Output bin j corresponds to padded-FFT bin k=j+1 (fft.rs:81 `skip(1)`).
        """
        return (k + 1) * self.bin_hz

    def log_frequency_fracs(self, n: int, centers: bool = True):
        """The n log-spaced pixel positions of the display frequency axis,
        as fractions f/max_frequency in (0, 1].

        Mirrors the fragment shader (gpu_spectrogram.rs:158-162):
        ``exp(lerp(ln min_f, ln max_f, uv.y)) / max_f`` with uv.y at pixel
        centers when `centers` else pixel edges.
        """
        lo, hi = math.log(self.min_frequency), math.log(self.max_frequency)
        out = []
        for i in range(n):
            v = (i + 0.5) / n if centers else i / n
            out.append(math.exp(lo + v * (hi - lo)) / self.max_frequency)
        return out

    def validate(self) -> None:
        if self.window_size < 2:
            raise ValueError("window too small")
        if self.hop_size < 1:
            raise ValueError("hop too small")
        if self.pad_factor < 1:
            raise ValueError("pad_factor must be >= 1")
        if not (0 < self.min_frequency < self.max_frequency):
            raise ValueError("bad frequency range")
        if not self.min_db < self.max_db:
            raise ValueError("bad dB range")


# The geometry bench.py measures: 4096-point FFT rows (BASELINE.json metric
# "rows/sec/chip at 4096-pt FFT x N streams") at the north-star 60 rows/s.
BENCH_CONFIG = SpectrogramConfig(
    sample_rate=48_000.0,
    window_period=2048.0 / 48_000.0,   # window 2048, padded x2 -> 4096-pt FFT
    hop_period=800.0 / 48_000.0,       # hop 800 -> 60 rows/s/stream
)

DEFAULT_CONFIG = SpectrogramConfig()
