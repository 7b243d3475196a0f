"""LiveSession: the runtime wiring layer (the reference's `build_ui` story).

The port of `spectrogram_tpu/session.py`.  Ties together the input
registry, host ring, pipeline, and the secondary visualizers the way
src/main.rs wires the GTK app (:62-151):

* selecting an input pauses the old stream, opens the new one, and — when the
  sample rate changes — rebuilds the pipeline (new FFT plan) and resets the
  state, exactly the reference's `select` -> `set_sample_rate` ->
  `fft_texture.set(None)` chain (audio_input_list_model.rs:35-83,
  gpu_spectrogram.rs:320-327);
* palette changes propagate at runtime with no rebuild (the `palette`
  property binding, main.rs:102-104);
* per-tick processing drains the host ring in hop-multiple chunks, feeding
  the spectrogram pipeline and, optionally, the oscilloscope and spectrum
  analyzer from the same samples (the visualizer swap site, main.rs:69-72).

Everything runs on the session's device: the card unless the caller passes
`device="cpu"`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from spectrogram_tpu_torch.color.colorscheme import scheme_index
from spectrogram_tpu_torch.config import SpectrogramConfig
from spectrogram_tpu_torch.io.registry import InputRegistry
from spectrogram_tpu_torch.models.oscilloscope import Oscilloscope
from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline, default_device
from spectrogram_tpu_torch.models.spectrum_analyzer import SpectrumAnalyzer, ring_rows
from spectrogram_tpu_torch.utils.profiling import LatencyTracker


@dataclasses.dataclass
class SessionConfig:
    window_period: float = 0.05
    hop_period: float = 2.5 / 2048.0
    viewport_height: int = 1024
    viewport_rows: int = 2048
    chunk_hops: int = 8
    palette: str = "Magma"
    enable_scope: bool = False
    enable_analyzer: bool = False


class LiveSession:
    """Single-stream live session over the input registry."""

    def __init__(self, session_cfg: Optional[SessionConfig] = None, device=None):
        self.scfg = session_cfg or SessionConfig()
        self.device = default_device(device)
        self.registry = InputRegistry(on_sample_rate=self._on_sample_rate)
        self.pipeline: Optional[SpectrogramPipeline] = None
        self.state = None
        self.scope = None
        self.scope_state = None
        self.analyzer = None
        self.levels = None
        self.latency = LatencyTracker()
        self.palette_id = scheme_index(self.scfg.palette)

    # -- wiring ---------------------------------------------------------------

    def _on_sample_rate(self, rate: float) -> None:
        """Sample-rate notify: rebuild the pipeline (new FFT plan) and reset
        state — the re-specialization path."""
        cfg = SpectrogramConfig(
            sample_rate=rate,
            window_period=self.scfg.window_period,
            hop_period=self.scfg.hop_period,
            viewport_height=self.scfg.viewport_height,
            viewport_rows=self.scfg.viewport_rows,
        )
        self.pipeline = SpectrogramPipeline(
            cfg, chunk_hops=self.scfg.chunk_hops, device=self.device)
        if self.pipeline.chunk_size > self.registry.ring.capacity:
            # The reference silently deadlocks when its ingest ring is
            # smaller than a window (SURVEY.md §5 / DESIGN.md D7); we refuse.
            raise ValueError(
                f"chunk ({self.pipeline.chunk_size} frames) exceeds ingest "
                f"ring capacity ({self.registry.ring.capacity}); enlarge the "
                "ring or reduce chunk_hops"
            )
        self.state = self.pipeline.init_state(1, palette_id=self.palette_id)
        if self.scfg.enable_scope:
            self.scope = Oscilloscope(push_size=self.pipeline.chunk_size,
                                      device=self.device)
            self.scope_state = self.scope.init_state(1)
        if self.scfg.enable_analyzer:
            # The analyzer consumes the magnitude rows push just wrote into
            # the row ring — no second STFT.  Ring rows are bf16: a <=0.4%
            # magnitude rounding, invisible on a dB bar display (the
            # reference's own texture path quantizes to f16 the same way).
            self.analyzer = SpectrumAnalyzer(cfg, device=self.device)
            self.levels = self.analyzer.init_levels(1)

    def select_input(self, index: int):
        """Switch input device/source (pause -> reconfigure -> play)."""
        return self.registry.select(index)

    def set_palette(self, name: str) -> None:
        self.palette_id = scheme_index(name)
        if self.pipeline is not None and self.state is not None:
            self.state = self.pipeline.set_palette(self.state, self.palette_id)

    # -- per-tick processing ----------------------------------------------------

    def process_available(self, max_chunks: int = 64):
        """Drain the host ring in chunk-size steps; returns the RGBA rows
        produced this tick (possibly empty), host numpy [k, H, 4] u8 each."""
        if self.pipeline is None:
            return []
        out = []
        n = self.pipeline.chunk_size
        k = self.pipeline.chunk_hops
        for _ in range(max_chunks):
            if len(self.registry.ring) < n:
                break
            frames = self.registry.ring.pop(n)
            chunk = torch.from_numpy(frames[None]).to(self.pipeline.device)
            with self.latency.measure():
                self.state, rgba = self.pipeline.push(self.state, chunk)
                rgba_np = rgba[0].cpu().numpy()
            out.append(rgba_np)
            if self.analyzer is not None:
                # the rows push just wrote to the ring (no second STFT), one
                # chunk behind the new cursor, sliced on the device
                self.levels = self.analyzer.push_rows(
                    self.levels, ring_rows(self.state, k))
            if self.scope is not None:
                self.scope_state = self.scope.push(self.scope_state, chunk)
        return out

    def metrics(self) -> dict:
        """Observability snapshot: rows, latency, drops (SURVEY §5 gap)."""
        out = {
            "ring_fill": len(self.registry.ring),
            "ring_dropped": self.registry.ring.dropped,
            "latency": self.latency.summary(),
        }
        if self.state is not None:
            out["rows_produced"] = int(self.state.row_count)
            out["palette_id"] = int(self.state.palette_id[0])
        src = self.registry._active
        if src is not None and hasattr(src, "overflows"):
            out["capture_overflows"] = src.overflows
        return out

    def viewport(self) -> np.ndarray:
        """[R, H, 4] u8 current scrolling view."""
        vp = self.pipeline.render_viewport(self.state)
        return vp[0].cpu().numpy()

    def stop(self):
        self.registry.stop()
