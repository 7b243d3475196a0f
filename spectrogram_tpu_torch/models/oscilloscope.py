"""Oscilloscope: raw-waveform visualizer, batched over streams.

The port of `spectrogram_tpu/models/oscilloscope.py`, a redesign of the
reference `Oscilloscope` widget (src/widgets/oscilloscope.rs): a 16384-sample
F32F32 ring texture written destructively from the stream (:199-213) and
drawn as two GL line strips whose vertex shader fetches sample i at
(gl_VertexID + ring_index) (:122-136).

Here the ring is a device tensor [S, N, 2] with a modular cursor, and the
"draw" is a min/max envelope reduction: each output pixel column covers
N/width consecutive samples and reports their (min, max) per channel — the
standard way to rasterize a waveform without a vertex pipeline, returning
[S, width, 2ch, 2] envelopes a host UI can fill between.  Line color comes
from the palette extremes exactly like the reference (color_for((1,0)) /
color_for((0,1)), oscilloscope.rs:177-178).

The cursor stays on the device: `push` writes and `envelope` reads through
modular indices `(cursor + arange) % N`, so neither reads it back to the
host.  The envelope is plain torch (JAX computes it outside any Pallas
kernel too).  Without a `device` the scope lives on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from spectrogram_tpu_torch.color.colorscheme import ColorScheme
from spectrogram_tpu_torch.models.spectrogram import default_device

BUFFER_SIZE = 1024 * 16  # oscilloscope.rs:19


class ScopeState(NamedTuple):
    ring: torch.Tensor    # [S, N, 2] f32 sample ring
    cursor: torch.Tensor  # [] int32 next write index (shared: lockstep pushes)


class Oscilloscope:
    """Batched waveform ring + envelope renderer.

    chunk contract mirrors the pipeline: push_size samples per push, with
    buffer_size % push_size == 0 so writes never wrap mid-chunk.
    """

    def __init__(self, push_size: int, buffer_size: int = BUFFER_SIZE, device=None):
        self.push_size = int(push_size)
        # Round up so writes never wrap mid-chunk (same policy as the
        # spectrogram ring's viewport_rows rounding).
        self.buffer_size = -(-int(buffer_size) // self.push_size) * self.push_size
        self.device = default_device(device)
        self._push_offsets = torch.arange(self.push_size, device=self.device)

    def init_state(self, n_streams: int) -> ScopeState:
        return ScopeState(
            ring=torch.zeros((n_streams, self.buffer_size, 2), dtype=torch.float32,
                             device=self.device),
            cursor=torch.zeros((), dtype=torch.int32, device=self.device),
        )

    def push(self, state: ScopeState, chunk) -> ScopeState:
        """Destructive ring write (the reference pops the stream dry,
        oscilloscope.rs:199-213): chunk [S, push_size, 2] into samples
        cursor .. cursor+push_size-1.  The ring is written in place, so the
        old and new state share it (JAX donates the old state instead)."""
        chunk = torch.as_tensor(chunk).to(device=self.device, dtype=torch.float32)
        if chunk.shape[1:] != (self.push_size, 2):
            raise ValueError(
                f"chunk must be [S, {self.push_size}, 2]; got {tuple(chunk.shape)}"
            )
        at = state.cursor.to(torch.int64) + self._push_offsets
        state.ring.index_copy_(1, at, chunk)
        return ScopeState(
            ring=state.ring, cursor=(state.cursor + self.push_size) % self.buffer_size
        )

    def envelope(self, state: ScopeState, width: int = 1024) -> torch.Tensor:
        """[S, width, 2, 2] (min, max) per pixel column per channel, in
        chronological order (oldest sample left).

        Any width <= buffer_size works: each column covers
        buffer_size // width samples, and when width does not divide
        buffer_size the envelope spans the NEWEST width * (buffer_size //
        width) samples (the oldest sliver is dropped — the buffer is
        rounded up to a push multiple, so the display window is an
        approximation of the full ring by at most one column's worth)."""
        if not 0 < width <= self.buffer_size:
            raise ValueError(
                f"width must be in 1..{self.buffer_size}, got {width}"
            )
        per_col = self.buffer_size // width
        span = width * per_col
        # sample j of the chronological ring is ring[(cursor + j) % N]; keep
        # the newest `span`
        at = (state.cursor.to(torch.int64) + (self.buffer_size - span)
              + torch.arange(span, device=state.ring.device)) % self.buffer_size
        s = state.ring.shape[0]
        grouped = state.ring.index_select(1, at).reshape(s, width, per_col, 2)
        return torch.stack([grouped.amin(dim=2), grouped.amax(dim=2)], dim=-1)

    @staticmethod
    def line_colors(scheme: ColorScheme) -> tuple[np.ndarray, np.ndarray]:
        """(left_rgb, right_rgb) u8 — palette extremes (oscilloscope.rs:177-178)."""
        left, _ = scheme.color_for(1.0, 0.0)
        right, _ = scheme.color_for(0.0, 1.0)
        return left, right

    def rasterize(
        self, envelopes, height: int, scheme: ColorScheme
    ) -> np.ndarray:
        """Host-side raster of one stream's envelope [width, 2, 2] ->
        [height, width, 3] u8 image — the live-view analog of the reference's
        two GL line strips (oscilloscope.rs:169-257): each pixel column fills
        [min, max] per channel in the palette-extreme line colors.

        Vectorized (one boolean mask per channel); right channel drawn last,
        matching the reference's draw order (:251-256)."""
        if isinstance(envelopes, torch.Tensor):
            envelopes = envelopes.detach().cpu().numpy()
        env = np.asarray(envelopes)
        width = env.shape[0]
        bg = np.asarray(scheme.background_color(), np.uint8)
        img = np.broadcast_to(bg, (height, width, 3)).copy()
        colors = self.line_colors(scheme)
        ys = np.arange(height)[:, None]  # [height, 1] vs per-column [1, width]
        for ch in range(2):
            lo = np.clip(
                (1.0 - env[:, ch, 1]) * 0.5 * (height - 1), 0, height - 1
            ).astype(int)
            hi = np.clip(
                (1.0 - env[:, ch, 0]) * 0.5 * (height - 1), 0, height - 1
            ).astype(int)
            img[(ys >= lo[None, :]) & (ys <= hi[None, :])] = colors[ch]
        return img
