"""The streaming spectrogram pipeline on PyTorch.

The counterpart of `spectrogram_tpu/models/spectrogram.py`
(`SpectrogramPipeline`, `StreamState`) for its k=1 streaming push: each push
takes one hop of stereo PCM per stream and returns one colormapped row per
stream.  A push is framing (carry + chunk -> one window per stream, and the
next carry), then two kernels:

  A. `stft_mag_packed`: stereo-packed STFT -> [S, N/2] magnitude planes
  B. `colormap_builtin`: two-tap log-frequency resample, dB and pan laws,
     per-stream built-in palette -> [S, H] int32 RGBA8888

On a CPU device both run as their plain PyTorch versions; on a CUDA device
both run as the hand-written kernels in `csrc/`.  There is no fallback from
one to the other.

What the JAX pipeline offers beyond this slice raises NotImplementedError
naming the ROADMAP.md item that brings it: chunk_hops > 1, store_ring, static
palettes, generic (non-built-in) scheme registries, i16_planes,
presorted_input and sorted_output.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from spectrogram_tpu_torch.config import SpectrogramConfig
from spectrogram_tpu_torch.ops import colormap as cmap_ops
from spectrogram_tpu_torch.ops import stft as stft_ops
from spectrogram_tpu_torch.ops.cuda import colormap_kernel, stft_kernel


class StreamState(NamedTuple):
    """Per-batch state.  Tensors lead with the stream axis except the
    scalars shared by the lockstep batch; the layout is the JAX package's."""

    carry: torch.Tensor       # [S, 2, window-hop] f32 planar sample history
    ring: torch.Tensor        # [S, 0, 2, B] bf16 — empty: store_ring=False
    cursor: torch.Tensor      # [] int32 — next ring row
    palette_id: torch.Tensor  # [S] int32 — per-stream palette index
    row_count: torch.Tensor   # [] int32 — rows produced since init
    # Pre-picked kernel tables, refreshed by init_state/set_palette and not
    # by a push: ([S, R*4],) per stream, or ([1, R*4],) for one palette.
    tables: tuple = ()


def _not_in_slice(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, modules to port: {item})"
    )


class SpectrogramPipeline:
    """Streaming STFT -> colormap pipeline over a batch of S streams.

    Args:
      cfg: geometry/presentation config.
      chunk_hops: rows per push; only 1 is ported.
      store_ring: keep a viewport ring; only False is ported.
      packed_output: emit [S, 1, H] int32 RGBA8888 (byte 0 = R) instead of
        [S, 1, H, 4] u8.
      precision_profile: "exact" or "fast".  Both compute the resample in
        true f32: "fast" relaxed only a TPU matrix-unit pass, and this port
        has no such pass.  Kept for API parity.
      lut_resolution: palette table size (default cfg.lut_resolution).
      schemes: palette registry (default the 19 built-ins); every scheme must
        fit the built-in mono/stereo structure.
      device: where state, constants and kernels live ("cpu" runs the plain
        versions, "cuda" the kernels).
    """

    def __init__(
        self,
        cfg: SpectrogramConfig,
        chunk_hops: int = 1,
        store_ring: bool = False,
        packed_output: bool = True,
        precision_profile: str = "exact",
        lut_resolution: Optional[int] = None,
        schemes=None,
        device=None,
        static_palette=None,
        i16_planes: bool = False,
        presorted_input: bool = False,
        sorted_output: bool = False,
    ):
        cfg.validate()
        if chunk_hops != 1:
            raise _not_in_slice("chunk_hops > 1", "6, pipeline completion")
        if store_ring:
            raise _not_in_slice("store_ring=True", "6, pipeline completion")
        if static_palette is not None:
            raise _not_in_slice("static_palette", "6, pipeline completion")
        if i16_planes:
            raise _not_in_slice("i16_planes", "6, pipeline completion")
        if presorted_input or sorted_output:
            raise _not_in_slice(
                "presorted_input / sorted_output", "6, pipeline completion"
            )
        if precision_profile not in ("exact", "fast"):
            raise ValueError(f"unknown precision_profile {precision_profile!r}")
        if cfg.pad_factor < 2:
            # the half-spectrum covers bins 1..W-1 only when W <= N/2
            raise ValueError(f"the packed STFT needs pad_factor >= 2, got {cfg}")
        from spectrogram_tpu_torch.color.colorscheme import DEFAULT_COLOR_SCHEMES

        self.cfg = cfg
        self.device = torch.device("cpu" if device is None else device)
        if self.device.type == "cuda":
            stft_kernel.check_fft_size(cfg.padded_size)
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {self.device}")
        self.chunk_hops = 1
        self.store_ring = False
        self.packed_output = bool(packed_output)
        self.precision_profile = precision_profile
        self.viewport_rows = cfg.viewport_rows
        self.schemes = tuple(schemes) if schemes is not None else DEFAULT_COLOR_SCHEMES
        res = lut_resolution or cfg.lut_resolution
        try:
            tables = colormap_kernel.builtin_color_tables(res, self.schemes)
        except ValueError as e:
            raise _not_in_slice(
                "a generic (non-built-in) scheme registry",
                "6, pipeline completion (generic palettes)",
            ) from e
        self.chunk_size = cfg.hop_size
        self.carry_size = stft_ops.carry_size(cfg)
        dev = self.device
        self.builtin_tables = torch.from_numpy(tables).to(dev)       # [P, R*4]
        self.hann = torch.from_numpy(
            stft_kernel.packed_hann(cfg.window_size)).to(dev)         # [W]
        self.twiddles = torch.from_numpy(
            stft_kernel.twiddle_table(cfg.padded_size)).to(dev)       # [N/2, 2]
        self.taps = colormap_kernel.resample_taps(
            cmap_ops.resample_matrix_full(cfg), dev)                  # [H] x 4

    # ------------------------------------------------------------------ state

    def init_state(self, n_streams: int, palette_id: int = 1) -> StreamState:
        """Fresh state for S streams.  Default palette 1 = Magma, the
        reference widget's default (gpu_spectrogram.rs:88)."""
        self._check_ids(np.asarray(palette_id))
        dev = self.device
        pid = torch.full((n_streams,), int(palette_id), dtype=torch.int32, device=dev)
        return StreamState(
            carry=torch.zeros((n_streams, 2, self.carry_size), dtype=torch.float32,
                              device=dev),
            ring=torch.zeros((n_streams, 0, 2, self.cfg.num_bins),
                             dtype=torch.bfloat16, device=dev),
            cursor=torch.zeros((), dtype=torch.int32, device=dev),
            palette_id=pid,
            row_count=torch.zeros((), dtype=torch.int32, device=dev),
            tables=(self._pick_tables(pid),),
        )

    def set_palette(self, state: StreamState, palette_id) -> StreamState:
        """Runtime palette switch, per stream ([S] ids) or for all streams
        (a scalar id): a state update that re-picks the kernel tables, so a
        push never touches the registry.  A scalar id stores one [1, R*4]
        table that every row reads."""
        if isinstance(palette_id, torch.Tensor):
            ids = palette_id.detach().cpu().numpy()
        else:
            ids = np.asarray(palette_id)
        self._check_ids(ids)
        s = state.palette_id.shape[0]
        pid = torch.from_numpy(
            np.broadcast_to(ids.astype(np.int32), (s,)).copy()).to(self.device)
        if ids.ndim == 0:
            picked = self._pick_tables(pid[:1])
        else:
            picked = self._pick_tables(pid)
        return state._replace(palette_id=pid, tables=(picked,))

    def _check_ids(self, ids: np.ndarray) -> None:
        if ids.size and (ids.min() < 0 or ids.max() >= len(self.schemes)):
            raise ValueError(
                f"palette_id out of range 0..{len(self.schemes) - 1}: {ids!r}"
            )

    def _pick_tables(self, pid: torch.Tensor) -> torch.Tensor:
        return self.builtin_tables.index_select(0, pid.to(torch.int64)).contiguous()

    # ------------------------------------------------------------------- push

    def push(self, state: StreamState, chunk: torch.Tensor):
        """Advance all streams by one hop.  chunk: [S, hop, 2] f32 PCM, or
        int16 PCM words scaled by 1/32768 on the device.  Returns
        (new_state, rows): [S, 1, H] int32 RGBA8888 when packed_output, else
        [S, 1, H, 4] u8."""
        if chunk.ndim != 3 or tuple(chunk.shape[1:]) != (self.chunk_size, 2):
            raise ValueError(
                f"chunk must be [S, {self.chunk_size}, 2]; got {tuple(chunk.shape)}"
            )
        return self._push_core(state, self._chunk_f32(chunk).transpose(1, 2))

    def push_planar(self, state: StreamState, chunk_planar: torch.Tensor):
        """As push, with the chunk channels-planar: [S, 2, hop]."""
        if chunk_planar.ndim != 3 or tuple(chunk_planar.shape[1:]) != (2, self.chunk_size):
            raise ValueError(
                f"planar chunk must be [S, 2, {self.chunk_size}]; got "
                f"{tuple(chunk_planar.shape)}"
            )
        return self._push_core(state, self._chunk_f32(chunk_planar))

    def _chunk_f32(self, chunk: torch.Tensor) -> torch.Tensor:
        """Wire-dtype edge: int16 PCM words scale by 1/32768 on the device
        (the JAX pipeline's `_chunk_f32`); floats cast to f32."""
        chunk = chunk.to(self.device)
        if chunk.dtype == torch.int16:
            return chunk.to(torch.float32) * (1.0 / 32768.0)
        return chunk.to(torch.float32)

    def frame_windows(self, state: StreamState, chunk_pl: torch.Tensor):
        """Split-channel framing of one push: (left, right, new_carry) with
        left/right the [S, W] f32 window planes of carry + chunk and
        new_carry the buffer's last C samples, built from the sources."""
        c, t, w = self.carry_size, self.chunk_size, self.cfg.window_size
        buf_l = torch.cat([state.carry[:, 0, :], chunk_pl[:, 0, :]], dim=1)
        buf_r = torch.cat([state.carry[:, 1, :], chunk_pl[:, 1, :]], dim=1)
        if t >= c:
            new_carry = chunk_pl[:, :, t - c:].contiguous()
        else:
            new_carry = torch.cat([state.carry[:, :, t:], chunk_pl], dim=2)
        return buf_l[:, :w].contiguous(), buf_r[:, :w].contiguous(), new_carry

    def _push_core(self, state: StreamState, chunk_pl: torch.Tensor):
        left, right, new_carry = self.frame_windows(state, chunk_pl)
        rows = self._rows(left, right, state.tables[0])
        s = chunk_pl.shape[0]
        new_state = StreamState(
            carry=new_carry,
            ring=state.ring,
            cursor=(state.cursor + 1) % self.viewport_rows,
            palette_id=state.palette_id,
            row_count=state.row_count + 1,
            tables=state.tables,
        )
        return new_state, self._output(rows.reshape(s, 1, -1))

    def _rows(self, left: torch.Tensor, right: torch.Tensor,
              tables: torch.Tensor) -> torch.Tensor:
        """[rows, W] window planes -> [rows, H] int32 RGBA8888, row n colored
        with tables[n % T]: kernel A, then kernel B."""
        mag_l, mag_r = stft_kernel.stft_mag_packed(left, right, self.hann,
                                                   self.twiddles)
        return colormap_kernel.colormap_builtin(mag_l, mag_r, self.taps, tables,
                                                self.cfg)

    def _output(self, packed: torch.Tensor) -> torch.Tensor:
        if self.packed_output:
            return packed
        return colormap_kernel.unpack_rgba_device(packed)

    # ------------------------------------------------------------ one-shot API

    def process(self, pcm: torch.Tensor, palette_id: int = 1) -> torch.Tensor:
        """Non-streaming form: [S, T, 2] (or [T, 2]) PCM -> rows for all
        complete windows, [S, rows, H] int32 (or [S, rows, H, 4] u8), every
        stream on one palette.  The same two kernels as push, so pushing the
        same samples in hops gives the same rows exactly."""
        self._check_ids(np.asarray(palette_id))
        squeeze = pcm.ndim == 2
        if squeeze:
            pcm = pcm[None]
        pcm = pcm.to(device=self.device, dtype=torch.float32)
        frames = stft_ops.frame_signal(pcm, self.cfg)      # [S, n, W, 2]
        s, n, w = frames.shape[:3]
        left = frames[..., 0].reshape(s * n, w).contiguous()
        right = frames[..., 1].reshape(s * n, w).contiguous()
        pid = torch.tensor([palette_id], dtype=torch.int32, device=self.device)
        rows = self._rows(left, right, self._pick_tables(pid))
        out = self._output(rows.reshape(s, n, -1))
        return out[0] if squeeze else out
