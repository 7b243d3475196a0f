"""The streaming spectrogram pipeline on PyTorch.

The counterpart of `spectrogram_tpu/models/spectrogram.py`
(`SpectrogramPipeline`, `StreamState`).  Each push takes `chunk_hops` = k
hops of stereo PCM per stream and returns k colormapped rows per stream; with
`store_ring` it also keeps each stream's last `viewport_rows` magnitude rows
in a bf16 ring, which `render_viewport` draws.  A push is framing (carry +
chunk -> per-channel sample buffers, and the next carry), then two kernels:

  A. the packed STFT -> [k*S, N/2] magnitude planes, window-major (row
     r*S + s is window r of stream s): `stft_mag_packed` over the one window
     per stream at k=1, `stft_mag_packed_allk` over the k windows of the
     buffers at k>1 (the windows are never materialized on the card)
  B. `colormap_builtin`: two-tap log-frequency resample, dB and pan laws,
     per-stream built-in palette -> [k*S, H] int32 RGBA8888

and, with the ring, a bf16 copy of bins 1..W-1 of the planes into it.
`render_viewport` runs kernel B again, over the ring's rows.

On a CPU device the kernels run as their plain PyTorch versions; on a CUDA
device as the hand-written kernels in `csrc/`.  There is no fallback from one
to the other.  Without a `device`, the pipeline runs on the card.

What the JAX pipeline offers beyond this port raises NotImplementedError
naming the ROADMAP.md item that brings it: static palettes, generic
(non-built-in) scheme registries, i16_planes, presorted_input,
sorted_output, and a ring dtype other than bfloat16.
"""

from __future__ import annotations

import copy
from typing import NamedTuple, Optional

import numpy as np
import torch

from spectrogram_tpu_torch.config import SpectrogramConfig
from spectrogram_tpu_torch.ops import colormap as cmap_ops
from spectrogram_tpu_torch.ops import stft as stft_ops
from spectrogram_tpu_torch.ops.cuda import colormap_kernel, stft_kernel

# Stream blocks of render_viewport hold at most this many bytes of f32 rows.
RENDER_BLOCK_BYTES = 1 << 29


class StreamState(NamedTuple):
    """Per-batch state.  Tensors lead with the stream axis except the
    scalars shared by the lockstep batch; the layout is the JAX package's."""

    carry: torch.Tensor       # [S, 2, window-hop] f32 planar sample history
    ring: torch.Tensor        # [S, R, 2, B] bf16 magnitude rows (R = 0: no ring)
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


def default_device(device=None) -> torch.device:
    """`device`, or the current CUDA card when it is None.  Without a card
    and without a device this raises: the port runs on the card unless the
    caller asks for the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is available, and the port runs on the card by "
            "default; pass device='cpu' to run the plain PyTorch versions"
        )
    return torch.device("cuda", torch.cuda.current_device())


class SpectrogramPipeline:
    """Streaming STFT -> colormap pipeline over a batch of S streams.

    Args:
      cfg: geometry/presentation config.
      chunk_hops: rows per push (k); a chunk is k * hop samples.
      viewport_rows: ring length (default cfg.viewport_rows), rounded up to
        a multiple of chunk_hops so that a push's rows never wrap.
      ring_dtype: ring storage; only torch.bfloat16 (the JAX default) is
        ported.
      lut_resolution: palette table size (default cfg.lut_resolution).
      store_ring: keep the row ring that render_viewport draws.
      packed_output: emit [S, k, H] int32 RGBA8888 (byte 0 = R) instead of
        [S, k, H, 4] u8.
      precision_profile: "exact" or "fast".  Both compute the resample in
        true f32: "fast" relaxed only a TPU matrix-unit pass, and this port
        has no such pass.  Kept for API parity.
      schemes: palette registry (default the 19 built-ins); every scheme must
        fit the built-in mono/stereo structure.
      device: where state, constants and kernels live: "cuda" (the default)
        runs the kernels, "cpu" their plain versions.
    """

    def __init__(
        self,
        cfg: SpectrogramConfig,
        chunk_hops: int = 1,
        viewport_rows: Optional[int] = None,
        ring_dtype=torch.bfloat16,
        lut_resolution: Optional[int] = None,
        store_ring: bool = True,
        packed_output: bool = True,
        precision_profile: str = "exact",
        schemes=None,
        device=None,
        static_palette=None,
        i16_planes: bool = False,
        presorted_input: bool = False,
        sorted_output: bool = False,
    ):
        cfg.validate()
        if ring_dtype != torch.bfloat16:
            raise _not_in_slice(f"ring_dtype={ring_dtype}", "6, pipeline completion")
        if static_palette is not None:
            raise _not_in_slice("static_palette", "6, pipeline completion")
        if i16_planes:
            raise _not_in_slice("i16_planes", "6, pipeline completion")
        if presorted_input or sorted_output:
            raise _not_in_slice(
                "presorted_input / sorted_output", "6, pipeline completion"
            )
        if int(chunk_hops) < 1:
            raise ValueError(f"chunk_hops must be >= 1; got {chunk_hops}")
        if precision_profile not in ("exact", "fast"):
            raise ValueError(f"unknown precision_profile {precision_profile!r}")
        if cfg.pad_factor < 2:
            # the half-spectrum covers bins 1..W-1 only when W <= N/2
            raise ValueError(f"the packed STFT needs pad_factor >= 2, got {cfg}")
        from spectrogram_tpu_torch.color.colorscheme import (
            DEFAULT_COLOR_SCHEMES,
            stacked_backgrounds,
        )

        self.cfg = cfg
        self.device = default_device(device)
        if self.device.type == "cuda":
            stft_kernel.check_fft_size(cfg.padded_size)
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {self.device}")
        k = self.chunk_hops = int(chunk_hops)
        rows = viewport_rows or cfg.viewport_rows
        self.viewport_rows = -(-rows // k) * k
        self.ring_dtype = ring_dtype
        self.store_ring = bool(store_ring)
        self.packed_output = bool(packed_output)
        self.precision_profile = precision_profile
        self.schemes = tuple(schemes) if schemes is not None else DEFAULT_COLOR_SCHEMES
        res = lut_resolution or cfg.lut_resolution
        try:
            tables = colormap_kernel.builtin_color_tables(res, self.schemes)
        except ValueError as e:
            raise _not_in_slice(
                "a generic (non-built-in) scheme registry",
                "6, pipeline completion (generic palettes)",
            ) from e
        self.chunk_size = k * cfg.hop_size
        self.carry_size = stft_ops.carry_size(cfg)
        dev = self.device
        self.builtin_tables = torch.from_numpy(tables).to(dev)       # [P, R*4]
        self.backgrounds = torch.from_numpy(
            stacked_backgrounds(self.schemes)).to(dev)                # [P, 3] u8
        self.hann = torch.from_numpy(
            stft_kernel.packed_hann(cfg.window_size)).to(dev)         # [W]
        self.twiddles = torch.from_numpy(
            stft_kernel.twiddle_table(cfg.padded_size)).to(dev)       # [N, 2]
        # the push reads [N/2] planes (bin k at k); the ring holds bins 1..W-1
        self.taps = colormap_kernel.resample_taps(
            cmap_ops.resample_matrix_full(cfg), dev)                  # [H] x 4
        self.ring_taps = colormap_kernel.resample_taps(
            cmap_ops.resample_matrix(cfg), dev)                       # [H] x 4
        self._time_taps = {}
        self._stft = stft_kernel.stft_mag_packed
        self._stft_allk = stft_kernel.stft_mag_packed_allk
        self._colormap = colormap_kernel.colormap_builtin

    def with_plain_kernels(self) -> "SpectrogramPipeline":
        """This pipeline with the plain PyTorch versions in place of its
        kernels, on the same device: what the kernels are held against on
        the card."""
        twin = copy.copy(self)
        twin._stft = lambda left, right, hann, tw: (
            stft_kernel.stft_mag_packed_plain(left, right, hann, tw.shape[0]))
        twin._stft_allk = lambda buf_l, buf_r, hann, tw, k, hop: (
            stft_kernel.stft_mag_packed_allk_plain(
                buf_l, buf_r, hann, tw.shape[0], k, hop))
        twin._colormap = colormap_kernel.colormap_builtin_plain
        return twin

    # ------------------------------------------------------------------ state

    def init_state(self, n_streams: int, palette_id: int = 1) -> StreamState:
        """Fresh state for S streams.  Default palette 1 = Magma, the
        reference widget's default (gpu_spectrogram.rs:88)."""
        self._check_ids(np.asarray(palette_id))
        dev = self.device
        pid = torch.full((n_streams,), int(palette_id), dtype=torch.int32, device=dev)
        ring_rows = self.viewport_rows if self.store_ring else 0
        return StreamState(
            carry=torch.zeros((n_streams, 2, self.carry_size), dtype=torch.float32,
                              device=dev),
            ring=torch.zeros((n_streams, ring_rows, 2, self.cfg.num_bins),
                             dtype=self.ring_dtype, device=dev),
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
        """Advance all streams by k hops.  chunk: [S, k*hop, 2] f32 PCM, or
        int16 PCM words scaled by 1/32768 on the device.  Returns
        (new_state, rows): [S, k, H] int32 RGBA8888 when packed_output, else
        [S, k, H, 4] u8.  With store_ring the push writes its rows into the
        ring in place: the ring tensor is shared by the old and new state."""
        if chunk.ndim != 3 or tuple(chunk.shape[1:]) != (self.chunk_size, 2):
            raise ValueError(
                f"chunk must be [S, {self.chunk_size}, 2]; got {tuple(chunk.shape)}"
            )
        return self._push_core(state, self._chunk_f32(chunk).transpose(1, 2))

    def push_planar(self, state: StreamState, chunk_planar: torch.Tensor):
        """As push, with the chunk channels-planar: [S, 2, k*hop]."""
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

    def frame_buffers(self, state: StreamState, chunk_pl: torch.Tensor):
        """Split-channel framing of one push: (buf_l, buf_r, new_carry) with
        buf_l/buf_r the [S, C + k*hop] f32 sample planes of carry + chunk
        and new_carry their last C samples, built from the sources."""
        c, t = self.carry_size, self.chunk_size
        buf_l = torch.cat([state.carry[:, 0, :], chunk_pl[:, 0, :]], dim=1)
        buf_r = torch.cat([state.carry[:, 1, :], chunk_pl[:, 1, :]], dim=1)
        if t >= c:
            new_carry = chunk_pl[:, :, t - c:].contiguous()
        else:
            new_carry = torch.cat([state.carry[:, :, t:], chunk_pl], dim=2)
        return buf_l, buf_r, new_carry

    def frame_windows(self, state: StreamState, chunk_pl: torch.Tensor):
        """k=1 framing: (left, right, new_carry) with left/right the [S, W]
        f32 window planes."""
        buf_l, buf_r, new_carry = self.frame_buffers(state, chunk_pl)
        w = self.cfg.window_size
        return buf_l[:, :w].contiguous(), buf_r[:, :w].contiguous(), new_carry

    def _push_core(self, state: StreamState, chunk_pl: torch.Tensor):
        s, k = chunk_pl.shape[0], self.chunk_hops
        if k == 1:
            left, right, new_carry = self.frame_windows(state, chunk_pl)
            mag_l, mag_r = self._stft(left, right, self.hann, self.twiddles)
        else:
            buf_l, buf_r, new_carry = self.frame_buffers(state, chunk_pl)
            mag_l, mag_r = self._stft_allk(buf_l, buf_r, self.hann, self.twiddles,
                                           k, self.cfg.hop_size)
        # window-major rows r*S + s take table (r*S + s) % S = s
        rows = self._colormap(mag_l, mag_r, self.taps, state.tables[0], self.cfg)
        if self.store_ring:
            self._write_ring(state, mag_l, mag_r)
        new_state = StreamState(
            carry=new_carry,
            ring=state.ring,
            cursor=(state.cursor + k) % self.viewport_rows,
            palette_id=state.palette_id,
            row_count=state.row_count + k,
            tables=state.tables,
        )
        return new_state, self._output(rows.view(k, s, -1).transpose(0, 1))

    def _write_ring(self, state: StreamState, mag_l: torch.Tensor,
                    mag_r: torch.Tensor) -> None:
        """Bins 1..W-1 of the [k*S, N/2] window-major planes, rounded to the
        ring dtype (to nearest even, as JAX's astype), into ring rows cursor
        .. cursor+k-1 of every stream, in place: the ring is the largest
        tensor of the state, and a copy per push would double it."""
        k, w = self.chunk_hops, self.cfg.window_size
        s, r = state.ring.shape[:2]
        if r != self.viewport_rows:
            raise ValueError(
                f"the state's ring has {r} rows; this pipeline keeps "
                f"{self.viewport_rows} (store_ring={self.store_ring})"
            )
        rows = torch.stack([mag_l[:, 1:w], mag_r[:, 1:w]], dim=1).to(self.ring_dtype)
        at = state.cursor.to(torch.int64) + torch.arange(k, device=self.device)
        state.ring.index_copy_(1, at, rows.view(k, s, 2, -1).transpose(0, 1))

    def _output(self, packed: torch.Tensor) -> torch.Tensor:
        if self.packed_output:
            return packed
        return colormap_kernel.unpack_rgba_device(packed)

    # ----------------------------------------------------------------- render

    def render_viewport(self, state: StreamState, width: Optional[int] = None):
        """Full scrolling viewport per stream, oldest row first: [S, R', H, 4]
        u8 RGBA, or [S, R', H] int32 RGBA8888 when packed_output, with R' =
        width or viewport_rows — the batch analog of the fragment shader's
        `(uv.x * rows + offset) / rows` time wrap (gpu_spectrogram.rs:166-171).

        `width` renders the viewport at any time-axis size, as the GL
        widget's Linear sampler does (gpu_spectrogram.rs:166-174, :285): a
        two-tap interpolation over the row axis, in magnitude space before
        the colormap, with clamped edges (DESIGN.md D2).  Reads the bf16
        ring, so output precision matches the texture path, not the f32
        streaming path.  Works through blocks of streams to bound memory;
        the output is the same."""
        if not self.store_ring:
            raise ValueError("this pipeline keeps no ring (store_ring=False)")
        ring, tables = state.ring, state.tables[0]
        s, r, _, b = ring.shape
        out_rows = r if width is None else int(width)
        j0, j1, w0, w1 = self._time_resample_taps(r, out_rows)
        cursor = state.cursor.to(torch.int64)
        i0, i1 = (cursor + j0) % r, (cursor + j1) % r
        block = max(1, RENDER_BLOCK_BYTES // (out_rows * 2 * b * 4))
        out = []
        for s0 in range(0, s, block):
            rows = ring[s0 : s0 + block]
            planes = []
            for c in range(2):
                x = rows[:, :, c].index_select(1, i0).to(torch.float32)
                if out_rows != r:
                    y = rows[:, :, c].index_select(1, i1).to(torch.float32)
                    x = w0 * x + w1 * y
                planes.append(x.reshape(-1, b))
            tab = tables if tables.shape[0] == 1 else tables[s0 : s0 + block]
            packed = self._colormap(planes[0], planes[1], self.ring_taps, tab,
                                    self.cfg, rows_per_table=out_rows)
            out.append(packed.view(-1, out_rows, packed.shape[1]))
        return self._output(torch.cat(out))

    def _time_resample_taps(self, rows: int, width: int):
        """(j0, j1, w0, w1): column j of the [rows, width] time-resample
        matrix reads w0[j] * row j0[j] + w1[j] * row j1[j] of the
        chronological ring; weights shaped [width, 1] to broadcast over
        bins."""
        if (rows, width) not in self._time_taps:
            m = cmap_ops.time_resample_matrix(rows, width)
            taps = colormap_kernel.resample_taps(m.T, self.device)
            self._time_taps[rows, width] = (taps.j0.long(), taps.j1.long(),
                                            taps.w0[:, None], taps.w1[:, None])
        return self._time_taps[rows, width]

    def composite(self, rgba_u8: torch.Tensor, palette_id) -> torch.Tensor:
        """Blend [S, ..., 4] u8 RGBA rows over each stream's palette
        background (frame clear + alpha blend, gpu_spectrogram.rs:278-293):
        [S, ..., 3] u8."""
        ids = torch.as_tensor(palette_id, device=self.device).to(torch.int64)
        bg = self.backgrounds.index_select(0, ids.reshape(-1))     # [S, 3] u8
        rgba = rgba_u8.to(torch.float32) / 255.0
        shape = (rgba.shape[0],) + (1,) * (rgba.ndim - 2) + (3,)
        return cmap_ops.composite_over_background(rgba, bg.reshape(shape))

    # ------------------------------------------------------------ one-shot API

    def process(self, pcm: torch.Tensor, palette_id: int = 1) -> torch.Tensor:
        """Non-streaming form: [S, T, 2] (or [T, 2]) PCM -> rows for all
        complete windows, [S, rows, H] int32 (or [S, rows, H, 4] u8), every
        stream on one palette.  Kernel A on the framed windows, then kernel
        B, so pushing the same samples in chunks gives the same rows
        exactly."""
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
        mag_l, mag_r = self._stft(left, right, self.hann, self.twiddles)
        rows = self._colormap(mag_l, mag_r, self.taps, self._pick_tables(pid),
                              self.cfg)
        out = self._output(rows.reshape(s, n, -1))
        return out[0] if squeeze else out
