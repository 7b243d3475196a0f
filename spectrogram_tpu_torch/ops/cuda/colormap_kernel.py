"""Kernel B: the per-row built-in colormap, and its plain version.

Replaces `spectrogram_tpu/ops/pallas/colormap_kernel.py`
`colormap_planes_banded` with the per-row body `_builtin_kernel` (via
`_builtin_word_tile`, `_resample_and_laws` and `_tent_lut_channels`), and
covers the uniform single-table read too (`tables` with one row).  Input:
the [rows, N/2] magnitude planes of kernel A with taps from
`resample_matrix_full`, or the viewport's [rows, B] ring planes (bins 1 ..
W-1) with taps from `resample_matrix`.  Output: [rows, H] int32 RGBA8888, R
in byte 0.

The TPU kernel needed a banded matmul for the two-tap resample, a tent basis
for the LUT read and SMEM tables, all to avoid gathers.  Here the resample is
a tap table (`resample_taps`) and each pixel reads its two bins and its two
LUT entries directly; the laws and their rounding are the JAX kernel's.

Host helpers (`builtin_color_tables`, `generic_color_tables`,
`unpack_rgba`) are copies of the JAX module's, pinned by the tests.
`colormap_builtin` takes a CPU tensor to `colormap_builtin_plain` and a CUDA
tensor to the kernel in `csrc/colormap_builtin.cu`, never one for the other.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from spectrogram_tpu_torch.config import SpectrogramConfig
from spectrogram_tpu_torch.ops import colormap as cmap_ops

KERNEL = "spk_colormap_builtin"


class ResampleTaps(NamedTuple):
    """Two-tap form of a [H, B] resample matrix: pixel p reads
    w0[p]*x[j0[p]] + w1[p]*x[j1[p]], with every tap below `bins` = B."""

    j0: torch.Tensor  # [H] int32
    j1: torch.Tensor  # [H] int32
    w0: torch.Tensor  # [H] f32
    w1: torch.Tensor  # [H] f32
    bins: int         # B: planes the taps index must be at least this wide


def resample_taps(matrix: np.ndarray, device=None) -> ResampleTaps:
    """The nonzeros of a two-tap [H, B] resample matrix (e.g.
    `resample_matrix_full(cfg)`), with the matrix's own f32 values: a pixel
    whose taps were clamped onto one bin keeps that bin's summed weight as
    w0, with w1 = 0 and j1 = j0."""
    h = matrix.shape[0]
    j0 = np.zeros(h, np.int32)
    j1 = np.zeros(h, np.int32)
    w0 = np.zeros(h, np.float32)
    w1 = np.zeros(h, np.float32)
    for p in range(h):
        nz = np.flatnonzero(matrix[p])
        if not 1 <= nz.size <= 2:
            raise ValueError(f"row {p} of the resample matrix has {nz.size} taps")
        j0[p], j1[p] = nz[0], nz[-1]
        w0[p] = matrix[p, nz[0]]
        w1[p] = matrix[p, nz[1]] if nz.size == 2 else 0.0

    def dev(a):
        return torch.from_numpy(a).to(device)

    return ResampleTaps(dev(j0), dev(j1), dev(w0), dev(w1), matrix.shape[1])


def _builtin_table_row(u: np.ndarray, v: np.ndarray, resolution: int):
    """If factored tables (U, V) match the built-in mono/stereo structure
    (mono: rgb = U(mag), alpha = 1; stereo: rgb = V(pan), alpha = mag ramp),
    return its [R*4] table row (rgb cols + stereo flag in col 3); else None."""
    ramp = (np.arange(resolution) / (resolution - 1)).astype(np.float32)
    mono = bool(np.all(v == 1.0) and np.all(u[:, 3] == 1.0))
    stereo = bool(
        np.all(u[:, :3] == 1.0)
        and np.all(v[:, 3] == 1.0)
        and np.array_equal(u[:, 3].astype(np.float32), ramp)
    )
    if not (mono or stereo):
        return None
    row = np.zeros(resolution * 4, np.float32)
    rgb = u[:, :3] if mono else v[:, :3]
    for t in range(resolution):
        row[t * 4 : t * 4 + 3] = rgb[t]
    row[3] = 0.0 if mono else 1.0
    return row


def builtin_color_tables(resolution: int = 32, schemes=None) -> np.ndarray:
    """[P, R*4] per-palette tables: cols t*4+c hold the rgb table (mono:
    mag-axis gradient, stereo: reversed pan-axis gradient, both /256 like
    the 2D LUT); col 3 is the stereo flag.  Raises ValueError if a scheme
    does not fit the built-in structure."""
    from spectrogram_tpu_torch.color.colorscheme import DEFAULT_COLOR_SCHEMES

    schemes = DEFAULT_COLOR_SCHEMES if schemes is None else schemes
    tables = np.zeros((len(schemes), resolution * 4), np.float32)
    for p, scheme in enumerate(schemes):
        u, v = scheme.factored_tables(resolution)
        row = _builtin_table_row(
            np.asarray(u, np.float32), np.asarray(v, np.float32), resolution
        )
        if row is None:
            raise ValueError(
                f"scheme {getattr(scheme, 'name', p)!r} does not fit the "
                f"built-in mono/stereo LUT structure; use the generic tables"
            )
        tables[p] = row
    return tables


def generic_color_tables(resolution: int = 32, schemes=None):
    """(U, V) each [P, R*4] flattened rank-1 factors (cols t*4+c)."""
    from spectrogram_tpu_torch.color.colorscheme import stacked_factored_tables

    u, v = stacked_factored_tables(resolution, schemes)
    p = u.shape[0]
    return (
        u.reshape(p, resolution * 4).astype(np.float32),
        v.reshape(p, resolution * 4).astype(np.float32),
    )


def unpack_rgba(packed) -> np.ndarray:
    """Host-side: [..., H] i32 RGBA8888 -> [..., H, 4] u8 (zero-copy view)."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    arr = np.asarray(packed)
    return arr.view(np.uint8).reshape(*arr.shape, 4)


def unpack_rgba_device(packed: torch.Tensor) -> torch.Tensor:
    """[..., H] i32 RGBA8888 -> [..., H, 4] u8 on the tensor's device."""
    return torch.stack(
        [((packed >> (8 * c)) & 0xFF).to(torch.uint8) for c in range(4)], dim=-1
    )


def _row_tables(tables: torch.Tensor, rows: int,
                rows_per_table: int = 1) -> torch.Tensor:
    """Row n's table is tables[(n // rows_per_table) % T]: [rows, R*4] (or
    [1, R*4] to broadcast)."""
    t = tables.shape[0]
    if t == 1 or (t == rows and rows_per_table == 1):
        return tables
    idx = (torch.arange(rows, device=tables.device) // rows_per_table) % t
    return tables.index_select(0, idx)


def _quantize(v: torch.Tensor) -> torch.Tensor:
    """clamp(round_half_even(255 v), 0, 255) as int64."""
    return torch.clamp(torch.round(v * 255.0), 0.0, 255.0).to(torch.int64)


def colormap_builtin_plain(mag_l: torch.Tensor, mag_r: torch.Tensor,
                           taps: ResampleTaps, tables: torch.Tensor,
                           cfg: SpectrogramConfig,
                           rows_per_table: int = 1) -> torch.Tensor:
    """The plain PyTorch version: the same laws, one rounding per op."""
    rows = mag_l.shape[0]
    res = tables.shape[1] // 4
    j0, j1 = taps.j0.long(), taps.j1.long()
    pl = taps.w0 * mag_l.index_select(1, j0) + taps.w1 * mag_l.index_select(1, j1)
    pr = taps.w0 * mag_r.index_select(1, j0) + taps.w1 * mag_r.index_select(1, j1)
    xu = cmap_ops.texel_coord(cmap_ops.db_normalize(pl, pr, cfg), res)
    xv = cmap_ops.texel_coord(cmap_ops.pan_fraction(pl, pr), res)
    tab = _row_tables(tables, rows, rows_per_table)         # [rows|1, R*4]
    stereo = tab[:, 3:4] != 0.0
    x = torch.where(stereo, xv, xu)
    f0 = torch.floor(x)
    t0 = f0.to(torch.int64)
    t1 = torch.clamp(t0 + 1, max=res - 1)
    wlo = torch.clamp(1.0 - torch.abs(x - f0), 0.0, 1.0)
    whi = torch.clamp(1.0 - torch.abs(x - (f0 + 1.0)), 0.0, 1.0)
    tab = tab.expand(rows, -1)
    word = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    for c in range(3):
        v = wlo * tab.gather(1, t0 * 4 + c) + whi * tab.gather(1, t1 * 4 + c)
        word |= _quantize(v) << (8 * c)
    alpha = torch.where(stereo, xu * np.float32(1.0 / (res - 1)), 1.0)
    word |= _quantize(alpha) << 24
    # two's complement into int32, as the kernel's packed word
    return torch.where(word >= 2**31, word - 2**32, word).to(torch.int32)


def colormap_builtin(mag_l: torch.Tensor, mag_r: torch.Tensor,
                     taps: ResampleTaps, tables: torch.Tensor,
                     cfg: SpectrogramConfig,
                     rows_per_table: int = 1) -> torch.Tensor:
    """[rows, B] f32 magnitude planes -> [rows, H] int32 RGBA8888, row n
    colored with tables[(n // rows_per_table) % T] ([T, R*4] f32, built-in
    layout): rows_per_table 1 for the push's window-major rows, R' for a
    viewport's R' rows per stream.

    CPU tensors take the plain version; CUDA tensors take the kernel."""
    rows, bins = mag_l.shape
    h = taps.j0.shape[0]
    # the kernel indexes planes by tap and tables by row % T unchecked
    if (mag_r.shape != mag_l.shape or taps.bins > bins
            or any(t.shape != (h,) for t in taps[:4])
            or tables.ndim != 2 or tables.shape[0] < 1
            or tables.shape[1] % 4 or tables.shape[1] < 8
            or rows_per_table < 1):
        raise ValueError(
            f"planes {tuple(mag_l.shape)}/{tuple(mag_r.shape)}, taps for "
            f"{taps.bins} bins, tables {tuple(tables.shape)} and "
            f"rows_per_table={rows_per_table} do not fit"
        )
    if mag_l.device.type == "cpu":
        return colormap_builtin_plain(mag_l, mag_r, taps, tables, cfg,
                                      rows_per_table)
    if mag_l.device.type != "cuda":
        raise ValueError(f"no colormap kernel for device {mag_l.device}")
    checks = (
        ("mag_l", mag_l, torch.float32), ("mag_r", mag_r, torch.float32),
        ("j0", taps.j0, torch.int32), ("j1", taps.j1, torch.int32),
        ("w0", taps.w0, torch.float32), ("w1", taps.w1, torch.float32),
        ("tables", tables, torch.float32),
    )
    for name, t, dtype in checks:
        if t.dtype != dtype or not t.is_contiguous() or t.device != mag_l.device:
            raise ValueError(
                f"{name} must be contiguous {dtype} on {mag_l.device}; got "
                f"{t.dtype} on {t.device}, contiguous={t.is_contiguous()}"
            )
    out = torch.empty((rows, h), dtype=torch.int32, device=mag_l.device)
    if rows and h:
        from spectrogram_tpu_torch.ops.cuda import _build

        res = tables.shape[1] // 4
        with torch.cuda.device(mag_l.device):
            stream = torch.cuda.current_stream().cuda_stream
            _build.library().launch(
                KERNEL, mag_l.data_ptr(), mag_r.data_ptr(), rows, bins,
                taps.j0.data_ptr(), taps.j1.data_ptr(), taps.w0.data_ptr(),
                taps.w1.data_ptr(), h, tables.data_ptr(), tables.shape[0],
                rows_per_table, res,
                cfg.min_db, cfg.max_db - cfg.min_db, cfg.db_epsilon,
                1.0 / (res - 1), out.data_ptr(), stream,
            )
    return out
