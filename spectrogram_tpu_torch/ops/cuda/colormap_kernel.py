"""The colormap kernels: kernel B (per-row built-in tables), the blockwise
colormap, the generic two-table colormap and the static colormap.

Kernel B replaces `spectrogram_tpu/ops/pallas/colormap_kernel.py`
`colormap_planes_banded` with the per-row body `_builtin_kernel` (via
`_builtin_word_tile`, `_resample_and_laws` and `_tent_lut_channels`), and
covers the uniform single-table read too (`tables` with one row).  Input:
the [rows, N/2] magnitude planes of kernel A with taps from
`resample_matrix_full`, or the viewport's [rows, B] ring planes (bins 1 ..
W-1) with taps from `resample_matrix`.  Output: [rows, H] int32 RGBA8888, R
in byte 0.

The blockwise colormap, `colormap_blockwise`, replaces the same entry's
`_blockwise_builtin_kernel` (with `_blockwise_operands`): it computes kernel
B's function and launches kernel B's code under its own entry point (the
TPU's per-block table flag cannot pay on the card: it reads what it would
save).  Its plain version is `colormap_builtin_plain` itself, since the
function is the same (`colormap_blockwise_plain` names it so).

The generic colormap, `colormap_generic`, replaces the bodies
`_generic_kernel` (per-row tables) and `_uniform_generic_kernel` (one table):
any rank-1 factored palette, LUT[i, j, c] = U[i, c] * V[j, c], read as two
4-channel two-tap lookups, U at the magnitude coordinate and V at the pan
coordinate.  The static colormap, `colormap_static`, replaces
`_static_builtin_kernel` and `_static_generic_kernel`: one palette for all
rows, held by the caller as a host (numpy) table and passed to the kernel by
value, at most `MAX_STATIC_RES` entries.

The TPU kernels needed a banded matmul for the two-tap resample, a tent
basis for the LUT read and SMEM or compile-time tables, all to avoid
gathers.  Here the resample is a tap table (`resample_taps`) and each pixel
reads its two bins and its LUT entries directly; the laws and their rounding
are the JAX kernels'.  Kernel B, the blockwise colormap and the generic
kernel share one tile (`csrc/colormap_tile.cuh`): whole rows per CTA, each
row's planes over [0, `ResampleTaps.span`) and its tables copied into
shared memory a row ahead of use ("staged"), or, where the span is wide
beside the row's pixels (the long windows), the first kernels' one pixel
per thread ("direct"); `tile_form` says which.  `colormap_rows_fused`
runs the generic kernel's tile on planar rows [N, 2, B] where its matrix
has two taps a pixel (every matrix the package builds): the left and right
planes of a row B floats apart, rows 2B apart.  The static colormap keeps
one pixel per thread with its palette in shared memory: staged on the tile
it ran slower at every span measured (PERF.md §6).

The tile's wrappers take `launch`, the form: None (or 0) the rule
`tile_form` reports, `TILE_STAGED` or `TILE_DIRECT` that form wherever it
runs (`tile_forms` lists them: the staged form wherever its stages fit
`TILE_MAX_STAGED_BYTES`, whatever the span; the direct form always).  Both
forms give the same bits; the autotuner (`utils/autotune.py`) measures
them.  The plain versions and the static colormap ignore it.

Host helpers (`builtin_color_tables`, `generic_color_tables`,
`unpack_rgba`, and `_auto_blocks`, `band_segments`, `_banded_worthwhile`,
which give the row block the palette-sort economics are counted in) are
copies of the JAX module's, pinned by the tests.  Every wrapper takes a CPU
tensor to its plain version and a CUDA tensor to its kernel
(`csrc/colormap_builtin.cu`, `csrc/colormap_blockwise.cu`,
`csrc/colormap_generic.cu`, `csrc/colormap_static.cu`), never one for the
other.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from spectrogram_tpu_torch.config import SpectrogramConfig
from spectrogram_tpu_torch.ops import colormap as cmap_ops

KERNEL = "spk_colormap_builtin"
BLOCKWISE_KERNEL = "spk_colormap_blockwise"
GENERIC_KERNEL = "spk_colormap_generic"
STATIC_KERNEL = "spk_colormap_static"
ROWS_KERNEL = "spk_colormap_rows"
# a static table is a kernel parameter: at most this many LUT entries
# (csrc/colormap_static.cu's kMaxRes)
MAX_STATIC_RES = 64
# the tile's forms (csrc/colormap_tile.cuh kTileFormRule .. kTileFormDirect)
TILE_RULE, TILE_STAGED, TILE_DIRECT = range(3)
TILE_FORMS = {TILE_STAGED: "staged", TILE_DIRECT: "direct"}
# the tile's stages and sizes (colormap_tile.cuh kTileStages,
# kTileMaxStagedBytes)
TILE_STAGES = 2
TILE_MAX_STAGED_BYTES = 48 * 1024


class ResampleTaps(NamedTuple):
    """Two-tap form of a [H, B] resample matrix: pixel p reads
    w0[p]*x[j0[p]] + w1[p]*x[j1[p]], with every tap below `span` <= `bins`
    = B."""

    j0: torch.Tensor  # [H] int32
    j1: torch.Tensor  # [H] int32
    w0: torch.Tensor  # [H] f32
    w1: torch.Tensor  # [H] f32
    bins: int         # B: planes the taps index must be at least this wide
    span: int         # the highest tap + 1: the bins kernel B stages per row


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

    return ResampleTaps(dev(j0), dev(j1), dev(w0), dev(w1), matrix.shape[1],
                        int(j1.max(initial=0)) + 1)


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


def _auto_blocks(b: int, block_rows, block_cols) -> tuple[int, int]:
    """The JAX colormap kernels' default (row, column) tile for a band of b
    bins: both shrink as b grows.  Explicit values override either."""
    if b <= 2560:
        auto = (128, 128)
    elif b <= 5120:
        auto = (64, 128)
    elif b <= 10240:
        auto = (32, 64)
    elif b <= 20480:
        auto = (16, 32)
    else:
        raise ValueError(
            f"{b} bins exceeds the supported colormap-kernel tiling; "
            "reduce the window size or use the XLA colormap backend"
        )
    return (block_rows or auto[0], block_cols or auto[1])


def band_segments(
    matrix_t: np.ndarray,   # [B, H] numpy resample matrix (transposed)
    tile_px: int = 128,
    lane: int = 128,
) -> tuple[tuple[int, int, int, int], ...]:
    """The JAX kernels' banding plan of a two-tap [B, H] resample matrix:
    ((px_lo, px_hi, bin_lo, bin_hi), ...), per `tile_px`-wide pixel tile the
    lane-aligned band of bins with any nonzero weight, adjacent tiles merged
    greedily whenever merging does not increase total band*pixels work."""
    b, h = matrix_t.shape
    nz_any = matrix_t != 0.0
    tiles = []
    for p0 in range(0, h, tile_px):
        p1 = min(p0 + tile_px, h)
        nz = np.nonzero(nz_any[:, p0:p1].any(axis=1))[0]
        if nz.size == 0:
            lo, hi = 0, min(lane, b)
        else:
            lo = int(nz.min()) // lane * lane
            hi = min(-(-int(nz.max() + 1) // lane) * lane, b)
        tiles.append((p0, p1, lo, hi))
    segs = [tiles[0]]
    for p0, p1, lo, hi in tiles[1:]:
        sp0, sp1, slo, shi = segs[-1]
        mlo, mhi = min(slo, lo), max(shi, hi)
        merged = (mhi - mlo) * (p1 - sp0)
        split = (shi - slo) * (sp1 - sp0) + (hi - lo) * (p1 - p0)
        if merged <= split:
            segs[-1] = (sp0, p1, mlo, mhi)
        else:
            segs.append((p0, p1, lo, hi))
    return tuple(segs)


def _banded_worthwhile(segments, b: int, h: int, threshold: float = 0.75) -> bool:
    """True when the banding plan's sum of band*pixels is below `threshold`
    of the dense B*H product."""
    banded = sum((hi - lo) * (p1 - p0) for p0, p1, lo, hi in segments)
    return banded < threshold * b * h


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


def _pack(channels) -> torch.Tensor:
    """Four [rows, H] f32 channels -> [rows, H] int32 RGBA8888 words."""
    word = _quantize(channels[0])
    for c in range(1, 4):
        word |= _quantize(channels[c]) << (8 * c)
    # two's complement into int32, as the kernel's packed word
    return torch.where(word >= 2**31, word - 2**32, word).to(torch.int32)


def _texels(mag_l: torch.Tensor, mag_r: torch.Tensor, taps: ResampleTaps,
            cfg: SpectrogramConfig, res: int):
    """(xu, xv): every pixel's magnitude and pan texel coordinates."""
    j0, j1 = taps.j0.long(), taps.j1.long()
    pl = taps.w0 * mag_l.index_select(1, j0) + taps.w1 * mag_l.index_select(1, j1)
    pr = taps.w0 * mag_r.index_select(1, j0) + taps.w1 * mag_r.index_select(1, j1)
    xu = cmap_ops.texel_coord(cmap_ops.db_normalize(pl, pr, cfg), res)
    xv = cmap_ops.texel_coord(cmap_ops.pan_fraction(pl, pr), res)
    return xu, xv


def _lut_read(tab: torch.Tensor, x: torch.Tensor, res: int, channels) -> list:
    """Clamped-linear reads of the [rows, R*4] tables at texel x ([rows, H]):
    wlo * tab[t0*4 + c] + whi * tab[t1*4 + c] for each channel c."""
    f0 = torch.floor(x)
    t0 = f0.to(torch.int64)
    t1 = torch.clamp(t0 + 1, max=res - 1)
    wlo = torch.clamp(1.0 - torch.abs(x - f0), 0.0, 1.0)
    whi = torch.clamp(1.0 - torch.abs(x - (f0 + 1.0)), 0.0, 1.0)
    return [wlo * tab.gather(1, t0 * 4 + c) + whi * tab.gather(1, t1 * 4 + c)
            for c in channels]


def colormap_builtin_plain(mag_l: torch.Tensor, mag_r: torch.Tensor,
                           taps: ResampleTaps, tables: torch.Tensor,
                           cfg: SpectrogramConfig,
                           rows_per_table: int = 1) -> torch.Tensor:
    """The plain PyTorch version: the same laws, one rounding per op."""
    rows = mag_l.shape[0]
    res = tables.shape[1] // 4
    xu, xv = _texels(mag_l, mag_r, taps, cfg, res)
    tab = _row_tables(tables, rows, rows_per_table)         # [rows|1, R*4]
    stereo = tab[:, 3:4] != 0.0
    rgb = _lut_read(tab.expand(rows, -1), torch.where(stereo, xv, xu), res, range(3))
    alpha = torch.where(stereo, xu * np.float32(1.0 / (res - 1)), 1.0)
    return _pack([*rgb, alpha])


def colormap_generic_plain(mag_l: torch.Tensor, mag_r: torch.Tensor,
                           taps: ResampleTaps, u: torch.Tensor, v: torch.Tensor,
                           cfg: SpectrogramConfig,
                           rows_per_table: int = 1) -> torch.Tensor:
    """The generic colormap's plain version: channel c of a pixel is
    q(U(xu)[c] * V(xv)[c]), the product rounded before the scale by 255."""
    rows = mag_l.shape[0]
    res = u.shape[1] // 4
    xu, xv = _texels(mag_l, mag_r, taps, cfg, res)
    cu = _lut_read(_row_tables(u, rows, rows_per_table).expand(rows, -1), xu, res, range(4))
    cv = _lut_read(_row_tables(v, rows, rows_per_table).expand(rows, -1), xv, res, range(4))
    return _pack([a * b for a, b in zip(cu, cv)])


# the blockwise kernel's plain version: the function is kernel B's
colormap_blockwise_plain = colormap_builtin_plain


def static_arrays(table) -> tuple:
    """A static table as the kernel takes it: (t,) for a built-in [R*4]
    table, (u, v) for a generic palette's two [R*4] factors, each a
    contiguous f32 numpy array.  Raises unless 2 <= R <= MAX_STATIC_RES."""
    arrays = table if isinstance(table, tuple) else (table,)
    arrays = tuple(np.ascontiguousarray(a, np.float32).reshape(-1) for a in arrays)
    n = arrays[0].size if arrays else 0
    if (len(arrays) not in (1, 2) or any(a.size != n for a in arrays)
            or n % 4 or not 2 <= n // 4 <= MAX_STATIC_RES):
        raise ValueError(
            f"a static table is one [R*4] table or a (u, v) pair of them with "
            f"2 <= R <= {MAX_STATIC_RES} (the kernel takes it as a parameter); "
            f"got sizes {[a.size for a in arrays]}"
        )
    return arrays


def colormap_static_plain(mag_l: torch.Tensor, mag_r: torch.Tensor,
                          taps: ResampleTaps, table,
                          cfg: SpectrogramConfig) -> torch.Tensor:
    """The static colormap's plain version: the one-table (uniform) plain
    version of kernel B, or of the generic colormap for a (u, v) table, with
    the table as a [1, R*4] tensor."""
    rows = [torch.from_numpy(a[None]).to(mag_l.device) for a in static_arrays(table)]
    if len(rows) == 2:
        return colormap_generic_plain(mag_l, mag_r, taps, *rows, cfg)
    return colormap_builtin_plain(mag_l, mag_r, taps, rows[0], cfg)


def _check(mag_l, mag_r, taps, tables, rows_per_table) -> None:
    """Raise unless the planes, taps and tables ([T, R*4], tensor or numpy)
    fit: the kernels index planes by tap and tables by row unchecked."""
    h = taps.j0.shape[0]
    if (mag_r.shape != mag_l.shape or taps.bins > mag_l.shape[1]
            or not 1 <= taps.span <= taps.bins
            or any(t.shape != (h,) for t in taps[:4])
            or tables.ndim != 2 or tables.shape[0] < 1
            or tables.shape[1] % 4 or tables.shape[1] < 8
            or rows_per_table < 1):
        raise ValueError(
            f"planes {tuple(mag_l.shape)}/{tuple(mag_r.shape)}, taps for "
            f"{taps.bins} bins, tables {tuple(tables.shape)} and "
            f"rows_per_table={rows_per_table} do not fit"
        )


def _launch(name: str, mag_l, mag_r, taps, cfg, res: int, tables: tuple,
            *table_args, span: int | None = None, form=None) -> torch.Tensor:
    """Launch colormap kernel `name` on CUDA tensors.  `tables` are the
    device tensors among its operands (checked as the planes are);
    `table_args` the arguments its C entry takes between `h` and
    `min_db`; `span`, where given, goes after the bins, and the tile's
    `form` (None: the rule) before the stream (kernel B, the blockwise
    colormap and the generic kernel)."""
    if mag_l.device.type != "cuda":
        raise ValueError(f"no colormap kernel for device {mag_l.device}")
    checks = (
        ("mag_l", mag_l, torch.float32), ("mag_r", mag_r, torch.float32),
        ("j0", taps.j0, torch.int32), ("j1", taps.j1, torch.int32),
        ("w0", taps.w0, torch.float32), ("w1", taps.w1, torch.float32),
        *(("tables", t, torch.float32) for t in tables),
    )
    for name_, t, dtype in checks:
        if t.dtype != dtype or not t.is_contiguous() or t.device != mag_l.device:
            raise ValueError(
                f"{name_} must be contiguous {dtype} on {mag_l.device}; got "
                f"{t.dtype} on {t.device}, contiguous={t.is_contiguous()}"
            )
    rows, bins = mag_l.shape
    h = taps.j0.shape[0]
    out = torch.empty((rows, h), dtype=torch.int32, device=mag_l.device)
    if rows and h:
        from spectrogram_tpu_torch.ops.cuda import _build

        with torch.cuda.device(mag_l.device):
            stream = torch.cuda.current_stream().cuda_stream
            _build.library().launch(
                name, mag_l.data_ptr(), mag_r.data_ptr(), rows, bins,
                *(() if span is None else (span,)), taps.j0.data_ptr(),
                taps.j1.data_ptr(), taps.w0.data_ptr(), taps.w1.data_ptr(), h,
                *table_args,
                cfg.min_db, cfg.max_db - cfg.min_db, cfg.db_epsilon,
                1.0 / (res - 1), out.data_ptr(),
                *(() if span is None else (int(form or TILE_RULE),)), stream,
            )
    return out


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t`, or a copy where its data is not 16-byte aligned: the tile's
    table copies move 16-byte chunks."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def tile_smem_bytes(span: int, res: int, generic: bool = False) -> int:
    """The staged tile's shared memory at `span` (colormap_tile.cuh
    `tile_smem_bytes`): per stage two plane rows of span + 3 floats in whole
    16-byte chunks and the row's table (U and V generic)."""
    plane = (span + 6) // 4 * 4
    return TILE_STAGES * (2 * plane + (2 if generic else 1) * res * 4) * 4


def tile_forms(span: int, h: int, res: int, generic: bool = False) -> tuple:
    """The forms the tile launches at `span`, width `h` and `res`-entry
    tables, in `TILE_FORMS` order: the staged form wherever its stages fit
    (colormap_tile.cuh `tile_launch_form`), the direct form always."""
    staged = tile_smem_bytes(span, res, generic) <= TILE_MAX_STAGED_BYTES
    return (TILE_STAGED, TILE_DIRECT) if staged else (TILE_DIRECT,)


def tile_rule(span: int, h: int, res: int, generic: bool = False) -> int:
    """The form `tile_staged`'s rule takes: staged where span <= 2.25h
    (3h generic) and the stages fit, else direct."""
    ratio = 12 if generic else 9
    staged = 4 * span <= ratio * h and TILE_STAGED in tile_forms(span, h, res, generic)
    return TILE_STAGED if staged else TILE_DIRECT


def tile_form(taps: ResampleTaps, res: int, generic: bool = False) -> str:
    """The form kernel B and the blockwise colormap (or the generic kernel)
    take on the card for `taps` and `res`-entry tables: "staged" (each row's
    planes over [0, taps.span) copied into shared memory) where the span is
    at most 2.25x the taps' pixels (3x generic) and two stages fit 48 KB,
    else "direct" (`csrc/colormap_tile.cuh` `tile_staged`, through its
    export `spk_colormap_form`, whose int operands and result are ctypes'
    defaults; builds the kernels)."""
    from spectrogram_tpu_torch.ops.cuda import _build

    staged = _build.library()._dll.spk_colormap_form(taps.span, taps.j0.shape[0], res,
                                                     int(generic))
    return "staged" if staged else "direct"


def rows_route() -> str:
    """The kernel that `colormap_rows_fused`'s last launch on the card took:
    "staged" or "direct", the generic row tile in that form (two taps a
    pixel), or "pixels", one pixel per thread over K taps (`csrc/
    colormap_rows.cu`, through its export `spk_colormap_rows_route`; builds
    the kernels)."""
    from spectrogram_tpu_torch.ops.cuda import _build

    route = _build.library()._dll.spk_colormap_rows_route()
    if route < 0:
        raise RuntimeError("colormap_rows_fused has not launched its kernel")
    return ("pixels", "staged", "direct")[route]


def colormap_builtin(mag_l: torch.Tensor, mag_r: torch.Tensor,
                     taps: ResampleTaps, tables: torch.Tensor,
                     cfg: SpectrogramConfig,
                     rows_per_table: int = 1, launch=None) -> torch.Tensor:
    """[rows, B] f32 magnitude planes -> [rows, H] int32 RGBA8888, row n
    colored with tables[(n // rows_per_table) % T] ([T, R*4] f32, built-in
    layout): rows_per_table 1 for the push's window-major rows, R' for a
    viewport's R' rows per stream.

    CPU tensors take the plain version; CUDA tensors take kernel B, in the
    form `launch` names (one of `tile_forms`; None: the form `tile_form`
    names)."""
    _check(mag_l, mag_r, taps, tables, rows_per_table)
    if mag_l.device.type == "cpu":
        return colormap_builtin_plain(mag_l, mag_r, taps, tables, cfg,
                                      rows_per_table)
    res = tables.shape[1] // 4
    tables = _aligned(tables)
    return _launch(KERNEL, mag_l, mag_r, taps, cfg, res, (tables,),
                   tables.data_ptr(), tables.shape[0], rows_per_table, res,
                   span=taps.span, form=launch)


def colormap_blockwise(mag_l: torch.Tensor, mag_r: torch.Tensor,
                       taps: ResampleTaps, tables: torch.Tensor,
                       cfg: SpectrogramConfig, rows_per_table: int = 1,
                       block_rows: int = 128, launch=None) -> torch.Tensor:
    """`colormap_builtin`'s function, with the rows taken in blocks of
    `block_rows`.  The output is kernel B's, bit for bit, whatever the
    blocks.

    CPU tensors take the plain version; CUDA tensors take the blockwise
    kernel's entry, which runs kernel B's code in the form `launch` names,
    as `colormap_builtin`."""
    _check(mag_l, mag_r, taps, tables, rows_per_table)
    if block_rows < 1:
        raise ValueError(f"block_rows must be at least 1; got {block_rows}")
    if mag_l.device.type == "cpu":
        return colormap_blockwise_plain(mag_l, mag_r, taps, tables, cfg,
                                        rows_per_table)
    res = tables.shape[1] // 4
    tables = _aligned(tables)
    return _launch(BLOCKWISE_KERNEL, mag_l, mag_r, taps, cfg, res, (tables,),
                   tables.data_ptr(), tables.shape[0], rows_per_table, res,
                   block_rows, span=taps.span, form=launch)


def colormap_generic(mag_l: torch.Tensor, mag_r: torch.Tensor,
                     taps: ResampleTaps, u: torch.Tensor, v: torch.Tensor,
                     cfg: SpectrogramConfig,
                     rows_per_table: int = 1, launch=None) -> torch.Tensor:
    """[rows, B] f32 magnitude planes -> [rows, H] int32 RGBA8888 through a
    generic palette: row n reads the factors u[(n // rows_per_table) % T]
    and v[...] ([T, R*4] f32 each, entries t*4+c), as `colormap_builtin`
    reads its tables.

    CPU tensors take the plain version; CUDA tensors take the generic
    kernel, in the form `launch` names, as `colormap_builtin`."""
    _check(mag_l, mag_r, taps, u, rows_per_table)
    if v.shape != u.shape:
        raise ValueError(f"u {tuple(u.shape)} and v {tuple(v.shape)} differ")
    if mag_l.device.type == "cpu":
        return colormap_generic_plain(mag_l, mag_r, taps, u, v, cfg, rows_per_table)
    res = u.shape[1] // 4
    u, v = _aligned(u), _aligned(v)
    return _launch(GENERIC_KERNEL, mag_l, mag_r, taps, cfg, res, (u, v),
                   u.data_ptr(), v.data_ptr(), u.shape[0], rows_per_table, res,
                   span=taps.span, form=launch)


def colormap_static(mag_l: torch.Tensor, mag_r: torch.Tensor,
                    taps: ResampleTaps, table,
                    cfg: SpectrogramConfig) -> torch.Tensor:
    """[rows, B] f32 magnitude planes -> [rows, H] int32 RGBA8888, every row
    colored with one palette held on the host: `table` a built-in [R*4]
    numpy table, or a (u, v) pair of a generic palette's [R*4] factors (see
    `static_arrays`).  The output is `colormap_builtin`'s (or
    `colormap_generic`'s) with that one table.

    CPU tensors take the plain version; CUDA tensors take the static
    kernel, which receives the table by value."""
    arrays = static_arrays(table)
    _check(mag_l, mag_r, taps, arrays[0][None], 1)
    if mag_l.device.type == "cpu":
        return colormap_static_plain(mag_l, mag_r, taps, arrays, cfg)
    res = arrays[0].size // 4
    v_host = arrays[1].ctypes.data if len(arrays) == 2 else None
    return _launch(STATIC_KERNEL, mag_l, mag_r, taps, cfg, res, (),
                   arrays[0].ctypes.data, v_host, res)


class ResampleTapsK(NamedTuple):
    """K-tap (ELL) form of a resample matrix: pixel p reads sum over t of
    w[p, t] * x[j[p, t]], taps in ascending bin order."""

    j: torch.Tensor   # [H, K] int32
    w: torch.Tensor   # [H, K] f32
    bins: int         # B: rows the taps index must have at least this many bins
    span: int         # the highest tap + 1
    # (j, w) tap-major [2, H], the row tile's operands, at K = 2; else None
    pairs: tuple | None


def resample_taps_k(matrix_t, device=None) -> ResampleTapsK:
    """The K-tap form of a dense transposed resample matrix [B, H] (numpy or
    a tensor), K = the most nonzeros of any pixel column: column p's
    nonzeros in ascending bin order with the matrix's own f32 values,
    padded with taps of weight 0 at the column's first nonzero bin (bin 0
    for an empty column).  Every matrix the package builds has K = 2, and
    then the taps are `resample_taps`' (a pixel clamped onto one bin reads
    it with w[p, 1] = 0 and j[p, 1] = j[p, 0]), also kept tap-major
    (`pairs`) for the kernel."""
    if isinstance(matrix_t, torch.Tensor):
        matrix_t = matrix_t.detach().cpu().numpy()
    m = np.asarray(matrix_t, np.float32).T                     # [H, B]
    h = m.shape[0]
    pixels, bins = np.nonzero(m)                               # by pixel, then bin
    counts = np.bincount(pixels, minlength=h)
    k = max(int(counts.max(initial=0)), 1)
    start = np.cumsum(counts) - counts
    first = np.zeros(h, np.int64)
    first[counts > 0] = bins[start[counts > 0]]
    j = np.repeat(first[:, None], k, axis=1).astype(np.int32)
    w = np.zeros((h, k), np.float32)
    slot = np.arange(pixels.size) - start[pixels]
    j[pixels, slot] = bins
    w[pixels, slot] = m[pixels, bins]
    pairs = (tuple(torch.from_numpy(np.ascontiguousarray(a.T)).to(device) for a in (j, w))
             if k == 2 else None)
    return ResampleTapsK(torch.from_numpy(j).to(device), torch.from_numpy(w).to(device),
                         m.shape[1], int(j.max(initial=0)) + 1, pairs)


def taps_dense(taps: ResampleTapsK) -> torch.Tensor:
    """The dense transposed matrix [B, H] of K-tap form `taps`."""
    h, k = taps.j.shape
    m = torch.zeros((taps.bins, h), dtype=torch.float32, device=taps.w.device)
    pixels = torch.arange(h, device=m.device).repeat_interleave(k)
    m.index_put_((taps.j.reshape(-1).long(), pixels), taps.w.reshape(-1), accumulate=True)
    return m


def pack_rgba(rgba_u8: torch.Tensor) -> torch.Tensor:
    """[..., 4] u8 RGBA -> [...] int32 RGBA8888 words, byte 0 = R (a view of
    the bytes on a little-endian host and card)."""
    return rgba_u8.contiguous().view(torch.int32)[..., 0]


def colormap_rows_fused_plain(rows: torch.Tensor, u_tables: torch.Tensor,
                              v_tables: torch.Tensor, matrix_t: torch.Tensor,
                              cfg: SpectrogramConfig,
                              packed: bool = False) -> torch.Tensor:
    """The plain version of `colormap_rows_fused`, the JAX package's own
    reference composition (tests/test_pallas_colormap.py): `resample_rows`
    of the interleaved rows by the [H, B] matrix, `db_normalize` and
    `pan_fraction`, `sample_lut_factored` with the per-row tables,
    `rgba_f32_to_u8`; [N, H, 4] u8, or [N, H] int32 words with `packed`.
    On the tensors' device, every matrix product in true f32."""
    with cmap_ops.true_f32():
        pixels = cmap_ops.resample_rows(rows.transpose(-2, -1), matrix_t.transpose(0, 1))
        mag = cmap_ops.db_normalize(pixels[..., 0], pixels[..., 1], cfg)
        pan = cmap_ops.pan_fraction(pixels[..., 0], pixels[..., 1])
        rgba = cmap_ops.sample_lut_factored(u_tables, v_tables, pan, mag)
    u8 = cmap_ops.rgba_f32_to_u8(rgba)
    return pack_rgba(u8) if packed else u8


def colormap_rows_fused(rows: torch.Tensor, u_tables: torch.Tensor,
                        v_tables: torch.Tensor, matrix_t, cfg: SpectrogramConfig,
                        block_rows=None, block_cols=None, precision=None,
                        interpret: bool = False, packed: bool = False,
                        launch=None) -> torch.Tensor:
    """The counterpart of the JAX package's `colormap_rows_fused`, with its
    signature: planar rows [N, 2, B] f32, per-row factor tables `u_tables`,
    `v_tables` [N, R, 4] f32 and the dense transposed resample matrix
    `matrix_t` [B, H] -> [N, H, 4] u8 RGBA, or [N, H] int32 RGBA8888 (byte
    0 = R) with `packed`.  `matrix_t` may also be its `resample_taps_k`,
    built once: the dense form is read on the host at every call.

    Raises ValueError where JAX raises: a matrix whose row count is not B,
    and more than 20,480 bins (`_auto_blocks`, whatever the blocks).
    `block_rows` and `block_cols` (positive, or None for JAX's tiers) were
    the TPU kernel's tiles; `precision` and `interpret` are accepted and
    change nothing: the port is always true f32 (JAX's HIGHEST), and a CUDA
    kernel has no interpret mode (as the pipeline's `kernel_interpret`).

    CPU tensors take the plain version; CUDA tensors take spk_colormap_rows
    (csrc/colormap_rows.cu): at K = 2 taps the generic kernel's row tile on
    the planar rows, whose words equal `colormap_generic`'s on copies of the
    planes bit for bit, in the form `launch` names (as `colormap_generic`;
    at K > 2 it must be None), else one pixel per thread over the K
    taps."""
    n, two, b = rows.shape
    taps = matrix_t if isinstance(matrix_t, ResampleTapsK) else None
    matrix_bins = taps.bins if taps is not None else matrix_t.shape[0]
    if matrix_bins != b:
        raise ValueError(f"rows have {b} bins but resample matrix expects {matrix_bins}")
    for name, blocks in (("block_rows", block_rows), ("block_cols", block_cols)):
        if blocks is not None and int(blocks) < 1:
            raise ValueError(f"{name} must be a positive tile size; got {blocks}")
    _auto_blocks(b, block_rows, block_cols)
    res = u_tables.shape[1] if u_tables.ndim == 3 else 0
    if (two != 2 or u_tables.shape != (n, res, 4) or v_tables.shape != u_tables.shape
            or res < 2):
        raise ValueError(
            f"rows {tuple(rows.shape)} and tables {tuple(u_tables.shape)}/"
            f"{tuple(v_tables.shape)} do not fit (expected [N, 2, B] and [N, R, 4])")
    if rows.device.type == "cpu":
        matrix = (taps_dense(taps) if taps is not None
                  else matrix_t if isinstance(matrix_t, torch.Tensor)
                  else torch.from_numpy(np.asarray(matrix_t, np.float32)))
        return colormap_rows_fused_plain(rows, u_tables, v_tables, matrix, cfg, packed)
    if rows.device.type != "cuda":
        raise ValueError(f"no colormap kernel for device {rows.device}")
    if taps is None:
        taps = resample_taps_k(matrix_t, rows.device)
    h, k = taps.j.shape
    checks = (("rows", rows, torch.float32), ("u_tables", u_tables, torch.float32),
              ("v_tables", v_tables, torch.float32), ("taps j", taps.j, torch.int32),
              ("taps w", taps.w, torch.float32))
    for name, t, dtype in checks:
        if t.dtype != dtype or not t.is_contiguous() or t.device != rows.device:
            raise ValueError(
                f"{name} must be contiguous {dtype} on {rows.device}; got "
                f"{t.dtype} on {t.device}, contiguous={t.is_contiguous()}")
    tap_j, tap_w = taps.j, taps.w
    if k == 2:
        # the row tile reads its taps tap-major and its tables by TMA
        tap_j, tap_w = taps.pairs
        u_tables, v_tables = _aligned(u_tables), _aligned(v_tables)
    out = torch.empty((n, h), dtype=torch.int32, device=rows.device)
    if n and h:
        from spectrogram_tpu_torch.ops.cuda import _build

        with torch.cuda.device(rows.device):
            _build.library().launch(
                ROWS_KERNEL, rows.data_ptr(), n, b, taps.span, tap_j.data_ptr(),
                tap_w.data_ptr(), h, k, u_tables.data_ptr(), v_tables.data_ptr(), res,
                cfg.min_db, cfg.max_db - cfg.min_db, cfg.db_epsilon, 1.0 / (res - 1),
                out.data_ptr(), int(launch or TILE_RULE),
                torch.cuda.current_stream().cuda_stream)
    return out if packed else out.view(torch.uint8).view(n, h, 4)
