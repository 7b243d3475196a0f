"""The fused push: split-real STFT -> built-in colormap in one kernel.

`push_fused` replaces `spectrogram_tpu/ops/pallas/push_kernel.py`
`push_fused_single` (body `_push_kernel`): [rows, W] window planes ->
[rows, H] int32 RGBA8888, and with `emit_mags` the two [rows, B] magnitude
planes too (B = `stft_kernel.stft_bins(N, W)`).  One thread block per row
runs the split-real row body of `stft_kernel.stft_mag_split` for both
channels into shared memory and colors the row from there with the per-pixel
body of `colormap_kernel.colormap_builtin` (kernel B), so its rows equal
that two-kernel chain's bit for bit (`csrc/push_fused.cu`).

`push_fused_single` is the JAX call's counterpart: it takes the transposed
full resample matrix [N/2, H] and reads its two taps per pixel
(`colormap_kernel.resample_taps`), and raises where the JAX function does.
The TPU kernel's band `segments` were a matrix-unit tiling; the taps take
their place here.

A CPU tensor takes the plain version (the plain split-real STFT, then
kernel B's plain version); a CUDA tensor takes the kernel, or where a row's
FFT buffer and its two planes do not fit a block's shared memory together
(`push_fused_fits`) the chain it stands for: the split-real kernel (the
large-N split route past `stft_kernel.is_large_split`), then kernel B.
"""

from __future__ import annotations

import numpy as np
import torch

from spectrogram_tpu_torch.config import SpectrogramConfig
from spectrogram_tpu_torch.ops.cuda import colormap_kernel as ck
from spectrogram_tpu_torch.ops.cuda import stft_kernel as sk

KERNEL = sk.PUSH_FUSED_KERNEL


def push_fused_fits(n_fft: int, window_size: int) -> bool:
    """True where a row's split-real FFT buffer and its two f32 planes fit
    one block's shared memory, as the fused kernel holds them."""
    return sk.push_smem_bytes(n_fft, window_size) <= sk.MAX_SMEM_BYTES


def push_fused_plain(left: torch.Tensor, right: torch.Tensor,
                     hann: torch.Tensor, n_fft: int, tables: torch.Tensor,
                     taps: ck.ResampleTaps, cfg: SpectrogramConfig,
                     emit_mags: bool = False):
    """The plain version: `stft_mag_split_plain`, then
    `colormap_builtin_plain` on its planes."""
    mag_l, mag_r = sk.stft_mag_split_plain(left, right, hann, n_fft)
    rows = ck.colormap_builtin_plain(mag_l, mag_r, taps, tables, cfg)
    return (rows, mag_l, mag_r) if emit_mags else rows


def push_fused(left: torch.Tensor, right: torch.Tensor, hann: torch.Tensor,
               consts: sk.FftConstants, tables: torch.Tensor,
               taps: ck.ResampleTaps, cfg: SpectrogramConfig,
               emit_mags: bool = False, launch=None):
    """[rows, H] int32 RGBA8888 of the [rows, W] f32 window planes, through
    the split-real STFT (hann `split_hann(W)`, N's `fft_constants`) and the
    built-in colormap, row n colored with tables[n % T] ([T, R*4] f32); with
    `emit_mags` (rows, mag_l, mag_r), the planes [rows, stft_bins(N, W)].

    CPU tensors take the plain version; CUDA tensors take spk_push_fused
    under the launch bounds `launch` names (one of
    `stft_kernel.launch_candidates("push", N, W)`; None the table's).  Where
    the block does not fit the chain runs at the table's bounds, and
    `launch` is ignored."""
    n_fft = consts.n_fft
    rows, w = left.shape
    if right.shape != left.shape or hann.shape != (w,) or w > n_fft:
        raise ValueError(
            f"window planes {tuple(left.shape)}/{tuple(right.shape)}, hann "
            f"{tuple(hann.shape)} and N={n_fft} do not fit"
        )
    planes = torch.empty((rows, sk.stft_bins(n_fft, w)), device="meta")
    ck._check(planes, planes, taps, tables, 1)
    if left.device.type == "cpu":
        return push_fused_plain(left, right, hann, n_fft, tables, taps, cfg, emit_mags)
    _, table = sk._cuda_kernel(KERNEL, (left, right), consts, hann=hann, tables=tables,
                               w0=taps.w0, w1=taps.w1)
    for name, t in (("j0", taps.j0), ("j1", taps.j1)):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != left.device:
            raise ValueError(f"{name} must be contiguous int32 on {left.device}")
    if not push_fused_fits(n_fft, w):
        # a row's FFT buffer and planes do not fit one block: the chain the
        # fused kernel stands for, the split-real STFT then kernel B
        planes = sk.stft_mag_split(left, right, hann, consts)
        out = ck.colormap_builtin(*planes, taps, tables, cfg)
        return (out, *planes) if emit_mags else out
    h = taps.j0.shape[0]
    res = tables.shape[1] // 4
    out = torch.empty((rows, h), dtype=torch.int32, device=left.device)
    mags = (sk._planes(rows, n_fft, w, left.device) if emit_mags else (None, None))
    if rows:
        sk._launch(KERNEL, left.device, n_fft, left.data_ptr(), right.data_ptr(),
                   hann.data_ptr(), table.data_ptr(), tables.data_ptr(),
                   tables.shape[0], res, taps.j0.data_ptr(), taps.j1.data_ptr(),
                   taps.w0.data_ptr(), taps.w1.data_ptr(), h, cfg.min_db,
                   cfg.max_db - cfg.min_db, cfg.db_epsilon, 1.0 / (res - 1),
                   out.data_ptr(), *(m.data_ptr() if m is not None else None for m in mags),
                   rows, w, n_fft, sk._choice(launch))
    return (out, *mags) if emit_mags else out


def push_fused_single(left: torch.Tensor, right: torch.Tensor,
                      color_tables: torch.Tensor, matrix_t,
                      cfg: SpectrogramConfig, emit_mags: bool = False):
    """The counterpart of the JAX package's `push_fused_single` at its call:
    [N, W] f32 window planes, per-row built-in tables [N, R*4] and the
    transposed full resample matrix [N_fft/2, H] (numpy or a tensor) ->
    [N, H] int32 RGBA8888, plus the two [N, N_fft/2] planes with
    `emit_mags`.  The window, FFT table and taps come from `cfg` and the
    matrix, on the planes' device.  Raises ValueError where the JAX
    function does: no even-n1 plan, pad_factor below 2, a matrix whose bins
    are not N_fft/2."""
    from spectrogram_tpu_torch.ops import fft_plan

    plan = fft_plan.make_plan(cfg)
    if plan is None or plan.n1 % 2:
        raise ValueError(f"no even-n1 factorization for {cfg}")
    if cfg.pad_factor < 2:
        raise ValueError(f"fused push requires pad_factor >= 2, got {cfg}")
    if left.shape[1] != cfg.window_size:
        raise ValueError(f"windows of {left.shape[1]} samples; cfg has {cfg.window_size}")
    matrix = (matrix_t.detach().cpu().numpy() if isinstance(matrix_t, torch.Tensor)
              else np.asarray(matrix_t))
    half = cfg.padded_size // 2
    if matrix.shape[0] != half:
        raise ValueError(f"resample matrix expects {matrix.shape[0]} bins, FFT emits {half}")
    dev = left.device
    hann = torch.from_numpy(sk.split_hann(cfg.window_size)).to(dev)
    taps = ck.resample_taps(matrix.T, dev)
    return push_fused(left, right, hann, sk.fft_constants(cfg.padded_size, dev),
                      color_tables, taps, cfg, emit_mags)
