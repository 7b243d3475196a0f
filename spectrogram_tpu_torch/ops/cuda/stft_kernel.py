"""Kernel A: the stereo-packed STFT magnitudes, and its plain version.

Replaces `spectrogram_tpu/ops/pallas/stft_kernel.py` `stft_mag_fused2` with
`packed=True, slice_bins=False` (bodies `_kernel_packed_2d` and
`_packed_mag_rows`).  Both channels ride one complex FFT, z = (l + i r)·hann,
and the conjugate-symmetric unpack splits them again:

    L[k] = |Z[k] + conj(Z[-k])|,  R[k] = |Z[k] - conj(Z[-k])|,  k = 0 .. N/2-1

with the reference's 2/W scale and the unpack's 1/2 folded into the window
(`packed_hann`).  The outputs are two [rows, N/2] f32 planes, DC included —
the layout `resample_matrix_full` indexes, so the colormap reads them as
they are.

`stft_mag_packed` takes a CPU tensor to `stft_mag_packed_plain` (torch.fft)
and a CUDA tensor to the hand-written kernel in `csrc/stft_packed.cu`, a
shared-memory radix-2 FFT that takes power-of-two N from 256 to 16384.  There
is no fallback between the two: a CUDA tensor the kernel cannot take raises.
"""

from __future__ import annotations

import numpy as np
import torch

from spectrogram_tpu_torch.ops.stft import hann_window_np

KERNEL = "spk_stft_packed"
MIN_FFT, MAX_FFT = 256, 16384  # one block's shared memory holds N complex f32


def packed_hann(window_size: int) -> np.ndarray:
    """[W] f32 periodic Hann times 2/W times 1/2 (the TPU kernel's
    `_packed_hann`; exact scalings for power-of-two windows)."""
    return hann_window_np(window_size) * (2.0 / window_size) * 0.5


def twiddle_table(n_fft: int) -> np.ndarray:
    """[N/2, 2] f32 (re, im) of exp(-2 pi i k / N), computed in float64 and
    rounded once to f32."""
    k = np.arange(n_fft // 2, dtype=np.float64)
    tw = np.exp(-2j * np.pi * k / n_fft)
    return np.stack([tw.real, tw.imag], axis=-1).astype(np.float32)


def check_fft_size(n_fft: int) -> None:
    """Raise for an N the CUDA kernel does not take."""
    if n_fft & (n_fft - 1) or not MIN_FFT <= n_fft <= MAX_FFT:
        raise NotImplementedError(
            f"the CUDA STFT kernel takes power-of-two FFT sizes "
            f"{MIN_FFT}..{MAX_FFT}; got {n_fft}.  Mixed-radix sizes such as "
            "DEFAULT_CONFIG's 4800 are the first item of ROADMAP.md's "
            "kernel queue"
        )


def stft_mag_packed_plain(left: torch.Tensor, right: torch.Tensor,
                          hann: torch.Tensor, n_fft: int):
    """The plain PyTorch version: torch.fft on complex64, same unpack."""
    z = torch.complex(left * hann, right * hann)
    x = torch.fft.fft(z, n=n_fft)
    half = n_fft // 2
    k = torch.arange(half, device=left.device)
    a = x[:, :half]
    b = x[:, (n_fft - k) % n_fft]          # Z[-k]; the k=0 partner is Z[0]
    return torch.abs(a + torch.conj(b)), torch.abs(a - torch.conj(b))


def stft_mag_packed(left: torch.Tensor, right: torch.Tensor,
                    hann: torch.Tensor, twiddles: torch.Tensor):
    """(mag_l, mag_r) [rows, N/2] f32 of the [rows, W] f32 window planes,
    with N = 2 * twiddles.shape[0] (`twiddle_table(N)` on the same device).

    CPU tensors take the plain version; CUDA tensors take the kernel."""
    n_fft = 2 * twiddles.shape[0]
    rows, w = left.shape
    if (right.shape != left.shape or hann.shape != (w,) or w > n_fft
            or twiddles.shape != (n_fft // 2, 2)):
        raise ValueError(
            f"window planes {tuple(left.shape)}/{tuple(right.shape)}, hann "
            f"{tuple(hann.shape)} and N={n_fft} do not fit"
        )
    if left.device.type == "cpu":
        return stft_mag_packed_plain(left, right, hann, n_fft)
    if left.device.type != "cuda":
        raise ValueError(f"no STFT kernel for device {left.device}")
    check_fft_size(n_fft)
    for name, t in (("left", left), ("right", right), ("hann", hann),
                    ("twiddles", twiddles)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != left.device:
            raise ValueError(
                f"{name} must be contiguous f32 on {left.device}; got "
                f"{t.dtype} on {t.device}, contiguous={t.is_contiguous()}"
            )
    out_l = torch.empty((rows, n_fft // 2), dtype=torch.float32, device=left.device)
    out_r = torch.empty_like(out_l)
    if rows:
        from spectrogram_tpu_torch.ops.cuda import _build

        with torch.cuda.device(left.device):
            stream = torch.cuda.current_stream().cuda_stream
            _build.library().launch(
                KERNEL, left.data_ptr(), right.data_ptr(), hann.data_ptr(),
                twiddles.data_ptr(), out_l.data_ptr(), out_r.data_ptr(),
                rows, w, n_fft.bit_length() - 1, stream,
            )
    return out_l, out_r
