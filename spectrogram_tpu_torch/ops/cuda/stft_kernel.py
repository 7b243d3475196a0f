"""The stereo-packed STFT kernels, and their plain versions.

Kernel A, `stft_mag_packed`, replaces `spectrogram_tpu/ops/pallas/
stft_kernel.py` `stft_mag_fused2` with `packed=True, slice_bins=False`
(bodies `_kernel_packed_2d` and `_packed_mag_rows`).  Both channels ride one
complex FFT, z = (l + i r)·hann, and the conjugate-symmetric unpack splits
them again:

    L[k] = |Z[k] + conj(Z[-k])|,  R[k] = |Z[k] - conj(Z[-k])|,  k = 0 .. N/2-1

with the reference's 2/W scale and the unpack's 1/2 folded into the window
(`packed_hann`).  The outputs are two [rows, N/2] f32 planes, DC included —
the layout `resample_matrix_full` indexes, so the colormap reads them as
they are.  On a CUDA tensor, power-of-two N runs `csrc/stft_packed.cu` and
other N = 2^a 3^b 5^c run `csrc/stft_mixed.cu`.

The all-windows kernel, `stft_mag_packed_allk`, replaces
`stft_mag_fused2_allk(packed=True)` (and computes what `stft_mag_fused2_buf`
computes): it reads the k hop-shifted windows of each stream straight out of
the carry+chunk sample planes and writes their magnitudes in window-major
order, row r*S + s (`csrc/stft_allk.cu`, both FFT bodies).

Each wrapper takes a CPU tensor to its plain version (torch.fft) and a CUDA
tensor to its kernel.  There is no fallback between the two: a CUDA tensor
a kernel cannot take raises.
"""

from __future__ import annotations

import numpy as np
import torch

from spectrogram_tpu_torch.ops.stft import hann_window_np

KERNEL = "spk_stft_packed"
MIXED_KERNEL = "spk_stft_mixed"
ALLK_KERNEL = "spk_stft_allk"
MIN_FFT, MAX_FFT = 256, 16384  # one block's shared memory holds N complex f32


def packed_hann(window_size: int) -> np.ndarray:
    """[W] f32 periodic Hann times 2/W times 1/2 (the TPU kernel's
    `_packed_hann`; exact scalings for power-of-two windows)."""
    return hann_window_np(window_size) * (2.0 / window_size) * 0.5


def twiddle_table(n_fft: int) -> np.ndarray:
    """[N, 2] f32 (re, im) of exp(-2 pi i t / N), t = 0 .. N-1, computed in
    float64 and rounded once to f32."""
    t = np.arange(n_fft, dtype=np.float64)
    tw = np.exp(-2j * np.pi * t / n_fft)
    return np.stack([tw.real, tw.imag], axis=-1).astype(np.float32)


def _is_power_of_two(n: int) -> bool:
    return n & (n - 1) == 0


def check_fft_size(n_fft: int) -> None:
    """Raise for an N the CUDA kernels do not take: N must be even,
    2^a 3^b 5^c, and within MIN_FFT..MAX_FFT."""
    rest = n_fft
    for p in (2, 3, 5):
        while rest > 1 and rest % p == 0:
            rest //= p
    if rest != 1 or n_fft % 2 or not MIN_FFT <= n_fft <= MAX_FFT:
        raise NotImplementedError(
            f"the CUDA STFT kernels take even FFT sizes 2^a 3^b 5^c from "
            f"{MIN_FFT} to {MAX_FFT}; got {n_fft}.  Other sizes need a "
            "Bluestein pass (ROADMAP.md, kernel queue)"
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


def stft_mag_packed_allk_plain(buf_l: torch.Tensor, buf_r: torch.Tensor,
                               hann: torch.Tensor, n_fft: int, k: int,
                               hop: int):
    """The plain version of the all-windows kernel: slice the k windows out
    of the buffers, window-major, and run `stft_mag_packed_plain`."""
    w = hann.shape[0]
    left = torch.cat([buf_l[:, r * hop : r * hop + w] for r in range(k)])
    right = torch.cat([buf_r[:, r * hop : r * hop + w] for r in range(k)])
    return stft_mag_packed_plain(left, right, hann, n_fft)


def _check_cuda(first: torch.Tensor, **tensors) -> None:
    """Raise unless every tensor is contiguous f32 on first's CUDA device."""
    if first.device.type != "cuda":
        raise ValueError(f"no STFT kernel for device {first.device}")
    for name, t in tensors.items():
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != first.device:
            raise ValueError(
                f"{name} must be contiguous f32 on {first.device}; got "
                f"{t.dtype} on {t.device}, contiguous={t.is_contiguous()}"
            )


def _launch(name: str, device: torch.device, *args) -> None:
    from spectrogram_tpu_torch.ops.cuda import _build

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.library().launch(name, *args, stream)


def stft_mag_packed(left: torch.Tensor, right: torch.Tensor,
                    hann: torch.Tensor, twiddles: torch.Tensor):
    """(mag_l, mag_r) [rows, N/2] f32 of the [rows, W] f32 window planes,
    with N = twiddles.shape[0] (`twiddle_table(N)` on the same device).

    CPU tensors take the plain version; CUDA tensors take kernel A."""
    n_fft = twiddles.shape[0]
    rows, w = left.shape
    if (right.shape != left.shape or hann.shape != (w,) or w > n_fft
            or twiddles.shape != (n_fft, 2)):
        raise ValueError(
            f"window planes {tuple(left.shape)}/{tuple(right.shape)}, hann "
            f"{tuple(hann.shape)} and N={n_fft} do not fit"
        )
    if left.device.type == "cpu":
        return stft_mag_packed_plain(left, right, hann, n_fft)
    _check_cuda(left, left=left, right=right, hann=hann, twiddles=twiddles)
    check_fft_size(n_fft)
    out_l = torch.empty((rows, n_fft // 2), dtype=torch.float32, device=left.device)
    out_r = torch.empty_like(out_l)
    if rows:
        if _is_power_of_two(n_fft):
            name, size = KERNEL, n_fft.bit_length() - 1
        else:
            name, size = MIXED_KERNEL, n_fft
        _launch(name, left.device, left.data_ptr(), right.data_ptr(),
                hann.data_ptr(), twiddles.data_ptr(), out_l.data_ptr(),
                out_r.data_ptr(), rows, w, size)
    return out_l, out_r


def stft_mag_packed_allk(buf_l: torch.Tensor, buf_r: torch.Tensor,
                         hann: torch.Tensor, twiddles: torch.Tensor,
                         k: int, hop: int):
    """(mag_l, mag_r) [k*S, N/2] f32 of the k windows buf[s, r*hop : r*hop+W]
    of the [S, L] f32 sample buffers (L >= W + (k-1)*hop), with row r*S + s
    holding window r of stream s, W = hann.shape[0] and N = twiddles.shape[0].

    CPU tensors take the plain version; CUDA tensors take the all-windows
    kernel, which never materializes the windows."""
    n_fft = twiddles.shape[0]
    s, length = buf_l.shape
    w = hann.shape[0]
    if (buf_r.shape != buf_l.shape or hann.ndim != 1 or w > n_fft or k < 1
            or hop < 1 or length < w + (k - 1) * hop
            or twiddles.shape != (n_fft, 2)):
        raise ValueError(
            f"buffers {tuple(buf_l.shape)}/{tuple(buf_r.shape)}, hann "
            f"{tuple(hann.shape)}, k={k}, hop={hop} and N={n_fft} do not fit"
        )
    if buf_l.device.type == "cpu":
        return stft_mag_packed_allk_plain(buf_l, buf_r, hann, n_fft, k, hop)
    _check_cuda(buf_l, buf_l=buf_l, buf_r=buf_r, hann=hann, twiddles=twiddles)
    check_fft_size(n_fft)
    out_l = torch.empty((k * s, n_fft // 2), dtype=torch.float32,
                        device=buf_l.device)
    out_r = torch.empty_like(out_l)
    if s:
        _launch(ALLK_KERNEL, buf_l.device, buf_l.data_ptr(), buf_r.data_ptr(),
                hann.data_ptr(), twiddles.data_ptr(), out_l.data_ptr(),
                out_r.data_ptr(), s, length, k, hop, w, n_fft)
    return out_l, out_r
