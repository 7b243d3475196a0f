"""The STFT kernels, stereo-packed and split-real, and their plain versions.

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

Both take f32 sample planes, or the int16 PCM words of the i16_planes wire
mode (the TPU kernels' int16 operand form): an int16 plane reads half the
bytes, converts exactly to f32 in the kernel, and takes its 1/32768 wire
scale from the window, `packed_hann_i16` = `packed_hann` * 2^-15, an exact
exponent shift.  So an int16 row is bitwise the f32 row of x / 32768, in the
kernels and in the plain versions alike.

The split-real kernels (`csrc/stft_split.cu`) run each channel as its own
FFT of real input, |DFT_N(x * hann)| with `split_hann` (the reference's 2/W,
the TPU kernels' `_scaled_hann`), bins 0 .. N/2-1, f32 only, in the four
operand layouts of the TPU's split-real kernels:

  * `stft_mag_split`: [rows, W] window planes; replaces `stft_mag_fused2`
    with `packed=False` (bodies `_kernel2_2d`, `_kernel2`, `_fft_mag_value`)
  * `stft_mag_split_allk`: the k windows of [S, L] carry+chunk buffers,
    window-major; replaces `stft_mag_fused2_allk(packed=False)` (body
    `_allk_kernel`)
  * `stft_mag_split_t`: the combined transposed operand [rows, 2, n1, m],
    x[n, c, j1, t] = sample t*n1 + j1 of channel c; replaces
    `stft_mag_fused2_t` (body `_kernel2_t`)
  * `stft_mag_split_tsplit`: the transposed carry [rows, 2, n1, c_cols] and
    hop chunk [rows, 2, n1, t_cols] as two operands, returning the next
    carry too; replaces `stft_mag_fused2_tsplit` (body `_tsplit_kernel`)

All four run one row body (`stft_real_row` in `csrc/stft_fft.cuh`) with a
sample source per layout, so on the card they give the same bits for the
same window.

Each wrapper takes a CPU tensor to its plain version (torch.fft) and a CUDA
tensor to its kernel: an f32 plane to the f32 kernel, an int16 plane to the
packed kernels' int16 form (the split-real kernels take f32 only).  There is
no fallback between the two, and no cast: a CUDA tensor a kernel cannot take
raises.
"""

from __future__ import annotations

import numpy as np
import torch

from spectrogram_tpu_torch.ops.stft import hann_window_np

KERNEL = "spk_stft_packed"
MIXED_KERNEL = "spk_stft_mixed"
ALLK_KERNEL = "spk_stft_allk"
SPLIT_KERNEL = "spk_stft_split"
SPLIT_ALLK_KERNEL = "spk_stft_split_allk"
SPLIT_T_KERNEL = "spk_stft_split_t"
SPLIT_TSPLIT_KERNEL = "spk_stft_split_tsplit"
KERNEL_I16 = "spk_stft_packed_i16"
MIXED_KERNEL_I16 = "spk_stft_mixed_i16"
ALLK_KERNEL_I16 = "spk_stft_allk_i16"
# each f32 kernel's int16 form
_I16_KERNELS = {KERNEL: KERNEL_I16, MIXED_KERNEL: MIXED_KERNEL_I16,
                ALLK_KERNEL: ALLK_KERNEL_I16}
WIRE_SCALE = 2.0 ** -15   # an int16 PCM word x stands for x * WIRE_SCALE
MIN_FFT, MAX_FFT = 256, 16384  # one block's shared memory holds N complex f32


def packed_hann(window_size: int) -> np.ndarray:
    """[W] f32 periodic Hann times 2/W times 1/2 (the TPU kernel's
    `_packed_hann`; exact scalings for power-of-two windows)."""
    return hann_window_np(window_size) * (2.0 / window_size) * 0.5


def split_hann(window_size: int) -> np.ndarray:
    """[W] f32 periodic Hann times 2/W, rounded as the TPU kernels'
    `_scaled_hann`: the window of the split-real kernels, twice
    `packed_hann` (which also folds in the stereo unpack's 1/2)."""
    return hann_window_np(window_size) * (2.0 / window_size)


def packed_hann_i16(window_size: int) -> np.ndarray:
    """`packed_hann` with the int16 wire scale 2^-15 folded in: the window
    of int16 sample planes."""
    return packed_hann(window_size) * np.float32(WIRE_SCALE)


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
    """The plain PyTorch version: torch.fft on complex64, same unpack.
    int16 planes convert exactly to f32 first (`hann` then carries 2^-15)."""
    z = torch.complex(left.to(torch.float32) * hann, right.to(torch.float32) * hann)
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


def _cuda_kernel(name: str, samples: tuple, **consts) -> str:
    """Kernel `name` for f32 sample planes, its int16 form for int16
    planes; raise unless the planes are contiguous f32 or int16 of one type
    on one CUDA device and the constants contiguous f32 there."""
    first = samples[0]
    if first.device.type != "cuda":
        raise ValueError(f"no STFT kernel for device {first.device}")
    if first.dtype not in (torch.float32, torch.int16):
        raise ValueError(
            f"sample planes must be float32 or int16 (the i16_planes wire "
            f"mode); got {first.dtype}")
    if first.dtype == torch.int16 and name not in _I16_KERNELS:
        raise ValueError(f"{name} takes float32 samples only; got int16")
    named = [("samples", t, first.dtype) for t in samples]
    named += [(arg, t, torch.float32) for arg, t in consts.items()]
    for arg, t, dtype in named:
        if t.dtype != dtype or not t.is_contiguous() or t.device != first.device:
            raise ValueError(
                f"{arg} must be contiguous {dtype} on {first.device}; got "
                f"{t.dtype} on {t.device}, contiguous={t.is_contiguous()}"
            )
    return name if first.dtype == torch.float32 else _I16_KERNELS[name]


def _launch(name: str, device: torch.device, *args) -> None:
    from spectrogram_tpu_torch.ops.cuda import _build

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.library().launch(name, *args, stream)


def stft_mag_packed(left: torch.Tensor, right: torch.Tensor,
                    hann: torch.Tensor, twiddles: torch.Tensor):
    """(mag_l, mag_r) [rows, N/2] f32 of the [rows, W] f32 or int16 window
    planes, with N = twiddles.shape[0] (`twiddle_table(N)` on the same
    device) and hann `packed_hann(W)`, or `packed_hann_i16(W)` for int16.

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
    if _is_power_of_two(n_fft):
        name, size = KERNEL, n_fft.bit_length() - 1
    else:
        name, size = MIXED_KERNEL, n_fft
    name = _cuda_kernel(name, (left, right), hann=hann, twiddles=twiddles)
    check_fft_size(n_fft)
    out_l = torch.empty((rows, n_fft // 2), dtype=torch.float32, device=left.device)
    out_r = torch.empty_like(out_l)
    if rows:
        _launch(name, left.device, left.data_ptr(), right.data_ptr(),
                hann.data_ptr(), twiddles.data_ptr(), out_l.data_ptr(),
                out_r.data_ptr(), rows, w, size)
    return out_l, out_r


def stft_mag_packed_allk(buf_l: torch.Tensor, buf_r: torch.Tensor,
                         hann: torch.Tensor, twiddles: torch.Tensor,
                         k: int, hop: int):
    """(mag_l, mag_r) [k*S, N/2] f32 of the k windows buf[s, r*hop : r*hop+W]
    of the [S, L] f32 or int16 sample buffers (L >= W + (k-1)*hop), with row
    r*S + s holding window r of stream s, W = hann.shape[0] and N =
    twiddles.shape[0]; hann as for `stft_mag_packed`.

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
    name = _cuda_kernel(ALLK_KERNEL, (buf_l, buf_r), hann=hann, twiddles=twiddles)
    check_fft_size(n_fft)
    out_l = torch.empty((k * s, n_fft // 2), dtype=torch.float32,
                        device=buf_l.device)
    out_r = torch.empty_like(out_l)
    if s:
        _launch(name, buf_l.device, buf_l.data_ptr(), buf_r.data_ptr(),
                hann.data_ptr(), twiddles.data_ptr(), out_l.data_ptr(),
                out_r.data_ptr(), s, length, k, hop, w, n_fft)
    return out_l, out_r


# ---------------------------------------------------------------- split-real

def stft_mag_split_plain(left: torch.Tensor, right: torch.Tensor,
                         hann: torch.Tensor, n_fft: int):
    """The plain version of the split-real kernels: torch.fft.rfft of each
    channel's windowed, zero-padded row; |X| of bins 0 .. N/2-1."""
    half = n_fft // 2

    def mag(x: torch.Tensor) -> torch.Tensor:
        return torch.abs(torch.fft.rfft(x * hann, n=n_fft)[:, :half])

    return mag(left), mag(right)


def stft_mag_split_allk_plain(buf_l: torch.Tensor, buf_r: torch.Tensor,
                              hann: torch.Tensor, n_fft: int, k: int,
                              hop: int):
    """Slice the k windows out of the buffers, window-major, and run
    `stft_mag_split_plain`."""
    w = hann.shape[0]
    left = torch.cat([buf_l[:, r * hop : r * hop + w] for r in range(k)])
    right = torch.cat([buf_r[:, r * hop : r * hop + w] for r in range(k)])
    return stft_mag_split_plain(left, right, hann, n_fft)


def stft_mag_split_t_plain(x: torch.Tensor, hann: torch.Tensor, n_fft: int):
    """Reorder the transposed operand [rows, 2, n1, m] (x[n, c, j1, t] is
    sample t*n1 + j1) into window planes and run `stft_mag_split_plain`."""
    rows, _, n1, m = x.shape
    left, right = (x[:, c].transpose(1, 2).reshape(rows, m * n1) for c in range(2))
    return stft_mag_split_plain(left, right, hann, n_fft)


def split_next_carry(carry: torch.Tensor, chunk: torch.Tensor) -> torch.Tensor:
    """The next transposed carry [rows, 2, n1, c_cols] after a hop of
    t_cols columns: carry columns t_cols.. then the chunk, or the chunk's
    last c_cols columns where t_cols >= c_cols."""
    c_cols, t_cols = carry.shape[3], chunk.shape[3]
    if t_cols >= c_cols:
        return chunk[..., t_cols - c_cols :].contiguous()
    return torch.cat([carry[..., t_cols:], chunk], dim=3)


def stft_mag_split_tsplit_plain(carry: torch.Tensor, chunk: torch.Tensor,
                                hann: torch.Tensor, n_fft: int):
    """(mag_l, mag_r, next_carry): the window carry + chunk through
    `stft_mag_split_t_plain`, and `split_next_carry`."""
    mag_l, mag_r = stft_mag_split_t_plain(torch.cat([carry, chunk], dim=3), hann, n_fft)
    return mag_l, mag_r, split_next_carry(carry, chunk)


def _split_check(name: str, samples: tuple, hann: torch.Tensor,
                 twiddles: torch.Tensor) -> None:
    """Raise unless the samples are contiguous f32 on the constants' CUDA
    device and N is one the kernels take."""
    _cuda_kernel(name, samples, hann=hann, twiddles=twiddles)
    check_fft_size(twiddles.shape[0])


def stft_mag_split(left: torch.Tensor, right: torch.Tensor,
                   hann: torch.Tensor, twiddles: torch.Tensor):
    """(mag_l, mag_r) [rows, N/2] f32 split-real magnitudes of the [rows, W]
    f32 window planes, hann `split_hann(W)`, N = twiddles.shape[0].

    CPU tensors take the plain version; CUDA tensors take spk_stft_split."""
    n_fft = twiddles.shape[0]
    rows, w = left.shape
    if (right.shape != left.shape or hann.shape != (w,) or w > n_fft
            or twiddles.shape != (n_fft, 2)):
        raise ValueError(
            f"window planes {tuple(left.shape)}/{tuple(right.shape)}, hann "
            f"{tuple(hann.shape)} and N={n_fft} do not fit"
        )
    if left.device.type == "cpu":
        return stft_mag_split_plain(left, right, hann, n_fft)
    _split_check(SPLIT_KERNEL, (left, right), hann, twiddles)
    out_l = torch.empty((rows, n_fft // 2), dtype=torch.float32, device=left.device)
    out_r = torch.empty_like(out_l)
    if rows:
        _launch(SPLIT_KERNEL, left.device, left.data_ptr(), right.data_ptr(),
                hann.data_ptr(), twiddles.data_ptr(), out_l.data_ptr(),
                out_r.data_ptr(), rows, w, n_fft)
    return out_l, out_r


def stft_mag_split_allk(buf_l: torch.Tensor, buf_r: torch.Tensor,
                        hann: torch.Tensor, twiddles: torch.Tensor,
                        k: int, hop: int):
    """(mag_l, mag_r) [k*S, N/2] f32 split-real magnitudes of the k windows
    buf[s, r*hop : r*hop+W] of the [S, L] f32 buffers, row r*S + s; hann
    `split_hann(W)`.

    CPU tensors take the plain version; CUDA tensors take
    spk_stft_split_allk, which never materializes the windows."""
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
        return stft_mag_split_allk_plain(buf_l, buf_r, hann, n_fft, k, hop)
    _split_check(SPLIT_ALLK_KERNEL, (buf_l, buf_r), hann, twiddles)
    out_l = torch.empty((k * s, n_fft // 2), dtype=torch.float32, device=buf_l.device)
    out_r = torch.empty_like(out_l)
    if s:
        _launch(SPLIT_ALLK_KERNEL, buf_l.device, buf_l.data_ptr(), buf_r.data_ptr(),
                hann.data_ptr(), twiddles.data_ptr(), out_l.data_ptr(),
                out_r.data_ptr(), s, length, k, hop, w, n_fft)
    return out_l, out_r


def stft_mag_split_t(x: torch.Tensor, hann: torch.Tensor, twiddles: torch.Tensor):
    """(mag_l, mag_r) [rows, N/2] f32 split-real magnitudes of the windows
    of the combined transposed operand x [rows, 2, n1, m] f32 (x[n, c, j1,
    t] = sample t*n1 + j1 of channel c), hann `split_hann(n1*m)`.

    CPU tensors take the plain version; CUDA tensors take spk_stft_split_t."""
    n_fft = twiddles.shape[0]
    if x.ndim != 4 or x.shape[1] != 2:
        raise ValueError(f"expected a [rows, 2, n1, m] operand; got {tuple(x.shape)}")
    rows, _, n1, m = x.shape
    if hann.shape != (n1 * m,) or n1 * m > n_fft or twiddles.shape != (n_fft, 2):
        raise ValueError(
            f"operand {tuple(x.shape)}, hann {tuple(hann.shape)} and N={n_fft} "
            "do not fit"
        )
    if x.device.type == "cpu":
        return stft_mag_split_t_plain(x, hann, n_fft)
    _split_check(SPLIT_T_KERNEL, (x,), hann, twiddles)
    out_l = torch.empty((rows, n_fft // 2), dtype=torch.float32, device=x.device)
    out_r = torch.empty_like(out_l)
    if rows:
        _launch(SPLIT_T_KERNEL, x.device, x.data_ptr(), hann.data_ptr(),
                twiddles.data_ptr(), out_l.data_ptr(), out_r.data_ptr(), rows,
                n1, m, n_fft)
    return out_l, out_r


def stft_mag_split_tsplit(carry: torch.Tensor, chunk: torch.Tensor,
                          hann: torch.Tensor, twiddles: torch.Tensor):
    """(mag_l, mag_r, next_carry): the split-real magnitudes [rows, N/2] f32
    of the windows whose columns are the transposed carry [rows, 2, n1,
    c_cols] followed by the transposed hop chunk [rows, 2, n1, t_cols]
    (f32; hann `split_hann(n1*(c_cols+t_cols))`), and the next carry
    [rows, 2, n1, c_cols] (`split_next_carry`), a new tensor.

    CPU tensors take the plain version; CUDA tensors take
    spk_stft_split_tsplit, which writes the next carry itself."""
    n_fft = twiddles.shape[0]
    if carry.ndim != 4 or carry.shape[1] != 2:
        raise ValueError(f"expected a [rows, 2, n1, c_cols] carry; got {tuple(carry.shape)}")
    rows, _, n1, c_cols = carry.shape
    t_cols = chunk.shape[-1]
    w = n1 * (c_cols + t_cols)
    if (chunk.shape != (rows, 2, n1, t_cols) or hann.shape != (w,) or w > n_fft
            or twiddles.shape != (n_fft, 2)):
        raise ValueError(
            f"carry {tuple(carry.shape)}, chunk {tuple(chunk.shape)}, hann "
            f"{tuple(hann.shape)} and N={n_fft} do not fit"
        )
    if carry.device.type == "cpu":
        return stft_mag_split_tsplit_plain(carry, chunk, hann, n_fft)
    _split_check(SPLIT_TSPLIT_KERNEL, (carry, chunk), hann, twiddles)
    out_l = torch.empty((rows, n_fft // 2), dtype=torch.float32, device=carry.device)
    out_r = torch.empty_like(out_l)
    next_carry = torch.empty_like(carry)
    if rows:
        _launch(SPLIT_TSPLIT_KERNEL, carry.device, carry.data_ptr(), chunk.data_ptr(),
                hann.data_ptr(), twiddles.data_ptr(), out_l.data_ptr(),
                out_r.data_ptr(), next_carry.data_ptr(), rows, n1, c_cols,
                t_cols, n_fft)
    return out_l, out_r, next_carry
