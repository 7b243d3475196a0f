"""The display ring write: magnitude planes into the ring's rows, in place.

`ring_write` writes bins 1..W-1 of the window-major [k*S, P] f32 planes
(row r*S + s: hop r of stream s) into rows cursor .. cursor+k-1 of every
stream's ring [S, R, 2, W-1], rounded to the ring's dtype (to nearest even,
as `.to(ring_dtype)`).  It replaces no TPU kernel: the JAX pipeline's
`dynamic_update_slice(ring, rows.astype(ring_dtype))` is one pass that XLA
fuses, and `csrc/ring_write.cu` makes that pass by hand, reading the cursor
on the device.  `ring_write_plain` is the same write as three ATen passes
(stack, cast, index_copy_).

A CPU tensor takes the plain version; a CUDA tensor takes the kernel, or the
wrapper raises.
"""

from __future__ import annotations

import torch

KERNEL = "spk_ring_write"
# the C entry's dtype codes
RING_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2, torch.float64: 3}


def ring_write_plain(ring: torch.Tensor, cursor: torch.Tensor, mag_l: torch.Tensor,
                     mag_r: torch.Tensor, k: int) -> None:
    """The plain version: stack the two channels' bins 1..W-1, cast them to
    the ring's dtype and `index_copy_` them into rows cursor .. cursor+k-1."""
    s, b = ring.shape[0], ring.shape[3]
    rows = torch.stack([mag_l[:, 1:b + 1], mag_r[:, 1:b + 1]], dim=1).to(ring.dtype)
    at = cursor.to(torch.int64) + torch.arange(k, device=ring.device)
    ring.index_copy_(1, at, rows.view(k, s, 2, -1).transpose(0, 1))


def ring_write(ring: torch.Tensor, cursor: torch.Tensor, mag_l: torch.Tensor,
               mag_r: torch.Tensor, k: int) -> None:
    """Write bins 1..B of the [k*S, P] f32 planes `mag_l`, `mag_r` (P > B,
    bins contiguous, one row stride) into rows cursor .. cursor+k-1 of the
    ring [S, R, 2, B] (its last two dims contiguous), in place; `cursor` is
    the int32 scalar of the state, on the ring's device.  The pipeline keeps
    cursor + k <= R (R is a multiple of k).

    CPU tensors take `ring_write_plain`; any other device takes
    spk_ring_write on the current stream (a bfloat16, float16, float32 or
    float64 ring), or raises."""
    if ring.ndim != 4 or ring.shape[2] != 2:
        raise ValueError(f"the ring must be [S, R, 2, B]; got {tuple(ring.shape)}")
    s, r, _, b = ring.shape
    if not 1 <= k <= r:
        raise ValueError(f"k={k} rows do not fit a ring of {r} rows")
    for name, t in (("mag_l", mag_l), ("mag_r", mag_r), ("cursor", cursor)):
        if t.device != ring.device:
            raise ValueError(f"{name} is on {t.device}; the ring on {ring.device}")
    for name, t in (("mag_l", mag_l), ("mag_r", mag_r)):
        if t.ndim != 2 or t.shape[0] != k * s or t.shape[1] <= b:
            raise ValueError(
                f"{name} {tuple(t.shape)} is not [k*S, > B] = [{k * s}, > {b}] planes")
    if ring.device.type == "cpu":
        ring_write_plain(ring, cursor, mag_l, mag_r, k)
        return
    if ring.dtype not in RING_DTYPES:
        raise ValueError(
            f"no ring kernel for a {ring.dtype} ring: bfloat16, float16, float32 or float64")
    for name, t in (("mag_l", mag_l), ("mag_r", mag_r)):
        if t.dtype != torch.float32 or t.stride(1) != 1:
            raise ValueError(
                f"{name} must be float32 planes with contiguous bins; got {t.dtype}, "
                f"strides {t.stride()}")
    if mag_r.stride() != mag_l.stride():
        raise ValueError(
            f"the planes' strides differ: {mag_l.stride()} and {mag_r.stride()}")
    if ring.stride(3) != 1 or ring.stride(2) != b:
        raise ValueError(
            f"the ring's last two dims must be contiguous; strides {ring.stride()}")
    if cursor.dtype != torch.int32 or cursor.numel() != 1:
        raise ValueError(f"cursor must be one int32; got {cursor.dtype} {tuple(cursor.shape)}")
    if s == 0:
        return
    from spectrogram_tpu_torch.ops.cuda import _build

    with torch.cuda.device(ring.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.library().launch(
            KERNEL, mag_l.data_ptr(), mag_r.data_ptr(), mag_l.stride(0), s, k, b,
            ring.data_ptr(), RING_DTYPES[ring.dtype], ring.stride(0), ring.stride(1), r,
            cursor.data_ptr(), stream)
