"""Carry a JAX `StreamState` into the PyTorch port and back, as numpy arrays.

This system has no weights: what a running deployment holds is its stream
state (the sample carry, the bf16 row ring with its cursor, palette ids, the
row count and the pre-picked palette tables).  `state_from_jax` takes that
state as a dict of numpy arrays — e.g. `{k: np.asarray(v) for k, v in
jax_state._asdict().items()}`, with `tables` a tuple of arrays — and
`state_to_numpy` gives the same form back.

The tables tuple keeps the JAX package's structure, which says what kind of
state it is: ([S|1, R*4],) per-row or one palette, with a zero-size int32
marker appended for the blockwise colormap; palette-sorted (t_sorted, perm,
inv) with block-relative int32 perm and inv, or (t_sorted, perm, inv,
marker) with global ones; a generic registry's (u, v) pair of [S|1, R*4]
factor tables; () for a static_palette pipeline.  So a state of a default
JAX pipeline serving many tenants, or of one with user-defined or static
palettes, carries across as it is, in either direction.
"""

from __future__ import annotations

import numpy as np
import torch

from spectrogram_tpu_torch.models.palette_layout import PaletteLayout
from spectrogram_tpu_torch.models.spectrogram import StreamState, default_device

_FIELDS = ("carry", "ring", "cursor", "palette_id", "row_count")


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    arr = np.asarray(a)
    if dtype.is_floating_point:
        # through f32 (f64 for an f64 tensor), which holds bf16 and f16
        # values exactly: numpy has no bfloat16 of its own
        wide = np.float64 if dtype == torch.float64 else np.float32
        return torch.from_numpy(np.array(arr, wide, copy=True)).to(device, dtype)
    return torch.from_numpy(np.array(arr, copy=True)).to(device, dtype)


def _tables(tables: tuple, device) -> tuple:
    """The tables tuple on `device`: 2-D tables as f32, 1-D perm, inv and
    marker as int32.  Raises for a layout no pipeline pushes."""
    arrays = tuple(np.asarray(t) for t in tables)
    PaletteLayout.check(arrays)
    return tuple(_tensor(a, torch.float32 if a.ndim == 2 else torch.int32, device)
                 for a in arrays)


def state_from_jax(state: dict, device=None,
                   ring_dtype: torch.dtype = torch.bfloat16) -> StreamState:
    """A `StreamState` on `device` (default: the card) from a JAX state's
    numpy arrays.  The carry is [S, 2, C] f32, or int16 from an i16_planes
    pipeline, or the transposed [S, 2, n1, C/n1] f32 of a transposed_carry
    or framing="tsplit" pipeline; the ring ([S, R, 2, B], R = 0 without
    store_ring) is stored in `ring_dtype`, the pipeline's (bfloat16, the
    JAX default, unless it was built with another), which holds a ring of
    that dtype exactly; the tables tuple keeps its structure."""
    carry = np.asarray(state["carry"])
    planar = carry.ndim == 3 and carry.dtype in (np.float32, np.int16)
    transposed = carry.ndim == 4 and carry.dtype == np.float32
    if not (planar or transposed) or carry.shape[1] != 2:
        raise ValueError(
            f"carry must be an f32 or int16 [S, 2, C] array or an f32 "
            f"[S, 2, n1, C/n1] one; got {carry.dtype} {carry.shape}"
        )
    device = default_device(device)
    return StreamState(
        carry=_tensor(carry, torch.int16 if carry.dtype == np.int16
                      else torch.float32, device),
        ring=_tensor(state["ring"], ring_dtype, device),
        cursor=_tensor(state["cursor"], torch.int32, device),
        palette_id=_tensor(state["palette_id"], torch.int32, device),
        row_count=_tensor(state["row_count"], torch.int32, device),
        tables=_tables(tuple(state.get("tables", ())), device),
    )


def state_to_numpy(state: StreamState) -> dict:
    """The state as a dict of numpy arrays (`tables` a tuple).  A bf16 ring
    comes back as f32, which holds its values exactly, any other ring in its
    dtype; the carry keeps its dtype."""
    def arr(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()

    out = {name: arr(getattr(state, name)) for name in _FIELDS}
    out["tables"] = tuple(arr(t) for t in state.tables)
    return out
