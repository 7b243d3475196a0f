"""Carry a JAX `StreamState` into the PyTorch port and back, as numpy arrays.

This system has no weights: what a running deployment holds is its stream
state (the sample carry, the bf16 row ring with its cursor, palette ids, the
row count and the pre-picked palette tables).  `state_from_jax` takes that
state as a dict of numpy arrays — e.g. `{k: np.asarray(v) for k, v in
jax_state._asdict().items()}`, with `tables` a tuple of arrays — and
`state_to_numpy` gives the same form back.
"""

from __future__ import annotations

import numpy as np
import torch

from spectrogram_tpu_torch.models.spectrogram import StreamState, default_device

_FIELDS = ("carry", "ring", "cursor", "palette_id", "row_count")


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    arr = np.asarray(a)
    if dtype == torch.bfloat16:
        # numpy has no bfloat16; bf16 values are exact in f32
        return torch.from_numpy(np.asarray(arr, np.float32)).to(device, dtype)
    return torch.from_numpy(np.array(arr, copy=True)).to(device, dtype)


def state_from_jax(state: dict, device=None) -> StreamState:
    """A `StreamState` on `device` (default: the card) from a JAX state's
    numpy arrays.  The ring ([S, R, 2, B], R = 0 without store_ring) arrives
    as bf16 or f32 values and is stored as bf16.

    Only the layout this port pushes is accepted: an f32 [S, 2, C] carry and
    external stream order.  The JAX pipeline's zero-size blockwise marker is
    dropped (a TPU kernel choice); a palette-sorted state (perm/inv in its
    tables) raises — build the JAX pipeline with palette_sort=False.
    """
    carry = np.asarray(state["carry"])
    if carry.ndim != 3 or carry.dtype != np.float32:
        raise ValueError(
            f"carry must be an f32 [S, 2, C] array; got {carry.dtype} "
            f"{carry.shape} (int16 and transposed carries are not ported)"
        )
    tables = tuple(np.asarray(t) for t in state.get("tables", ()))
    tables = tuple(t for t in tables if not (t.ndim == 1 and t.size == 0))
    if len(tables) != 1 or tables[0].ndim != 2:
        raise ValueError(
            "expected one [S or 1, R*4] built-in table array; got shapes "
            f"{[t.shape for t in tables]} (sorted or generic states are "
            "not ported)"
        )
    device = default_device(device)
    return StreamState(
        carry=_tensor(carry, torch.float32, device),
        ring=_tensor(state["ring"], torch.bfloat16, device),
        cursor=_tensor(state["cursor"], torch.int32, device),
        palette_id=_tensor(state["palette_id"], torch.int32, device),
        row_count=_tensor(state["row_count"], torch.int32, device),
        tables=(_tensor(tables[0], torch.float32, device),),
    )


def state_to_numpy(state: StreamState) -> dict:
    """The state as a dict of numpy arrays (`tables` a tuple).  The bf16
    ring comes back as f32, which holds its values exactly."""
    def arr(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()

    out = {name: arr(getattr(state, name)) for name in _FIELDS}
    out["tables"] = tuple(arr(t) for t in state.tables)
    return out
