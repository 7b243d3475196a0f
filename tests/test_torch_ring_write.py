"""The display ring write (`ops/cuda/ring_kernel.py`) on the CPU.

`ring_write_plain`, which the pipeline's push takes on a CPU tensor, is
held bit for bit to the three steps `_write_ring` ran before the kernel
(stack, cast, `index_copy_`), inlined here as the oracle: through the
pipeline, at every cursor position of a 16-row ring, for k = 1, 2 and 8,
the four ring dtypes the kernel takes, and f32 and int16 (`i16_planes`)
chunks.  The wrapper's checks, which guard the kernel's pointers, run on
`meta` tensors (any device but the CPU takes the kernel's path).  The
kernel itself is held to the plain version on the card in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from portbench import trace
from spectrogram_tpu_torch import testing
from spectrogram_tpu_torch.config import SpectrogramConfig
from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline
from spectrogram_tpu_torch.ops.cuda import ring_kernel

torch.set_num_threads(2)

SMALL = SpectrogramConfig(sample_rate=8000.0, window_period=0.032, hop_period=0.008)
RING_ROWS = 16
STREAMS = 3


def _old_write_ring(ring, cursor, mag_l, mag_r, k, w):
    """`_write_ring` before the kernel, as it was."""
    s = ring.shape[0]
    rows = torch.stack([mag_l[:, 1:w], mag_r[:, 1:w]], dim=1).to(ring.dtype)
    at = cursor.to(torch.int64) + torch.arange(k, device=ring.device)
    ring.index_copy_(1, at, rows.view(k, s, 2, -1).transpose(0, 1))


@pytest.mark.parametrize("wire", ["f32", "i16"])
def test_push_writes_the_old_ring_bits(wire):
    """For k = 1, 2 and 8 and each ring dtype, every push of R/k + 1 (the
    ring wraps once) writes the bits the old three steps write, and no
    others, at each cursor in turn; the rows never wrap inside a push."""
    for k in (1, 2, 8):
        for ring_dtype in ring_kernel.RING_DTYPES:
            p = SpectrogramPipeline(SMALL, chunk_hops=k, viewport_rows=RING_ROWS,
                                    ring_dtype=ring_dtype, i16_planes=wire == "i16",
                                    packed_output=True, device="cpu")
            assert p._ring_write is ring_kernel.ring_write
            assert p.with_plain_kernels()._ring_write is ring_kernel.ring_write_plain
            _push_around_the_ring(p, k, wire)


def _push_around_the_ring(p, k, wire):
    state = p.set_palette(p.init_state(STREAMS), np.array([0, 1, 8]))
    pushes = RING_ROWS // k + 1
    pcm = testing.chirp_tone(STREAMS, pushes * p.chunk_size, SMALL.sample_rate, seed=k)
    pcm += np.random.default_rng(k).normal(0.0, 0.05, pcm.shape).astype(np.float32)
    if wire == "i16":
        pcm = np.round(np.clip(pcm, -1, 1) * 32767.0).astype(np.int16)
    calls = []

    def spy(ring, cursor, mag_l, mag_r, k_):
        assert int(cursor) + k_ <= ring.shape[1]          # a push never wraps
        expect = ring.clone()
        _old_write_ring(expect, cursor, mag_l, mag_r, k_, SMALL.window_size)
        ring_kernel.ring_write(ring, cursor, mag_l, mag_r, k_)
        torch.testing.assert_close(ring, expect, atol=0, rtol=0, equal_nan=True)
        calls.append(int(cursor))

    p._ring_write = spy
    for i in range(pushes):
        chunk = torch.from_numpy(pcm[:, i * p.chunk_size:(i + 1) * p.chunk_size])
        state, _ = p.push(state, chunk)
    assert calls == [(i * k) % RING_ROWS for i in range(pushes)]
    assert int(state.cursor) == (pushes * k) % RING_ROWS
    assert state.ring.dtype == p.ring_dtype and bool(state.ring.abs().sum() > 0)


def _meta_operands(k=2, s=3, r=8, b=7, p=10):
    ring = torch.empty((s, r, 2, b), dtype=torch.bfloat16, device="meta")
    planes = [torch.empty((k * s, p), dtype=torch.float32, device="meta") for _ in range(2)]
    cursor = torch.empty((), dtype=torch.int32, device="meta")
    return dict(ring=ring, cursor=cursor, mag_l=planes[0], mag_r=planes[1], k=k)


@pytest.mark.parametrize("fault,match", [
    ("plane_on_cpu", "mag_l is on cpu"),
    ("cursor_on_cpu", "cursor is on cpu"),
    ("ring_int16", "no ring kernel for a torch.int16 ring"),
    ("ring_float8", "no ring kernel"),
    ("planes_f64", "float32 planes"),
    ("bins_strided", "contiguous bins"),
    ("strides_differ", "strides differ"),
    ("ring_last_dims_transposed", "last two dims must be contiguous"),
    ("ring_bins_padded", "last two dims must be contiguous"),
    ("cursor_int64", "one int32"),
    ("cursor_two", "one int32"),
    ("rows_not_k_streams", r"not \[k\*S, > B\]"),
    ("planes_too_narrow", r"not \[k\*S, > B\]"),
    ("k_past_ring", "do not fit a ring"),
    ("ring_3d", r"must be \[S, R, 2, B\]"),
])
def test_wrapper_raises(fault, match):
    """What the kernel cannot take raises before any launch."""
    a = _meta_operands()
    ring, mag = a["ring"], a["mag_l"]
    change = {
        "plane_on_cpu": dict(mag_l=torch.empty(mag.shape)),
        "cursor_on_cpu": dict(cursor=torch.zeros((), dtype=torch.int32)),
        "ring_int16": dict(ring=ring.to(torch.int16)),
        "ring_float8": dict(ring=ring.to(torch.float8_e4m3fn)),
        "planes_f64": dict(mag_l=mag.double(), mag_r=mag.double()),
        "bins_strided": dict(mag_l=torch.empty((6, 20), device="meta")[:, ::2],
                             mag_r=torch.empty((6, 20), device="meta")[:, ::2]),
        "strides_differ": dict(mag_r=torch.empty((6, 12), device="meta")[:, :10]),
        "ring_last_dims_transposed": dict(
            ring=torch.empty((3, 8, 7, 2), dtype=torch.bfloat16, device="meta").transpose(2, 3)),
        "ring_bins_padded": dict(
            ring=torch.empty((3, 8, 2, 9), dtype=torch.bfloat16, device="meta")[..., :7]),
        "cursor_int64": dict(cursor=torch.empty((), dtype=torch.int64, device="meta")),
        "cursor_two": dict(cursor=torch.empty((2,), dtype=torch.int32, device="meta")),
        "rows_not_k_streams": dict(k=1),
        "planes_too_narrow": dict(mag_l=torch.empty((6, 7), device="meta"),
                                  mag_r=torch.empty((6, 7), device="meta")),
        "k_past_ring": dict(k=9),
        "ring_3d": dict(ring=ring[0]),
    }[fault]
    with pytest.raises(ValueError, match=match):
        ring_kernel.ring_write(**{**a, **change})


def test_trace_rule_takes_the_kernel():
    """The benchmark's trace gives the kernel's device time to the layer
    `gather_ms` reads (the library launches it with no ATen op)."""
    assert trace.attribute("ring_write_kernel", "", trace.rules()) == "gather"
