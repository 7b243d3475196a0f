"""The port's LiveSession against the JAX package's, on the CPU.

Mirrors the session and metrics tests of `tests/test_session.py` (its
checkpoint tests, npz, sharded and orbax, are ported in
`tests/test_torch_checkpoint.py`, the orbax ones onto
`torch.distributed.checkpoint`).  Live
selection runs the registry's real-time source pump; the parity tests
drive both sessions deterministically, the same seeded frames pushed into
their host rings.  The bars:

  * rows within 1 u8 per channel of JAX's over what the image shows
    (`testing.rgba_u8_diff`); ring rows within 1 bf16 ulp
    (`testing.bf16_ulps`);
  * scope envelopes exactly equal;
  * analyzer levels within 1e-5 absolute of JAX's analyzer fed the same
    ring rows (its band product sums in another order); inside the port,
    the session's levels equal a replay of `push_rows` over its ring rows
    bit for bit.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrogram_tpu.session import LiveSession as JaxSession
from spectrogram_tpu.session import SessionConfig as JaxSessionConfig

from spectrogram_tpu_torch import testing
from spectrogram_tpu_torch.io.registry import InputDescriptor
from spectrogram_tpu_torch.io.sources import SineSource
from spectrogram_tpu_torch.models.spectrogram import StreamState
from spectrogram_tpu_torch.models.spectrum_analyzer import ring_rows
from spectrogram_tpu_torch.session import LiveSession, SessionConfig

torch.set_num_threads(2)

SMALL = dict(window_period=0.016, hop_period=0.004, viewport_height=64,
             viewport_rows=32, chunk_hops=4, enable_scope=True, enable_analyzer=True)
LEVELS_ATOL = 1e-5
STFT_ATOL = 3e-5


def small_session():
    return LiveSession(SessionConfig(**SMALL), device="cpu")


def _wait_rows(sess, seconds=5.0):
    deadline = time.time() + seconds
    rows = []
    while not rows and time.time() < deadline:
        rows = sess.process_available()
        time.sleep(0.02)
    return rows


def test_session_select_process_switch():
    sess = small_session()
    sess.registry._inputs.append(InputDescriptor(
        "Test: 44.1 kHz tone", "synthetic", 44100.0,
        factory=lambda: SineSource(44100.0, 440.0, 660.0)))
    try:
        sess.select_input(len(sess.registry) - 4)  # the 48 kHz sine source
        assert sess.pipeline.cfg.sample_rate == 48000.0
        assert sess.pipeline.device == torch.device("cpu")
        rows = _wait_rows(sess)
        assert rows, "no rows produced from live synthetic input"
        assert rows[0].shape == (4, 64, 4) and rows[0].dtype == np.uint8
        vp = sess.viewport()
        assert vp.shape == (sess.pipeline.viewport_rows, 64, 4)
        # runtime palette switch requires no rebuild
        pipeline_before = sess.pipeline
        sess.set_palette("Viridis")
        assert sess.pipeline is pipeline_before
        assert int(sess.state.palette_id[0]) == 2
        # analyzer and scope advanced
        assert sess.levels is not None and float(sess.levels.max()) > 0
        assert int(sess.scope_state.cursor) >= 0
        # a capture at another rate rebuilds the pipeline (new FFT plan,
        # N=1410 at 44.1 kHz) and resets the state; the palette carries over
        sess.select_input(len(sess.registry) - 1)
        assert sess.pipeline is not pipeline_before
        assert sess.pipeline.cfg.sample_rate == 44100.0
        assert sess.pipeline.cfg.padded_size == 1410
        assert int(sess.state.row_count) == 0
        assert int(sess.state.palette_id[0]) == 2
        assert sess.scope.push_size == sess.pipeline.chunk_size
        rows = _wait_rows(sess)
        assert rows and rows[0].shape == (4, 64, 4)
        assert sess.analyzer.cfg.sample_rate == 44100.0
    finally:
        sess.stop()


def test_session_metrics():
    sess = small_session()
    try:
        sess.select_input(len(sess.registry) - 3)
        time.sleep(0.15)
        sess.process_available(max_chunks=2)
        m = sess.metrics()
        assert "ring_dropped" in m and "latency" in m
        assert m["rows_produced"] >= 0 and m["palette_id"] == 1
    finally:
        sess.stop()


def _drive(sess, frames, chunk):
    """Push the frames into the session's host ring a chunk at a time and
    process each: deterministic, no source pump."""
    out = []
    for i in range(0, len(frames), chunk):
        sess.registry.ring.push(frames[i : i + chunk])
        out.extend(np.asarray(r) for r in sess.process_available())
    return out


@pytest.mark.parametrize("rate", [48000.0, 44100.0])
def test_session_matches_jax(rate):
    """The same frames through both sessions: rows, ring, scope envelopes,
    and the analyzer fed from the ring."""
    port = small_session()
    jsess = JaxSession(JaxSessionConfig(**SMALL))
    port._on_sample_rate(rate)
    jsess._on_sample_rate(rate)
    n = port.pipeline.chunk_size
    assert n == jsess.pipeline.chunk_size
    pushes = 6                              # 24 rows: the 32-row ring holds them all
    frames = testing.chirp_tone(1, pushes * n, rate, seed=4)[0]
    got, want = _drive(port, frames, n), _drive(jsess, frames, n)
    assert len(got) == len(want) == pushes
    for a, b in zip(got, want):
        assert a.shape == b.shape == (4, 64, 4)
        assert testing.rgba_u8_diff(a, b) <= 1
    ring = port.state.ring
    jring = np.asarray(jsess.state.ring.astype(jnp.float32))
    assert testing.bf16_ulps(ring, jring, STFT_ATOL) <= 1
    assert int(port.state.cursor) == int(jsess.state.cursor)
    np.testing.assert_array_equal(port.scope.envelope(port.scope_state, 256).numpy(),
                                  np.asarray(jsess.scope.envelope(jsess.scope_state, 256)))
    # the analyzer read each push's k rows from the ring: a replay over
    # the port's ring rows gives its levels bit for bit, and JAX's analyzer
    # fed the same rows gives them within the bar
    k = port.pipeline.chunk_hops
    rows = ring.to(torch.float32).transpose(-1, -2)          # [1, R, B, 2]
    replay = port.analyzer.init_levels(1)
    jlevels = jsess.analyzer.init_levels(1)
    for i in range(pushes):
        step = rows[:, i * k : (i + 1) * k]
        replay = port.analyzer.push_rows(replay, step)
        jlevels = jsess.analyzer.push_rows(jlevels, jnp.asarray(step.numpy()))
    assert torch.equal(port.levels, replay)
    np.testing.assert_allclose(port.levels.numpy(), np.asarray(jlevels), rtol=0,
                               atol=LEVELS_ATOL)
    assert float(port.levels.max()) > 0.3


@pytest.mark.parametrize("k", [1, 4])
def test_ring_rows_slice_the_newest_rows(k):
    """`ring_rows` reads rows (cursor - k) .. cursor - 1 of every stream on
    the device, as JAX's dynamic slice at (cursor - k) % R does, also where
    the cursor has wrapped to 0."""
    rng = np.random.default_rng(k)
    r, b = 16, 33
    ring = torch.from_numpy(rng.random((3, r, 2, b)).astype(np.float32)).to(torch.bfloat16)
    jring = jnp.asarray(ring.to(torch.float32).numpy()).astype(jnp.bfloat16)
    for cursor in range(0, r, k):
        state = _state_at(ring, cursor)
        got = ring_rows(state, k)
        want = jax.lax.dynamic_slice(jring, (0, (cursor - k) % r, 0, 0),
                                     (3, k, 2, b)).astype(jnp.float32)
        np.testing.assert_array_equal(got.numpy(), np.swapaxes(np.asarray(want), 2, 3))


def _state_at(ring, cursor):
    return StreamState(carry=torch.zeros(3, 2, 4), ring=ring,
                       cursor=torch.tensor(cursor, dtype=torch.int32),
                       palette_id=torch.ones(3, dtype=torch.int32),
                       row_count=torch.tensor(cursor, dtype=torch.int32))


def test_session_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        assert LiveSession().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LiveSession()
