"""The port's async device feeder against the JAX package's, on the CPU.

`spectrogram_tpu_torch/io/feeder.py` (`DeviceFeeder`, `ChunkPool`) on a CPU
pipeline: the rows it hands back are bit for bit the port pipeline's
sequential pushes of the same chunks, and within 1 u8 per channel of the
JAX package's `DeviceFeeder` on the JAX pipeline over what the image shows
(`testing.rgba_u8_diff`), with carries exactly equal.  Covered: interleaved
and planar chunks, depths 1-3, the int16 wire (a `RingBank16` drained raw
into an int16 `ChunkPool`), `readback="probe"` (tensors handed back), the
pool's rotation with `copy_chunks=False` (every slot overwritten while the
feeder runs), `run()`, `on_rows`, the throughput probe, and the checks on
`depth` and `readback`.  Then the serving loop's host-sorted drain:
`pop_matrix_i16_planar(dest=input_dest)` into an `i16_planes` +
`presorted_input` + `sorted_output` pipeline at 256 streams against the JAX
package's same loop (its Pallas chain in interpret mode, where the palette
sort engages), and bit for bit the port's per-row pipeline fed the same
words directly.

Geometries as in `tests/test_io.py` (W=256, hop 64, H=64) and, for the int16
planes, BENCH_CONFIG's W=2048 with H=64.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import spectrogram_tpu.config as jcfg
from spectrogram_tpu.io import feeder as jfeeder
from spectrogram_tpu.io import ring as jring
from spectrogram_tpu.models.spectrogram import SpectrogramPipeline as JaxPipeline

from spectrogram_tpu_torch import testing
from spectrogram_tpu_torch.config import BENCH_CONFIG, SpectrogramConfig
from spectrogram_tpu_torch.io import feeder as tfeeder
from spectrogram_tpu_torch.io import ring as tring
from spectrogram_tpu_torch.io.feeder import ChunkPool, DeviceFeeder
from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline
from spectrogram_tpu_torch.ops.cuda.colormap_kernel import unpack_rgba

torch.set_num_threads(2)

SMALL = dict(sample_rate=8000.0, window_period=0.032, hop_period=0.008,
             viewport_height=64, viewport_rows=16)
CFG, JCFG = SpectrogramConfig(**SMALL), jcfg.SpectrogramConfig(**SMALL)
BENCH64 = dataclasses.replace(BENCH_CONFIG, viewport_height=64)
JBENCH64 = dataclasses.replace(jcfg.BENCH_CONFIG, viewport_height=64)
JAX_KW = dict(stft_backend="pallas", colormap_backend="pallas", kernel_interpret=True)
S = 3
IDS = np.array([0, 3, 8])          # stereo, mono, mono
PUSHES = 5

# name -> (pipeline arguments, feeder arguments, chunk source)
CASES = {
    "interleaved_d2": (dict(chunk_hops=2), dict(depth=2), "array"),
    "planar_d1": (dict(chunk_hops=2), dict(depth=1, planar=True), "array"),
    "planar_d3_probe": (dict(chunk_hops=2), dict(depth=3, planar=True, readback="probe"),
                        "array"),
    "pool_rotation_d2": (dict(chunk_hops=2), dict(depth=2, planar=True, copy_chunks=False),
                         "pool"),
    "pool_interleaved_d1_k1": (dict(chunk_hops=1, store_ring=False, packed_output=True),
                               dict(depth=1, copy_chunks=False), "pool"),
    "int16_wire_d2": (dict(chunk_hops=2), dict(depth=2, planar=True, copy_chunks=False),
                      "bank16"),
    "int16_wire_packed_d3": (dict(chunk_hops=1, store_ring=False, packed_output=True),
                             dict(depth=3, planar=True, copy_chunks=False), "bank16"),
}


@functools.lru_cache(maxsize=None)
def _pipelines(kw_items: tuple):
    """(JAX pipeline, port pipeline) with the same arguments, shared so that
    each JAX push structure compiles once."""
    kw = dict(kw_items)
    return JaxPipeline(JCFG, **kw), SpectrogramPipeline(CFG, device="cpu", **kw)


def _u8(rows):
    rows = rows.numpy() if isinstance(rows, torch.Tensor) else np.asarray(rows)
    return unpack_rgba(rows) if rows.dtype == np.int32 else rows


def _feed(feeder, feeder_mod, chunks, source: str, s: int):
    """Drive `feeder` over `chunks` ([S, n, 2] f32 or int16 numpy) as
    `source` delivers them; returns (rows in order, the on_rows calls)."""
    planar = feeder.planar
    seen = []
    feeder.on_rows = seen.append
    out = []
    if source == "array":
        it = iter(c.transpose(0, 2, 1).copy() if planar else c for c in chunks)
        out = list(feeder.run(lambda: next(it, None)))
        return out, seen
    pool = feeder_mod.ChunkPool.for_feeder(feeder, s, dtype=chunks[0].dtype)
    assert len(pool) == feeder.depth + 1
    bank = None
    if source == "bank16":
        ring = jring if feeder_mod is jfeeder else tring
        bank = ring.RingBank16(s, 4096)
        bank.push_matrix(np.concatenate(chunks, axis=1))
    n = chunks[0].shape[1]
    for c in chunks:
        buf = pool.next()
        if bank is not None:
            bank.pop_matrix_i16_planar(n, out=buf)
        else:
            buf[:] = c.transpose(0, 2, 1) if planar else c   # "drain" into the slot
        done = feeder.push(buf)
        if done is not None:
            out.append(done)
    out.extend(feeder.flush())
    if bank is not None:
        assert bank.min_size() == 0 and bank.dropped_total == 0
    return out, seen


@pytest.mark.parametrize("case", sorted(CASES))
def test_feeder_matches_pushes_and_jax(case):
    kw, fkw, source = CASES[case]
    jp, tp = _pipelines(tuple(sorted(kw.items())))
    wire = np.int16 if source == "bank16" else np.float32
    pcm = testing.chirp_tone(S, PUSHES * tp.chunk_size, CFG.sample_rate, seed=7)
    if wire == np.int16:
        pcm = np.round(pcm * 32767.0).astype(np.int16)
    chunks = [np.ascontiguousarray(pcm[:, i * tp.chunk_size : (i + 1) * tp.chunk_size])
              for i in range(PUSHES)]

    # the port pipeline's own sequential pushes
    ts = tp.set_palette(tp.init_state(S), IDS)
    want = []
    for c in chunks:
        ts, r = tp.push(ts, torch.from_numpy(c))
        want.append(r)

    feeder = DeviceFeeder(tp, tp.set_palette(tp.init_state(S), IDS), **fkw)
    got, seen = _feed(feeder, tfeeder, chunks, source, S)
    assert len(got) == PUSHES and len(seen) == PUSHES
    for g, w, o in zip(got, want, seen):
        assert o is g
        if fkw.get("readback") == "probe":
            assert isinstance(g, torch.Tensor)        # stays on the device
            torch.testing.assert_close(g, w, atol=0, rtol=0)
        else:
            assert isinstance(g, np.ndarray)
            np.testing.assert_array_equal(g, w.numpy())
    torch.testing.assert_close(feeder.state.carry, ts.carry, atol=0, rtol=0)
    summary = feeder.probe.summary()
    assert summary["pushes"] == PUSHES
    assert summary["rows_out"] == PUSHES * S * tp.chunk_hops
    assert summary["samples_in"] == PUSHES * S * tp.chunk_size
    assert feeder.h2d.samples == [] and feeder.device_time.samples == []   # CPU: no copy

    # the JAX package's feeder over the JAX pipeline, the same way
    jf = jfeeder.DeviceFeeder(jp, jp.set_palette(jp.init_state(S), IDS), **fkw)
    jgot, _ = _feed(jf, jfeeder, chunks, source, S)
    assert len(jgot) == PUSHES
    for g, j in zip(got, jgot):
        assert testing.rgba_u8_diff(_u8(g), _u8(j)) <= 1
    np.testing.assert_array_equal(feeder.state.carry.numpy(), np.asarray(jf.state.carry))


@pytest.mark.parametrize("k,planar", [(2, False), (3, True)])
def test_pool_slots_are_overwritten_while_the_feeder_runs(k, planar):
    """copy_chunks=False over a depth+1 pool: every slot is filled with
    garbage as soon as its push returns (on a CPU pipeline the transfer is
    a host copy, so the push keeps no view of the slot), and the rows and
    the carry still equal the sequential pushes.  At k=3 a planar chunk is
    exactly the next carry (C = 3 hops), the case where a carry could alias
    the slot."""
    jp, tp = _pipelines((("chunk_hops", k),))
    assert (tp.chunk_size == tp.carry_size) == (k == 3)
    chunks = [testing.noise(S, tp.chunk_size, seed=i) for i in range(6)]
    ts = tp.init_state(S)
    want = []
    for c in chunks:
        ts, r = tp.push(ts, torch.from_numpy(c))
        want.append(r.numpy())
    feeder = DeviceFeeder(tp, tp.init_state(S), depth=2, planar=planar, copy_chunks=False)
    pool = ChunkPool.for_feeder(feeder, S)
    assert not pool.pinned and len(pool) == 3
    got = []
    for c in chunks:
        buf = pool.next()
        buf[:] = c.transpose(0, 2, 1) if planar else c
        done = feeder.push(buf)
        buf[:] = np.nan
        if done is not None:
            got.append(done)
    got.extend(feeder.flush())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    torch.testing.assert_close(feeder.state.carry, ts.carry, atol=0, rtol=0)


def test_feeder_checks_its_arguments():
    _, tp = _pipelines((("chunk_hops", 2),))
    for bad in (0, -1):
        with pytest.raises(ValueError, match="depth"):
            DeviceFeeder(tp, tp.init_state(1), depth=bad)
    with pytest.raises(ValueError, match="readback"):
        DeviceFeeder(tp, tp.init_state(1), readback="none")
    with pytest.raises(ValueError, match=">= 2 buffers"):
        ChunkPool(1, (2, 2))
    feeder = DeviceFeeder(tp, tp.init_state(2), depth=2, planar=True)
    assert ChunkPool.for_feeder(feeder, 2, np.int16).next().shape == (2, 2, tp.chunk_size)
    assert DeviceFeeder(tp, tp.init_state(2), depth=4).flush() == []


def test_presorted_int16_drain_matches_jax_and_per_row():
    """The serving loop's drain at 256 streams: int16 words in a RingBank16,
    popped raw with dest=input_dest into an int16 ChunkPool, pushed by a
    depth-2 DeviceFeeder into i16_planes + presorted_input + sorted_output.
    rows[output_perm] equal the port's per-row pipeline fed the same words
    directly, bit for bit, and JAX's same loop within 1 u8; carries exact."""
    s, n_ticks = 256, 3
    ids = np.arange(s) % 2
    kw = dict(chunk_hops=1, store_ring=False, packed_output=True, i16_planes=True)
    full = dict(kw, presorted_input=True, sorted_output=True)
    tp = SpectrogramPipeline(BENCH64, device="cpu", **full)
    jp = JaxPipeline(JBENCH64, **JAX_KW, **full)
    per_row = SpectrogramPipeline(BENCH64, device="cpu", palette_sort=False, **kw)
    words = np.round(testing.chirp_tone(s, n_ticks * tp.chunk_size, BENCH64.sample_rate,
                                        seed=12) * 32767.0).astype(np.int16)

    def loop(pipe, ring_mod, feeder_mod):
        state = pipe.set_palette(pipe.init_state(s), ids)
        dest = pipe.input_dest(state)
        assert dest is not None and dest.dtype == np.uint64      # the sort engaged
        bank = ring_mod.RingBank16(s, 8192)
        feeder = feeder_mod.DeviceFeeder(pipe, state, depth=2, planar=True,
                                         copy_chunks=False)
        pool = feeder_mod.ChunkPool.for_feeder(feeder, s, dtype=np.int16)
        rows = []
        for t in range(n_ticks):
            bank.push_matrix(words[:, t * pipe.chunk_size : (t + 1) * pipe.chunk_size])
            chunk, counts = bank.pop_matrix_i16_planar(pipe.chunk_size, pool.next(),
                                                       dest=dest)
            assert (counts == pipe.chunk_size).all()
            done = feeder.push(chunk)
            if done is not None:
                rows.append(done)
        rows.extend(feeder.flush())
        assert bank.dropped_total == 0 and bank.min_size() == 0
        return rows, feeder.state, pipe.output_perm(feeder.state), dest

    trows, tstate, out, tdest = loop(tp, tring, tfeeder)
    jrows, jstate, jout, jdest = loop(jp, jring, jfeeder)
    np.testing.assert_array_equal(tdest, jdest)
    np.testing.assert_array_equal(out, jout)
    rs = per_row.set_palette(per_row.init_state(s), ids)
    for t, (tr, jr) in enumerate(zip(trows, jrows)):
        rs, rr = per_row.push(rs, torch.from_numpy(
            words[:, t * tp.chunk_size : (t + 1) * tp.chunk_size]))
        np.testing.assert_array_equal(tr[out], rr.numpy())
        assert testing.rgba_u8_diff(unpack_rgba(tr), unpack_rgba(np.asarray(jr))) <= 1
    np.testing.assert_array_equal(tstate.carry.numpy(), np.asarray(jstate.carry))
    inv = tp.palette_layout.global_perms(tstate.tables)[1]
    torch.testing.assert_close(tstate.carry.index_select(0, inv), rs.carry, atol=0, rtol=0)
