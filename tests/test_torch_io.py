"""The port's host-ingest layer against the JAX package's, on the CPU.

`spectrogram_tpu_torch/io/ring.py` binds its own copy of the native ring
source (held byte for byte against the JAX package's), built by its own g++
call into `build/host/`; `io/sources.py`, `io/registry.py` and
`utils/probe.py` are copies.  Here:

  * the rings: the port's `StereoRing`, `RingBank` and `RingBank16` and the
    JAX package's, fed the same seeded frames by the same seeded sequence of
    operations (push, push_matrix, push_matrix_range, push_matrix_planar,
    pop, peek, skip, the f32, planar and raw-int16 drains with and without
    `dest`, reset), give equal pops, counts, sizes and drops, bit for bit:
    the native rings against each other, the numpy rings against each other,
    and the port's native ring against its numpy plain version; a
    cross-thread producer/consumer loses and reorders nothing in either;
    the port's native banks are resident once made (every page written at
    construction) and left as new;
  * the port's loader: a failed build raises with the compiler's output and
    never falls back; concurrent builds into one directory (per-process
    temporary files, then a rename) leave one loadable library; a `dest`
    entry >= S raises ValueError on every drain;
  * the copies: the same source text function by function, the same seeded
    blocks, the same WAV round trip, the same enumeration and lockstep
    `StreamBatch` pops.
"""

import ctypes
import gc
import inspect
import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from spectrogram_tpu.io import registry as jreg
from spectrogram_tpu.io import ring as jring
from spectrogram_tpu.io import sources as jsrc
from spectrogram_tpu.utils import probe as jprobe

from spectrogram_tpu_torch.io import registry as treg
from spectrogram_tpu_torch.io import ring as tring
from spectrogram_tpu_torch.io import sources as tsrc
from spectrogram_tpu_torch.utils import probe as tprobe

REPO = pathlib.Path(__file__).resolve().parents[1]

# (port ring, JAX ring): each "numpy" side has its `_load_library` replaced
# by one that returns None, as tests/test_ring.py does for the JAX package
PAIRINGS = {
    "native_vs_jax_native": ("native", "native"),
    "numpy_vs_jax_numpy": ("numpy", "numpy"),
    "native_vs_own_numpy": ("native", "port_numpy"),
}


def _use_numpy(monkeypatch, mod):
    monkeypatch.setattr(mod, "_load_library", lambda: None)


@pytest.fixture(params=sorted(PAIRINGS))
def pairing(request, monkeypatch):
    """(make(cls_name, *args) for side a, for side b): side a is always the
    port's module; side b the JAX package's or, for the plain-version
    comparison, the port's numpy ring."""
    a, b = PAIRINGS[request.param]
    if b == "native" and not jring.native_available():
        pytest.fail("the JAX package's native ring did not build")
    if a == "numpy":
        _use_numpy(monkeypatch, tring)
        _use_numpy(monkeypatch, jring)
    if b == "port_numpy":
        # build the native library first, then construct side b's objects
        # with the loader replaced only while they are made
        assert tring.native_available()

        def make_b(name, *args, **kw):
            with monkeypatch.context() as m:
                _use_numpy(m, tring)
                return getattr(tring, name)(*args, **kw)
    else:
        def make_b(name, *args, **kw):
            return getattr(jring, name)(*args, **kw)

    def make_a(name, *args, **kw):
        return getattr(tring, name)(*args, **kw)

    return make_a, make_b


def _frames(rng, n):
    return rng.standard_normal((n, 2)).astype(np.float32)


def _words(rng, shape):
    return rng.integers(-32768, 32768, shape, dtype=np.int16)


def _same(a, b):
    """Equal results: arrays bit for bit (dtype and shape too), tuples and
    scalars by value."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("seed", [0, 1])
def test_stereo_ring_ops_equal(pairing, seed):
    """FIFO, peek/skip, wraparound and overrun: 60 seeded operations on a
    64-frame ring (capacity 50 rounds up to 64 in both)."""
    make_a, make_b = pairing
    a, b = make_a("StereoRing", 50), make_b("StereoRing", 50)
    assert a.capacity == b.capacity == 64
    rng = np.random.default_rng(seed)
    for _ in range(60):
        op = rng.choice(["push", "pop", "peek", "skip"], p=[0.4, 0.3, 0.15, 0.15])
        n = int(rng.integers(0, 40))
        if op == "push":
            f = _frames(rng, n)
            _same(a.push(f), b.push(f))
        else:
            _same(getattr(a, op)(n), getattr(b, op)(n))
        _same((len(a), a.dropped), (len(b), b.dropped))
    assert a.dropped > 0          # the sequence overran the ring


@pytest.mark.parametrize("seed", [0, 1])
def test_ring_bank_ops_equal(pairing, seed):
    """push, push_matrix, pop_matrix and pop_matrix_planar with and without
    `dest`, sizes and drops per stream, on a 5-stream bank of 32 frames."""
    make_a, make_b = pairing
    s = 5
    a, b = make_a("RingBank", s, 32, n_threads=2), make_b("RingBank", s, 32, n_threads=2)
    rng = np.random.default_rng(seed)
    for _ in range(50):
        op = rng.choice(["push", "push_matrix", "pop_matrix", "pop_matrix_planar"])
        n = int(rng.integers(1, 24))
        if op == "push":
            st, f = int(rng.integers(s)), _frames(rng, n)
            _same(a.push(st, f), b.push(st, f))
        elif op == "push_matrix":
            block = rng.standard_normal((s, n, 2)).astype(np.float32)
            _same(a.push_matrix(block), b.push_matrix(block))
        else:
            dest = rng.permutation(s).astype(np.uint64) if rng.random() < 0.5 else None
            _same(getattr(a, op)(n, dest=dest), getattr(b, op)(n, dest=dest))
        _same((a.min_size(), a.dropped_total), (b.min_size(), b.dropped_total))
        for st in range(s):
            _same((a.size(st), a.dropped(st)), (b.size(st), b.dropped(st)))
    assert a.dropped_total > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ring_bank16_ops_equal(seed):
    """The int16 bank (native on both sides): push, push_matrix,
    push_matrix_range, push_matrix_planar, the f32, planar f32 and raw int16
    drains with and without `dest` (into fresh and caller buffers), reset,
    sizes and drops, on a 6-stream bank of 32 frames."""
    if not jring.native_available():
        pytest.fail("the JAX package's native ring did not build")
    s = 6
    a, b = tring.RingBank16(s, 32, n_threads=3), jring.RingBank16(s, 32, n_threads=3)
    assert a.capacity == b.capacity == 32
    rng = np.random.default_rng(seed)
    ops = ["push", "push_matrix", "push_matrix_range", "push_matrix_planar",
           "pop_matrix_f32", "pop_matrix_f32_planar", "pop_matrix_i16_planar", "reset"]
    for _ in range(80):
        op = ops[int(rng.integers(len(ops)))]
        n = int(rng.integers(1, 20))
        if op == "push":
            st, w = int(rng.integers(s)), _words(rng, (n, 2))
            _same(a.push(st, w), b.push(st, w))
        elif op in ("push_matrix", "push_matrix_planar"):
            w = _words(rng, (s, n, 2) if op == "push_matrix" else (s, 2, n))
            _same(getattr(a, op)(w), getattr(b, op)(w))
        elif op == "push_matrix_range":
            lo = int(rng.integers(s))
            w = _words(rng, (int(rng.integers(1, s - lo + 1)), n, 2))
            _same(a.push_matrix_range(lo, w), b.push_matrix_range(lo, w))
        elif op == "reset":
            st = int(rng.integers(s))
            a.reset(st), b.reset(st)
        else:
            dest = rng.permutation(s).astype(np.uint64) if rng.random() < 0.5 else None
            if rng.random() < 0.5:
                _same(getattr(a, op)(n, dest=dest), getattr(b, op)(n, dest=dest))
            else:       # into caller buffers, as a ChunkPool slot is drained
                shape = (s, n, 2) if op == "pop_matrix_f32" else (s, 2, n)
                dtype = np.int16 if op == "pop_matrix_i16_planar" else np.float32
                oa, ob = np.full(shape, 7, dtype), np.full(shape, 7, dtype)
                ra, rb = getattr(a, op)(n, oa, dest=dest), getattr(b, op)(n, ob, dest=dest)
                assert ra[0] is oa and rb[0] is ob
                _same(ra, rb)
        _same((a.min_size(), a.dropped_total), (b.min_size(), b.dropped_total))
        for st in range(s):
            _same(a.size(st), b.size(st))
    assert a.dropped_total > 0


def _rss_bytes() -> int:
    status = pathlib.Path("/proc/self/status").read_text()
    return next(int(line.split()[1]) * 1024 for line in status.splitlines()
                if line.startswith("VmRSS:"))


@pytest.mark.parametrize("kind", ["RingBank", "RingBank16"])
def test_native_bank_resident_once_made(kind):
    """A native bank writes every page of its rings when it is made, so a
    serving loop's first hops pay no first-touch page faults: the process's
    resident set grows by the rings' bytes in the constructor.  The bank is
    then as new (empty, nothing dropped) and passes frames through unchanged
    across the capacity's wrap."""
    cls, dtype, itemsize = {"RingBank": (tring.RingBank, np.float32, 4),
                            "RingBank16": (tring.RingBank16, np.int16, 2)}[kind]
    s, cap = 2048, 4096
    gc.collect()
    # hand the heap's free pages back first: tests run before this one in
    # the process may have left freed pages resident, which the bank's
    # allocation would reuse without growing the resident set
    ctypes.CDLL("libc.so.6").malloc_trim(0)
    before = _rss_bytes()
    bank = cls(s, cap, n_threads=2)
    grown = _rss_bytes() - before
    assert bank._handle and bank.capacity == cap
    assert grown >= 0.9 * s * cap * 2 * itemsize, (grown, s * cap * 2 * itemsize)
    assert bank.min_size() == 0 and bank.dropped_total == 0
    rng = np.random.default_rng(7)
    pop = bank.pop_matrix_planar if kind == "RingBank" else bank.pop_matrix_i16_planar
    for _ in range(3):                                   # 3 x 3000 frames: wraps twice
        block = (_words(rng, (s, 3000, 2)) if kind == "RingBank16"
                 else rng.standard_normal((s, 3000, 2)).astype(dtype))
        bank.push_matrix(block)
        out, counts = pop(3000)
        np.testing.assert_array_equal(out, block.transpose(0, 2, 1))
        assert (counts == 3000).all()
    assert bank.min_size() == 0 and bank.dropped_total == 0


@pytest.mark.parametrize("resident", [False, True], ids=["as_malloc_left_them", "resident"])
def test_ingest_probe_round_on_the_cpu(resident):
    """`ingest_probe.paced_round` at a small size on the CPU: every hop is
    drained in order, nothing is dropped, and each hop's lateness is
    reported for both kinds of bank."""
    from spectrogram_tpu_torch import ingest_probe
    rng = np.random.default_rng(3)
    s, t = 512, 4
    hops = _words(rng, (t, s, ingest_probe.HOP_FRAMES, 2))
    dest = rng.permutation(s).astype(np.uint64)
    pool = [np.empty((s, 2, ingest_probe.HOP_FRAMES), np.int16) for _ in range(3)]
    row = ingest_probe.paced_round(hops, dest, pool, 4096, resident, torch.device("cpu"))
    assert row["rings"] == ("resident" if resident else "as malloc left them")
    assert row["dropped"] == 0 and row["stalled_at_tick"] is None and not row["errors"]
    assert len(row["worst_lateness_per_hop_ms"]) == t and row["first_drain_ms"] is not None
    last = pool[(t - 1) % 3]                        # the last hop, in dest order
    np.testing.assert_array_equal(last[dest.astype(np.int64)], hops[-1].transpose(0, 2, 1))


@pytest.mark.parametrize("side", ["port", "jax"])
def test_cross_thread_producer_consumer(side):
    """The native SPSC ring across two threads: nothing lost, duplicated or
    reordered (the audio-callback/UI-thread boundary), in both packages."""
    mod = tring if side == "port" else jring
    if not mod.native_available():
        pytest.fail(f"the {side} native ring did not build")
    r = mod.StereoRing(1 << 12)
    total = 100_000
    received = []

    def producer():
        rng = np.random.default_rng(3)
        sent = 0
        while sent < total:
            n = min(int(rng.integers(1, 512)), total - sent)
            base = np.arange(sent, sent + n, dtype=np.float32)
            sent += r.push(np.stack([base, -base], axis=-1))   # re-offer the rest

    def consumer():
        count = 0
        while count < total:
            out = r.pop(1024)
            if len(out):
                received.append(out.copy())
                count += len(out)

    threads = [threading.Thread(target=producer), threading.Thread(target=consumer)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    got = np.concatenate(received)
    np.testing.assert_array_equal(got[:, 0], np.arange(total, dtype=np.float32))
    np.testing.assert_array_equal(got[:, 1], -np.arange(total, dtype=np.float32))


# ------------------------------------------------------------------ the loader

def test_native_source_is_the_jax_packages():
    port = REPO / "spectrogram_tpu_torch" / "native" / "ring_buffer.cpp"
    assert tring.SOURCE == port
    assert port.read_bytes() == (REPO / "spectrogram_tpu" / "native" / "ring_buffer.cpp").read_bytes()


def test_library_built_from_the_ports_copy():
    lib = tring._load_library()
    path = pathlib.Path(lib._name)
    assert path == tring.BUILD_DIR / tring.LIBRARY_NAME
    assert path.parent == REPO / "build" / "host"
    assert (path.parent / (tring.LIBRARY_NAME + ".sha256")).read_text() == tring._digest()


@pytest.mark.parametrize("breakage", ["compiler_fails", "bad_flag", "no_compiler"])
def test_failed_build_raises_without_fallback(breakage, monkeypatch, tmp_path):
    """A build that fails raises RuntimeError with the compiler's output,
    from every constructor and from native_available(); nothing falls back
    to the numpy ring or to a library built earlier."""
    monkeypatch.setattr(tring, "_LIB", None)
    monkeypatch.setattr(tring, "BUILD_DIR", tmp_path)
    # a library from an earlier build with a stale stamp is not loaded
    (tmp_path / tring.LIBRARY_NAME).write_bytes(b"stale")
    (tmp_path / (tring.LIBRARY_NAME + ".sha256")).write_text("stale")
    if breakage == "compiler_fails":
        monkeypatch.setattr(tring, "CXX", "false")
        match = "failed"
    elif breakage == "bad_flag":
        monkeypatch.setattr(tring, "CXX_FLAGS", (*tring.CXX_FLAGS, "-fno-such-option-xyz"))
        match = "no-such-option-xyz"
    else:
        monkeypatch.setattr(tring, "CXX", str(tmp_path / "no-such-compiler"))
        match = "no-such-compiler"
    for make in (tring.native_available, lambda: tring.StereoRing(8),
                 lambda: tring.RingBank(2, 8), lambda: tring.RingBank16(2, 8)):
        with pytest.raises(RuntimeError, match=match):
            make()
    assert tring._LIB is None
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        tring.LIBRARY_NAME, tring.LIBRARY_NAME + ".sha256"]


def test_concurrent_builds_leave_one_library(tmp_path):
    """Four processes build into one directory at once, over a stale
    library: each compiles to its own temporary file and renames it, so all
    four succeed, no temporary file is left, and the library loads."""
    (tmp_path / tring.LIBRARY_NAME).write_bytes(b"stale")
    (tmp_path / (tring.LIBRARY_NAME + ".sha256")).write_text("stale")
    code = ("import sys, pathlib\n"
            "from spectrogram_tpu_torch.io import ring\n"
            "print(ring.build(pathlib.Path(sys.argv[1])))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        tring.LIBRARY_NAME, tring.LIBRARY_NAME + ".sha256"]
    assert (tmp_path / (tring.LIBRARY_NAME + ".sha256")).read_text() == tring._digest()
    lib = ctypes.CDLL(str(tmp_path / tring.LIBRARY_NAME))
    assert lib.bank16_create and lib.bank16_pop_matrix_i16_planar_perm


@pytest.mark.parametrize("impl", ["native", "numpy"])
def test_dest_out_of_range_raises_value_error(impl, monkeypatch):
    """A `dest` entry >= S raises ValueError (not numpy's IndexError) on
    every drain that takes one, before any frame moves."""
    s, n = 4, 3
    bad = np.array([0, 1, 2, 4], np.uint64)
    negative = np.array([0, 1, 2, -1])            # wraps to 2^64 - 1
    if impl == "numpy":
        _use_numpy(monkeypatch, tring)
    bank = tring.RingBank(s, 16)
    bank.push_matrix(np.ones((s, n, 2), np.float32))
    drains = [bank.pop_matrix, bank.pop_matrix_planar]
    if impl == "native":
        bank16 = tring.RingBank16(s, 16)
        bank16.push_matrix(np.ones((s, n, 2), np.int16))
        drains += [bank16.pop_matrix_f32, bank16.pop_matrix_f32_planar,
                   bank16.pop_matrix_i16_planar]
    for drain in drains:
        for dest in (bad, negative):
            with pytest.raises(ValueError, match=r"dest entries must lie in \[0, 4\)"):
                drain(n, dest=dest)
    assert bank.min_size() == n
    if impl == "native":
        assert bank16.min_size() == n


def test_numpy_ring_only_where_the_loader_is_replaced(monkeypatch):
    """With the loader replaced, StereoRing and RingBank run the numpy ring
    and RingBank16 raises, as in the JAX package."""
    assert tring.native_available()
    assert tring.StereoRing(8)._handle
    _use_numpy(monkeypatch, tring)
    assert not tring.native_available()
    assert tring.StereoRing(8)._handle is None
    assert tring.RingBank(2, 8)._handle is None
    with pytest.raises(RuntimeError, match="native library"):
        tring.RingBank16(2, 8)


# ------------------------------------------------------------------ the copies

def _defined_here(mod):
    return {name: obj for name, obj in vars(mod).items()
            if (inspect.isclass(obj) or inspect.isfunction(obj))
            and obj.__module__ == mod.__name__}


@pytest.mark.parametrize("pair", ["sources", "registry", "probe"])
def test_copies_have_the_jax_source(pair):
    """Every class and function of the copied modules has the JAX package's
    source text (only the module docstrings and imports differ)."""
    jmod, tmod = {"sources": (jsrc, tsrc), "registry": (jreg, treg),
                  "probe": (jprobe, tprobe)}[pair]
    jdefs, tdefs = _defined_here(jmod), _defined_here(tmod)
    assert sorted(jdefs) == sorted(tdefs) and jdefs
    for name in jdefs:
        assert inspect.getsource(jdefs[name]) == inspect.getsource(tdefs[name]), name


def test_sources_give_the_same_blocks():
    """Seeded synthesis, block by block, and channel adaptation."""
    for make in (lambda m: m.SineSource(8000.0, 400.0, 523.0),
                 lambda m: m.ChirpSource(8000.0, duration=0.5),
                 lambda m: m.NoiseSource(seed=4)):
        a, b = make(tsrc), make(jsrc)
        for n in (100, 37, 4000):
            np.testing.assert_array_equal(a.next_block(n), b.next_block(n))
    rng = np.random.default_rng(5)
    for block in (rng.standard_normal(9), rng.standard_normal((9, 1)),
                  rng.standard_normal((9, 2))):
        np.testing.assert_array_equal(tsrc.adapt_channels(block), jsrc.adapt_channels(block))
    for mod in (tsrc, jsrc):
        with pytest.raises(ValueError):
            mod.adapt_channels(np.ones((5, 3), np.float32))
    assert tsrc.CaptureSource.available() == jsrc.CaptureSource.available()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_wav_round_trip_across_packages(writer, tmp_path):
    """A WAV written by one package reads back the same in both."""
    pcm = (np.random.default_rng(6).random((1000, 2)).astype(np.float32) - 0.5) * 0.8
    path = tmp_path / "t.wav"
    (tsrc if writer == "port" else jsrc).write_wav(path, pcm, 48000)
    a, b = tsrc.WavSource(path), jsrc.WavSource(path)
    assert (a.sample_rate, a.channels, a.num_frames) == (b.sample_rate, b.channels, b.num_frames)
    back = a.read_all()
    np.testing.assert_array_equal(back, b.read_all())
    np.testing.assert_allclose(back, pcm, atol=2.0 / 32767)
    for x, y in zip(a.blocks(256), b.blocks(256)):
        np.testing.assert_array_equal(x, y)


def test_registry_enumerates_the_same_inputs():
    a, b = treg.InputRegistry(), jreg.InputRegistry()
    assert [(d.name, d.kind, d.sample_rate, d.device_index) for d in a.inputs] == [
        (d.name, d.kind, d.sample_rate, d.device_index) for d in b.inputs]
    assert isinstance(a.ring, tring.StereoRing)
    desc = a.select(len(a) - 1)
    assert desc.kind == "synthetic" and a.sample_rate == 48000.0
    pump = a._active
    a.stop()
    assert not pump.is_alive()


def test_stream_batch_lockstep_pops_equal():
    """Attached seeded sources, ticks and lockstep pops, partial attach."""
    batches = []
    for reg in (treg, jreg):
        batch = reg.StreamBatch(4, ring_capacity=1024)
        src = tsrc if reg is treg else jsrc
        batch.attach_all(lambda s, src=src: src.SineSource(8000.0, 100.0 * (s + 1), 50.0))
        batches.append(batch)
    for batch in batches:
        batch.tick(300)
    assert batches[0].ready_chunks(128) == batches[1].ready_chunks(128) == 2
    for _ in range(2):
        _same(batches[0].pop_chunk(128), batches[1].pop_chunk(128))
    assert batches[0].dropped_total == batches[1].dropped_total == 0
    partial = treg.StreamBatch(4, ring_capacity=1024)
    partial.attach(1, tsrc.NoiseSource(seed=2))
    partial.tick(256)
    assert partial.ready_chunks(128) == 2
    with pytest.raises(IndexError):
        partial.attach(9, tsrc.NoiseSource())


def test_probe_counts_equal():
    a, b = tprobe.ThroughputProbe(), jprobe.ThroughputProbe()
    for probe in (a, b):
        probe.record_push(16, 800, 1)
        probe.record_push(16, 800, 1)
        probe.record_drops(3)
    keys = ("pushes", "samples_in", "rows_out", "dropped_frames")
    sa, sb = a.summary(), b.summary()
    assert sorted(sa) == sorted(sb)
    assert [sa[k] for k in keys] == [sb[k] for k in keys] == [2, 25600, 32, 3]
