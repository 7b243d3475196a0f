"""The port's spans and counters, on the CPU.

`utils.profiling.span` opens a `spk.<name>` host range while a
`torch.profiler` records and nothing otherwise.  Held here:

  * under a CPU profiler every stage span appears with the right parent
    (its nearest enclosing `spk.` span) on four paths: a k=1 serving push
    (`i16_planes`, `presorted_input`, `sorted_output`, block-sorted over
    256-stream sort blocks), a k=1 carry-sort push that gathers the chunk
    and the rows itself, a k=8 ring push of a sorted state (the mag-bridge)
    with `render_viewport`, and a `DeviceFeeder` with `readback="full"`;
  * with no profiler, `span` is the shared null context and never enters
    a range (the range factory is patched to raise);
  * rows and the next state are bit-identical with the profiler on and off;
  * the layout counters and `last_layout` on four layouts: clustered,
    block-sorted, globally sorted and refused, and the mesh's sharded
    layouts; the push counters once a push where the path is taken;
  * `KernelLibrary.build_s` keeps the seconds `build()` returned.

Geometries as in `tests/test_torch_serving.py`: W=256, hop 64, H=64, and
BENCH_CONFIG's W=2048 with H=64 for the int16 planes.
"""

import collections
import dataclasses
import pathlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from spectrogram_tpu_torch import testing
from spectrogram_tpu_torch.config import BENCH_CONFIG, SpectrogramConfig
from spectrogram_tpu_torch.io.feeder import DeviceFeeder
from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline
from spectrogram_tpu_torch.ops.cuda import _build
from spectrogram_tpu_torch.utils import profiling

torch.set_num_threads(2)

SMALL = SpectrogramConfig(sample_rate=8000.0, window_period=0.032, hop_period=0.008,
                          viewport_height=64, viewport_rows=16)     # W=256, hop 64, H=64
BENCH64 = dataclasses.replace(BENCH_CONFIG, viewport_height=64)
STREAMING = dict(chunk_hops=1, store_ring=False, packed_output=True)

# the stage spans of one push, each under spk.push
PUSH = {"spk.wire", "spk.order.perms", "spk.frame", "spk.stft", "spk.colormap",
        "spk.state"}

# name -> (config, pipeline arguments, streams, palette ids, pushes, the
# spans beside PUSH, the push counters)
PATHS = {
    "serving_k1": (BENCH64, dict(STREAMING, i16_planes=True, presorted_input=True,
                                 sorted_output=True, stream_blocks=256),
                   512, (np.arange(512) // 64) % 2, 2, set(), {}),
    "carry_sort_k1": (SMALL, dict(STREAMING, stream_blocks=256), 512,
                      (np.arange(512) // 64) % 2, 2, {"spk.order.chunk", "spk.order.rows"},
                      {"push.order_chunk": 2, "push.order_rows": 2}),
    "ring_k8": (SMALL, dict(chunk_hops=8, packed_output=True), 256, np.arange(256) % 2, 2,
                {"spk.order.bridge", "spk.order.rows", "spk.ring"},
                {"push.bridge": 2, "push.order_rows": 2, "push.ring": 2}),
}


def _pipeline(path: str):
    cfg, kw, s, ids, pushes, _, _ = PATHS[path]
    p = SpectrogramPipeline(cfg, device="cpu", **kw)
    state = p.set_palette(p.init_state(s), ids)
    assert p.palette_layout.read(state.tables).sorted   # every path runs a sorted state
    dtype = torch.int16 if p.i16_planes else torch.float32
    pcm = testing.make("noise", s, pushes * p.chunk_size, cfg.sample_rate, seed=4)
    chunks = [torch.from_numpy(np.ascontiguousarray(
        pcm[:, i * p.chunk_size:(i + 1) * p.chunk_size].transpose(0, 2, 1)))
        for i in range(pushes)]
    if dtype == torch.int16:
        chunks = [torch.round(c * 32767).to(torch.int16) for c in chunks]
    return p, state, chunks


def _run(p, state, chunks, render: bool):
    """Push every chunk (planar); with `render`, draw the viewport after."""
    out = []
    for c in chunks:
        state, rows = p.push_planar(state, c)
        out.append(rows)
    if render:
        out.append(p.render_viewport(state))
    return state, out


def _edges(prof) -> set:
    """(span, its nearest enclosing spk. span or None) of every spk. span."""
    out = set()
    for e in prof.events():
        if not e.name.startswith(profiling.SPAN_PREFIX):
            continue
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith(profiling.SPAN_PREFIX):
            parent = parent.cpu_parent
        out.add((e.name, parent.name if parent is not None else None))
    return out


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        result = fn()
    return prof, result


@pytest.mark.parametrize("path", sorted(PATHS))
def test_push_spans_nest(path):
    p, state, chunks = _pipeline(path)
    extra, counts = PATHS[path][5], PATHS[path][6]
    render = p.store_ring
    before = collections.Counter(p.counters)
    prof, _ = _profiled(lambda: _run(p, state, chunks, render))
    want = {("spk.push", None)} | {(n, "spk.push") for n in PUSH | extra}
    if render:
        want |= {("spk.render", None), ("spk.colormap", "spk.render")}
    assert _edges(prof) == want
    pushed = {k: v - before[k] for k, v in p.counters.items() if k.startswith("push.")}
    assert {k: v for k, v in pushed.items() if v} == counts


def test_feeder_spans_nest():
    p, state, chunks = _pipeline("carry_sort_k1")
    got = []
    feeder = DeviceFeeder(p, state, depth=2, planar=True, readback="full",
                          on_rows=got.append)
    host = [c.numpy() for c in chunks]
    prof, _ = _profiled(lambda: [feeder.push(c) for c in host])
    tick = {"spk.feeder.copy_in", "spk.feeder.upload", "spk.feeder.push",
            "spk.feeder.readback", "spk.feeder.on_rows"}
    want = ({("spk.feeder.tick", None), ("spk.push", "spk.feeder.push")}
            | {(n, "spk.feeder.tick") for n in tick}
            | {(n, "spk.push") for n in PUSH | {"spk.order.chunk", "spk.order.rows"}})
    assert _edges(prof) == want
    assert len(got) == 1


@pytest.mark.parametrize("caller", ["push", "feeder"])
def test_span_off_never_enters_a_range(monkeypatch, caller):
    def refuse(name):
        raise AssertionError(f"a range was entered with no profiler: {name}")

    monkeypatch.setattr(profiling, "_range", refuse)
    assert profiling.span("push") is profiling.span("frame")        # the shared null context
    p, state, chunks = _pipeline("ring_k8")
    if caller == "push":
        _run(p, state, chunks, render=True)
    else:
        feeder = DeviceFeeder(p, state, depth=2, planar=True)
        for c in chunks:
            feeder.push(c.numpy())
        assert len(feeder.flush()) == 1


@pytest.mark.parametrize("path", sorted(PATHS))
def test_rows_equal_with_profiler_on_and_off(path):
    p, state, chunks = _pipeline(path)
    off_state, off = _run(p, state, chunks, p.store_ring)
    ring_off = off_state.ring.clone()
    # the ring is written in place: start the profiled run from a fresh one
    _, state, _ = _pipeline(path)
    _, (on_state, on) = _profiled(lambda: _run(p, state, chunks, p.store_ring))
    for a, b in zip(off, on):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    for name in ("carry", "cursor", "row_count", "palette_id"):
        torch.testing.assert_close(getattr(off_state, name), getattr(on_state, name),
                                   atol=0, rtol=0)
    torch.testing.assert_close(ring_off, on_state.ring, atol=0, rtol=0)


def _uniform(p, order_ids: np.ndarray) -> dict:
    """The blockwise rule's reading of ids in this order: row blocks of
    the colormap's size, and how many hold one palette."""
    ts = p.palette_layout.block_rows(order_ids.shape[0] * p.chunk_hops)
    nb = order_ids.shape[0] // ts
    head = order_ids[: nb * ts].reshape(nb, ts)
    return {"blocks": nb, "uniform": int((head == head[:, :1]).all(axis=1).sum())}


def _block_sorted(ids: np.ndarray, bs: int) -> np.ndarray:
    return np.concatenate([np.sort(ids[b0:b0 + bs], kind="stable")
                           for b0 in range(0, ids.shape[0], bs)])


# name -> (streams, palette ids, pipeline arguments, counters, the order
# last_layout reads: "external", "blocks" (of the sort blocks) or "global")
LAYOUTS = {
    "clustered": (256, np.arange(256) // 128, {},
                  {"layout.tests": 1, "layout.clustered": 1}, "external"),
    "block_sorted": (512, (np.arange(512) // 64) % 2, dict(stream_blocks=256),
                     {"layout.tests": 2, "layout.sorted_blocks": 1}, "blocks"),
    "global_sorted": (576, np.arange(576) % 2, dict(stream_blocks=128),
                      {"layout.tests": 3, "layout.sorted_global": 1}, "global"),
    "refused": (256, np.arange(256) % 19, {},
                {"layout.tests": 2, "layout.unsorted": 1}, "blocks"),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_layout_counters(layout):
    s, ids, kw, counts, order = LAYOUTS[layout]
    p = SpectrogramPipeline(SMALL, device="cpu", **dict(STREAMING, **kw))
    assert p.counters == {} and p.last_layout is None
    state = p.set_palette(p.init_state(s), ids)
    assert dict(p.counters) == counts
    bs = p.palette_layout.sort_block_streams(s) or s
    read = {"external": ids, "blocks": _block_sorted(ids, bs),
            "global": np.sort(ids, kind="stable")}[order]
    assert p.last_layout == _uniform(p, read)
    # a restored state takes the same decision, and counts it again
    p.restored_tables_for(state.palette_id)
    assert dict(p.counters) == {k: 2 * v for k, v in counts.items()}


@pytest.mark.parametrize("ids, counts", [
    (np.arange(512) // 128, {"layout.tests": 1, "layout.clustered": 1}),
    (np.arange(512) % 2, {"layout.tests": 2, "layout.sorted_global": 1}),
    (np.arange(512) % 19, {"layout.tests": 2, "layout.unsorted": 1})],
    ids=["clustered", "per_shard_sorted", "refused"])
def test_mesh_layouts_count(ids, counts):
    """The mesh's sharded layout (two shards of 256 streams) counts its
    decision as the pipeline's own layouts do; a carry goes into its
    stream order and back (the per-shard sort's perm confined to each
    shard)."""
    p = SpectrogramPipeline(SMALL, device="cpu", **STREAMING)
    pl = p.palette_layout
    tables = pl.tables_for(ids, shards=2)
    assert dict(p.counters) == counts
    carry = torch.arange(512 * 2 * 3, dtype=torch.float32).reshape(512, 2, 3)
    at_rest = pl.carry_from_external(carry, tables)
    v = pl.read(tables)
    if v.sorted:
        assert v.perm_global and bool((v.perm[:256] < 256).all())
        torch.testing.assert_close(at_rest, carry[v.perm.long()], atol=0, rtol=0)
    else:
        assert at_rest is carry
    torch.testing.assert_close(pl.carry_to_external(at_rest, tables), carry, atol=0, rtol=0)


def test_generic_registry_counts_generic():
    from spectrogram_tpu_torch.color.colorscheme import DEFAULT_COLOR_SCHEMES, FactoredScheme

    schemes = DEFAULT_COLOR_SCHEMES[:2] + (
        FactoredScheme("custom", *testing.custom_factors()),)
    p = SpectrogramPipeline(SMALL, device="cpu", schemes=schemes, **STREAMING)
    p.set_palette(p.init_state(8), np.arange(8) % 3)
    assert dict(p.counters) == {"layout.generic": 1}
    assert p.last_layout is None


@pytest.mark.parametrize("seconds", [0.0, 12.5])
def test_library_keeps_build_seconds(monkeypatch, seconds):
    class FakeDll:
        def __getattr__(self, name):
            return type("Entry", (), {})()

    monkeypatch.setattr(_build, "build", lambda: (pathlib.Path("libfake.so"), seconds))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeDll())
    _build.library.cache_clear()
    try:
        lib = _build.library()
        assert lib.build_s == seconds
        assert lib.path == pathlib.Path("libfake.so")
    finally:
        _build.library.cache_clear()
