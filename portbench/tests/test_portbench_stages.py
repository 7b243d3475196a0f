"""The program's `spk.` spans in the trace, on synthetic timelines: host
spans leave the reduction's numbers as they were and name the idle gaps;
`stages` gives device time, host time and idle time by span; the
`uniform_block_share` reader reads the pipeline's `last_layout`, and
nothing from a program that keeps none."""

import types

import pytest

from portbench import harness, stages, trace


def ev(i, name, start, end, device=False, parent=None, link=0):
    return trace.Event(name, device, start, end, id=i, link=link, parent=parent)


def _timeline(spans: bool) -> list:
    """Two units: a stack (ring) and a cat (framing) launched by ATen ops,
    an STFT kernel launched by the program itself, a kernel no rule takes,
    a copy waited on; with `spans`, the program's spans around them and the
    profiler's device-side copy of one of them."""
    u1 = ev(1, trace.HOST_LABEL, 0.0, 100.0)
    u2 = ev(2, trace.HOST_LABEL, 100.0, 200.0)
    push = ev(20, "spk.push", 1.0, 99.0, parent=u1) if spans else u1
    ring = ev(21, "spk.ring", 10.0, 25.0, parent=push) if spans else push
    frame = ev(22, "spk.frame", 30.0, 45.0, parent=push) if spans else push
    stft = ev(23, "spk.stft", 46.0, 50.0, parent=push) if spans else push
    wait = ev(24, "spk.feeder.readback", 110.0, 190.0, parent=u2) if spans else u2
    stack = ev(3, "aten::stack", 11.0, 20.0, parent=ring)
    cat_in_stack = ev(4, "aten::cat", 12.0, 19.0, parent=stack)
    cat = ev(5, "aten::cat", 31.0, 40.0, parent=frame)
    launch = ev(6, "cudaLaunchKernel", 47.0, 48.0, parent=stft)
    copy = ev(7, "aten::copy_", 111.0, 189.0, parent=wait)
    sync = ev(8, "cudaStreamSynchronize", 112.0, 188.0, parent=copy)
    evs = [u1, u2, stack, cat_in_stack, cat, launch, copy, sync,
           ev(10, "void at::native::CatArrayBatchedCopy<float>(x)", 50.0, 60.0, True, link=4),
           ev(11, "void at::native::CatArrayBatchedCopy<float>(x)", 60.0, 70.0, True, link=5),
           ev(12, "void stft_packed_kernel<Body>(x)", 70.0, 95.0, True, link=6),
           ev(13, "weird_kernel", 120.0, 130.0, True, link=7),
           ev(14, "Memcpy DtoH (Device -> Pinned)", 150.0, 180.0, True, link=7),
           ev(15, "early_kernel", -20.0, 5.0, True)]
    if spans:
        evs += [push, ring, frame, stft, wait,
                ev(30, "spk.push", 50.0, 95.0, True)]        # the range's device-side copy
    return evs


def test_spans_leave_the_reduction_as_it_was():
    """Busy and window time, layers, unattributed operations and gap lengths
    are the same with the program's host spans in the trace; the gaps and
    the unattributed operations' launch chains are named by them."""
    bare = trace.reduce(_timeline(False), units=2)
    spanned = trace.reduce([e for e in _timeline(True) if e.name != "spk.push" or not e.device],
                           units=2)
    for name in ("busy_s", "window_s", "bucket_s"):
        assert getattr(spanned, name) == pytest.approx(getattr(bare, name)), name
    assert spanned.bucket_ops == bare.bucket_ops
    assert bare.unattributed == {"weird_kernel @ aten::copy_": (1, pytest.approx(10e-6))}
    assert spanned.unattributed == {
        "weird_kernel @ spk.feeder.readback/aten::copy_": (1, pytest.approx(10e-6))}
    assert [s for _, s in spanned.gaps] == pytest.approx([s for _, s in bare.gaps])
    assert [g[0] for g in bare.gaps] == [
        "portbench.unit", "portbench.unit", "portbench.unit/aten::copy_/cudaStreamSynchronize"]
    assert [g[0] for g in spanned.gaps] == [
        "portbench.unit/spk.push", "portbench.unit/spk.push",
        "portbench.unit/spk.feeder.readback/aten::copy_/cudaStreamSynchronize"]


def test_stage_seconds_by_innermost_span():
    evs = _timeline(True)
    assert stages.stage_s(evs) == pytest.approx(
        {"spk.ring": 10e-6, "spk.frame": 10e-6, "spk.stft": 25e-6,
         "spk.feeder.readback": 40e-6})
    assert stages.stage_s(_timeline(False)) == pytest.approx({"-": 85e-6})


def test_span_host_seconds_and_self_time():
    got = stages.span_host_s(_timeline(True))
    want = {"spk.push": [98, 98 - 15 - 15 - 4], "spk.ring": [15, 15], "spk.frame": [15, 15],
            "spk.stft": [4, 4], "spk.feeder.readback": [80, 80]}
    assert {k: [round(s * 1e6, 6) for s in v] for k, v in got.items()} == want
    assert stages.span_host_s(_timeline(False)) == {}


def test_stage_idle_by_gap_label():
    rec = trace.reduce([e for e in _timeline(True) if e.name != "spk.push" or not e.device],
                       units=2)
    assert stages.stage_idle_s(rec.gaps) == pytest.approx(
        {"spk.feeder.readback": 20e-6, "spk.push": 70e-6})
    assert stages.stage_idle_s([("portbench.unit/aten::copy_", 1.0),
                                ("ts.feeder.tick/spk.feeder.readback/aten::copy_", 2.0)]) \
        == {"-": 1.0, "spk.feeder.readback": 2.0}


@pytest.mark.parametrize("layout, want", [
    ({"blocks": 32, "uniform": 17}, 53.125), ({"blocks": 16, "uniform": 6}, 37.5),
    ({"blocks": 0, "uniform": 0}, None), (None, None), ("absent", None)])
def test_uniform_block_share_reads_last_layout(layout, want):
    pipe = types.SimpleNamespace() if layout == "absent" \
        else types.SimpleNamespace(last_layout=layout)
    rec = types.SimpleNamespace(run=types.SimpleNamespace(pipe=pipe))
    got = harness._metric_reader("uniform_block_share").read(rec)
    assert got == (pytest.approx(want) if want is not None else None)
