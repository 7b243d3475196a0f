"""The trace reduction on a synthetic timeline: the union of busy intervals
(overlaps counted once), the layer attribution by kernel and launching op,
unattributed operations kept, and idle gaps named by the host's span."""

import pytest
import torch

from portbench import trace


def ev(i, name, start, end, device=False, parent=None, link=0):
    return trace.Event(name, device, start, end, id=i, link=link, parent=parent)


def test_reduce_synthetic_timeline():
    unit = ev(1, trace.HOST_LABEL, 0.0, 100.0)
    stack = ev(2, "aten::stack", 10.0, 20.0, parent=unit)
    cat_in_stack = ev(3, "aten::cat", 11.0, 19.0, parent=stack)
    cat = ev(4, "aten::cat", 30.0, 40.0, parent=unit)
    events = [unit, stack, cat_in_stack, cat,
              ev(10, "void at::native::CatArrayBatchedCopy<float>(x)", 50.0, 60.0, True, link=3),
              ev(11, "void at::native::CatArrayBatchedCopy<float>(x)", 60.0, 70.0, True, link=4),
              ev(12, "void stft_packed_kernel<Body>(x)", 65.0, 90.0, True),
              ev(13, "weird_kernel", 120.0, 130.0, True),
              ev(14, "early_kernel", -20.0, 5.0, True)]
    rec = trace.reduce(events, units=2)
    assert rec.window_s == pytest.approx(130e-6)
    assert rec.busy_s == pytest.approx((5 + 40 + 10) * 1e-6)
    assert rec.bucket_s == pytest.approx({"gather": 10e-6, "framing": 10e-6, "stft": 25e-6})
    assert rec.per_unit_ms("stft") == pytest.approx(25e-6 * 1e3 / 2)
    assert rec.per_unit_ms("h2d") == 0.0
    assert list(rec.unattributed) == ["weird_kernel @ -"]
    assert rec.bucket_ops["gather"] == {"CatArrayBatchedCopy @ aten::stack": pytest.approx(10e-6)}
    assert rec.bucket_ops["framing"] == {"CatArrayBatchedCopy @ aten::cat": pytest.approx(10e-6)}
    assert [round(s * 1e6) for _, s in rec.gaps] == [45, 30]
    assert rec.gaps[1][0] == trace.HOST_LABEL
    b = rec.breakdown()
    assert b["device_ops"][0] == ["stft_packed_kernel", pytest.approx(25e-6)]
    assert len(b["idle_gaps"]) == 2


def test_short_names():
    assert trace.short_name("void (anonymous namespace)::colormap_tile_kernel<3>(TileArgs)") \
        == "colormap_tile_kernel"
    assert trace.short_name("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH"


def test_events_of_a_cpu_profile_nest():
    """The raw events of a real profile, host spans nested by thread."""
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.randn(64, 64)
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with record_function(trace.HOST_LABEL):
        torch.stack([x, x]).to(torch.bfloat16)
    prof.stop()
    evs = trace.events(prof)
    cat = next(e for e in evs if e.name == "aten::cat")
    assert trace._op_path(cat).startswith(trace.HOST_LABEL + "/aten::stack/aten::cat")


def test_nest_by_thread():
    a = trace.Event("a", False, 0.0, 10.0, thread=1)
    b = trace.Event("b", False, 2.0, 5.0, thread=1)
    c = trace.Event("c", False, 3.0, 4.0, thread=2)
    d = trace.Event("d", False, 6.0, 8.0, thread=1)
    trace.nest([d, c, b, a])
    assert (b.parent, c.parent, d.parent, a.parent) == (a, None, a, None)


def test_attribution_takes_the_launching_op_whole():
    """An op rule matches the ATen op the program called, whole: a kernel
    under `aten::addmm` is no `aten::add`'s, and stays unattributed; a named
    kernel wins over an op rule; an op-only rule takes no copy."""
    table = trace.rules()
    assert trace.launching_op("portbench.unit/aten::addmm/aten::add/cudaLaunchKernel") \
        == "aten::addmm"
    assert trace.launching_op("portbench.unit/cudaLaunchKernel") == ""
    assert trace.attribute("elementwise_kernel", "aten::addmm", table) is None
    assert trace.attribute("elementwise_kernel", "aten::add", table) == "bookkeeping"
    assert trace.attribute("elementwise_kernel", "aten::add_", table) is None
    assert trace.attribute("colormap_tile_kernel", "aten::add", table) == "colormap"
    assert trace.attribute("Memcpy HtoD", "aten::to", table) == "h2d"
    assert trace.attribute("Memset (Device)", "aten::to", table) is None
    assert trace.attribute("elementwise_kernel", "aten::to", table) == "gather"
    assert trace.attribute("CatArrayBatchedCopy", "aten::stack", table) == "gather"
    assert trace.attribute("CatArrayBatchedCopy", "aten::cat", table) == "framing"
    assert trace.attribute("CatArrayBatchedCopy", "aten::concat", table) is None


def test_idle_share_reads_the_untraced_wall_time():
    """Busy time a unit from the stretch against the wall time a unit of the
    window before it: 0.8 ms busy in 1 ms a unit is 20% idle."""
    import types

    from portbench import harness

    rec = types.SimpleNamespace(
        trace=types.SimpleNamespace(units=200, busy_s=0.16), untraced=(1000, 1.0))
    assert harness._metric_reader("idle_share").read(rec) == pytest.approx(20.0)
    assert harness._metric_reader("idle_share.served").read(rec) == pytest.approx(20.0)
    rec.untraced = None
    assert harness._metric_reader("idle_share").read(rec) is None
