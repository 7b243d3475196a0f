"""The long-window cell, `long4k.k1.device`: its files are found by name,
its geometry is the configuration's, it rehearses correct at a tiny size
on the CPU, and its three readers of the large-N STFT route read what
they name and nothing else."""

import types

import pytest
from conftest import rehearse, tiny_cell

from portbench import harness
from portbench.reference import law
from portbench.work import stft

CELL = "long4k.k1.device"


def test_cell_loads_its_files():
    c = harness.cell(CELL)
    assert c.config["name"] == "serve-long48k" and c.traffic["loop"] == "device_closed"
    assert c.chips == 1 and c.config["streams"] == 4096 and c.config["reduced"] == []
    assert set(c.limits) == {"rows_u8", "rows_off_ppm", "carry_off", "perm_off", "missing"}
    assert [m for m, _ in c.metrics] == ["rows_per_s", "push_ms_p95", "setup_s"]
    layer = [m for m, _ in c.layer_metrics]
    assert {"stft_ms", "stft_roofline", "large_load_ms", "large_unpack_ms",
            "large_scratch_mb"} <= set(layer)
    assert "framing_ms.served" not in layer


def test_geometry_is_the_long_window():
    g = law.geometry(harness.cell(CELL).config["spectrogram"])
    assert (g.window, g.n_fft, g.hop, g.carry) == (32768, 65536, 800, 31968)


def test_stft_work_binds_on_operations():
    """4,096 windows of N = 65,536: 21.7 GF against 593 MB a push."""
    c = harness.cell(CELL)
    run = types.SimpleNamespace(geometry=law.geometry(c.config["spectrogram"]), k=1,
                                streams=4096, store_ring=False, wire=c.config["wire"])
    nbytes, flops = stft.work(run)
    assert 5.9e8 < nbytes < 6.0e8 and 2.1e10 < flops < 2.2e10
    assert harness.least_seconds(nbytes, flops)[1] == "f32 operations"


def test_cell_rehearses_correct():
    c = tiny_cell(CELL, streams=16)
    c.traffic.update(warmup_pushes=2)
    run, info, checks = rehearse(c, seconds=0.3, trace=True)
    assert run.units > 0 and harness.correct(checks), checks
    assert checks["carry_off"]["value"] == 0 and checks["perm_off"]["value"] == 0
    assert run.pipe.last_stft["route"] == "plain"        # the CPU runs the plain STFT
    assert harness.result(run, True, info, checks)["metrics"] == {}


def _trace(op_s, units=4):
    return types.SimpleNamespace(op_s=op_s, units=units)


def _rec(trace=None, last_stft=None):
    return types.SimpleNamespace(trace=trace, run=types.SimpleNamespace(
        pipe=types.SimpleNamespace(last_stft=last_stft)))


def test_route_readers_sum_their_kernels():
    load = harness._metric_reader("large_load_ms").read
    unpack = harness._metric_reader("large_unpack_ms").read
    rec = _rec(_trace({"large_load_local_kernel": 0.012, "large_last_unpack_kernel": 0.008,
                       "large_pass_kernel": 0.004, "colormap_tile_kernel": 1.0}))
    assert load(rec) == pytest.approx(4.0) and unpack(rec) == pytest.approx(2.0)
    for rec in (_rec(), _rec(_trace({"stft_packed_kernel": 0.01}))):
        assert load(rec) is None and unpack(rec) is None


def test_scratch_reader_reads_the_record():
    read = harness._metric_reader("large_scratch_mb").read
    large = {"route": "large", "n_fft": 65536, "rows": 4096, "groups": 1,
             "scratch_bytes": 1 << 31}
    assert read(_rec(last_stft=large)) == pytest.approx(2147.483648)
    assert read(_rec(last_stft=dict(large, route="plain", groups=0, scratch_bytes=0))) is None
    assert read(_rec()) is None                      # a program that keeps no record
    assert read(types.SimpleNamespace(run=types.SimpleNamespace(pipe=object()))) is None
