"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""

import importlib
import json
import math
import re

from conftest import CELLS, ROOT

from portbench import harness, trace

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_limits():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and (ROOT / "portbench").is_dir()
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert all("/" not in w and ".." not in w for w in b["command"])
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    full = 2 + 14 * 24
    assert full * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_entries_have_exactly_the_contract_keys():
    b = bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert (ROOT / c["file"]).is_file() and 1 <= len(c["source"]) <= 200
        assert 1 <= len(c["why"]) <= 200 and len(c["reduced"]) <= 16
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(set(pairs)) == len(pairs)
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names)
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in [e["name"] for e in b["end_to_end"]]
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        for cell in m.get("workloads", []):
            assert cell in CELLS


def test_every_cell_reports_setup_another_metric_and_a_layer():
    b = bench()
    assert [w["name"] for w in b["workloads"]] == list(CELLS)
    for name in CELLS:
        c = harness.cell(name)
        e2e = [m for m, _ in c.metrics]
        assert "setup_s" in e2e and len(e2e) >= 2 and c.layer_metrics
        for m in b["per_layer"]:
            if name in m.get("workloads", [name]):
                assert m["moves"] in e2e


def test_every_file_is_found_by_name():
    b = bench()
    for name in CELLS:
        c = harness.cell(name)
        assert importlib.import_module(f"portbench.loops.{c.traffic['loop']}")
        assert set(c.limits) >= {"rows_u8", "rows_off_ppm", "carry_off", "perm_off", "missing"}
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(harness._metric_reader(m["name"]).read)
    for layer in ("stft", "colormap"):
        assert callable(importlib.import_module(f"portbench.work.{layer}").work)


def test_layer_rules_load():
    rules = trace.rules()
    assert {r.bucket for r in rules} >= {"framing", "gather", "stft", "colormap", "h2d",
                                         "readback"}
    # named kernels first, those with an op condition before those without;
    # rules that name only an op last
    order = [(r.kernel is None, r.op is None) for r in rules]
    assert order == sorted(order)
    assert all(r.kernel is not None or r.op is not None for r in rules)


def test_configs_state_what_the_contract_asks():
    for path in (ROOT / "portbench" / "configs").glob("*.json"):
        c = json.loads(path.read_text())
        assert c["name"] == path.stem and c["guarantees"] and c["reduced"] == []
        assert c["wire"]["dtype"] in ("int16", "float32")
        assert not math.isnan(c["spectrogram"]["window_period"])
