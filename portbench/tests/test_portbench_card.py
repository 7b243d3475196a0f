"""On the card: each cell runs as the check runs it and comes out correct,
with its end-to-end metrics, and its traced run with the per-layer ones.
Skips without a CUDA card; run with `python -m pytest portbench/tests -m
cuda` on a machine that has one."""

import json
import subprocess
import sys

import pytest
from conftest import CELLS, ROOT

from portbench import harness


def _run(name, trace):
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", name,
                        "--seed", "4294967311", "--seconds", "3", "--trace", str(trace)],
                       cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = harness.cell(name)
    line = _run(name, 0)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {m for m, _ in c.metrics}
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    line = _run(name, 1)
    assert line["correct"] and set(line["metrics"]) == {m for m, _ in c.layer_metrics}
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    for m, v in line["metrics"].items():
        if m.endswith("_roofline"):
            assert 0 < v["value"] <= 100
