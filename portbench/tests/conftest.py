"""The benchmark's own CPU tests: `python -m pytest portbench/tests` from
the root of the checkout.  Card tests carry the `cuda` marker and skip
without a card."""

import copy
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

torch.set_num_threads(2)

CELLS = ("svc16k.k1.device", "ref2k.k8.ring.mixed", "svc16k.k1.served",
         "ref2k.k8.ring.onepalette")


def tiny_cell(name: str, streams: int | None = None, rows: int = 64):
    """A cell of the benchmark cut to a size the CPU runs in a second: few
    streams, a short ring, small pools, a short traced stretch.  Widths,
    geometry, laws and loop are the cell's own."""
    from portbench import harness

    c = harness.cell(name)
    c.config = copy.deepcopy(c.config)
    c.traffic = copy.deepcopy(c.traffic)
    ring = c.config["pipeline"].get("store_ring", True)
    c.config["streams"] = streams or (8 if ring else 16)
    c.config["spectrogram"]["viewport_rows"] = rows
    c.traffic.update(pool_pushes=8, warmup_pushes=12, trace_units=5, held_units=3,
                     ring_streams=4)
    return c


def rehearse(c, seed: int = 2**31 + 7, seconds: float = 0.4, trace: bool = False,
             patch=None):
    """Set-up, window, close and check of a cell on the CPU: (run, checks)."""
    from portbench import harness

    run = harness.Run(c, seed, "cpu", t_process=0.0)
    run.setup()
    if patch is not None:
        patch(run)
    run.loop.window(run, seconds, trace)
    info = run.close()
    return run, info, run.judge()


@pytest.fixture(params=CELLS)
def cell_name(request):
    return request.param
