"""Each cell's loop end to end at a tiny size on the CPU, through the port's
device="cpu" path: the check against the reference passes, and no device
metric is written."""

import numpy as np
from conftest import rehearse, tiny_cell

from portbench import harness


def test_cell_rehearses_correct(cell_name):
    c = tiny_cell(cell_name)
    run, info, checks = rehearse(c, trace=True)
    assert run.units > 0 and run.window_s > 0
    assert harness.correct(checks), checks
    assert checks["carry_off"]["value"] == 0 and checks["perm_off"]["value"] == 0
    assert checks["missing"]["value"] == 0
    assert set(checks) == set(c.limits)
    for trace in (False, True):
        line = harness.result(run, trace, info, checks)
        assert line["device"]["platform"] == "cpu"
        assert line["metrics"] == {}        # a CPU run writes no metric of the card
        assert list(line)[-1] == "checks"


def test_served_loop_returns_every_tick():
    run, _, checks = rehearse(tiny_cell("svc16k.k1.served"))
    assert checks["missing"]["value"] == 0
    assert run.latency_ms.size == run.units


def test_seed_gives_the_same_inputs_and_sizes():
    from portbench import traffic_gen

    a = traffic_gen.pool(tiny_cell("svc16k.k1.device").traffic["signal"], 48000.0, 800, 1,
                         4, 3, __import__("torch").int16, 2**33 + 1, "cpu")
    b = traffic_gen.pool(tiny_cell("svc16k.k1.device").traffic["signal"], 48000.0, 800, 1,
                         4, 3, __import__("torch").int16, 2**33 + 1, "cpu")
    assert (a == b).all()
    law = harness.cell("svc16k.k1.device").traffic["palettes"]
    x = traffic_gen.palettes(law, 4096, 19, 1)
    y = traffic_gen.palettes(law, 4096, 19, 2**33 + 5)
    for s0 in range(0, 4096, law["stratum"]):     # every stratum holds the same counts
        a, b = x[s0: s0 + law["stratum"]], y[s0: s0 + law["stratum"]]
        assert (np.bincount(a, minlength=19) == np.bincount(b, minlength=19)).all()
    counts = np.bincount(x[: law["stratum"]], minlength=19)
    assert counts[law["ranks"]].tolist() == sorted(counts, reverse=True)   # the ranks' order
    assert (x != y).any()


def test_signal_reaches_both_db_clamps():
    """The generated levels put bins at the dB floor and above the ceiling,
    so both clamps and the taps between see use."""
    import torch

    from portbench.reference import law

    c = tiny_cell("svc16k.k1.device")
    g = law.geometry(c.config["spectrogram"])
    pool = __import__("portbench.traffic_gen", fromlist=["pool"]).pool(
        c.traffic["signal"], g.sample_rate, g.hop, 1, 64, 16, torch.int16, 5, "cpu")
    bins = torch.arange(1, g.window)
    win = torch.cat([law.windows(law.history(pool, i, g, 1), g, 1) for i in range(2, 16)])
    mag = law.magnitudes(win, g, bins)
    power = mag[:, :, 0] ** 2 + mag[:, :, 1] ** 2
    db = 10 * torch.log10(power + g.db_epsilon)
    # 10 log10(p + 1e-7) never reads below -70 dB: the floor is the epsilon
    assert (db < g.min_db + 0.5).any() and (db > g.max_db).any()
