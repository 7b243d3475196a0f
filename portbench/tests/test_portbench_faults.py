"""The check is shown to fail: the control (the reference with its DFT in
bfloat16, put in the program's place) and the timed path broken underneath
each come out not correct.  (The exchange between chips is a fault no cell
can have: every cell runs on one chip.)"""

import pytest
import torch
from conftest import rehearse, tiny_cell

from portbench import harness

FAULT_CELLS = ("svc16k.k1.device", "ref2k.k8.ring.mixed", "svc16k.k1.served")


def _wrap(run, change):
    orig = run.pipe._push_core

    def broken(state, chunk):
        new_state, rows = orig(state, chunk)
        return change(state, new_state, rows)

    run.pipe._push_core = broken


def state_unchanged(run):
    """A push that returns the state it was given."""
    _wrap(run, lambda old, new, rows: (old, rows))


def half_left_out(run):
    """Half of the streams left out of each push: no rows for them, their
    carry not advanced."""
    def change(old, new, rows):
        h = rows.shape[0] // 2
        rows = rows.clone()
        rows[h:] = 0
        carry = new.carry.clone()
        carry[h:] = old.carry[h:]
        return new._replace(carry=carry), rows
    _wrap(run, change)


def answer_altered(run):
    """One pixel of one row altered where it is produced, in every push."""
    def change(old, new, rows):
        rows = rows.clone()
        rows[0, 0, 0] ^= 0x40404040
        return new, rows
    _wrap(run, change)


@pytest.mark.parametrize("fault", [state_unchanged, half_left_out, answer_altered])
@pytest.mark.parametrize("name", FAULT_CELLS)
def test_broken_timed_path_is_not_correct(name, fault):
    _, _, checks = rehearse(tiny_cell(name), patch=fault)
    assert not harness.correct(checks), checks


def test_control_is_not_correct(cell_name):
    run, _, program = rehearse(tiny_cell(cell_name))
    assert harness.correct(program)
    control = run.judge("bf16")
    assert not harness.correct(control), control
    assert control["rows_off_ppm"]["value"] > program["rows_off_ppm"]["value"] * 3


def test_control_dft_is_bf16():
    """The control's magnitudes differ from the f32 reference's by bf16's
    rounding, not by a different law."""
    from portbench.reference import law

    c = tiny_cell("svc16k.k1.device")
    g = law.geometry(c.config["spectrogram"])
    x = torch.sin(torch.arange(g.window, dtype=torch.float32) * 0.37)[None] * 0.5
    bins = torch.arange(1, g.window)
    a = law.magnitudes(x, g, bins, "f32")
    b = law.magnitudes(x, g, bins, "bf16")
    peak = a.max()
    assert (a - b).abs().max() < 0.02 * peak and not torch.allclose(a, b, atol=1e-5)
