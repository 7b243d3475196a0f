"""Each layer's work count equals a hand count at one small shape, and does
not depend on how the program frames or fuses the push."""

import math
import types

import pytest

from portbench.reference import law
from portbench.work import colormap, stft

SPEC = {"sample_rate": 8000.0, "window_period": 0.008, "hop_period": 0.003, "pad_factor": 2,
        "min_db": -70.0, "max_db": -10.0, "db_epsilon": 1e-7, "min_frequency": 100.0,
        "max_frequency": 3000.0, "viewport_rows": 16, "viewport_height": 8,
        "lut_resolution": 4}


def run(ring, wire="int16", **pipeline):
    return types.SimpleNamespace(geometry=law.geometry(SPEC), k=3, streams=5,
                                 store_ring=ring, wire={"dtype": wire}, pipeline=pipeline)


def tapped():
    return law.tapped_bins(law.taps(law.geometry(SPEC), "cpu")).numel()


@pytest.mark.parametrize("ring", [False, True])
def test_stft_hand_count(ring):
    # W = 64, hop = 24, N = 128, C = 40; 5 streams, k = 3: 15 windows
    g = law.geometry(SPEC)
    assert (g.window, g.hop, g.n_fft, g.carry) == (64, 24, 128, 40)
    nb = 63 if ring else tapped()
    nbytes, flops = stft.work(run(ring))
    assert nbytes == 5 * 2 * (40 + 72) * 2 + 15 * 2 * nb * 4
    assert flops == 15 * (5 * 128 * 7 + 2 * 64 + 8 * 2 * nb)
    f32, _ = stft.work(run(ring, "float32"))
    assert f32 - nbytes == 5 * 2 * 112 * 2


def test_colormap_hand_count():
    nbytes, flops = colormap.work(run(False))
    assert nbytes == 15 * 2 * tapped() * 4 + 5 * 4 + 19 * 4 * 4 * 4 + 8 * 16 + 15 * 8 * 4
    assert flops == 15 * 8 * 40


@pytest.mark.parametrize("layer", [stft, colormap])
def test_count_is_the_same_for_concatenating_and_fused_framing(layer):
    """The count reads the cell's shapes only: a push framed by
    concatenation or by a kernel that reads the carry and the chunk itself
    (framing="tsplit") is the same work."""
    assert layer.work(run(False, framing="auto")) == layer.work(run(False, framing="tsplit"))
    assert not math.isnan(layer.work(run(True))[0])
