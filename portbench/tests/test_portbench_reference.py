"""The reference against the port at a tiny size of both geometries.  The
reference imports nothing of the port; these tests may import both."""

import json

import numpy as np
import pytest
import torch
from conftest import ROOT

from portbench import harness
from portbench.reference import law, palettes

CONFIGS = ("serve-bench48k", "display-ref48k")


def config(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


def port(name, **over):
    from spectrogram_tpu_torch.config import SpectrogramConfig
    from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline

    from portbench.harness import _pipeline_kwargs

    c = config(name)
    c["spectrogram"].update(over)
    return SpectrogramPipeline(SpectrogramConfig(**c["spectrogram"]), device="cpu",
                               **_pipeline_kwargs(c)), c


@pytest.mark.parametrize("name", CONFIGS)
def test_geometry_and_taps_are_the_ports(name):
    from spectrogram_tpu_torch.ops import colormap as cmap_ops

    pipe, c = port(name, viewport_rows=8)
    g = law.geometry(c["spectrogram"])
    cfg = pipe.cfg
    assert (g.window, g.hop, g.n_fft, g.carry, g.bins) == (
        cfg.window_size, cfg.hop_size, cfg.padded_size, pipe.carry_size, cfg.num_bins)
    m = cmap_ops.resample_matrix(cfg)
    t = law.taps(g, "cpu")
    rows = np.arange(g.height)
    dense = np.zeros_like(m)
    np.add.at(dense, (rows, t.k0.numpy() - 1), t.w0.numpy())
    np.add.at(dense, (rows, t.k1.numpy() - 1), t.w1.numpy())
    assert np.array_equal(dense, m)


def test_palette_tables_are_the_ports():
    from spectrogram_tpu_torch.color.colorscheme import stacked_lookup_tables

    assert np.array_equal(palettes.lookup_tables(32), stacked_lookup_tables(32))


@pytest.mark.parametrize("name", CONFIGS)
def test_rows_and_ring_within_the_bar_of_the_ports_cpu_rows(name):
    """The port's CPU pushes of seeded traffic against the reference: rows
    within 1 u8 over what they show, the carry exact, ring rows within one
    bf16 step above the dB floor."""
    from portbench import traffic_gen

    pipe, c = port(name, viewport_rows=16)
    g, k, s = law.geometry(c["spectrogram"]), pipe.chunk_hops, 6
    ids = np.array([0, 1, 3, 8, 1, 12], np.int32)
    state = pipe.set_palette(pipe.init_state(s), ids)
    dtype = getattr(torch, c["wire"]["dtype"])
    pool = traffic_gen.pool(
        {"chirp": {"start_hz": [40.0, 400.0], "end_frac": [0.3, 0.9], "level_db": [-12.0, -3.0]},
         "tone": {"hz": [50.0, 12000.0], "level_db": [-24.0, -6.0]},
         "noise": {"low_hz": [50.0, 4000.0], "width_ratio": [2.0, 8.0], "level_db": [-50.0, -20.0]},
         "segment_s": 0.05, "gain_db": [-80.0, 10.0]},
        g.sample_rate, g.hop, k, s, 5, dtype, 3, "cpu")
    perm = pipe.input_perm(state) if c["pipeline"].get("presorted_input") else None
    luts = torch.from_numpy(palettes.lookup_tables(g.resolution))
    taps = law.taps(g, "cpu")
    bins = law.tapped_bins(taps)
    for i in range(7):
        chunk = pool[i % 5] if perm is None else pool[i % 5][torch.from_numpy(perm).long()]
        state, rows = pipe.push_planar(state, chunk)
    win = law.windows(law.history(pool, 6, g, k), g, k)
    mag = law.magnitudes(win, g, bins)
    ref = law.colormap(mag[:, :, 0].reshape(s * k, -1), mag[:, :, 1].reshape(s * k, -1), bins,
                       taps, luts, torch.from_numpy(ids).long().repeat_interleave(k), g)
    out = pipe.output_perm(state)
    rows = rows if out is None else rows[torch.from_numpy(out).long()]
    mine = rows.contiguous().view(torch.uint8).reshape(s * k, g.height, 4)
    worst, off, pixels = law.rgba_gap(mine, ref)
    assert worst <= 1 and off < pixels * 1e-3
    carry = state.carry if perm is None else state.carry[torch.from_numpy(out).long()]
    assert torch.equal(carry, law.next_carry(pool, 6, g, k))
    if pipe.store_ring:
        rb = torch.arange(1, g.window)
        m = law.magnitudes(win, g, rb).to(torch.bfloat16)        # [s, k, 2, W-1]
        slots = [(6 * k + j) % pipe.viewport_rows for j in range(k)]
        worst, n = law.bf16_ulps(state.ring[:, slots], m, 10 ** (g.min_db / 20))
        assert worst <= 1 and n > 0


@pytest.mark.parametrize("name,streams", [("serve-bench48k", 16384), ("serve-bench48k", 64),
                                          ("display-ref48k", 2048), ("display-ref48k", 40)])
@pytest.mark.parametrize("exponent", [1.0, 2.0])
def test_sort_order_is_the_ports(name, streams, exponent):
    """The palette order the reference works out from the ids is the one the
    port's set_palette takes (block sort, whole-state sort, or none)."""
    from portbench import traffic_gen

    pipe, c = port(name, viewport_rows=8)
    k = pipe.chunk_hops
    for seed in (1, 2):
        law_ = dict(harness.cell("svc16k.k1.device").traffic["palettes"], exponent=exponent)
        ids = traffic_gen.palettes(law_, streams, 19, seed)
        state = pipe.set_palette(pipe.init_state(streams), ids)
        mine = pipe.input_perm(state)
        mine = np.arange(streams) if mine is None else mine
        ref = law.sort_order(ids, k, c["palette_order"], pipe.store_ring)
        assert np.array_equal(mine, ref)
