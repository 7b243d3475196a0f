"""The long-window serving deployment on the CPU: `serve-long48k`'s
geometry (48 kHz, W = 32,768, N = 65,536, hop 800, H = 1,024) in its full
serving mode (`i16_planes`, `presorted_input`, `sorted_output`, the
palette sort) at 16 and 32 streams, three pushes, against the
benchmark's plain reference (`portbench.reference.law`): rows within 1 u8
where they show, the next carry exact, the palette order the layout
rule's (also at the cell's 4,096 streams); and at 2 streams in the same
mode against the JAX package's pipeline from one state (rows within 1 u8,
carry exact, the same palette order).  And the large-N route's row
grouping, the counters and the `last_stft` record the pipeline keeps of
it."""

import collections
import json
import pathlib

import numpy as np
import pytest
import torch

from portbench import traffic_gen
from portbench.reference import law, palettes
from spectrogram_tpu_torch.config import SpectrogramConfig
from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline
from spectrogram_tpu_torch.ops.cuda import stft_kernel as sk

torch.set_num_threads(2)

PORTBENCH = pathlib.Path(__file__).resolve().parents[1] / "portbench"
CONFIG = json.loads((PORTBENCH / "configs" / "serve-long48k.json").read_text())
TRAFFIC = json.loads((PORTBENCH / "traffic" / "closed.zipf1.json").read_text())
STREAMS, PUSHES, SEED = 16, 3, 2**31 + 11


def _ids(streams: int) -> np.ndarray:
    return traffic_gen.palettes(TRAFFIC["palettes"], streams, len(palettes.SCHEMES), SEED)


def _pipeline(ids: np.ndarray):
    cfg = SpectrogramConfig(**CONFIG["spectrogram"])
    p = SpectrogramPipeline(cfg, device="cpu", **CONFIG["pipeline"])
    return p, p.set_palette(p.init_state(ids.shape[0]), ids)


def _perms(p, state, s: int):
    """The program's (input_perm, output_perm), the identity where None."""
    got = (p.input_perm(state), p.output_perm(state))
    return tuple(np.arange(s) if x is None else x for x in got)


def test_palette_order_is_the_rule_at_the_cells_streams():
    """At the cell's 4,096 streams the sort takes the layout the law gives
    (243 of 256 row blocks uniform on every seed: the traffic fixes the
    counts)."""
    ids = _ids(4096)
    p, state = _pipeline(ids)
    order = law.sort_order(ids, 1, CONFIG["palette_order"], ring=False)
    assert (order != np.arange(4096)).any()
    into, back = _perms(p, state, 4096)
    assert (into == order).all() and (back[order] == np.arange(4096)).all()
    assert p.last_layout == {"blocks": 256, "uniform": 243}


# the traffic's Zipf palettes at 16 streams (one row block: left unsorted),
# and two palettes alternating over 32 streams (sorted into two blocks)
@pytest.mark.parametrize("ids", [_ids(STREAMS), np.arange(32) % 2],
                         ids=["zipf16", "sorted32"])
def test_serving_push_matches_the_reference(ids):
    s = ids.shape[0]
    p, state = _pipeline(ids)
    g = law.geometry(CONFIG["spectrogram"])
    assert (p.cfg.window_size, p.cfg.padded_size, p.cfg.hop_size) == (g.window, g.n_fft, g.hop)
    assert sk.is_large(g.n_fft) and p.stft_packed and p.i16_planes
    order = law.sort_order(ids, 1, CONFIG["palette_order"], ring=False)
    assert (order != np.arange(s)).any() == (s == 32)
    into, back = _perms(p, state, s)
    assert (into == order).all() and (back[order] == np.arange(s)).all()
    inverse = torch.from_numpy(np.argsort(order))
    pool = traffic_gen.pool(TRAFFIC["signal"], g.sample_rate, g.hop, 1, s, PUSHES,
                            torch.int16, SEED, "cpu")
    taps = law.taps(g, "cpu")
    bins = law.tapped_bins(taps)
    luts = torch.from_numpy(palettes.lookup_tables(g.resolution))
    pid = torch.from_numpy(ids.astype(np.int64))
    perm = torch.from_numpy(order.astype(np.int64))
    for i in range(PUSHES):
        state, rows = p.push_planar(state, pool[i].index_select(0, perm))
        win = law.windows(law.history(pool, i, g, 1), g, 1)                # [S, 1, 2, W]
        mag = law.magnitudes(win, g, bins)
        want = law.colormap(mag[:, 0, 0], mag[:, 0, 1], bins, taps, luts, pid, g)
        mine = rows.index_select(0, inverse).contiguous().view(torch.uint8)
        worst, _, pixels = law.rgba_gap(mine.reshape(s, g.height, 4), want)
        assert worst <= 1 and pixels == s * g.height
    carry = state.carry.index_select(0, inverse)
    torch.testing.assert_close(carry, law.next_carry(pool, PUSHES - 1, g, 1), atol=0, rtol=0)
    # the plain STFT on the CPU: its route, and none of the large route's counts
    assert p.last_stft == {"route": "plain", "n_fft": 65536, "rows": s, "groups": 0,
                           "scratch_bytes": 0}
    assert p.counters["push.stft_large"] == p.counters["stft.large_groups"] == 0


def test_serving_push_matches_jax():
    """serve-long48k's spectrogram settings and serving mode (i16_planes,
    presorted_input, sorted_output, the palette sort, k=1, no ring) at 2
    streams of two palettes: the port's pipeline on the CPU against the JAX
    package's, both from one state with a chirp-and-tone carry, three
    planar pushes.  JAX takes i16_planes only on its fused packed path,
    which it does not run at this N on the CPU, so its pipeline takes the
    rest of the mode and the same words as f32 x / 32768 (the edge the
    port's int16 pipeline equals bit for bit).  The same palette order,
    rows within 1 u8 over what they show, the next carry exact."""
    import jax.numpy as jnp
    from test_torch_fft_sizes import _np_state

    import spectrogram_tpu.config as jcfg
    from spectrogram_tpu.models.spectrogram import SpectrogramPipeline as JaxPipeline
    from spectrogram_tpu_torch import testing
    from spectrogram_tpu_torch.models.convert import state_from_jax
    from spectrogram_tpu_torch.ops.cuda import colormap_kernel as ck

    s, ids = 2, np.array([3, 0], dtype=np.int32)
    jkw = {k: v for k, v in CONFIG["pipeline"].items() if k != "i16_planes"}
    jp = JaxPipeline(jcfg.SpectrogramConfig(**CONFIG["spectrogram"]), **jkw)
    tp = SpectrogramPipeline(SpectrogramConfig(**CONFIG["spectrogram"]), device="cpu",
                             **CONFIG["pipeline"])
    assert tp.cfg.padded_size == 65536 and tp.chunk_hops == 1 and not tp.store_ring
    c, t = tp.carry_size, tp.chunk_size
    pcm = testing.chirp_tone(s, c + PUSHES * t, tp.cfg.sample_rate, seed=23)
    words = np.round(pcm * 32767.0).astype(np.int16).transpose(0, 2, 1)   # [S, 2, T]
    js = jp.set_palette(jp.init_state(s), ids)
    js = js._replace(carry=jnp.asarray(words[:, :, :c].astype(np.float32) / 32768.0))
    start = _np_state(js)
    start["carry"] = np.ascontiguousarray(words[:, :, :c])
    ts = state_from_jax(start, device="cpu")
    assert ts.carry.dtype == torch.int16
    perms = [(jp.input_perm(js), tp.input_perm(ts)), (jp.output_perm(js), tp.output_perm(ts))]
    for want, got in perms:
        assert (want is None) == (got is None)
        if want is not None:
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    into = np.arange(s) if perms[0][1] is None else np.asarray(perms[0][1])
    for i in range(PUSHES):
        chunk = np.ascontiguousarray(words[into, :, c + i * t : c + (i + 1) * t])
        js, jr = jp.push_planar(js, jnp.asarray(chunk.astype(np.float32) / 32768.0))
        ts, tr = tp.push_planar(ts, torch.from_numpy(chunk))
        np.testing.assert_array_equal(ts.carry.numpy().astype(np.float32) / 32768.0,
                                      np.asarray(js.carry))
        assert tr.shape == (s, 1, tp.cfg.viewport_height)
        assert testing.rgba_u8_diff(ck.unpack_rgba(tr), ck.unpack_rgba(np.asarray(jr))) <= 1


@pytest.mark.parametrize("rows, split, want", [
    (4096, False, (4096, 1, 1 << 31)),       # one group of exactly 2 GiB
    (8192, False, (4096, 2, 1 << 31)),
    (4097, False, (4096, 2, 1 << 31)),
    (4096, True, (4096, 1, 1 << 31)),        # split-real: two channels of N/2
    (16, False, (16, 1, 16 * 65536 * 8)),
    (0, False, (0, 0, 0)),
])
def test_large_grouping(rows, split, want):
    assert sk.large_grouping(65536, rows, split) == want


def test_large_grouping_at_a_bluestein_size():
    """N = 16,411 (prime): the scratch holds Bluestein's M entries a row."""
    m = sk.bluestein_size(16411)
    rows = sk.LARGE_SCRATCH_BYTES // (m * 8)
    assert sk.large_grouping(16411, 3 * rows) == (rows, 3, rows * m * 8)
    assert sk.large_grouping(16411, 3 * rows + 1)[1] == 4
    assert rows * m * 8 <= sk.LARGE_SCRATCH_BYTES < (rows + 1) * m * 8


def test_large_route_counters_and_record():
    """The record and counters as a pipeline on the card keeps them (the
    kernels' flag set on a CPU pipeline, whose STFT stays plain): one
    "push.stft_large" a push, its groups under "stft.large_groups"."""
    cfg = SpectrogramConfig(sample_rate=48000.0, window_period=16384 / 48000.0,
                            hop_period=4096 / 48000.0, viewport_height=64)
    p = SpectrogramPipeline(cfg, device="cpu", chunk_hops=2, store_ring=False,
                            packed_output=True)
    assert sk.is_large(cfg.padded_size) and p.last_stft is None
    p._stft_plain = False
    state = p.init_state(3)
    for _ in range(2):
        state, _ = p.push_planar(state, torch.zeros(3, 2, p.chunk_size))
    assert p.last_stft == {"route": "large", "n_fft": 32768, "rows": 6, "groups": 1,
                           "scratch_bytes": 6 * 32768 * 8}
    assert p.counters["push.stft_large"] == 2 and p.counters["stft.large_groups"] == 2
    twin = p.with_plain_kernels()
    twin.push_planar(state, torch.zeros(3, 2, p.chunk_size))
    assert twin.last_stft["route"] == "plain" and twin.counters == collections.Counter()


def test_small_n_records_its_body():
    cfg = SpectrogramConfig(sample_rate=8000.0, window_period=0.032, hop_period=0.008,
                            viewport_height=64)
    p = SpectrogramPipeline(cfg, device="cpu", chunk_hops=1, store_ring=False,
                            packed_output=True, stft_packed=False)
    p._stft_plain = False
    p.push_planar(p.init_state(2), torch.zeros(2, 2, p.chunk_size))
    assert p.last_stft == {"route": "radix2", "n_fft": 512, "rows": 2, "groups": 0,
                           "scratch_bytes": 0}
    assert "push.stft_large" not in p.counters
