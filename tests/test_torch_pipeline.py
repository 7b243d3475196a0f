"""The port's k=1 streaming push against the JAX pipeline, on the CPU.

Both pipelines start from the same state (a nonzero carry and scattered
per-stream palettes, carried over with `state_from_jax`) and push the same
chunks.  The bar: the next carry exactly equal, and RGBA within 1 u8 per
channel over what the image shows (`testing.rgba_u8_diff`: alpha everywhere,
r, g, b wherever alpha is nonzero).

* Small geometry (W=256): the JAX pipeline on its Pallas kernels in interpret
  mode, with palette_sort=False so that its state stays in external stream
  order; once with its default plan (16x32, split-real STFT kernel) and once
  with the packed plan that BENCH_CONFIG resolves to on the TPU.
* BENCH_CONFIG widths (W=2048, N=4096, H=1024), 4 streams: the JAX pipeline
  on its XLA backends.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectrogram_tpu.config as jcfg
from spectrogram_tpu.models.spectrogram import SpectrogramPipeline as JaxPipeline
from spectrogram_tpu.ops.mxu_fft import FftPlan

from spectrogram_tpu_torch import testing
from spectrogram_tpu_torch.config import BENCH_CONFIG, SpectrogramConfig
from spectrogram_tpu_torch.models.convert import state_from_jax, state_to_numpy
from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline
from spectrogram_tpu_torch.ops.cuda.colormap_kernel import unpack_rgba

torch.set_num_threads(2)

SMALL = dict(sample_rate=8000.0, window_period=0.032, hop_period=0.008)  # W=256, hop 64
IDS = np.array([0, 1, 3, 8])            # stereo, mono, stereo, mono
KINDS = ["chirp_tone", "noise"]


def _np_state(state) -> dict:
    d = {k: np.asarray(v) for k, v in state._asdict().items() if k != "tables"}
    d["tables"] = tuple(np.asarray(t) for t in state.tables)
    return d


def _run_both(jp, tp, cfg, kind, n_pushes=3):
    """Push the same chunks through both; check carries, return the rows."""
    s = len(IDS)
    js = jp.set_palette(jp.init_state(s), IDS)
    carry = testing.make(kind, s, jp.carry_size, cfg.sample_rate, seed=9)
    js = js._replace(carry=jnp.asarray(carry.transpose(0, 2, 1).copy()))
    ts = state_from_jax(_np_state(js), device="cpu")
    pcm = testing.make(kind, s, n_pushes * jp.chunk_size, cfg.sample_rate, seed=1)
    jrows, trows = [], []
    for i in range(n_pushes):
        chunk = pcm[:, i * jp.chunk_size : (i + 1) * jp.chunk_size]
        js, jr = jp.push(js, jnp.asarray(chunk))
        ts, tr = tp.push(ts, torch.from_numpy(chunk))
        np.testing.assert_array_equal(ts.carry.numpy(), np.asarray(js.carry))
        assert int(ts.cursor) == int(js.cursor)
        assert int(ts.row_count) == int(js.row_count)
        jrows.append(unpack_rgba(np.asarray(jr)))
        trows.append(unpack_rgba(tr))
    return np.concatenate(jrows, axis=1), np.concatenate(trows, axis=1)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("plan", ["default", "packed"])
def test_push_matches_jax_pallas_small(kind, plan):
    jcfg_small = jcfg.SpectrogramConfig(**SMALL)
    jp = JaxPipeline(
        jcfg_small, chunk_hops=1, store_ring=False, packed_output=True,
        stft_backend="pallas", colormap_backend="pallas",
        kernel_interpret=True, palette_sort=False,
    )
    if plan == "packed":
        jp.override_plan(FftPlan(512, 4, 128, 64))
        assert jp.stft_packed and jp.cmap_segments_full is not None
    cfg = SpectrogramConfig(**SMALL)
    tp = SpectrogramPipeline(cfg, chunk_hops=1, store_ring=False, packed_output=True,
                             device="cpu")
    want, got = _run_both(jp, tp, cfg, kind)
    assert got.shape == want.shape == (len(IDS), 3, cfg.viewport_height, 4)
    assert testing.rgba_u8_diff(got, want) <= 1


@pytest.mark.parametrize("kind", KINDS)
def test_push_matches_jax_xla_bench(kind):
    jp = JaxPipeline(
        jcfg.BENCH_CONFIG, chunk_hops=1, store_ring=False, packed_output=True,
        stft_backend="xla", colormap_backend="xla",
    )
    tp = SpectrogramPipeline(BENCH_CONFIG, chunk_hops=1, store_ring=False,
                             packed_output=True, device="cpu")
    want, got = _run_both(jp, tp, BENCH_CONFIG, kind)
    assert got.shape == want.shape == (len(IDS), 3, BENCH_CONFIG.viewport_height, 4)
    assert testing.rgba_u8_diff(got, want) <= 1
    # mono rows have alpha 255 everywhere, so every channel is held there
    mono = [1, 3]
    assert np.abs(got[mono].astype(int) - want[mono].astype(int)).max() <= 1


@pytest.mark.parametrize("ids", [IDS, 2])
def test_streamed_equals_one_shot(ids):
    """Pushing T samples hop by hop gives exactly the rows of process() on
    the same PCM with C leading zeros standing in for the initial carry."""
    cfg = SpectrogramConfig(**SMALL)
    p = SpectrogramPipeline(cfg, chunk_hops=1, packed_output=True, device="cpu")
    s, n = len(IDS), 5
    state = p.set_palette(p.init_state(s), ids)
    pcm = testing.chirp_tone(s, n * p.chunk_size, cfg.sample_rate, seed=4)
    rows = []
    for i in range(n):
        state, r = p.push(state, torch.from_numpy(pcm[:, i * p.chunk_size : (i + 1) * p.chunk_size]))
        rows.append(r)
    streamed = torch.cat(rows, dim=1)
    padded = np.concatenate([np.zeros((s, p.carry_size, 2), np.float32), pcm], axis=1)
    for pid in np.unique(ids):
        sel = np.flatnonzero(np.broadcast_to(ids, (s,)) == pid)
        oneshot = p.process(torch.from_numpy(padded[sel]), palette_id=int(pid))
        assert oneshot.shape == (len(sel), n, cfg.viewport_height)
        torch.testing.assert_close(oneshot, streamed[sel], atol=0, rtol=0)


def test_int16_and_planar_pushes():
    cfg = SpectrogramConfig(**SMALL)
    p = SpectrogramPipeline(cfg, chunk_hops=1, packed_output=True, device="cpu")
    rng = np.random.default_rng(2)
    words = rng.integers(-32768, 32767, (3, p.chunk_size, 2), dtype=np.int16)
    s0 = p.init_state(3)
    a, ra = p.push(s0, torch.from_numpy(words))
    b, rb = p.push(s0, torch.from_numpy(words.astype(np.float32) / 32768.0))
    c, rc = p.push_planar(s0, torch.from_numpy(words).transpose(1, 2))
    for st, r in ((b, rb), (c, rc)):
        torch.testing.assert_close(r, ra, atol=0, rtol=0)
        torch.testing.assert_close(st.carry, a.carry, atol=0, rtol=0)
    with pytest.raises(ValueError, match="chunk must be"):
        p.push(s0, torch.zeros(3, p.chunk_size + 1, 2))
    with pytest.raises(ValueError, match="planar chunk"):
        p.push_planar(s0, torch.zeros(3, p.chunk_size, 2))


def test_unpacked_output_is_the_packed_bytes():
    cfg = SpectrogramConfig(**SMALL)
    chunk = torch.from_numpy(testing.noise(2, cfg.hop_size, seed=6))
    packed = SpectrogramPipeline(cfg, chunk_hops=1, packed_output=True, device="cpu")
    loose = SpectrogramPipeline(cfg, chunk_hops=1, packed_output=False, device="cpu")
    _, rp = packed.push(packed.init_state(2), chunk)
    _, ru = loose.push(loose.init_state(2), chunk)
    assert ru.dtype == torch.uint8 and ru.shape == (2, 1, cfg.viewport_height, 4)
    np.testing.assert_array_equal(ru.numpy(), unpack_rgba(rp))


def test_set_palette():
    p = SpectrogramPipeline(SpectrogramConfig(**SMALL), chunk_hops=1,
                            packed_output=True, device="cpu")
    s = p.init_state(4)
    assert s.tables[0].shape == (4, 128)
    one = p.set_palette(s, 3)
    assert one.tables[0].shape == (1, 128)
    assert one.palette_id.tolist() == [3] * 4
    per = p.set_palette(s, torch.tensor([0, 1, 2, 18]))
    torch.testing.assert_close(per.tables[0], p.builtin_tables[[0, 1, 2, 18]])
    for bad in (19, -1, np.array([0, 19, 1, 1])):
        with pytest.raises(ValueError, match="out of range"):
            p.set_palette(s, bad)


@pytest.mark.parametrize("kwargs", [
    dict(ring_dtype=torch.float16), dict(ring_dtype=torch.float32),
    dict(ring_dtype=torch.float16, static_palette=1), dict(ring_dtype=torch.float64),
    dict(ring_dtype=torch.float32, static_palette="Magma"),
    dict(ring_dtype=torch.float16, static_palette=0, i16_planes=True),
])
def test_arguments_outside_the_slice_raise(kwargs):
    """The ring dtypes the ring kernel takes are ported (with static
    palettes too, tests/test_torch_palettes.py); any other ring dtype, a
    float8 one included, raises ValueError at construction."""
    p = SpectrogramPipeline(SpectrogramConfig(**SMALL), device="cpu", **kwargs)
    assert p.ring_dtype == kwargs["ring_dtype"]
    assert p.init_state(2).ring.dtype == kwargs["ring_dtype"]
    for bad in (torch.int16, torch.int32, torch.complex64, "float16", np.float32,
                torch.float8_e4m3fn, torch.float8_e5m2):
        with pytest.raises(ValueError, match="ring_dtype"):
            SpectrogramPipeline(SpectrogramConfig(**SMALL), device="cpu",
                                **dict(kwargs, ring_dtype=bad))
    static = {k: v for k, v in kwargs.items() if k != "ring_dtype"}
    if static:
        p = SpectrogramPipeline(SpectrogramConfig(**SMALL), device="cpu", **static)
        assert p.static_palette_id == (1 if static["static_palette"] in (1, "Magma") else 0)


class _SeparableScheme:
    """A rank-1 palette outside the built-in mono/stereo structure."""

    name = "separable"

    def factored_tables(self, resolution=32):
        return (np.full((resolution, 4), 0.5, np.float32),
                np.full((resolution, 4), 0.25, np.float32))

    def background_color(self):
        return (0, 0, 0)


def test_scheme_registries():
    from spectrogram_tpu_torch.color.colorscheme import ColorScheme

    cfg = SpectrogramConfig(**SMALL)
    grey = ColorScheme("grey", "", gradient_fn=lambda t: np.stack([t, t, t], -1))
    p = SpectrogramPipeline(cfg, schemes=[grey, ColorScheme("s", "COOL", (0, 0, 0))],
                            device="cpu")
    assert p.builtin_tables.shape == (2, 128) and p.generic_tables is None
    assert p.builtin_tables[0, 3] == 0.0 and p.builtin_tables[1, 3] == 1.0
    # a scheme outside the built-in structure: the whole registry is generic
    g = SpectrogramPipeline(cfg, schemes=[_SeparableScheme(), grey], device="cpu")
    assert g.builtin_tables is None
    u, v = g.generic_tables
    assert u.shape == v.shape == (2, 128) and float(u[0, 0]) == 0.5 and float(v[0, 0]) == 0.25
    state = g.set_palette(g.init_state(3), np.array([0, 1, 0]))
    assert [t.shape for t in state.tables] == [(3, 128), (3, 128)]


def test_state_round_trip():
    jp = JaxPipeline(jcfg.SpectrogramConfig(**SMALL), chunk_hops=1,
                     store_ring=False, packed_output=True, palette_sort=False)
    js = jp.set_palette(jp.init_state(3), np.array([4, 0, 9]))
    d = _np_state(js)
    back = state_to_numpy(state_from_jax(d, device="cpu"))
    for k in ("carry", "ring", "cursor", "palette_id", "row_count"):
        np.testing.assert_array_equal(back[k], np.asarray(d[k], back[k].dtype))
    np.testing.assert_array_equal(back["tables"][0], d["tables"][0])
    # the transposed carry [S, 2, n1, C/n1] carries across as it is (f32
    # only: no pipeline keeps it int16); other carries raise
    transposed = dict(d, carry=d["carry"].reshape(3, 2, 4, -1))
    np.testing.assert_array_equal(
        state_to_numpy(state_from_jax(transposed, device="cpu"))["carry"],
        transposed["carry"])
    for carry in (transposed["carry"].astype(np.int16), d["carry"][:, 0],
                  d["carry"].reshape(3, 1, 2, -1)):
        with pytest.raises(ValueError, match="carry"):
            state_from_jax(dict(d, carry=carry), device="cpu")
    assert jax.default_backend() == "cpu"
