"""Pipeline completion against the JAX pipeline, on the CPU: ring dtypes
other than bfloat16, `state_from_jax` in the pipeline's ring dtype,
`override_plan` and `restored_tables_for`.

The bars: rows and rendered viewports within 1 u8 per channel over what the
image shows (`testing.rgba_u8_diff`); carries exactly equal; rings within
the STFT bar of two f32 FFTs (atol 3e-5 / rtol 1e-4) in float32, and in
float16 within one f16 rounding of it (rtol 2^-10 beyond that atol); a ring
carried across in its own dtype exactly; the plan-derived decisions and the
layout classes equal JAX's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectrogram_tpu.config as jcfg
from spectrogram_tpu.models.spectrogram import SpectrogramPipeline as JaxPipeline
from spectrogram_tpu.models.spectrogram import StreamState as JaxState
from spectrogram_tpu.ops.mxu_fft import FftPlan as JaxPlan

from spectrogram_tpu_torch import testing
from spectrogram_tpu_torch.config import BENCH_CONFIG, SpectrogramConfig
from spectrogram_tpu_torch.models.convert import state_from_jax, state_to_numpy
from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline
from spectrogram_tpu_torch.ops import fft_plan
from spectrogram_tpu_torch.ops.cuda.colormap_kernel import unpack_rgba

torch.set_num_threads(2)

SMALL = dict(sample_rate=8000.0, window_period=0.032, hop_period=0.008,
             viewport_height=64, viewport_rows=8)          # W=256, hop 64
TSPLIT = dict(sample_rate=48000.0, window_period=2048 / 48000.0,
              hop_period=800 / 48000.0, viewport_height=64)  # W=2048, hop 800
IDS = np.array([0, 1, 3, 8])            # stereo, mono, stereo, mono
STFT_ATOL, STFT_RTOL = 3e-5, 1e-4
RING_DTYPES = {"float32": (torch.float32, jnp.float32, STFT_RTOL),
               "float16": (torch.float16, jnp.float16, 2.0 ** -10)}


def _np_state(state) -> dict:
    d = {k: np.asarray(v) for k, v in state._asdict().items() if k != "tables"}
    d["tables"] = tuple(np.asarray(t) for t in state.tables)
    return d


def _jax_state(d: dict, ring_dtype) -> JaxState:
    return JaxState(
        carry=jnp.asarray(d["carry"]), ring=jnp.asarray(d["ring"]).astype(ring_dtype),
        cursor=jnp.asarray(d["cursor"]), palette_id=jnp.asarray(d["palette_id"]),
        row_count=jnp.asarray(d["row_count"]),
        tables=tuple(jnp.asarray(t) for t in d["tables"]),
    )


def _ring_close(got: torch.Tensor, want, rtol: float) -> None:
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want).astype(np.float32),
                               atol=STFT_ATOL, rtol=rtol)


# -------------------------------------------------------------- ring dtype

@pytest.mark.parametrize("dtype", sorted(RING_DTYPES))
def test_ring_dtype_pipeline_matches_jax(dtype):
    """k=2 pushes wrapping an 8-row ring held in float32 or float16, from
    one state, then render_viewport at R and at 12 columns; the port's
    state carried back into JAX renders as the port does."""
    tdtype, jdtype, rtol = RING_DTYPES[dtype]
    cfg, jc = SpectrogramConfig(**SMALL), jcfg.SpectrogramConfig(**SMALL)
    jp = JaxPipeline(jc, chunk_hops=2, ring_dtype=jdtype)
    tp = SpectrogramPipeline(cfg, chunk_hops=2, ring_dtype=tdtype, device="cpu")
    js = jp.set_palette(jp.init_state(len(IDS)), IDS)
    carry = testing.make("chirp_tone", len(IDS), jp.carry_size, cfg.sample_rate, seed=9)
    js = js._replace(carry=jnp.asarray(carry.transpose(0, 2, 1).copy()))
    ts = state_from_jax(_np_state(js), device="cpu", ring_dtype=tdtype)
    assert ts.ring.dtype == tdtype and tp.init_state(1).ring.dtype == tdtype
    t = tp.chunk_size
    pcm = testing.chirp_tone(len(IDS), 6 * t, cfg.sample_rate, seed=1)
    for i in range(6):                   # 12 rows: the 8-row ring wraps
        chunk = pcm[:, i * t : (i + 1) * t]
        js, jr = jp.push(js, jnp.asarray(chunk))
        ts, tr = tp.push(ts, torch.from_numpy(chunk))
        np.testing.assert_array_equal(ts.carry.numpy(), np.asarray(js.carry))
        assert testing.rgba_u8_diff(tr.numpy(), np.asarray(jr)) <= 1
        assert ts.ring.dtype == tdtype and np.asarray(js.ring).dtype == jdtype
        _ring_close(ts.ring, js.ring, rtol)
    for width in (None, 12):
        got = tp.render_viewport(ts, width)
        want = np.asarray(jp.render_viewport(js, width))
        assert got.shape == want.shape
        assert testing.rgba_u8_diff(got.numpy(), want) <= 1
    # the port's state in JAX: the ring exactly, the same render
    back = _jax_state(state_to_numpy(ts), jdtype)
    np.testing.assert_array_equal(np.asarray(back.ring), ts.ring.numpy())
    assert testing.rgba_u8_diff(np.asarray(jp.render_viewport(back)),
                                tp.render_viewport(ts).numpy()) <= 1


@pytest.mark.parametrize("dtype", ["bfloat16", *sorted(RING_DTYPES)])
def test_state_from_jax_keeps_the_ring_dtype(dtype):
    """A JAX ring carried into the port in the pipeline's ring dtype is the
    same values, and comes back as them; the port renders it as JAX does."""
    tdtype, jdtype = ((torch.bfloat16, jnp.bfloat16) if dtype == "bfloat16"
                      else RING_DTYPES[dtype][:2])
    cfg, jc = SpectrogramConfig(**SMALL), jcfg.SpectrogramConfig(**SMALL)
    jp = JaxPipeline(jc, chunk_hops=2, ring_dtype=jdtype)
    tp = SpectrogramPipeline(cfg, chunk_hops=2, ring_dtype=tdtype, device="cpu")
    js = jp.set_palette(jp.init_state(len(IDS)), IDS)
    pcm = testing.chirp_tone(len(IDS), 5 * jp.chunk_size, cfg.sample_rate, seed=2)
    for i in range(5):
        js, _ = jp.push(js, jnp.asarray(pcm[:, i * jp.chunk_size : (i + 1) * jp.chunk_size]))
    d = _np_state(js)
    ts = state_from_jax(d, device="cpu", ring_dtype=tdtype)
    assert ts.ring.dtype == tdtype
    np.testing.assert_array_equal(ts.ring.to(torch.float32).numpy(),
                                  np.asarray(d["ring"]).astype(np.float32))
    np.testing.assert_array_equal(state_to_numpy(ts)["ring"].astype(np.float32),
                                  np.asarray(d["ring"]).astype(np.float32))
    assert testing.rgba_u8_diff(tp.render_viewport(ts).numpy(),
                                np.asarray(jp.render_viewport(js))) <= 1


# ------------------------------------------------------------ override_plan

GEOMETRIES = {"small": SMALL, "tsplit": TSPLIT}
KNOBS = {
    "defaults": {},
    "transposed": dict(transposed_carry=True),
    "tsplit": dict(framing="tsplit"),
    "split_real": dict(stft_packed=False),
    "unpack_0": dict(stft_unpack_split=0),
    "i16": dict(i16_planes=True),
}


def _plans(cfg):
    """Every factorization choose_factors weighs: n1 | W, n1 * n2 = N, both
    at most 256."""
    n, w = cfg.padded_size, cfg.window_size
    return [(n, n1, n // n1, w // n1) for n1 in range(2, 257)
            if n % n1 == 0 and w % n1 == 0 and n // n1 <= 256]


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("k", [1, 8])
def test_override_plan_matches_jax(geometry, k):
    """For each knob set both packages accept, each plan swap gives JAX's
    decisions: the plan, the transposed carry, the tsplit framing, the
    block rows; `stft_packed` and `stft_unpack_split` where JAX's "auto"
    stays packed (the port's "auto" is packed on every plan, a recorded
    deviation), and an i16_planes pipeline raises where JAX's does not
    keep the packed STFT only for that reason."""
    kw = GEOMETRIES[geometry]
    cfg, jc = SpectrogramConfig(**kw), jcfg.SpectrogramConfig(**kw)
    plans = _plans(cfg)
    assert len(plans) >= 4
    for name, knobs in KNOBS.items():
        args = dict(chunk_hops=k, store_ring=False, **knobs)
        try:
            jp = JaxPipeline(jc, stft_backend="pallas", **args)
        except ValueError:
            # i16_planes: JAX's "auto" leaves the packed STFT where its
            # plan gate fails, the port's does not (the deviation above)
            if not knobs.get("i16_planes"):
                with pytest.raises(ValueError):
                    SpectrogramPipeline(cfg, device="cpu", **args)
            continue
        tp = SpectrogramPipeline(cfg, device="cpu", **args)
        for plan in plans:
            try:
                jp.override_plan(JaxPlan(*plan), block_rows=32)
                jerr = None
            except ValueError as e:
                jerr = e
            tp.override_plan(fft_plan.FftPlan(*plan), block_rows=32)
            if jerr is not None:
                # JAX's "auto" left the packed STFT on this plan
                assert knobs.get("i16_planes") and not jp.stft_packed, (name, plan, jerr)
                assert tp.stft_packed
                continue
            assert dataclasses.astuple(tp.fft_plan) == dataclasses.astuple(jp.fft_plan)
            for attr in ("carry_transposed", "tsplit_framing", "carry_is_transposed",
                         "stft_block_rows"):
                assert getattr(tp, attr) == getattr(jp, attr), (name, plan, attr)
            if jp.stft_packed or knobs.get("stft_packed") is False:
                assert (tp.stft_packed, tp.stft_unpack_split) == (
                    jp.stft_packed, jp.stft_unpack_split), (name, plan)
            else:
                assert tp.stft_packed, (name, plan)
                assert tp.stft_unpack_split == knobs.get("stft_unpack_split", 3), (name, plan)


def test_override_plan_keeps_the_transposed_layout_consistent():
    """A plan swap that a transposed carry cannot take clears it (as JAX),
    and a state built after the swap takes the new layout's carry; a
    swap back to a plan that takes it does not re-enable it."""
    cfg = SpectrogramConfig(**SMALL)
    p = SpectrogramPipeline(cfg, chunk_hops=1, store_ring=False, transposed_carry=True,
                            device="cpu")
    n1 = p.fft_plan.n1
    assert p.carry_transposed and p.init_state(2).carry.shape == (2, 2, n1, p.carry_size // n1)
    p.override_plan(fft_plan.FftPlan(512, 128, 4, 2))        # hop 64 % 128 != 0
    assert not p.carry_transposed and p.init_state(2).carry.shape == (2, 2, p.carry_size)
    p.override_plan(fft_plan.FftPlan(512, 4, 128, 64))
    assert not p.carry_transposed


# ------------------------------------------------------- restored_tables_for

# (streams, palette ids, pipeline arguments)
RESTORE_LAYOUTS = {
    "one_palette": (256, np.full(256, 3), {}),
    "clustered": (256, np.arange(256) // 128, {}),
    "scattered_sortable": (256, np.arange(256) % 2, {}),
    "scattered_unsortable": (256, np.arange(256) % 19, {}),
    "global": (576, np.arange(576) % 2, dict(stream_blocks=128)),
    "ring": (256, np.arange(256) % 2, dict(store_ring=True, viewport_rows=4)),
    "blockwise_off": (256, np.arange(256) // 128, dict(blockwise_palettes=False)),
    "no_sort": (256, np.arange(256) % 2, dict(palette_sort=False)),
}


@pytest.mark.parametrize("layout", sorted(RESTORE_LAYOUTS))
def test_restored_tables_for_matches_jax(layout):
    """The tables tuple re-derived from concrete ids: JAX's structure and
    values (marker, 3-tuple, global 4-tuple, or plain), and the one
    set_palette gives the same ids."""
    s, ids, kw = RESTORE_LAYOUTS[layout]
    cfg = dataclasses.replace(BENCH_CONFIG, viewport_height=64)
    jc = dataclasses.replace(jcfg.BENCH_CONFIG, viewport_height=64)
    args = dict(dict(chunk_hops=1, store_ring=False, packed_output=True), **kw)
    jp = JaxPipeline(jc, stft_backend="pallas", colormap_backend="pallas",
                     kernel_interpret=True, **args)
    tp = SpectrogramPipeline(cfg, device="cpu", **args)
    want = [np.asarray(t) for t in jp.restored_tables_for(ids)]
    for given in (ids, torch.from_numpy(ids)):
        got = tp.restored_tables_for(given)
        assert [tuple(t.shape) for t in got] == [t.shape for t in want], layout
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b)
    via_set = tp.set_palette(tp.init_state(s), ids).tables
    assert len(via_set) == len(want)
    for a, b in zip(via_set, tp.restored_tables_for(ids)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="out of range"):
        tp.restored_tables_for(np.full(s, 19))
