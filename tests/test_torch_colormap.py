"""Kernel B's plain version and the colormap laws against the JAX package.

`colormap_builtin_plain` (what the CUDA kernel is held to on the card)
against the TPU kernel `colormap_planes_banded` in interpret mode, with
per-row tables and with one table for all rows.  The bar is 1 u8 per
channel: both sides use the same f32 laws, but XLA's and PyTorch's log10
and the JAX kernel's matmul-form resample may round differently.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrogram_tpu.config import SpectrogramConfig as JaxConfig
from spectrogram_tpu.ops import colormap as jcm
from spectrogram_tpu.ops.pallas import colormap_kernel as jck

from spectrogram_tpu_torch import testing
from spectrogram_tpu_torch.config import BENCH_CONFIG, SpectrogramConfig
from spectrogram_tpu_torch.ops import colormap as tcm
from spectrogram_tpu_torch.ops.cuda import colormap_kernel as tck
from spectrogram_tpu_torch.ops.cuda import stft_kernel as tsk

torch.set_num_threads(2)

SMALL = dict(sample_rate=8000.0, window_period=0.032, hop_period=0.008,
             viewport_height=64)
GEOMETRIES = {"small": SMALL, "bench": None}


def _cfgs(name):
    kw = GEOMETRIES[name]
    if kw is None:
        import spectrogram_tpu.config as jcfg

        return BENCH_CONFIG, jcfg.BENCH_CONFIG
    return SpectrogramConfig(**kw), JaxConfig(**kw)


def _planes(cfg, kind: str, rows: int):
    """[rows, N/2] magnitude planes of `kind` windows; the last row of each
    is silence (the pan guard) and one row is loud enough to saturate."""
    w = cfg.window_size
    frames = testing.make(kind, 1, rows * w, cfg.sample_rate, seed=7)[0]
    frames = frames.reshape(rows, w, 2).copy()
    frames[-1] = 0.0
    frames[0] *= 40.0
    hann = torch.from_numpy(tsk.packed_hann(w))
    ml, mr = tsk.stft_mag_packed_plain(
        torch.from_numpy(np.ascontiguousarray(frames[..., 0])),
        torch.from_numpy(np.ascontiguousarray(frames[..., 1])),
        hann, cfg.padded_size,
    )
    return ml, mr


def _u8(packed) -> np.ndarray:
    return tck.unpack_rgba(np.asarray(packed)).astype(np.int32)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("kind", ["chirp_tone", "noise"])
@pytest.mark.parametrize("layout", ["per_row", "one_table"])
def test_plain_matches_tpu_kernel(geometry, kind, layout):
    cfg, jcfg = _cfgs(geometry)
    rows = 8 if geometry == "small" else 4
    ml, mr = _planes(cfg, kind, rows)
    all_tables = tck.builtin_color_tables(cfg.lut_resolution)
    if layout == "per_row":
        ids = (np.arange(rows) * 5) % len(all_tables)     # mono and stereo mixed
        tables, period = all_tables[ids], rows
    else:
        tables, period = all_tables[[3]], None            # stereo, one table
    full = tcm.resample_matrix_full(cfg)
    got = tck.colormap_builtin_plain(
        ml, mr, tck.resample_taps(full), torch.from_numpy(tables), cfg
    )
    matrix_t = full.T
    want = jck.colormap_planes_banded(
        jnp.asarray(ml.numpy()), jnp.asarray(mr.numpy()), jnp.asarray(tables),
        jnp.asarray(matrix_t), jcfg, jck.band_segments(matrix_t),
        interpret=True, table_period=period,
    )
    assert got.dtype == torch.int32 and got.shape == (rows, cfg.viewport_height)
    diff = np.abs(_u8(got.numpy()) - _u8(want))
    assert diff.max() <= 1, (diff.max(), np.argwhere(diff > 1)[:5])


def test_wrapper_takes_plain_version_on_cpu():
    cfg = SpectrogramConfig(**SMALL)
    ml, mr = _planes(cfg, "noise", 5)
    taps = tck.resample_taps(tcm.resample_matrix_full(cfg))
    tables = torch.from_numpy(tck.builtin_color_tables()[[0, 1, 2, 3, 4]])
    got = tck.colormap_builtin(ml, mr, taps, tables, cfg)
    torch.testing.assert_close(
        got, tck.colormap_builtin_plain(ml, mr, taps, tables, cfg), atol=0, rtol=0
    )
    with pytest.raises(ValueError, match="no colormap kernel"):
        tck.colormap_builtin(ml.to("meta"), mr.to("meta"), taps, tables, cfg)
    # taps built for other planes, and empty or one-entry tables, never
    # reach a kernel that would index with them unchecked
    bench_taps = tck.resample_taps(tcm.resample_matrix_full(BENCH_CONFIG))
    for bad_taps, bad_tables in ((bench_taps, tables), (taps, tables[:0]),
                                 (taps, tables[:, :4])):
        with pytest.raises(ValueError, match="do not fit"):
            tck.colormap_builtin(ml.to("meta"), mr.to("meta"), bad_taps,
                                 bad_tables, cfg)


def test_row_tables_wrap_modulo():
    """Row n reads tables[n % T]: 2 windows x 3 streams, window-major."""
    cfg = SpectrogramConfig(**SMALL)
    ml, mr = _planes(cfg, "chirp_tone", 6)
    taps = tck.resample_taps(tcm.resample_matrix_full(cfg))
    t3 = torch.from_numpy(tck.builtin_color_tables()[[0, 8, 13]])
    got = tck.colormap_builtin_plain(ml, mr, taps, t3, cfg)
    want = tck.colormap_builtin_plain(ml, mr, taps, t3.repeat(2, 1), cfg)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_laws_match_jax():
    cfg, jcfg = SpectrogramConfig(**SMALL), JaxConfig(**SMALL)
    rng = np.random.default_rng(11)
    left = np.abs(rng.standard_normal((5, 64))).astype(np.float32) * 0.1
    right = np.abs(rng.standard_normal((5, 64))).astype(np.float32) * 0.1
    left[0, :8] = right[0, :8] = 0.0                       # pan guard
    tl, tr = torch.from_numpy(left), torch.from_numpy(right)
    jl, jr = jnp.asarray(left), jnp.asarray(right)
    np.testing.assert_allclose(
        tcm.db_normalize(tl, tr, cfg).numpy(),
        np.asarray(jcm.db_normalize(jl, jr, jcfg)), rtol=1e-6, atol=1e-6,
    )
    np.testing.assert_array_equal(
        tcm.pan_fraction(tl, tr).numpy(), np.asarray(jcm.pan_fraction(jl, jr))
    )
    coord = np.linspace(-0.2, 1.2, 97).astype(np.float32)
    np.testing.assert_array_equal(
        tcm.tent_weights(torch.from_numpy(coord), 32).numpy(),
        np.asarray(jcm.tent_weights(jnp.asarray(coord), 32)),
    )
    u, v = tck.generic_color_tables(32)
    u, v = u[:3].reshape(3, 32, 4), v[:3].reshape(3, 32, 4)
    mag, pan = np.clip(left[:3], 0, 1), np.clip(right[:3] * 5, 0, 1)
    np.testing.assert_allclose(
        tcm.sample_lut_factored(*map(torch.from_numpy, (u, v, pan, mag))).numpy(),
        np.asarray(jcm.sample_lut_factored(*map(jnp.asarray, (u, v, pan, mag)))),
        atol=1e-6,
    )
    rows = np.stack([left, right], axis=-1)                   # [5, B=64, 2]
    m = tcm.resample_matrix(cfg, height=16)[:, :64]
    np.testing.assert_allclose(
        tcm.resample_rows(torch.from_numpy(rows), torch.from_numpy(m)).numpy(),
        np.asarray(jcm.resample_rows(jnp.asarray(rows), jnp.asarray(m))),
        rtol=1e-6, atol=1e-7,
    )
    halves = (np.arange(-2, 260) / 255.0 + 0.5 / 255.0).astype(np.float32)
    np.testing.assert_array_equal(
        tcm.rgba_f32_to_u8(torch.from_numpy(halves)).numpy(),
        np.asarray(jcm.rgba_f32_to_u8(jnp.asarray(halves))),
    )


def test_unpack_on_device_matches_host_view():
    packed = torch.tensor([[0x04030201, -1, 0x7F00FF10]], dtype=torch.int32)
    np.testing.assert_array_equal(
        tck.unpack_rgba_device(packed).numpy(), tck.unpack_rgba(packed)
    )
    assert tck.unpack_rgba(packed)[0, 0].tolist() == [1, 2, 3, 4]
