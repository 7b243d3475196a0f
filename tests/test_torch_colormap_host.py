"""The colormap kernels' per-pixel device code, compiled for the CPU, against
the plain versions.

`spectrogram_tpu_torch/csrc/colormap_common.cuh` holds what every colormap
kernel runs for one pixel: the taps, dB and pan laws (`pixel_texels`), the
built-in word and the generic two-table word.  None of it depends on the
card, so a C++ compiler can run it here: `tests/cuda_host_stub/` supplies a
host stand-in for the CUDA runtime and an entry that colors whole rows, row
n reading its tables at (n / rows_per_table) % T as the kernels do.  The
bar is 1 u8 per channel against the plain PyTorch versions (the host's
log10f and PyTorch's may round differently); a wrong table entry, channel
or association gives far more.  Without a C++ compiler the tests skip.

Kernel B, the blockwise colormap (kernel B's code under its own entry) and
the generic kernel color rows through a tile (`csrc/colormap_tile.cuh`):
whole rows per CTA, four pixels per thread, each row's planes and tables
copied into a stage of shared memory.  The stub runs each CTA's loop in
turn with the header's own index code, the stage an array and each copy a
memcpy; its words must equal the per-pixel rows bit for bit, every (row,
pixel) stored exactly once.  `colormap_rows_fused`'s kernel runs the
generic kernel's tile on planar rows [rows, 2, B] at two taps (a plane row
stride of 2B, the taps tap-major): its host run must give the K-tap
per-pixel body's words (`planar_row_pixel`), every pixel stored once.
"""

import ctypes
import dataclasses
import functools
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from spectrogram_tpu_torch import testing
from spectrogram_tpu_torch.config import BENCH_CONFIG, SpectrogramConfig
from spectrogram_tpu_torch.ops import colormap as tcm
from spectrogram_tpu_torch.ops.cuda import colormap_kernel as tck
from spectrogram_tpu_torch.ops.cuda import stft_kernel as tsk

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
STUB = ROOT / "tests" / "cuda_host_stub"
CSRC = ROOT / "spectrogram_tpu_torch" / "csrc"
GEOMETRIES = {"small": SpectrogramConfig(sample_rate=8000.0, window_period=0.032,
                                         hop_period=0.008, viewport_height=64),
              "bench": BENCH_CONFIG}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler to build the device code for the CPU")
    out = tmp_path_factory.mktemp("colormap_host") / "libcolormap_host.so"
    subprocess.run(
        [cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         f"-I{STUB}", f"-I{CSRC}", "-o", str(out), str(STUB / "colormap_host.cpp")],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(out))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.colormap_host_rows.argtypes = (p, p, i, i, p, p, p, p, i, p, p, i, i, i,
                                       f, f, f, f, p)
    lib.colormap_host_rows.restype = i
    lib.colormap_host_tile.argtypes = (p, p, i, i, i, p, p, p, p, i, p, p, i, i, i,
                                       f, f, f, f, p, p)
    lib.colormap_host_tile.restype = i
    lib.colormap_host_blockwise.argtypes = (p, p, i, i, i, p, p, p, p, i, p, i, i, i, i,
                                            f, f, f, f, p, p)
    lib.colormap_host_blockwise.restype = i
    lib.colormap_host_form.argtypes = (i, i, i, i)
    lib.colormap_host_form.restype = i
    lib.colormap_host_planar_rows.argtypes = (p, i, i, p, p, i, i, p, p, i, f, f, f, f, p)
    lib.colormap_host_planar_rows.restype = i
    lib.colormap_host_planar_tile.argtypes = (p, i, i, i, p, p, i, p, p, i, f, f, f, f, p, p)
    lib.colormap_host_planar_tile.restype = i
    return lib


def _host_rows(lib, ml, mr, taps, u, v, cfg, rows_per_table=1) -> np.ndarray:
    """[rows, H] RGBA8888 words from the host build: the built-in body with
    tables `u`, or the generic body with factors `u`, `v`."""
    rows, bins = ml.shape
    h = taps.j0.shape[0]
    res = u.shape[1] // 4
    out = np.zeros((rows, h), np.uint32)
    arrays = [np.ascontiguousarray(x.numpy()) for x in (ml, mr, *taps[:4], u)]
    v_arr = None if v is None else np.ascontiguousarray(v.numpy())
    assert lib.colormap_host_rows(
        *(a.ctypes.data for a in arrays[:2]), rows, bins,
        *(a.ctypes.data for a in arrays[2:6]), h, arrays[6].ctypes.data,
        None if v_arr is None else v_arr.ctypes.data, u.shape[0], rows_per_table,
        res, cfg.min_db, cfg.max_db - cfg.min_db, cfg.db_epsilon, 1.0 / (res - 1),
        out.ctypes.data) == 0
    return out.view(np.int32)


def _planes(cfg, rows: int):
    frames = testing.chirp_tone(1, rows * cfg.window_size, cfg.sample_rate, seed=3)[0]
    frames = frames.reshape(rows, cfg.window_size, 2).copy()
    frames[-1] = 0.0                 # silence: the pan guard
    frames[0] *= 40.0                # loud: saturates the magnitude axis
    return tsk.stft_mag_packed_plain(
        torch.from_numpy(np.ascontiguousarray(frames[..., 0])),
        torch.from_numpy(np.ascontiguousarray(frames[..., 1])),
        torch.from_numpy(tsk.packed_hann(cfg.window_size)), cfg.padded_size)


def _u8_diff(a, b) -> int:
    return int(np.abs(tck.unpack_rgba(a).astype(int) - tck.unpack_rgba(b).astype(int)).max())


def _custom():
    """`testing.custom_factors` with alpha from pan as well, so that every
    channel of V varies: [1, R*4] tables."""
    u, v = testing.custom_factors()
    v[:, 3] = 1.0 - np.linspace(0.0, 1.0, 32, dtype=np.float32)
    return torch.from_numpy(u.reshape(1, -1)), torch.from_numpy(v.reshape(1, -1))


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("layout", ["per_row", "one_table", "rows_per_table"])
def test_builtin_and_generic_bodies_match_plain(host_lib, geometry, layout):
    cfg = GEOMETRIES[geometry]
    rows = 8
    ml, mr = _planes(cfg, rows)
    taps = tck.resample_taps(tcm.resample_matrix_full(cfg))
    builtin = torch.from_numpy(tck.builtin_color_tables(32))
    gu, gv = (torch.from_numpy(t) for t in tck.generic_color_tables(32))
    cu, cv = _custom()
    gu, gv = torch.cat([gu, cu]), torch.cat([gv, cv])    # 20 palettes, one generic
    pick = {"per_row": torch.tensor([19, 0, 1, 3, 8, 19, 4, 2]),
            "one_table": torch.tensor([19]),
            "rows_per_table": torch.tensor([19, 3, 0, 8])}[layout]
    rpt = 2 if layout == "rows_per_table" else 1
    ids = pick.clamp(max=18)                             # built-in: no 20th
    got = _host_rows(host_lib, ml, mr, taps, builtin[ids], None, cfg, rpt)
    want = tck.colormap_builtin_plain(ml, mr, taps, builtin[ids], cfg, rpt).numpy()
    assert _u8_diff(got, want) <= 1
    got = _host_rows(host_lib, ml, mr, taps, gu[pick], gv[pick], cfg, rpt)
    want = tck.colormap_generic_plain(ml, mr, taps, gu[pick], gv[pick], cfg, rpt).numpy()
    assert _u8_diff(got, want) <= 1
    # the static colormap's plain version is the one-table one
    if layout == "one_table":
        static = tck.colormap_static_plain(ml, mr, taps, (cu[0].numpy(), cv[0].numpy()), cfg)
        np.testing.assert_array_equal(static.numpy(), want)


# ------------------------------------------------------------------ the tile

TILE_ROWS = 37              # no multiple of the tile's rows per CTA
TILE_WIDTHS = {2048: BENCH_CONFIG,                                       # N=4096
               2205: SpectrogramConfig(sample_rate=44100.0, window_period=0.05)}  # 4410


@functools.lru_cache(maxsize=None)
def _tile_operands(bins: int, h: int):
    """Planes [TILE_ROWS, bins] (the left one a float past a 16-byte
    boundary, inside a padded buffer, so that the copies' rounding reads
    only the buffer) and the taps of the geometry at width h."""
    cfg = dataclasses.replace(TILE_WIDTHS[bins], viewport_height=h)
    ml, mr = _planes(cfg, TILE_ROWS)
    assert ml.shape == (TILE_ROWS, bins)
    planes = []
    for plane, offset in ((ml, 1), (mr, 0)):
        buf = np.zeros(TILE_ROWS * bins + 8, np.float32)
        buf[offset : offset + plane.numel()] = plane.numpy().reshape(-1)
        planes.append((buf, offset))
    taps = tck.resample_taps(tcm.resample_matrix_full(cfg))
    return cfg, (ml, mr), planes, taps


def _tile_tables(word: str, n_tables: int):
    gu, gv = (torch.from_numpy(t) for t in tck.generic_color_tables(32))
    cu, cv = _custom()
    if word == "builtin":
        t = torch.from_numpy(tck.builtin_color_tables(32))
        return (t if n_tables == 19 else t[3:4]).contiguous(), None
    u, v = torch.cat([cu, gu[:18]]), torch.cat([cv, gv[:18]])
    return u[:n_tables].contiguous(), v[:n_tables].contiguous()


def _host_tile(lib, planes, taps, u, v, cfg, rows_per_table, block_rows=None):
    """(words, stores per word) of the tile's host run: kernel B, or the
    generic kernel where v is given; the blockwise entry where `block_rows`
    is given."""
    (bl, ol), (br, orr) = planes
    bins = (bl.size - 8) // TILE_ROWS
    h = taps.j0.shape[0]
    res = u.shape[1] // 4
    out = np.zeros((TILE_ROWS, h), np.uint32)
    count = np.zeros((TILE_ROWS, h), np.int32)
    tap_arrays = [np.ascontiguousarray(t.numpy()) for t in taps[:4]]
    u_arr = np.ascontiguousarray(u.numpy())
    v_arr = None if v is None else np.ascontiguousarray(v.numpy())
    v_ptr = None if v_arr is None else v_arr.ctypes.data
    head = (bl.ctypes.data + 4 * ol, br.ctypes.data + 4 * orr, TILE_ROWS, bins, taps.span,
            *(a.ctypes.data for a in tap_arrays), h)
    laws = (cfg.min_db, cfg.max_db - cfg.min_db, cfg.db_epsilon, 1.0 / (res - 1),
            out.ctypes.data, count.ctypes.data)
    if block_rows is None:
        code = lib.colormap_host_tile(*head, u_arr.ctypes.data, v_ptr, u.shape[0],
                                      rows_per_table, res, *laws)
    else:
        code = lib.colormap_host_blockwise(*head, u_arr.ctypes.data, u.shape[0],
                                           rows_per_table, res, block_rows, *laws)
    assert code == 0, f"the tile's host run refused ({code})"
    return out.view(np.int32), count


@pytest.mark.parametrize("word", ["builtin", "generic"])
@pytest.mark.parametrize("n_tables", [1, 19])
# 16: a CTA's rows lie 10 apart (grid 10), so some take the table of the
# row before them and some a new one: a stage's table skip keyed on the
# wrong earlier row shows only there
@pytest.mark.parametrize("rows_per_table", [1, 8, 16])
@pytest.mark.parametrize("bins", sorted(TILE_WIDTHS))
@pytest.mark.parametrize("h", [64, 1024, 1021])
def test_tile_writes_every_pixel_once_with_the_pixel_bits(host_lib, h, bins,
                                                          rows_per_table, n_tables, word):
    cfg, (ml, mr), planes, taps = _tile_operands(bins, h)
    u, v = _tile_tables(word, n_tables)
    got, count = _host_tile(host_lib, planes, taps, u, v, cfg, rows_per_table)
    np.testing.assert_array_equal(count, 1)
    want = _host_rows(host_lib, ml, mr, taps, u, v, cfg, rows_per_table)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layout", ["uniform copies", "mixed copies", "uniform shared"])
@pytest.mark.parametrize("block_rows", [8, 128])
@pytest.mark.parametrize("bins", sorted(TILE_WIDTHS))
@pytest.mark.parametrize("h", [64, 1024, 1021])
def test_blockwise_tile_writes_every_pixel_once_with_the_pixel_bits(host_lib, h, bins,
                                                                    block_rows, layout):
    """The blockwise colormap's staged form on 37 rows (no multiple of
    `block_rows`): blocks of one palette whose rows hold copies of it
    (equal bytes at different addresses, as the sorted state's per-row
    tables), mixed blocks, and blocks whose rows share one table by
    address (`rows_per_table` = `block_rows`); every pixel stored once, the
    per-pixel rows' bits."""
    cfg, (ml, mr), planes, taps = _tile_operands(bins, h)
    builtin = torch.from_numpy(tck.builtin_color_tables(32))
    rows = torch.arange(TILE_ROWS)
    tables, rpt = {"uniform copies": (builtin[(rows // block_rows) % 19], 1),
                   "mixed copies": (builtin[rows % 19], 1),
                   "uniform shared": (builtin, block_rows)}[layout]
    tables = tables.contiguous()
    got, count = _host_tile(host_lib, planes, taps, tables, None, cfg, rpt, block_rows)
    np.testing.assert_array_equal(count, 1)
    np.testing.assert_array_equal(got, _host_rows(host_lib, ml, mr, taps, tables, None, cfg,
                                                  rpt))


def test_blockwise_entry_refuses_what_the_launch_refuses(host_lib):
    """block_rows < 1 and a span past the bins."""
    cfg, _, planes, taps = _tile_operands(2048, 64)
    table = torch.from_numpy(tck.builtin_color_tables(32)[:1])
    for t, block_rows in ((taps, 0), (taps._replace(span=2049), 8)):
        with pytest.raises(AssertionError, match="refused"):
            _host_tile(host_lib, planes, t, table, None, cfg, 1, block_rows)


# (geometry, width) -> the form kernel B (and the blockwise colormap) and
# the generic kernel take
FORMS = {
    ("bench", 1024): ("staged", "staged"),                               # span 1875
    ("bench", 1021): ("staged", "staged"),
    ("44.1 kHz N=4410", 1024): ("staged", "staged"),                     # span 2197
    ("N=6400", 1024): ("direct", "staged"),                              # span 2929
    ("N=8192", 1024): ("direct", "direct"),                              # span 3749
    ("N=16384", 1024): ("direct", "direct"),                             # span 7497
    ("48 kHz 0.5 s", 1024): ("direct", "direct"),                        # span 21,961
    ("N=2400", 512): ("staged", "staged"),                               # span 1096
    ("bench", 512): ("direct", "direct"),                                # span 1869
    ("N=6400", 512): ("direct", "direct"),                               # span 2920
    ("bench", 64): ("direct", "direct"),
}


@pytest.mark.parametrize("geometry,h", sorted(FORMS))
def test_tile_form_follows_the_span(host_lib, geometry, h):
    """`ResampleTaps.span` is the highest tap + 1, and the launch stages the
    planes where the span is at most 2.25h (built-in) or 3h (generic) and two
    stages fit 48 KB: the main paths' spans at H = 1024, not the long
    windows, nor spans wide beside a narrow H."""
    base = {"bench": BENCH_CONFIG,
            "44.1 kHz N=4410": TILE_WIDTHS[2205],
            "N=2400": SpectrogramConfig(window_period=1200 / 48000.0),
            "N=6400": SpectrogramConfig(window_period=3200 / 48000.0),
            "N=8192": SpectrogramConfig(window_period=4096 / 48000.0),
            "N=16384": SpectrogramConfig(window_period=8192 / 48000.0),
            "48 kHz 0.5 s": SpectrogramConfig(window_period=0.5)}[geometry]
    cfg = dataclasses.replace(base, viewport_height=h)
    m = tcm.resample_matrix_full(cfg)
    taps = tck.resample_taps(m)
    assert taps.span == int(np.nonzero(m)[1].max()) + 1 <= taps.bins
    got = tuple({1: "staged", 0: "direct"}[host_lib.colormap_host_form(taps.span, h, 32, g)]
                for g in (0, 1))
    assert got == FORMS[geometry, h]


# ------------------------------------------------- planar rows on the tile

# B -> (geometry, planes, matrix): BENCH_CONFIG's ring planes (bins 1 ..
# W-1: the right plane starts 8,188 bytes into a row) and the N=4410 planes
PLANAR_WIDTHS = {2047: (BENCH_CONFIG, "ring"), 2205: (TILE_WIDTHS[2205], "full")}


@pytest.mark.parametrize("bins", sorted(PLANAR_WIDTHS))
@pytest.mark.parametrize("h", [512, 1024])
def test_planar_rows_tile_writes_every_pixel_once_with_the_rows_bits(host_lib, h, bins):
    """spk_colormap_rows at two taps: the generic kernel's tile over planar
    rows [37, 2, B] (a plane row stride of 2B, the buffer a float past a
    16-byte boundary, so both planes' copies start unaligned), tap-major
    taps and per-row factors, stores every pixel once with the words of the
    K-tap per-pixel body `colormap_rows_kernel` runs."""
    base, kind = PLANAR_WIDTHS[bins]
    cfg = dataclasses.replace(base, viewport_height=h)
    ml, mr = _planes(cfg, TILE_ROWS)
    if kind == "ring":
        w = cfg.window_size
        ml, mr = ml[:, 1:w], mr[:, 1:w]
        m = tcm.resample_matrix(cfg)
    else:
        m = tcm.resample_matrix_full(cfg)
    rows = np.ascontiguousarray(torch.stack([ml, mr], 1).numpy())
    assert rows.shape == (TILE_ROWS, 2, bins) and m.shape == (h, bins)
    buf = np.zeros(rows.size + 8, np.float32)
    buf[1 : 1 + rows.size] = rows.reshape(-1)
    ptr = buf.ctypes.data + 4
    taps = tck.resample_taps_k(m.T)
    assert taps.j.shape == (h, 2) and taps.span == int(np.nonzero(m)[1].max()) + 1
    tap_j, tap_w = (np.ascontiguousarray(t.numpy()) for t in taps.pairs)
    np.testing.assert_array_equal(tap_j, taps.j.numpy().T)
    j, w = (np.ascontiguousarray(t.numpy()) for t in (taps.j, taps.w))
    gu, gv = tck.generic_color_tables(32)
    cu, cv = (t.numpy() for t in _custom())
    pick = np.arange(TILE_ROWS) % 20
    u = np.ascontiguousarray(np.concatenate([gu, cu])[pick])
    v = np.ascontiguousarray(np.concatenate([gv, cv])[pick])
    res = 32
    laws = (cfg.min_db, cfg.max_db - cfg.min_db, cfg.db_epsilon, 1.0 / (res - 1))
    got = np.zeros((TILE_ROWS, h), np.uint32)
    count = np.zeros((TILE_ROWS, h), np.int32)
    assert host_lib.colormap_host_planar_tile(
        ptr, TILE_ROWS, bins, taps.span, tap_j.ctypes.data, tap_w.ctypes.data, h,
        u.ctypes.data, v.ctypes.data, res, *laws, got.ctypes.data, count.ctypes.data) == 0
    np.testing.assert_array_equal(count, 1)
    want = np.zeros_like(got)
    assert host_lib.colormap_host_planar_rows(
        ptr, TILE_ROWS, bins, j.ctypes.data, w.ctypes.data, h, 2, u.ctypes.data,
        v.ctypes.data, res, *laws, want.ctypes.data) == 0
    np.testing.assert_array_equal(got, want)
    plain = tck.colormap_rows_fused_plain(
        torch.from_numpy(rows), torch.from_numpy(u.reshape(TILE_ROWS, res, 4)),
        torch.from_numpy(v.reshape(TILE_ROWS, res, 4)), torch.from_numpy(m.T.copy()), cfg,
        packed=True)
    assert _u8_diff(got.view(np.int32), plain.numpy()) <= 1
