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
"""

import ctypes
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
