"""The STFT kernels' device code, compiled for the CPU, against a float64 FFT.

`spectrogram_tpu_torch/csrc/stft_fft.cuh` holds the row code every STFT
kernel runs: the Hann-pack-pad load, the radix-2 and mixed-radix (4/2/3/5)
FFT bodies and the stereo unpack.  Its index logic (bit and digit reversal,
butterfly positions, twiddle indices) does not depend on the card, so a C++
compiler can run it here: `tests/cuda_host_stub/` supplies a host stand-in
for the CUDA runtime (one thread per block) and a C entry point.  The bar,
1e-6 absolute on magnitudes up to ~0.2, is far below what a wrong index
gives and far above f32 rounding (~3e-8).  Without a C++ compiler the tests
skip.
"""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest

from spectrogram_tpu_torch import testing
from spectrogram_tpu_torch.ops.cuda import stft_kernel as tsk

ROOT = pathlib.Path(__file__).resolve().parents[1]
STUB = ROOT / "tests" / "cuda_host_stub"
CSRC = ROOT / "spectrogram_tpu_torch" / "csrc"
ATOL = 1e-6


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler to build the device code for the CPU")
    out = tmp_path_factory.mktemp("stft_host") / "libstft_host.so"
    subprocess.run(
        [cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         f"-I{STUB}", f"-I{CSRC}", "-o", str(out), str(STUB / "stft_host.cpp")],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.stft_host_rows.argtypes = (i, i, i, i, p, p, p, p, p, p)
    lib.stft_host_rows.restype = i
    lib.stft_host_plan.argtypes = (i, p)
    lib.stft_host_plan.restype = i
    return lib


def _reference(left, right, hann, n):
    z = (left.astype(np.float64) + 1j * right.astype(np.float64)) * hann
    x = np.fft.fft(z, n=n)
    k = np.arange(n // 2)
    a, b = x[:, k], x[:, (n - k) % n]
    return np.abs(a + np.conj(b)), np.abs(a - np.conj(b))


@pytest.mark.parametrize("n_fft,mixed", [
    (256, 0), (4096, 0), (16384, 0),
    (256, 1), (480, 1), (720, 1), (4800, 1), (9600, 1), (2 * 3**8, 1),
])
def test_fft_bodies_match_float64(host_lib, n_fft, mixed):
    rows, w = 3, n_fft // 2
    pcm = testing.chirp_tone(rows, w, 48000.0, seed=n_fft)
    left = np.ascontiguousarray(pcm[..., 0])
    right = np.ascontiguousarray(pcm[..., 1])
    hann = tsk.packed_hann(w)
    tw = tsk.twiddle_table(n_fft)
    out_l = np.zeros((rows, n_fft // 2), np.float32)
    out_r = np.zeros_like(out_l)
    rc = host_lib.stft_host_rows(
        mixed, n_fft, rows, w, left.ctypes.data, right.ctypes.data,
        hann.ctypes.data, tw.ctypes.data, out_l.ctypes.data, out_r.ctypes.data)
    assert rc == 0
    want_l, want_r = _reference(left, right, hann.astype(np.float64), n_fft)
    np.testing.assert_allclose(out_l, want_l, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out_r, want_r, atol=ATOL, rtol=0)


def test_mixed_radix_plans_agree_with_the_size_check(host_lib):
    radix = (ctypes.c_int * 16)()
    assert host_lib.stft_host_plan(4800, radix) == 6
    assert list(radix)[:6] == [4, 4, 4, 3, 5, 5]
    for n in range(tsk.MIN_FFT, 5000, 2):
        stages = host_lib.stft_host_plan(n, radix)
        try:
            tsk.check_fft_size(n)
            taken = True
        except NotImplementedError:
            taken = False
        assert (stages > 0) == taken, n
        if taken:
            assert int(np.prod(list(radix)[:stages])) == n
