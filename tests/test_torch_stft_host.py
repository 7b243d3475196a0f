"""The STFT kernels' device code, compiled for the CPU, against a float64 FFT
and against the plain versions.

`spectrogram_tpu_torch/csrc/stft_fft.cuh` holds the row code every STFT
kernel runs: the Hann-pack-pad load, the radix-2 and mixed-radix (4/2/3/5)
FFT bodies, the stereo unpack, and the split-real row with its four sample
sources (window planes, carry+chunk buffers, the transposed operand, the
transposed carry and chunk) and the tsplit next carry.  Its index logic (bit and digit reversal,
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
import torch

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
    for fn in (lib.stft_host_rows, lib.stft_host_rows_i16):
        fn.argtypes = (i, i, i, i, p, p, p, p, p, p)
        fn.restype = i
    lib.stft_host_plan.argtypes = (i, p)
    lib.stft_host_plan.restype = i
    lib.stft_host_split.argtypes = (i, i, i, i, p, p, p, p, p, p)
    lib.stft_host_split_allk.argtypes = (i, i, i, i, i, i, i, p, p, p, p, p, p)
    lib.stft_host_split_t.argtypes = (i, i, i, i, i, p, p, p, p, p)
    lib.stft_host_split_tsplit.argtypes = (i, i, i, i, i, i, p, p, p, p, p, p, p)
    for fn in (lib.stft_host_split, lib.stft_host_split_allk,
               lib.stft_host_split_t, lib.stft_host_split_tsplit):
        fn.restype = i
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


def _host_rows(host_lib, fn, mixed, n_fft, left, right, hann):
    rows, w = left.shape
    tw = tsk.twiddle_table(n_fft)
    out_l = np.zeros((rows, n_fft // 2), np.float32)
    out_r = np.zeros_like(out_l)
    assert fn(mixed, n_fft, rows, w, left.ctypes.data, right.ctypes.data,
              hann.ctypes.data, tw.ctypes.data, out_l.ctypes.data,
              out_r.ctypes.data) == 0
    return out_l, out_r


@pytest.mark.parametrize("n_fft,mixed", [(4096, 0), (4800, 1)])
def test_int16_rows_equal_f32_rows_of_x_over_32768(host_lib, n_fft, mixed):
    """The int16 load (exact conversion, 2^-15 folded into the window) gives
    the bits of the f32 load of x / 32768, full-scale words included."""
    rows, w = 3, n_fft // 2
    rng = np.random.default_rng(n_fft)
    words = rng.integers(-32768, 32768, (2, rows, w), dtype=np.int16)
    words[0, 0, :4] = (-32768, 32767, 0, -1)
    got = _host_rows(host_lib, host_lib.stft_host_rows_i16, mixed, n_fft,
                     words[0], words[1], tsk.packed_hann_i16(w))
    scaled = words.astype(np.float32) / np.float32(32768.0)
    want = _host_rows(host_lib, host_lib.stft_host_rows, mixed, n_fft,
                      np.ascontiguousarray(scaled[0]), np.ascontiguousarray(scaled[1]),
                      tsk.packed_hann(w))
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)


# ------------------------------------------------------------- split-real

def _ptr(a: np.ndarray) -> int:
    assert a.flags.c_contiguous
    return a.ctypes.data


def _outs(rows: int, n_fft: int):
    return np.zeros((rows, n_fft // 2), np.float32), np.zeros((rows, n_fft // 2), np.float32)


# (N, mixed, n1): radix-2 and mixed radix, windows of W = N/2 = n1 * m
@pytest.mark.parametrize("n_fft,mixed,n1", [(512, 0, 8), (480, 1, 8), (4800, 1, 48)])
@pytest.mark.parametrize("kind", ["chirp_tone", "noise"])
def test_split_real_layouts_match_plain(host_lib, n_fft, mixed, n1, kind):
    """Each of the four sample sources through `stft_real_row` against
    `stft_mag_split_plain` on the same windows, and all four bit for bit
    the same: a source that misplaces a sample (j1 and t swapped) fails."""
    rows, w = 3, n_fft // 2
    m = w // n1
    pcm = testing.make(kind, rows, w, 48000.0, seed=n_fft)
    left = np.ascontiguousarray(pcm[..., 0])
    right = np.ascontiguousarray(pcm[..., 1])
    hann = tsk.split_hann(w)
    tw = tsk.twiddle_table(n_fft)
    want = tsk.stft_mag_split_plain(torch.from_numpy(left), torch.from_numpy(right),
                                    torch.from_numpy(hann), n_fft)

    planes = _outs(rows, n_fft)
    assert host_lib.stft_host_split(mixed, n_fft, rows, w, _ptr(left), _ptr(right),
                                    _ptr(hann), _ptr(tw), *map(_ptr, planes)) == 0
    for got, x in zip(planes, want):
        np.testing.assert_allclose(got, x.numpy(), atol=ATOL, rtol=0)

    # the transposed operand: x[n, c, j1, t] = sample t*n1 + j1
    x = np.ascontiguousarray(
        np.stack([left, right], 1).reshape(rows, 2, m, n1).transpose(0, 1, 3, 2))
    t_out = _outs(rows, n_fft)
    assert host_lib.stft_host_split_t(mixed, n_fft, rows, n1, m, _ptr(x), _ptr(hann),
                                      _ptr(tw), *map(_ptr, t_out)) == 0
    torch_t = tsk.stft_mag_split_t_plain(torch.from_numpy(x), torch.from_numpy(hann), n_fft)

    # k=3 windows of two streams' carry+chunk buffers, row r*S + s, against
    # the plane source on the extracted windows
    k, s, hop = 3, 2, w // 4
    ld = w + (k - 1) * hop + 5
    buf = testing.make(kind, s, ld, 48000.0, seed=n_fft + 1)
    buf_l, buf_r = (np.ascontiguousarray(buf[..., c]) for c in range(2))
    wl, wr = (np.ascontiguousarray(np.concatenate([b[:, r * hop : r * hop + w]
                                                   for r in range(k)]))
              for b in (buf_l, buf_r))
    allk = _outs(k * s, n_fft)
    assert host_lib.stft_host_split_allk(mixed, n_fft, s, ld, k, hop, w, _ptr(buf_l),
                                         _ptr(buf_r), _ptr(hann), _ptr(tw),
                                         *map(_ptr, allk)) == 0
    allk_planes = _outs(k * s, n_fft)
    assert host_lib.stft_host_split(mixed, n_fft, k * s, w, _ptr(wl), _ptr(wr), _ptr(hann),
                                    _ptr(tw), *map(_ptr, allk_planes)) == 0
    torch_allk = tsk.stft_mag_split_allk_plain(torch.from_numpy(buf_l), torch.from_numpy(buf_r),
                                               torch.from_numpy(hann), n_fft, k, hop)

    for got, same, plain in zip(t_out, planes, torch_t):
        np.testing.assert_array_equal(got, same)
        np.testing.assert_allclose(got, plain.numpy(), atol=ATOL, rtol=0)
    for got, same, plain in zip(allk, allk_planes, torch_allk):
        np.testing.assert_array_equal(got, same)
        np.testing.assert_allclose(got, plain.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_fft,mixed,n1", [(512, 0, 8), (480, 1, 8)])
@pytest.mark.parametrize("t_cols", [5, 25])
def test_split_real_tsplit_matches_plain_and_framing(host_lib, n_fft, mixed, n1, t_cols):
    """Carry + chunk as two operands: magnitudes bit for bit the transposed
    operand's, within the bar of the plain version; the next carry equal to
    the transposed framing's (carry + chunk, last c_cols columns), on both
    sides of t_cols = c_cols."""
    rows, w = 3, n_fft // 2
    m = w // n1
    c_cols = m - t_cols
    rng = np.random.default_rng(t_cols)
    x = (rng.standard_normal((rows, 2, n1, m)) * 0.3).astype(np.float32)
    carry = np.ascontiguousarray(x[..., :c_cols])
    chunk = np.ascontiguousarray(x[..., c_cols:])
    hann = tsk.split_hann(w)
    tw = tsk.twiddle_table(n_fft)
    out = _outs(rows, n_fft)
    nxt = np.full_like(carry, np.nan)
    assert host_lib.stft_host_split_tsplit(
        mixed, n_fft, rows, n1, c_cols, t_cols, _ptr(carry), _ptr(chunk), _ptr(hann),
        _ptr(tw), *map(_ptr, out), _ptr(nxt)) == 0
    t_out = _outs(rows, n_fft)
    assert host_lib.stft_host_split_t(mixed, n_fft, rows, n1, m, _ptr(x), _ptr(hann),
                                      _ptr(tw), *map(_ptr, t_out)) == 0
    plain = tsk.stft_mag_split_tsplit_plain(torch.from_numpy(carry), torch.from_numpy(chunk),
                                            torch.from_numpy(hann), n_fft)
    for got, same, want in zip(out, t_out, plain):
        np.testing.assert_array_equal(got, same)
        np.testing.assert_allclose(got, want.numpy(), atol=ATOL, rtol=0)
    # the next push's carry by the torch framing: the window's columns
    # after a hop of t_cols, i.e. the last c_cols of carry + chunk
    framed = np.concatenate([carry, chunk], axis=3)[..., t_cols:]
    np.testing.assert_array_equal(nxt, framed)
    np.testing.assert_array_equal(plain[2].numpy(), framed)
