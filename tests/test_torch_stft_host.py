"""The STFT kernels' device code, compiled for the CPU, against a float64 FFT
and against the plain versions.

`spectrogram_tpu_torch/csrc/stft_fft.cuh` holds the row code every STFT
kernel runs: the Hann-pack-pad load, the radix-2, mixed-radix (4/2/3/5/7)
and Bluestein FFT bodies (the chirp and filter products folded into the
first and last stages of its DIF pass, the output chirp into the unpack),
the stereo unpack, and the split-real row (the N/2-point real-FFT pack at
even N, the N-point row at odd N) with its sample sources (window planes,
carry+chunk buffers, the transposed operand, the transposed carry and
chunk, the planar carry and chunk) and the next carries; `push_fused.cuh`
the fused push's row (both channels' split-real STFT into shared planes,
then the built-in colormap's pixels from them).
Its index logic (bit and digit reversal, butterfly positions, twiddle,
chirp and filter indices) does not depend on the card, so a C++ compiler
can run it here: `tests/cuda_host_stub/` supplies a host stand-in for the
CUDA runtime (one thread per block) and C entry points.  The bar, 1e-6
absolute on magnitudes up to ~0.3, is far below what a wrong index gives
and far above f32 rounding (~3e-8; Bluestein's two M-point passes stay
near 5e-8).  Without a C++ compiler the tests skip.
"""

import ctypes
import hashlib
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from spectrogram_tpu_torch import testing
from spectrogram_tpu_torch.config import SpectrogramConfig
from spectrogram_tpu_torch.ops import colormap as tcm
from spectrogram_tpu_torch.ops.cuda import colormap_kernel as tck
from spectrogram_tpu_torch.ops.cuda import stft_kernel as tsk

ROOT = pathlib.Path(__file__).resolve().parents[1]
STUB = ROOT / "tests" / "cuda_host_stub"
CSRC = ROOT / "spectrogram_tpu_torch" / "csrc"
ATOL = 1e-6
RADIX2, MIXED, PICKED = 0, 1, 2   # the stub's body argument (PICKED: by N)
STAGES = 3                        # radix 2, one shared-memory pass per stage
COPY = 4                          # mixed radix (and Bluestein's inner body), one pass per stage
NARROW = 5                        # PICKED with the passes of 64-register kernels
# N with a prime factor above 7: the sizes that keep the Bluestein body
BLUESTEIN_SIZES = (11, 97, 1410, 2204, 4406, 4801, 9998)
# the sha256 of stft_host_rows' output planes (see `_packed_digest`) at the
# parent of radix 7 and of the real-FFT pack: a 5-smooth N keeps its bits
FIVE_SMOOTH_DIGESTS = {
    (4096, 0): "ff916e7e0987b0e8963c8ef3b149d89d9e14e46e8702927a22a0b395f064911d",
    (4800, 1): "14be376bb1a61b6a64487f4592433a33e83166e2a3ee5b52eb64c93bf39e0a75",
    (4800, 2): "14be376bb1a61b6a64487f4592433a33e83166e2a3ee5b52eb64c93bf39e0a75",
}


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
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn in (lib.stft_host_rows, lib.stft_host_rows_i16):
        fn.argtypes = (i, i, i, i, p, p, p, p, p, p)
    lib.stft_host_plan.argtypes = (i, p)
    lib.stft_host_buf_size.argtypes = (i,)
    lib.stft_host_split_buf_size.argtypes = (i,)
    lib.stft_host_split.argtypes = (i, i, i, i, p, p, p, p, p, p)
    lib.stft_host_split_allk.argtypes = (i, i, i, i, i, i, i, p, p, p, p, p, p, p, i)
    lib.stft_host_split_carry.argtypes = (i, i, i, i, i, i, i, p, p, p, p, p, p, p)
    lib.stft_host_split_t.argtypes = (i, i, i, i, i, p, p, p, p, p)
    lib.stft_host_split_tsplit.argtypes = (i, i, i, i, i, i, p, p, p, p, p, p, p)
    lib.stft_host_push.argtypes = (i, i, i, i, p, p, p, p, p, i, i, p, p, p, p, i,
                                   f, f, f, f, p, p, p)
    lib.stft_host_builtin.argtypes = (p, p, i, i, p, i, i, p, p, p, p, i, f, f, f, f, p)
    lib.stft_host_builtin.restype = i
    lib.stft_host_set_load.argtypes = (i,)
    lib.stft_host_set_load.restype = None
    for fn in (lib.stft_host_allk, lib.stft_host_allk_i16):
        fn.argtypes = (i, i, i, i, i, i, i, p, p, p, p, p, p, p, i)
        fn.restype = i
    for fn in (lib.stft_host_rows, lib.stft_host_rows_i16, lib.stft_host_plan,
               lib.stft_host_buf_size, lib.stft_host_split_buf_size, lib.stft_host_split,
               lib.stft_host_split_allk,
               lib.stft_host_split_carry, lib.stft_host_split_t,
               lib.stft_host_split_tsplit, lib.stft_host_push):
        fn.restype = i
    return lib


def _reference(left, right, hann, n, bins=None):
    """float64 stereo unpack of bins 0 .. bins-1 (default N/2)."""
    z = (left.astype(np.float64) + 1j * right.astype(np.float64)) * hann
    x = np.fft.fft(z, n=n)
    k = np.arange(n // 2 if bins is None else bins)
    a, b = x[:, k], x[:, (n - k) % n]
    return np.abs(a + np.conj(b)), np.abs(a - np.conj(b))


def _host_rows(host_lib, fn, body, n_fft, left, right, hann, table=None):
    """fn's [rows, stft_bins] planes; `table` defaults to N's `fft_table`
    (the split-real rows take `split_fft_table`)."""
    rows, w = left.shape
    bins = tsk.stft_bins(n_fft, w)
    out_l = np.zeros((rows, bins), np.float32)
    out_r = np.zeros_like(out_l)
    table = tsk.fft_table(n_fft) if table is None else table
    assert fn(body, n_fft, rows, w, left.ctypes.data, right.ctypes.data,
              hann.ctypes.data, table.ctypes.data, out_l.ctypes.data,
              out_r.ctypes.data) == 0
    return out_l, out_r


@pytest.mark.parametrize("n_fft,body", [
    (256, RADIX2), (4096, RADIX2), (16384, RADIX2),
    (256, MIXED), (480, MIXED), (720, MIXED), (4800, MIXED), (9600, MIXED),
    (2 * 3**8, MIXED),
    *((n, PICKED) for n in BLUESTEIN_SIZES),
])
def test_fft_bodies_match_float64(host_lib, n_fft, body):
    """Every body against a float64 FFT; PICKED takes the body the kernels
    pick for N (Bluestein for every N of BLUESTEIN_SIZES)."""
    if body == PICKED:
        assert tsk.fft_body(n_fft) == "bluestein"
    rows, w = 3, n_fft // 2
    pcm = testing.chirp_tone(rows, w, 48000.0, seed=n_fft)
    left = np.ascontiguousarray(pcm[..., 0])
    right = np.ascontiguousarray(pcm[..., 1])
    hann = tsk.packed_hann(w)
    out_l, out_r = _host_rows(host_lib, host_lib.stft_host_rows, body, n_fft,
                              left, right, hann)
    want_l, want_r = _reference(left, right, hann.astype(np.float64), n_fft)
    np.testing.assert_allclose(out_l, want_l, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out_r, want_r, atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_fft", [97, 256, 480, 1410, 2205])
def test_pad_factor_one_rows_match_float64(host_lib, n_fft):
    """N = W: the rows carry W bins (`stft_bins`), the Nyquist bin of an
    even N and every bin past N/2 included, each partnered with N - k."""
    rows = 2
    pcm = testing.noise(rows, n_fft, seed=n_fft)
    left = np.ascontiguousarray(pcm[..., 0])
    right = np.ascontiguousarray(pcm[..., 1])
    hann = tsk.packed_hann(n_fft)
    out = _host_rows(host_lib, host_lib.stft_host_rows, PICKED, n_fft, left, right, hann)
    want = _reference(left, right, hann.astype(np.float64), n_fft, bins=n_fft)
    for g, x in zip(out, want):
        assert g.shape == (rows, n_fft)
        np.testing.assert_allclose(g, x, atol=ATOL, rtol=0)
    plain = tsk.stft_mag_packed_plain(torch.from_numpy(left), torch.from_numpy(right),
                                      torch.from_numpy(hann), n_fft)
    for g, x in zip(out, plain):
        np.testing.assert_allclose(g, x.numpy(), atol=ATOL, rtol=0)


def test_mixed_radix_plans_agree_with_the_size_check(host_lib):
    """A mixed-radix plan exists exactly for N = 2^a 3^b 5^c 7^d, the host's
    choice of body and buffer is the kernels', and the size check takes
    every N up to the shared-memory limit."""
    radix = (ctypes.c_int * 16)()
    assert host_lib.stft_host_plan(4800, radix) == 6
    assert list(radix)[:6] == [4, 4, 4, 3, 5, 5]
    for n in range(2, 5000):
        stages = host_lib.stft_host_plan(n, radix)
        assert (stages > 0) == (tsk.fft_body(n) != "bluestein"), n
        if stages > 0:
            assert int(np.prod(list(radix)[:stages])) == n
            assert tuple(radix)[:stages] == tsk.mixed_radix_plan(n)
        assert host_lib.stft_host_buf_size(n) == tsk.fft_buf_size(n), n
        tsk.check_fft_size(n)
    for n in (9720, 28800, 14000):
        assert host_lib.stft_host_buf_size(n) == tsk.fft_buf_size(n), n


def test_bluestein_table_layout():
    """The Bluestein table: M twiddles, N chirp entries with the phase
    reduced in integers, M filter entries in the DIF order."""
    n = 97
    m = tsk.bluestein_size(n)
    table = tsk.fft_table(n)
    assert m == 196 and table.shape == tsk.fft_table_shape(n) == (2 * m + n, 2)
    np.testing.assert_array_equal(table[:m], tsk.twiddle_table(m))
    t = np.arange(n)
    chirp = np.exp(-1j * np.pi * (t.astype(np.float64) ** 2) / n)
    np.testing.assert_allclose(table[m : m + n, 0], chirp.real, atol=1e-7)
    np.testing.assert_allclose(table[m : m + n, 1], chirp.imag, atol=1e-7)
    assert sorted(tsk.digit_reversal(m)) == list(range(m))


@pytest.mark.parametrize("n_fft,body", [(4096, RADIX2), (4800, MIXED), (4410, PICKED)])
def test_int16_rows_equal_f32_rows_of_x_over_32768(host_lib, n_fft, body):
    """The int16 load (exact conversion, 2^-15 folded into the window) gives
    the bits of the f32 load of x / 32768, full-scale words included."""
    rows, w = 3, n_fft // 2
    rng = np.random.default_rng(n_fft)
    words = rng.integers(-32768, 32768, (2, rows, w), dtype=np.int16)
    words[0, 0, :4] = (-32768, 32767, 0, -1)
    got = _host_rows(host_lib, host_lib.stft_host_rows_i16, body, n_fft,
                     words[0], words[1], tsk.packed_hann_i16(w))
    scaled = words.astype(np.float32) / np.float32(32768.0)
    want = _host_rows(host_lib, host_lib.stft_host_rows, body, n_fft,
                      np.ascontiguousarray(scaled[0]), np.ascontiguousarray(scaled[1]),
                      tsk.packed_hann(w))
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)


# ------------------------------------------------------------- split-real

def _ptr(a: np.ndarray) -> int:
    assert a.flags.c_contiguous
    return a.ctypes.data


def _outs(rows: int, n_fft: int, w: int = None):
    bins = tsk.stft_bins(n_fft, n_fft // 2 if w is None else w)
    return np.zeros((rows, bins), np.float32), np.zeros((rows, bins), np.float32)


# (N, body, n1): radix-2, mixed radix and Bluestein, windows of W = N/2 = n1 * m
@pytest.mark.parametrize("n_fft,body,n1", [(512, RADIX2, 8), (480, MIXED, 8),
                                           (4800, MIXED, 48), (1410, PICKED, 5)])
@pytest.mark.parametrize("kind", ["chirp_tone", "noise"])
def test_split_real_layouts_match_plain(host_lib, n_fft, body, n1, kind):
    """Each of the sample sources through `stft_real_row` against
    `stft_mag_split_plain` on the same windows, and all bit for bit the
    same: a source that misplaces a sample (j1 and t swapped) fails."""
    rows, w = 3, n_fft // 2
    m = w // n1
    pcm = testing.make(kind, rows, w, 48000.0, seed=n_fft)
    left = np.ascontiguousarray(pcm[..., 0])
    right = np.ascontiguousarray(pcm[..., 1])
    hann = tsk.split_hann(w)
    tw = tsk.split_fft_table(n_fft)
    want = tsk.stft_mag_split_plain(torch.from_numpy(left), torch.from_numpy(right),
                                    torch.from_numpy(hann), n_fft)

    planes = _outs(rows, n_fft)
    assert host_lib.stft_host_split(body, n_fft, rows, w, _ptr(left), _ptr(right),
                                    _ptr(hann), _ptr(tw), *map(_ptr, planes)) == 0
    for got, x in zip(planes, want):
        np.testing.assert_allclose(got, x.numpy(), atol=ATOL, rtol=0)

    # the transposed operand: x[n, c, j1, t] = sample t*n1 + j1
    x = np.ascontiguousarray(
        np.stack([left, right], 1).reshape(rows, 2, m, n1).transpose(0, 1, 3, 2))
    t_out = _outs(rows, n_fft)
    assert host_lib.stft_host_split_t(body, n_fft, rows, n1, m, _ptr(x), _ptr(hann),
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
    assert host_lib.stft_host_split_allk(body, n_fft, s, ld, k, hop, w, _ptr(buf_l),
                                         _ptr(buf_r), _ptr(hann), _ptr(tw),
                                         *map(_ptr, allk), None, 0) == 0
    allk_planes = _outs(k * s, n_fft)
    assert host_lib.stft_host_split(body, n_fft, k * s, w, _ptr(wl), _ptr(wr), _ptr(hann),
                                    _ptr(tw), *map(_ptr, allk_planes)) == 0
    torch_allk = tsk.stft_mag_split_allk_plain(torch.from_numpy(buf_l), torch.from_numpy(buf_r),
                                               torch.from_numpy(hann), n_fft, k, hop)

    for got, same, plain in zip(t_out, planes, torch_t):
        np.testing.assert_array_equal(got, same)
        np.testing.assert_allclose(got, plain.numpy(), atol=ATOL, rtol=0)
    for got, same, plain in zip(allk, allk_planes, torch_allk):
        np.testing.assert_array_equal(got, same)
        np.testing.assert_allclose(got, plain.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_fft,body,n1", [(512, RADIX2, 8), (480, MIXED, 8)])
@pytest.mark.parametrize("t_cols", [5, 25])
def test_split_real_tsplit_matches_plain_and_framing(host_lib, n_fft, body, n1, t_cols):
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
    tw = tsk.split_fft_table(n_fft)
    out = _outs(rows, n_fft)
    nxt = np.full_like(carry, np.nan)
    assert host_lib.stft_host_split_tsplit(
        body, n_fft, rows, n1, c_cols, t_cols, _ptr(carry), _ptr(chunk), _ptr(hann),
        _ptr(tw), *map(_ptr, out), _ptr(nxt)) == 0
    t_out = _outs(rows, n_fft)
    assert host_lib.stft_host_split_t(body, n_fft, rows, n1, m, _ptr(x), _ptr(hann),
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


# (N, body, W, hop, k): the carry longer than the chunk (C = W - hop > k*hop)
# and shorter, radix 2, mixed radix and Bluestein
@pytest.mark.parametrize("n_fft,body,w,hop,k", [
    (512, RADIX2, 256, 64, 1), (512, RADIX2, 256, 64, 4), (480, MIXED, 240, 100, 2),
    (1410, PICKED, 705, 150, 3), (97, PICKED, 97, 20, 8),
])
def test_planar_carry_source_and_next_carries(host_lib, n_fft, body, w, hop, k):
    """The planar carry + chunk source (the split kernel of JAX's
    `stft_mag_fused2_split`): rows bit for bit the all-windows source's on
    the concatenated buffers, within the bar of the plain version; its next
    carry and the all-windows kernels' (`buffer_tail`) both exactly the
    buffers' last C samples."""
    s = 3
    c = tsk.carry_len(w, hop)
    rng = np.random.default_rng(n_fft + k)
    carry = (rng.standard_normal((s, 2, c)) * 0.3).astype(np.float32)
    chunk = (rng.standard_normal((s, 2, k * hop)) * 0.3).astype(np.float32)
    buf = np.concatenate([carry, chunk], axis=2)
    buf_l, buf_r = (np.ascontiguousarray(buf[:, ch]) for ch in range(2))
    hann = tsk.split_hann(w)
    tw = tsk.split_fft_table(n_fft)
    out = _outs(k * s, n_fft, w)
    nxt = np.full_like(carry, np.nan)
    assert host_lib.stft_host_split_carry(body, n_fft, s, c, k, hop, w, _ptr(carry),
                                          _ptr(chunk), _ptr(hann), _ptr(tw),
                                          *map(_ptr, out), _ptr(nxt)) == 0
    allk = _outs(k * s, n_fft, w)
    allk_next = np.full_like(carry, np.nan)
    assert host_lib.stft_host_split_allk(body, n_fft, s, c + k * hop, k, hop, w,
                                         _ptr(buf_l), _ptr(buf_r), _ptr(hann), _ptr(tw),
                                         *map(_ptr, allk), _ptr(allk_next), c) == 0
    plain = tsk.stft_mag_split_carry_plain(torch.from_numpy(carry), torch.from_numpy(chunk),
                                           torch.from_numpy(hann), n_fft, k, hop)
    for got, same, want in zip(out, allk, plain):
        np.testing.assert_array_equal(got, same)
        np.testing.assert_allclose(got, want.numpy(), atol=ATOL, rtol=0)
    tail = buf[:, :, buf.shape[2] - c :]
    for got in (nxt, allk_next, plain[2].numpy()):
        np.testing.assert_array_equal(got, tail)


@pytest.mark.parametrize("n_fft,body", [(256, RADIX2), (480, MIXED), (194, PICKED)])
@pytest.mark.parametrize("emit_mags", [False, True])
def test_fused_push_row_matches_split_then_colormap(host_lib, n_fft, body, emit_mags):
    """The fused push's row: its planes bit for bit the split-real kernel's,
    its words within 1 u8 of the plain chain (split-real STFT, then kernel
    B's plain version) over what the image shows, tables read per row."""
    w = n_fft // 2
    cfg = SpectrogramConfig(sample_rate=8000.0, window_period=w / 8000.0,
                            hop_period=w / 4 / 8000.0, viewport_height=64,
                            max_frequency=3600.0)
    rows = 5
    pcm = testing.chirp_tone(rows, w, cfg.sample_rate, seed=n_fft)
    left, right = (np.ascontiguousarray(pcm[..., c]) for c in range(2))
    hann = tsk.split_hann(w)
    tw = tsk.split_fft_table(n_fft)
    taps = tck.resample_taps(tcm.resample_matrix_full(cfg))
    tables = np.ascontiguousarray(tck.builtin_color_tables()[[0, 1, 3, 8]])
    res = tables.shape[1] // 4
    h = cfg.viewport_height
    words = np.zeros((rows, h), np.uint32)
    mags = _outs(rows, n_fft) if emit_mags else (None, None)
    assert host_lib.stft_host_push(
        body, n_fft, rows, w, _ptr(left), _ptr(right), _ptr(hann), _ptr(tw),
        _ptr(tables), tables.shape[0], res, *(_ptr(t.numpy()) for t in taps[:4]), h,
        cfg.min_db, cfg.max_db - cfg.min_db, cfg.db_epsilon, 1.0 / (res - 1),
        _ptr(words), *(None if m is None else _ptr(m) for m in mags)) == 0
    planes = _outs(rows, n_fft)
    assert host_lib.stft_host_split(body, n_fft, rows, w, _ptr(left), _ptr(right),
                                    _ptr(hann), _ptr(tw), *map(_ptr, planes)) == 0
    if emit_mags:
        for got, same in zip(mags, planes):
            np.testing.assert_array_equal(got, same)
    want = tck.colormap_builtin_plain(torch.from_numpy(planes[0]), torch.from_numpy(planes[1]),
                                      taps, torch.from_numpy(tables), cfg)
    assert testing.rgba_u8_diff(tck.unpack_rgba(words.view(np.int32)),
                                tck.unpack_rgba(want)) <= 1


@pytest.mark.parametrize("n_fft,body", [(256, RADIX2), (4096, RADIX2), (480, MIXED),
                                         (4800, PICKED), (194, PICKED), (435, PICKED)])
def test_fused_push_row_equals_the_chain(host_lib, n_fft, body):
    """The fused push's row: its planes the split-real kernel's and its
    words kernel B's per-pixel body on those planes, bit for bit, tables
    read per row (W = N/2, and W = N at the odd N = 435)."""
    w = n_fft if n_fft % 2 else n_fft // 2
    rows, h = 3, 64 if n_fft < 1000 else 1024
    left, right, window = _random_rows(rows, w, n_fft, np.float32)
    left, right = left * 0.05, right * 0.02
    table = tsk.split_fft_table(n_fft)
    bins = tsk.stft_bins(n_fft, w)
    rng = np.random.default_rng(n_fft)
    j0 = np.sort(rng.integers(0, bins - 1, h)).astype(np.int32)
    j1 = (j0 + 1).astype(np.int32)
    w1 = rng.uniform(0.0, 1.0, h).astype(np.float32)
    w0 = (1.0 - w1).astype(np.float32)
    tables = np.ascontiguousarray(tck.builtin_color_tables()[[0, 1, 3, 8]])
    res = tables.shape[1] // 4
    laws = (-120.0, 120.0, 1e-12, 1.0 / (res - 1))
    words = np.zeros((rows, h), np.uint32)
    mags = _outs(rows, n_fft, w)
    assert host_lib.stft_host_push(
        body, n_fft, rows, w, _ptr(left), _ptr(right), _ptr(window), _ptr(table),
        _ptr(tables), tables.shape[0], res, _ptr(j0), _ptr(j1), _ptr(w0), _ptr(w1), h,
        *laws, _ptr(words), *map(_ptr, mags)) == 0
    planes = _host_rows(host_lib, host_lib.stft_host_split, body, n_fft, left, right, window,
                        table)
    for got, same in zip(mags, planes):
        np.testing.assert_array_equal(got, same)
    chain = np.zeros_like(words)
    assert host_lib.stft_host_builtin(
        *map(_ptr, planes), rows, bins, _ptr(tables), tables.shape[0], res, _ptr(j0),
        _ptr(j1), _ptr(w0), _ptr(w1), h, *laws, _ptr(chain)) == 0
    np.testing.assert_array_equal(words, chain)
    assert len(np.unique(words)) > h // 4


# ------------------------------------------- radix 7 and the real-FFT pack

def _packed_digest(host_lib, n_fft: int, body: int) -> str:
    """sha256 of the packed rows of 4 windows of chirp+tone, then of noise,
    at W = N/2 (left plane, then right, per kind)."""
    h = hashlib.sha256()
    w = n_fft // 2
    for kind in ("chirp_tone", "noise"):
        pcm = testing.make(kind, 4, w, 48000.0, seed=n_fft)
        left, right = (np.ascontiguousarray(pcm[..., c]) for c in range(2))
        for plane in _host_rows(host_lib, host_lib.stft_host_rows, body, n_fft, left, right,
                                tsk.packed_hann(w)):
            h.update(plane.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("n_fft,body", sorted(FIVE_SMOOTH_DIGESTS))
def test_five_smooth_rows_keep_their_bits(host_lib, n_fft, body):
    """Kernel A's and the all-windows kernel's row (`stft_packed_row`) at
    N = 4096 (radix 2) and 4800 (4-4-4-3-5-5, forced and as picked) gives
    the bits it gave before radix 7 joined the plan: the digests come from
    the parent tree's host build on these inputs."""
    assert tsk.mixed_radix_plan(4800) == (4, 4, 4, 3, 5, 5)
    assert _packed_digest(host_lib, n_fft, body) == FIVE_SMOOTH_DIGESTS[(n_fft, body)]


@pytest.mark.parametrize("n_fft", [7, 343, 4410, 4802, 17640])
def test_radix7_plans_and_rows_match_float64(host_lib, n_fft):
    """A 7-smooth N runs the direct mixed-radix body with its 7s last (the
    radix-7 butterfly alone at N = 7): the host plan is Python's, and the
    packed rows at W = N/2 and W = N match float64."""
    radix = (ctypes.c_int * 16)()
    stages = host_lib.stft_host_plan(n_fft, radix)
    plan = tsk.mixed_radix_plan(n_fft)
    assert tuple(radix)[:stages] == plan and plan[-1] == 7
    assert tsk.fft_body(n_fft) == "mixed" and host_lib.stft_host_buf_size(n_fft) == n_fft
    for w in (n_fft // 2, n_fft):
        pcm = testing.chirp_tone(2, w, 44100.0, seed=n_fft + w)
        left, right = (np.ascontiguousarray(pcm[..., c]) for c in range(2))
        hann = tsk.packed_hann(w)
        got = _host_rows(host_lib, host_lib.stft_host_rows, PICKED, n_fft, left, right, hann)
        want = _reference(left, right, hann.astype(np.float64), n_fft,
                          bins=tsk.stft_bins(n_fft, w))
        for g, x in zip(got, want):
            np.testing.assert_allclose(g, x, atol=ATOL, rtol=0)


def _real_reference(x: np.ndarray, hann: np.ndarray, n_fft: int, bins: int) -> np.ndarray:
    """float64 |DFT_N(x * hann)| of each row, bins 0 .. bins-1."""
    z = x.astype(np.float64) * hann.astype(np.float64)
    return np.abs(np.fft.fft(z, n=n_fft))[:, :bins]


def _split_rows(host_lib, body: int, n_fft: int, w: int, kind: str = "chirp_tone"):
    """(left, right, hann, (out_l, out_r)): stft_host_split over 2 windows."""
    pcm = testing.make(kind, 2, w, 48000.0, seed=n_fft + w)
    left, right = (np.ascontiguousarray(pcm[..., c]) for c in range(2))
    hann = tsk.split_hann(w)
    out = _host_rows(host_lib, host_lib.stft_host_split, body, n_fft, left, right, hann,
                     tsk.split_fft_table(n_fft))
    return left, right, hann, out


@pytest.mark.parametrize("n_fft", [4096, 4800, 4410, 4408, 17640, 32768, 48000])
def test_split_real_pack_matches_float64(host_lib, n_fft):
    """The split-real row at even N as the N/2-point pack, on the body the
    kernels pick for N/2 (radix 2 at 4096 and 32,768; mixed at 4800, 4410,
    17,640 and 48,000; Bluestein at 4408, N/2 = 2204, M = 4500), against
    float64; its buffer is N/2's, in shared memory up to N = 48,000."""
    half = n_fft // 2
    assert tsk.split_packs(n_fft) and tsk.split_size(n_fft) == half
    assert host_lib.stft_host_split_buf_size(n_fft) == tsk.split_buf_size(n_fft) == \
        tsk.fft_buf_size(half)
    assert not tsk.is_large_split(n_fft)
    assert tsk.split_route(n_fft) == tsk.fft_body(half)
    left, right, hann, out = _split_rows(host_lib, PICKED, n_fft, half)
    for g, x in zip(out, (left, right)):
        np.testing.assert_allclose(g, _real_reference(x, hann, n_fft, half), atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_fft,body", [(256, RADIX2), (480, MIXED), (4410, PICKED),
                                        (2204, PICKED), (4408, PICKED)])
def test_split_real_pack_pad_factor_one(host_lib, n_fft, body):
    """N = W: a split-real row carries W bins; the Nyquist bin (twiddle -1)
    and the mirrors |X[N-k]| past it come out of the pack's unpack, within
    the float64 bar and the plain version's."""
    left, right, hann, out = _split_rows(host_lib, body, n_fft, n_fft, "noise")
    plain = tsk.stft_mag_split_plain(torch.from_numpy(left), torch.from_numpy(right),
                                     torch.from_numpy(hann), n_fft)
    for g, x, q in zip(out, (left, right), plain):
        assert g.shape == (2, n_fft)
        np.testing.assert_allclose(g, _real_reference(x, hann, n_fft, n_fft), atol=ATOL, rtol=0)
        np.testing.assert_allclose(g, q.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_fft,w", [(97, 48), (97, 97), (435, 145), (693, 231)])
def test_split_real_odd_n_keeps_the_full_row(host_lib, n_fft, w):
    """Odd N has no pack: the N-point row on (x, 0), with N's own table,
    within the float64 bar (Bluestein at 97, 435 = 3 5 29, 693 = 3^2 7 11)."""
    assert not tsk.split_packs(n_fft) and tsk.split_size(n_fft) == n_fft
    assert tsk.split_table_shape(n_fft) == tsk.fft_table_shape(n_fft)
    np.testing.assert_array_equal(tsk.split_fft_table(n_fft), tsk.fft_table(n_fft))
    assert host_lib.stft_host_split_buf_size(n_fft) == tsk.fft_buf_size(n_fft)
    left, right, hann, out = _split_rows(host_lib, PICKED, n_fft, w)
    for g, x in zip(out, (left, right)):
        np.testing.assert_allclose(g, _real_reference(x, hann, n_fft, tsk.stft_bins(n_fft, w)),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_fft,m", [(97, 196), (1410, 2880), (2204, 4500)])
def test_fused_bluestein_matches_float64(host_lib, n_fft, m):
    """Bluestein with its chirp product in the first DIF stage, its filter
    product in the last and its output chirp in the unpack, on a 7-smooth M:
    the packed rows at W = N/2 and W = N, and the split-real row (the N/2
    pack, itself Bluestein at 1410 and 2204), within the float64 bar."""
    assert tsk.fft_body(n_fft) == "bluestein" and tsk.bluestein_size(n_fft) == m
    assert tsk.mixed_radix_plan(m) and host_lib.stft_host_buf_size(n_fft) == m
    for w in (n_fft // 2, n_fft):
        pcm = testing.noise(2, w, seed=n_fft + w)
        left, right = (np.ascontiguousarray(pcm[..., c]) for c in range(2))
        hann = tsk.packed_hann(w)
        got = _host_rows(host_lib, host_lib.stft_host_rows, PICKED, n_fft, left, right, hann)
        want = _reference(left, right, hann.astype(np.float64), n_fft,
                          bins=tsk.stft_bins(n_fft, w))
        for g, x in zip(got, want):
            np.testing.assert_allclose(g, x, atol=ATOL, rtol=0)
    left, right, hann, out = _split_rows(host_lib, PICKED, n_fft, n_fft // 2)
    for g, x in zip(out, (left, right)):
        np.testing.assert_allclose(g, _real_reference(x, hann, n_fft, tsk.stft_bins(n_fft, n_fft // 2)),
                                   atol=ATOL, rtol=0)


def test_split_sizes_agree_with_the_host(host_lib):
    """`split_buf_size` is the buffer `with_real_body` gives the split-real
    kernels at every N up to 5000 and at the long windows; the pack leaves
    the large-N route below N = 58,112 where N/2 is direct."""
    for n in range(2, 5000):
        assert host_lib.stft_host_split_buf_size(n) == tsk.split_buf_size(n), n
    for n, size, large in ((4096, 2048, False), (4408, 4500, False), (17640, 8820, False),
                           (32768, 16384, False), (48000, 24000, False), (57600, 28800, False),
                           (60000, 30000, True), (65536, 32768, True), (16411, 33614, True),
                           (97, 196, False)):
        assert tsk.split_buf_size(n) == size and tsk.is_large_split(n) == large, n
        assert tsk.split_route(n) == (tsk.LARGE if large else tsk.fft_body(tsk.split_size(n)))
        if not large:
            assert host_lib.stft_host_split_buf_size(n) == size, n


# ------------------------------------------- the radix-2 register passes

# the sha256 of stft_host_split's planes (see `_split_digest`) at the parent
# of the grouped radix-2 passes: the split-real pack of N runs Radix2 on N/2
SPLIT_RADIX2_DIGESTS = {
    8: "6c71ace67bb1e047d0c28c243567d3b57ea9b08be1b615cee2c19f75e0ee9f54",
    16: "27b8b912f4dc50e7bcc08d5d6fe6b8e2058c14601d18ea6dea41d9b777bee596",
    32: "e7a5f5c13e610ce55dd8d18a1505e63a7dabab27cdb5cb16055e128a35269e9e",
    64: "134ff84aa981d27610c39eec6f0cce0a4312a59fb5fb49ccdff40d3c437c720d",
    128: "aedb57f6bee3a97ac4d4c08904a6f3e80e34ac247c00023ee20874316ec7ea9f",
    256: "b7218b680bd39e2761e02e885721229f6e7f2379f000504da3701a134574e44b",
    512: "8afa065409de5d12e54aba48922ddcb63a7b7b9cc7fb8ac8081901e94b3372fb",
    1024: "238a4c3eef9df12fbe2f0bd5e13a657e99ea9649aed07942e9778fafbaf9a15b",
    2048: "172f839356ba66f059c9953522b686b7b0c2a33bdd2e328f29c0f45530a9182e",
    4096: "bb68124ba5580ea46cea6d5b4e1e3d33658b3c519a26676013bc4a5be2f161e1",
    8192: "76f21e60edb52e64b62b8edfc932d70e090c7545e847e14f974ed60402d8e112",
    16384: "027924d151a5156218299c2988fbf9bc58a22d738809232236922da18c63cc66",
    32768: "708337bb1d130d006006a95d0249f6fbc279ed64a2880508ba132d9510530c21",
}


def _random_rows(rows: int, w: int, seed: int, dtype) -> tuple:
    """(left, right, window): f32 noise or full-range int16 words, and a
    window of values in (0, 1] (hann is zero at both ends of short windows,
    which would hide a wrong sample)."""
    rng = np.random.default_rng(seed)
    window = rng.uniform(2.0**-8, 1.0, w).astype(np.float32)
    if dtype == np.int16:
        x = rng.integers(-32768, 32768, (2, rows, w), dtype=np.int16)
        return x[0], x[1], window * np.float32(2.0**-15)
    x = rng.standard_normal((2, rows, w)).astype(np.float32)
    return x[0], x[1], window


@pytest.mark.parametrize("dtype", [np.float32, np.int16], ids=["f32", "int16"])
@pytest.mark.parametrize("w_of", ["below", "equal"])
@pytest.mark.parametrize("log2n", range(1, 15))
def test_radix2_passes_equal_one_stage_per_pass(host_lib, log2n, w_of, dtype):
    """The radix-2 body's register passes (four stages at a time, the load
    fused into the first, a swizzled buffer) give the bits of one
    shared-memory pass per stage on the same table entries, at every N =
    2^1 .. 2^14, with W < N and W = N, f32 and int16 rows."""
    n_fft = 1 << log2n
    w = n_fft if w_of == "equal" else max(1, n_fft // 2 + log2n % 3)
    rows = 3 if log2n < 12 else 2
    left, right, window = _random_rows(rows, w, log2n * 2 + (w_of == "equal"), dtype)
    fn = host_lib.stft_host_rows_i16 if dtype == np.int16 else host_lib.stft_host_rows
    got = _host_rows(host_lib, fn, RADIX2, n_fft, left, right, window)
    want = _host_rows(host_lib, fn, STAGES, n_fft, left, right, window)
    for g, x in zip(got, want):
        assert np.isfinite(g).all() and g.any()
        np.testing.assert_array_equal(g, x)


# (N, body, W, hop, k): radix 2 at pad 2 and 1, N = 2^14, mixed radix, Bluestein
@pytest.mark.parametrize("dtype", [np.float32, np.int16], ids=["f32", "int16"])
@pytest.mark.parametrize("n_fft,body,w,hop,k", [
    (4096, RADIX2, 2048, 800, 3), (2048, RADIX2, 2048, 800, 2), (16384, PICKED, 9000, 4000, 2),
    (4800, PICKED, 2400, 58, 3), (1410, PICKED, 705, 264, 3),
])
def test_packed_allk_row_equals_window_planes(host_lib, n_fft, body, w, hop, k, dtype):
    """The packed all-windows row (window r of stream s read at s*ld +
    r*hop, row r*S + s) gives the window-plane row's bits on the extracted
    windows, f32 and int16, and its next carry is each buffer's last W - hop
    samples."""
    s, c_len = 2, w - hop
    ld = w + (k - 1) * hop + 3
    buf_l, buf_r, window = _random_rows(s, ld, n_fft + k, dtype)
    fn = host_lib.stft_host_allk_i16 if dtype == np.int16 else host_lib.stft_host_allk
    rows_fn = host_lib.stft_host_rows_i16 if dtype == np.int16 else host_lib.stft_host_rows
    table = tsk.fft_table(n_fft)
    window = window[:w].copy()
    allk = _outs(k * s, n_fft, w)
    nxt = np.zeros((s, 2, c_len), dtype)
    assert fn(body, n_fft, s, ld, k, hop, w, _ptr(buf_l), _ptr(buf_r), _ptr(window),
              _ptr(table), *map(_ptr, allk), _ptr(nxt), c_len) == 0
    wl, wr = (np.ascontiguousarray(np.concatenate([b[:, r * hop : r * hop + w]
                                                   for r in range(k)]))
              for b in (buf_l, buf_r))
    planes = _host_rows(host_lib, rows_fn, body, n_fft, wl, wr, window, table)
    for got, want in zip(allk, planes):
        assert got.any()
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(nxt, np.stack([buf_l, buf_r], 1)[..., ld - c_len :])


def _split_digest(host_lib, n_fft: int, body: int = RADIX2) -> str:
    """sha256 of stft_host_split's planes over 2 windows of chirp+tone, then
    of noise, at W = N/2 and then W = N."""
    h = hashlib.sha256()
    table = tsk.split_fft_table(n_fft)
    for w in (n_fft // 2, n_fft):
        for kind in ("chirp_tone", "noise"):
            pcm = testing.make(kind, 2, w, 48000.0, seed=n_fft + w)
            left, right = (np.ascontiguousarray(pcm[..., c]) for c in range(2))
            for plane in _host_rows(host_lib, host_lib.stft_host_split, body, n_fft, left,
                                    right, tsk.split_hann(w), table):
                h.update(plane.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("n_fft", sorted(SPLIT_RADIX2_DIGESTS))
def test_split_real_radix2_rows_keep_their_bits(host_lib, n_fft):
    """The split-real rows whose N/2 pack runs the radix-2 body (N = 8 ..
    32,768, W = N/2 and N) give the bits they gave with one shared-memory
    pass per stage: the digests come from the parent tree's host build."""
    assert _split_digest(host_lib, n_fft) == SPLIT_RADIX2_DIGESTS[n_fft]


# ------------------------------------------- the mixed-radix register passes

# every N = 2^a 3^b 5^c 7^d from 6 to 10,000 but the powers of two: the
# sizes the direct mixed-radix body runs
MIXED_GRID = tuple(n for n in range(6, 10001) if tsk.fft_body(n) == "mixed")
# the sha256 of stft_host_split's planes (see `_split_digest`) at the parent
# of the grouped mixed-radix passes: the split-real rows of N over the body
# of N/2 (4410: 2205 = 3 3 5 7 7; 4800: 2400; 17,640: 8820 = 4 3 3 5 7 7)
# and of odd N (735 = 3 5 7 7, the N-point row)
SPLIT_MIXED_DIGESTS = {
    735: "0d0be2b1548b031b05cfa9eef1090ce728a9caf9dc1ecea63a221977c3ce0210",
    4410: "643ad8e16e60e183b6a03c38abc05dbdac07f6129b6d51aad13504ba79293d2a",
    4800: "6b98c02ff842386425186592021150d2c8a89bf51267b3f441cfb4062e8a74da",
    17640: "dacc61bbe1738ff3118ce791c1d4da557e74850276d60780e84c0a67f1ef35f1",
}


def _rows_equal(host_lib, n_fft: int, w: int, body: int, want_body: int, dtype) -> None:
    """The packed rows of `body` give `want_body`'s bits on 2 windows of
    random rows (`_random_rows`) at W = w."""
    left, right, window = _random_rows(2, w, n_fft + w, dtype)
    fn = host_lib.stft_host_rows_i16 if dtype == np.int16 else host_lib.stft_host_rows
    got = _host_rows(host_lib, fn, body, n_fft, left, right, window)
    want = _host_rows(host_lib, fn, want_body, n_fft, left, right, window)
    for g, x in zip(got, want):
        assert np.isfinite(g).all() and g.any()
        np.testing.assert_array_equal(g, x)


def _allk_equal(host_lib, n_fft: int, w: int, dtype) -> None:
    """The packed all-windows row (k=2 windows of 2 streams, hop w/3) over
    the picked body gives the copy's bits, next carry included."""
    s, k, hop = 2, 2, max(1, w // 3)
    ld = w + (k - 1) * hop + 1
    buf_l, buf_r, window = _random_rows(s, ld, n_fft + 7, dtype)
    window = window[:w].copy()
    fn = host_lib.stft_host_allk_i16 if dtype == np.int16 else host_lib.stft_host_allk
    table = tsk.fft_table(n_fft)
    outs = []
    for body in (PICKED, COPY):
        planes = _outs(k * s, n_fft, w)
        nxt = np.zeros((s, 2, w - hop), dtype)
        assert fn(body, n_fft, s, ld, k, hop, w, _ptr(buf_l), _ptr(buf_r), _ptr(window),
                  _ptr(table), *map(_ptr, planes), _ptr(nxt), w - hop) == 0
        outs.append((*planes, nxt))
    for got, want in zip(*outs):
        assert got.any()
        np.testing.assert_array_equal(got, want)


def _split_equal(host_lib, n_fft: int, w: int, body: int = PICKED) -> None:
    """The split-real row (the pack over N/2's body at even N, the N-point
    row at odd N) over `body` gives the copy's bits."""
    left, right, window = _random_rows(2, w, n_fft + 3, np.float32)
    table = tsk.split_fft_table(n_fft)
    got = _host_rows(host_lib, host_lib.stft_host_split, body, n_fft, left, right, window, table)
    want = _host_rows(host_lib, host_lib.stft_host_split, COPY, n_fft, left, right, window, table)
    for g, x in zip(got, want):
        assert np.isfinite(g).all() and g.any()
        np.testing.assert_array_equal(g, x)


@pytest.mark.parametrize("n_fft", MIXED_GRID)
def test_mixed_radix_passes_equal_one_stage_per_pass(host_lib, n_fft):
    """The mixed-radix body's register passes (stages two at a time, the
    load fused into the first, the swizzled buffer) give the bits of one
    shared-memory pass per stage on the same table entries (mixed_stages.h)
    at every 7-smooth N from 6 to 10,000 but the powers of two: packed rows
    at W < N (on both sides of N/2) and W = N, f32 and int16, on the body
    the kernels pick (MixedRadixT<5> for a 5-smooth plan), on
    MixedRadixT<7> and with the narrow passes of 64-register kernels; the
    packed all-windows row; the split-real row, also narrow."""
    assert tsk.fft_body(n_fft) == "mixed"
    for w in (max(1, n_fft // 2 + n_fft % 3), n_fft):
        for dtype in (np.float32, np.int16):
            _rows_equal(host_lib, n_fft, w, PICKED, COPY, dtype)
            _allk_equal(host_lib, n_fft, w, dtype)
        _rows_equal(host_lib, n_fft, w, MIXED, COPY, np.float32)
        _rows_equal(host_lib, n_fft, w, NARROW, COPY, np.float32)
        _split_equal(host_lib, n_fft, w)
        _split_equal(host_lib, n_fft, w, NARROW)


@pytest.mark.parametrize("n_fft", BLUESTEIN_SIZES)
def test_bluestein_passes_equal_one_stage_per_pass(host_lib, n_fft):
    """Bluestein over the grouped passes (its DIF half paired from the top,
    the filter product in the pass of stage 0) gives the bits of Bluestein
    over one pass per stage (the copy as its inner body): packed rows at W <
    N and W = N, f32 and int16 (f32 also narrow), the all-windows row, the
    split-real row."""
    assert tsk.fft_body(n_fft) == "bluestein"
    for w in (max(1, n_fft // 2 + n_fft % 3), n_fft):
        for dtype in (np.float32, np.int16):
            _rows_equal(host_lib, n_fft, w, PICKED, COPY, dtype)
            _allk_equal(host_lib, n_fft, w, dtype)
        _rows_equal(host_lib, n_fft, w, NARROW, COPY, np.float32)
        _split_equal(host_lib, n_fft, w)
        _split_equal(host_lib, n_fft, w, NARROW)


@pytest.mark.parametrize("n_fft", sorted(SPLIT_MIXED_DIGESTS))
def test_split_real_mixed_rows_keep_their_bits(host_lib, n_fft):
    """The split-real rows over the mixed-radix body (the N/2 pack at 4410,
    4800 and 17,640, the N-point row at the odd 735), W = N/2 and N, give
    the bits they gave with one shared-memory pass per stage: the digests
    come from the parent tree's host build."""
    assert tsk.split_route(n_fft) == "mixed"
    assert _split_digest(host_lib, n_fft, PICKED) == SPLIT_MIXED_DIGESTS[n_fft]


@pytest.mark.parametrize("w", [367, 735])
def test_split_real_odd_seven_smooth_row_matches_float64(host_lib, w):
    """Odd 7-smooth N = 735 = 3 5 7 7 has no pack: the split-real row is the
    N-point MixedRadixT<7> row on (x, 0), with N's own table, within the
    float64 bar and the plain version's."""
    n_fft = 735
    assert not tsk.split_packs(n_fft) and tsk.fft_body(n_fft) == "mixed"
    assert 7 in tsk.mixed_radix_plan(n_fft)
    left, right, hann, out = _split_rows(host_lib, PICKED, n_fft, w, "noise")
    plain = tsk.stft_mag_split_plain(torch.from_numpy(left), torch.from_numpy(right),
                                     torch.from_numpy(hann), n_fft)
    for g, x, q in zip(out, (left, right), plain):
        want = _real_reference(x, hann, n_fft, tsk.stft_bins(n_fft, w))
        np.testing.assert_allclose(g, want, atol=ATOL, rtol=0)
        np.testing.assert_allclose(g, q.numpy(), atol=ATOL, rtol=0)



@pytest.mark.parametrize("n_fft", [35280, 16400])
def test_split_real_wide_radix7_packs_match_float64(host_lib, n_fft):
    """The N/2 packs that run at 1,024 threads on the card over a radix-7
    body: N = 35,280 (17,640 = 4 2 3 3 5 7 7, MixedRadixT<7>) and N = 16,400
    (8200 = 2^3 5^2 41: Bluestein over M = 16,807 = 7^5), against float64."""
    m = tsk.split_buf_size(n_fft)
    assert m >= tsk.WIDE_ROW and not tsk.is_large_split(n_fft)
    assert 7 in tsk.mixed_radix_plan(m)
    assert host_lib.stft_host_split_buf_size(n_fft) == m
    left, right, hann, out = _split_rows(host_lib, PICKED, n_fft, n_fft // 2)
    for g, x in zip(out, (left, right)):
        np.testing.assert_allclose(g, _real_reference(x, hann, n_fft, n_fft // 2),
                                   atol=ATOL, rtol=0)


# ------------------------------------- the split-real row's two load forms

FUSED, LANES = 0, 1   # stft_host_set_load: the kernels' load, split_lanes.h's
# every even N = 2^1 .. 2^14, every 7-smooth N of MIXED_GRID (the odd 735
# among them: the N-point row), the Bluestein sizes and the odd N = 435
SPLIT_LOAD_SIZES = tuple(sorted({1 << b for b in range(1, 15)} | set(MIXED_GRID)
                                | set(BLUESTEIN_SIZES) | {435}))


def _load_n1(w: int) -> int:
    """The largest divisor of w at most sqrt(w): the transposed layouts'
    n1 (1 at a prime w)."""
    return max(d for d in range(1, int(w**0.5) + 1) if w % d == 0)


def _source_rows(host_lib, n_fft: int, w: int) -> list:
    """The planes of each sample source at W = w over the picked body, in
    the load form set: window planes (2 rows), the planar carry + chunk
    (k=2 windows of one stream, the carry one sample longer than W - hop),
    the transposed operand (2 rows, n1 = `_load_n1(w)`) and, where the
    window has two columns or more, the transposed carry + chunk."""
    table = tsk.split_fft_table(n_fft)
    left, right, window = _random_rows(2, w, n_fft + w, np.float32)
    outs = [_host_rows(host_lib, host_lib.stft_host_split, PICKED, n_fft, left, right,
                       window, table)]
    k, hop = 2, max(1, w // 3)
    c_len = w - hop + 1
    rng = np.random.default_rng(n_fft - w)
    carry = rng.standard_normal((1, 2, c_len)).astype(np.float32)
    chunk = rng.standard_normal((1, 2, k * hop)).astype(np.float32)
    planar = _outs(k, n_fft, w)
    nxt = np.zeros_like(carry)
    assert host_lib.stft_host_split_carry(PICKED, n_fft, 1, c_len, k, hop, w, _ptr(carry),
                                          _ptr(chunk), _ptr(window), _ptr(table),
                                          *map(_ptr, planar), _ptr(nxt)) == 0
    outs.append(planar)
    n1 = _load_n1(w)
    m = w // n1
    x = np.ascontiguousarray(
        np.stack([left, right], 1).reshape(2, 2, m, n1).transpose(0, 1, 3, 2))
    t_out = _outs(2, n_fft, w)
    assert host_lib.stft_host_split_t(PICKED, n_fft, 2, n1, m, _ptr(x), _ptr(window),
                                      _ptr(table), *map(_ptr, t_out)) == 0
    outs.append(t_out)
    if m >= 2:
        t_cols = max(1, m // 3)
        tc, tt = (np.ascontiguousarray(a) for a in (x[..., : m - t_cols], x[..., m - t_cols :]))
        ts_out = _outs(2, n_fft, w)
        ts_next = np.zeros_like(tc)
        assert host_lib.stft_host_split_tsplit(PICKED, n_fft, 2, n1, m - t_cols, t_cols,
                                               _ptr(tc), _ptr(tt), _ptr(window), _ptr(table),
                                               *map(_ptr, ts_out), _ptr(ts_next)) == 0
        outs.append(ts_out)
    return outs


@pytest.mark.parametrize("n_fft", SPLIT_LOAD_SIZES)
def test_split_real_fused_load_equals_lanes(host_lib, n_fft):
    """The split-real row with its samples read by window position straight
    into the first pass gives the bits of the lane load it replaced
    (split_lanes.h: each sample a float lane of its slot, then the whole
    transform), for each of the four sample sources, at W = N/2, 3N/4, N
    and an odd W:
    every even N = 2^1 .. 2^14, every 7-smooth N from 6 to 10,000, the
    Bluestein sizes (whose load goes through its slots in both forms) and
    the odd N = 435 and 735 (the N-point row)."""
    for w in sorted({max(1, n_fft // 2), max(1, n_fft - n_fft // 4), n_fft,
                     (n_fft // 2) | 1}):
        forms = []
        for load in (FUSED, LANES):
            host_lib.stft_host_set_load(load)
            try:
                forms.append(_source_rows(host_lib, n_fft, w))
            finally:
                host_lib.stft_host_set_load(0)
        assert len(forms[0]) == (4 if w // _load_n1(w) >= 2 else 3)
        for fused, lanes in zip(*forms):
            for got, want in zip(fused, lanes):
                assert np.isfinite(got).all() and got.any()
                np.testing.assert_array_equal(got, want)
