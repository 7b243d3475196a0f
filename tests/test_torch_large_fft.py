"""The large-N STFT route, on the CPU: FFT sizes whose row buffer passes a
block's shared memory.

`spectrogram_tpu_torch/csrc/stft_large.cuh` holds the route's index code
(for a 7-smooth N two passes: the load fused into the first of the
register passes that run the first radix stages over each run, through
shared memory between them, and the last stage fused into the unpack, a
butterfly pair at a time; for Bluestein the load, its global
stages, the local pass with the filter product, and the unpack; the
split-real pack's unpack); `tests/cuda_host_stub/` compiles it with g++ and
runs each pass over every row, one thread per block, as the route's launches
do, and keeps the unfused pass sequence (load, local pass, each global
stage, unpack) callable beside it.  The bars: 1e-6 absolute of a float64 FFT
(the bar of `tests/test_torch_stft_host.py`; f32 rounding over 8-17 passes
stays near 1e-7) at N = 32,768 (radix 4^7 2), 48,000 (mixed), 35,280 (mixed
with radix 7) and the prime 16,411 (Bluestein, M = 33,614), packed and
split-real; the split-real route at N = 60,000 and 65,536, where even the
N/2-point pack passes a block; and at N the shared-memory bodies take too
(4800, 4410, 2204), their bits exactly; the two passes against the unfused
sequence, bit for bit, and every output bin written exactly once; pass 1's
form (register passes, threads) as the library reports it.  Then the
size check, and the pipeline at N = 35,280 against the JAX package's, as
`tests/test_torch_fft_sizes.py` runs it.  Without a C++ compiler the host
tests skip.
"""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from spectrogram_tpu_torch import testing
from spectrogram_tpu_torch.config import SpectrogramConfig
from spectrogram_tpu_torch.ops.cuda import _build
from spectrogram_tpu_torch.ops.cuda import stft_kernel as tsk

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
STUB = ROOT / "tests" / "cuda_host_stub"
CSRC = ROOT / "spectrogram_tpu_torch" / "csrc"
ATOL = 1e-6
LARGE_SIZES = (32768, 48000, 35280, 16411)
PICKED = 2    # the stub's body argument: the body the kernels pick for N


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler to build the device code for the CPU")
    out = tmp_path_factory.mktemp("stft_large_host") / "libstft_host.so"
    subprocess.run(
        [cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         f"-I{STUB}", f"-I{CSRC}", "-o", str(out), str(STUB / "stft_host.cpp")],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    large = (lib.stft_host_large, lib.stft_host_large_unfused, lib.stft_host_large_writes)
    for fn in large:
        fn.argtypes = (i, i, i, i, p, p, p, p, p, p, i)
    lib.stft_host_large_pass1.argtypes = (i, i, i, p)
    lib.stft_host_rows.argtypes = (i, i, i, i, p, p, p, p, p, p)
    lib.stft_host_split.argtypes = (i, i, i, i, p, p, p, p, p, p)
    for fn in (*large, lib.stft_host_large_pass1, lib.stft_host_rows, lib.stft_host_split):
        fn.restype = i
    return lib


def _planes(kind: str, n_fft: int, rows: int = 2, w: int | None = None):
    w = n_fft // 2 if w is None else w
    pcm = testing.make(kind, rows, w, 48000.0, seed=n_fft)
    return tuple(np.ascontiguousarray(pcm[..., c]) for c in range(2))


def _host(fn, *lead, n_fft, left, right, hann, tail=(), split=False, dtype=np.float32):
    """fn's planes, with N's `fft_table`, or `split_fft_table` with `split`
    (int32 `dtype`: the write counts of `stft_host_large_writes`)."""
    rows, w = left.shape
    bins = tsk.stft_bins(n_fft, w)
    out = np.zeros((rows, bins), dtype), np.zeros((rows, bins), dtype)
    table = tsk.split_fft_table(n_fft) if split else tsk.fft_table(n_fft)
    assert fn(*lead, n_fft, rows, w, left.ctypes.data, right.ctypes.data, hann.ctypes.data,
              table.ctypes.data, *(o.ctypes.data for o in out), *tail) == 0
    return out


def _reference(left, right, hann, n_fft, split):
    """float64 magnitudes of bins 0 .. N/2-1: the stereo unpack, or each
    channel's |DFT|."""
    h = hann.astype(np.float64)
    k = np.arange(n_fft // 2)
    if split:
        return tuple(np.abs(np.fft.fft(x.astype(np.float64) * h, n=n_fft))[:, k]
                     for x in (left, right))
    x = np.fft.fft((left.astype(np.float64) + 1j * right.astype(np.float64)) * h, n=n_fft)
    a, b = x[:, k], x[:, (n_fft - k) % n_fft]
    return np.abs(a + np.conj(b)), np.abs(a - np.conj(b))


@pytest.mark.parametrize("split", [False, True], ids=["packed", "split"])
@pytest.mark.parametrize("n_fft", LARGE_SIZES)
def test_large_route_matches_float64(host_lib, n_fft, split):
    """The route's passes against float64, and against the plain version
    the card holds the kernels to: packed at N the packed kernels leave to
    it, split-real (the pack over N/2 = 16,384, 24,000, 17,640; the N-point
    row at the odd 16,411) at the same N."""
    assert tsk.is_large(n_fft) and tsk.fft_route(n_fft) == tsk.LARGE
    left, right = _planes("chirp_tone", n_fft)
    w = left.shape[1]
    hann = tsk.split_hann(w) if split else tsk.packed_hann(w)
    got = _host(host_lib.stft_host_large, int(split), n_fft=n_fft, left=left, right=right,
                hann=hann, tail=(tsk.MAX_BUF,), split=split)
    plain = (tsk.stft_mag_split_plain if split else tsk.stft_mag_packed_plain)(
        torch.from_numpy(left), torch.from_numpy(right), torch.from_numpy(hann), n_fft)
    for g, want, p in zip(got, _reference(left, right, hann, n_fft, split), plain):
        np.testing.assert_allclose(g, want, atol=ATOL, rtol=0)
        np.testing.assert_allclose(g, p.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("max_span", [tsk.MAX_BUF, 64], ids=["kernels", "span64"])
@pytest.mark.parametrize("split", [False, True], ids=["packed", "split"])
@pytest.mark.parametrize("n_fft", [4800, 4410, 2204])
def test_large_route_gives_the_shared_memory_bodies_bits(host_lib, n_fft, split, max_span):
    """At an N both take, the route runs the shared-memory bodies' own
    steps in their order (mixed radix with radix 7; Bluestein's chirp, DIF,
    filter, DIT, output chirp; the split-real pack and its unpack), so its
    rows are theirs bit for bit, however its stages split between the local
    pass and global ones (all but the last local, as the kernels split
    them, or only those within 64 entries): one law at every N."""
    assert not tsk.is_large(n_fft)
    left, right = _planes("noise", n_fft, rows=3)
    w = left.shape[1]
    hann = tsk.split_hann(w) if split else tsk.packed_hann(w)
    got = _host(host_lib.stft_host_large, int(split), n_fft=n_fft, left=left, right=right,
                hann=hann, tail=(max_span,), split=split)
    fn = host_lib.stft_host_split if split else host_lib.stft_host_rows
    want = _host(fn, PICKED, n_fft=n_fft, left=left, right=right, hann=hann, split=split)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)


# (split, N) of the fused order's checks: the packed route at 2^15 (last
# stage radix 2), 48,000 (5), 35,280 (7) and 2^16 (4: the long-window
# serving geometry, runs of 4^7 entries); the split-real pack at the same
# N (N/2 = 16,384, 24,000, 17,640) and past a block (30,000: radix 5;
# 32,768: 2); the odd split-real row 33,075 = 3^3 5^2 7^2 (the N-point row,
# radix 7 last)
FUSED_CASES = ((False, 32768), (False, 48000), (False, 35280), (False, 65536),
               (True, 32768), (True, 48000), (True, 35280), (True, 60000), (True, 65536),
               (True, 33075))
FUSED_IDS = [f"{'split' if s else 'packed'}-{n}" for s, n in FUSED_CASES]


def _window(n_fft: int, width: str) -> int:
    """W for N: half (pad_factor 2: bins 0 .. N/2-1), three quarters, or
    full (pad_factor 1: bins 0 .. N-1, past N/2)."""
    return {"half": n_fft // 2, "3/4": 3 * n_fft // 4, "full": n_fft}[width]


@pytest.mark.parametrize("operand", [("chirp_tone", "half"), ("noise", "half"),
                                     ("noise", "full")],
                         ids=["chirp_tone", "noise", "noise-full-window"])
@pytest.mark.parametrize("max_span", [tsk.MAX_BUF, 64], ids=["kernels", "span64"])
@pytest.mark.parametrize("split,n_fft", FUSED_CASES, ids=FUSED_IDS)
def test_large_fused_order_equals_the_pass_sequence(host_lib, split, n_fft, max_span,
                                                    operand):
    """The route's two passes of a direct N (the load fused into the local
    pass, reading each run's inputs G entries apart into their
    digit-reversed places; the last stage fused into the unpack, a butterfly
    pair (j, len - j) at a time) give the bits of the passes they replace
    (load, local pass, each global stage, unpack), with every stage but the
    last local (the kernels' span) or those within 64 entries (the middle
    global stages as passes of their own); within 1e-6 of float64.  A
    swapped slot / unslot or a wrong mirror fails on the chirp."""
    kind, width = operand
    left, right = _planes(kind, n_fft, w=_window(n_fft, width))
    w = left.shape[1]
    hann = tsk.split_hann(w) if split else tsk.packed_hann(w)
    run = dict(n_fft=n_fft, left=left, right=right, hann=hann, tail=(max_span,),
               split=split)
    got = _host(host_lib.stft_host_large, int(split), **run)
    want = _host(host_lib.stft_host_large_unfused, int(split), **run)
    half = np.arange(n_fft // 2)
    for g, x, ref in zip(got, want, _reference(left, right, hann, n_fft, split)):
        assert np.isfinite(g).all()
        np.testing.assert_array_equal(g, x)
        np.testing.assert_allclose(g[:, half], ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("width", ["half", "3/4", "full"])
@pytest.mark.parametrize("max_span", [tsk.MAX_BUF, 64], ids=["kernels", "span64"])
@pytest.mark.parametrize("split,n_fft", FUSED_CASES, ids=FUSED_IDS)
def test_large_last_unpack_writes_every_bin_once(host_lib, split, n_fft, max_span, width):
    """Each butterfly pair writes the bins of its outputs: every bin
    0 .. max(N/2, W)-1 of every plane exactly once, N/2 and the bins past
    it (W > N/2), the self-paired j = 0 and j = len/2, and the pack's
    mirrors N - k and bin N/2 included (`stft_host_large_writes` counts the
    writes; `stft_host_large` leaves a bin no pass writes NaN)."""
    left, right = _planes("noise", n_fft, w=_window(n_fft, width))
    w = left.shape[1]
    hann = tsk.split_hann(w) if split else tsk.packed_hann(w)
    run = dict(n_fft=n_fft, left=left, right=right, hann=hann, tail=(max_span,),
               split=split)
    for count in _host(host_lib.stft_host_large_writes, int(split), dtype=np.int32, **run):
        assert count.shape == (2, tsk.stft_bins(n_fft, w))
        np.testing.assert_array_equal(count, 1)
    for plane in _host(host_lib.stft_host_large, int(split), **run):
        assert np.isfinite(plane).all()


@pytest.mark.parametrize("n_fft", [60000, 65536])
def test_large_split_route_matches_float64(host_lib, n_fft):
    """Past N/2 = 29,056 even the split-real pack leaves shared memory: the
    route's split form runs the pack over an N/2-entry scratch row (30,000
    mixed, 32,768 radix 4^7 2) within the float64 bar."""
    assert tsk.split_packs(n_fft) and tsk.is_large_split(n_fft)
    assert tsk.split_route(n_fft) == tsk.LARGE
    left, right = _planes("chirp_tone", n_fft)
    hann = tsk.split_hann(left.shape[1])
    got = _host(host_lib.stft_host_large, 1, n_fft=n_fft, left=left, right=right,
                hann=hann, tail=(tsk.MAX_BUF,), split=True)
    for g, want in zip(got, _reference(left, right, hann, n_fft, split=True)):
        np.testing.assert_allclose(g, want, atol=ATOL, rtol=0)


# pass 1's launch bounds, threads and the pass bound their registers leave
# (csrc/stft_large.cuh `LargeLoadBounds`, csrc/stft_fft.cuh `group_cap`)
PASS1_THREADS, PASS1_CAP = 512, 25


def _pass1_grouping(radices, cap):
    """The register passes of a run's stages `radices` under the pass bound
    `cap`, as `MixedRadixT::with_radices` takes them (`pass_stages`: two
    stages where their radices multiply to at most the bound, the first
    pass's bound at most 16, as `load_transform`'s)."""
    passes, s = [], 0
    while s < len(radices):
        bound = min(cap, 16) if s == 0 else cap
        q = 2 if s + 1 < len(radices) and radices[s] * radices[s + 1] <= bound else 1
        passes.append(radices[s:s + q])
        s += q
    return passes


@pytest.mark.parametrize("n_fft,want", [(65536, (4, 512)), (48000, (4, 512))])
def test_large_pass1_form_follows_the_plan(host_lib, n_fft, want):
    """`spk_stft_large_pass1`'s (register passes, threads) of pass 1, as
    the stub runs the same header code: the plan's local stages (all but
    the last, within a block's shared memory: 4^7, runs of 16,384 entries,
    at N = 65,536; 4-4-4-2-3-5-5, runs of 9,600, at 48,000) grouped as
    `with_radices` groups them under the bound of the launch ((4 4)(4 4)
    (4 4)(4); (4 4)(4 2)(3 5)(5)), and a thread per group of the widest
    pass, at most the launch's 512.  The
    split-real pack of 65,536 runs the same runs; a Bluestein N has no
    pass 1, and a window past N is refused."""
    radices = tsk.mixed_radix_plan(n_fft)
    local, span = 0, 1
    while local + 1 < len(radices) and span * radices[local] <= tsk.MAX_BUF:
        span *= radices[local]
        local += 1
    assert span == tsk.large_span(n_fft)
    passes = _pass1_grouping(radices[:local], PASS1_CAP)
    groups = span // min(int(np.prod(q)) for q in passes)
    expect = (len(passes), min(PASS1_THREADS, -(-groups // 32) * 32))
    assert expect == want
    form = (ctypes.c_int * 2)()
    assert host_lib.stft_host_large_pass1(n_fft, n_fft // 2, 0, ctypes.addressof(form)) == 0
    assert tuple(form) == expect
    if n_fft == 65536:
        assert host_lib.stft_host_large_pass1(n_fft, n_fft // 2, 1, ctypes.addressof(form)) == 0
        assert tuple(form) == expect
    assert host_lib.stft_host_large_pass1(16411, 8192, 0, ctypes.addressof(form)) == 0
    assert tuple(form) == (0, 0)
    assert host_lib.stft_host_large_pass1(n_fft, n_fft + 1, 0, ctypes.addressof(form)) != 0


@pytest.mark.parametrize("n_fft", [65536, 48000, 4800, 33075, 16411])
def test_tables_end_with_the_run_twiddles(n_fft):
    """A direct transform's table ends with every G-th of its twiddles, G
    = its length over the span of the route's runs (4 at N = 65,536, 5 at
    48,000), copied bit for bit: the packed table after N's twiddles, the
    split-real pack's after its post-twiddles (N/2's runs), an odd N's as
    the packed one's; Bluestein's tables carry none."""
    tables = ((tsk.fft_table(n_fft), n_fft), (tsk.split_fft_table(n_fft), tsk.split_size(n_fft)))
    for table, size in tables:
        if tsk.fft_body(size) == "bluestein":
            assert table.shape[0] == 2 * tsk.bluestein_size(size) + n_fft
            continue
        span = tsk.large_span(size)
        assert size % span == 0 and span < size
        runs = table[-span:]
        np.testing.assert_array_equal(runs, tsk.twiddle_table(size)[:: size // span])
        np.testing.assert_array_equal(table[:size], tsk.twiddle_table(size))
    assert tsk.large_span(65536) == 16384 and tsk.large_span(48000) == 9600


def test_check_fft_size_raises_only_below_two():
    """Every N from 2 up runs: the shared-memory bodies up to a 227 KB row
    buffer, the large-N route past it, under its own launch label."""
    for n in (2, 3, 97, 4096, 4410, 14000, 14503, 16384, 28800, 29056, 29160, 30000,
              32768, 48000, 17640, 16411, 65536):
        tsk.check_fft_size(n)
    for n in (0, 1, -4):
        with pytest.raises(ValueError, match="at least 2"):
            tsk.check_fft_size(n)
    # the boundary: a buffer of 29,056 complex f32 fits (28,125 = 3^2 5^5
    # does), the next smooth size, 29,160, does not; 29,056 = 2^7 227 itself
    # takes Bluestein, M = 58,320; 17,640 = 2^3 3^2 5 7^2 runs direct
    assert tsk.MAX_BUF == 29056
    for n, large in ((16384, False), (28800, False), (28125, False), (29160, True),
                     (29056, True), (32768, True), (14000, False), (14503, True),
                     (17640, False), (35280, True)):
        assert tsk.is_large(n) == large, n
        assert tsk.fft_route(n) == (tsk.LARGE if large else tsk.fft_body(n))
    assert tsk.fft_body(17640) == "mixed" and tsk.fft_body(14503) == "bluestein"
    assert tsk.LARGE in _build.FFT_BODIES
    for name in (tsk.LARGE_KERNEL, tsk.LARGE_KERNEL_I16, tsk.LARGE_SPLIT_KERNEL):
        assert name in _build.KERNELS


def test_large_pipeline_matches_jax():
    """44.1 kHz with a 0.4 s window (W=17,640, N=35,280 = 2^4 3^2 5 7^2:
    the packed kernels' route, the split-real pack's shared memory), 2
    streams, H=64, k=1: the port's pipeline on the CPU against the JAX
    package's default pipeline from one state, with the bars of
    `tests/test_torch_fft_sizes.py` (carry exact, rows within 1 u8, ring
    within 1 bf16 ulp, streamed == process(), the state carried back)."""
    from test_torch_fft_sizes import _check_against_jax

    kw = dict(sample_rate=44100.0, window_period=0.4, viewport_height=64,
              viewport_rows=8)
    cfg = SpectrogramConfig(**kw)
    n = cfg.padded_size
    assert n == 35280 and tsk.is_large(n) and not tsk.is_large_split(n)
    c = tsk.carry_len(cfg.window_size, cfg.hop_size)
    pcm = testing.chirp_tone(2, 3 * cfg.hop_size, cfg.sample_rate, seed=4)
    carry = testing.make("chirp_tone", 2, c, cfg.sample_rate, seed=5).transpose(0, 2, 1)
    tp = _check_against_jax(kw, 1, pcm, np.ascontiguousarray(carry))
    assert tp.fft_consts.n_fft == 35280
