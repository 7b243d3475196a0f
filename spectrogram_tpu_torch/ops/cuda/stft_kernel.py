"""The STFT kernels, stereo-packed and split-real, and their plain versions.

Kernel A, `stft_mag_packed`, replaces `spectrogram_tpu/ops/pallas/
stft_kernel.py` `stft_mag_fused2` with `packed=True, slice_bins=False`
(bodies `_kernel_packed_2d` and `_packed_mag_rows`).  Both channels ride one
complex FFT, z = (l + i r)·hann, and the conjugate-symmetric unpack splits
them again:

    L[k] = |Z[k] + conj(Z[-k])|,  R[k] = |Z[k] - conj(Z[-k])|,  k < B

with the reference's 2/W scale and the unpack's 1/2 folded into the window
(`packed_hann`).  The outputs are two [rows, B] f32 planes, DC included, B =
`stft_bins(N, W)` = max(N/2, W): N/2 at pad_factor >= 2 and W at
pad_factor 1 (bins 1 .. W-1 pass N/2 there) — the layout
`resample_matrix_full` indexes, so the colormap reads them as they are.  On
a CUDA tensor, power-of-two N runs `csrc/stft_packed.cu` and every other N
`csrc/stft_mixed.cu`.

Every N from 2 up runs on the card (`check_fft_size`): the kernels pick one
of three FFT bodies from N (`fft_body`; csrc/stft_fft.cuh): radix 2, mixed
radix 4/2/3/5/7 for 2^a 3^b 5^c 7^d (N = 4410 at 44.1 kHz and the
reference's 0.05 s window: 2-3-3-5-7-7), and Bluestein's chirp-z convolution
of a 7-smooth length M >= 2N - 1 (`bluestein_size`) for N with a prime
factor above 7 (N = 2204, M = 4500).  Each body reads one host-built table
in float64 rounded once (`fft_table`), passed with N as `FftConstants`
(`fft_constants(N, device)`).  A body holds a row's buffer (N, or M, complex
f32) in one block's shared memory, at most 227 KB; where it passes that
(`is_large`: N = 2^15 and up, 7-smooth N above 29,056, Bluestein N from
about 14,500), every packed entry takes the large-N route instead
(`csrc/stft_large.cu`): the wrapper frames its operand into [rows, W] window
planes, as the plain version frames it, and the route runs the bodies'
butterflies over a scratch in device memory: for a direct N two passes, the
load fused into the first of the register passes that run the first stages
over each run (`large_pass1` reports them) and the last stage fused into the
unpack (Bluestein: its load, stages and unpack as passes of their own).  The
scratch holds each row's whole buffer between the passes, in row groups of
at most `LARGE_SCRATCH_BYTES` (`large_grouping`; each group's launch opens
a `spk.stft.large` span while a profiler records).  All split-real entries
share one large split kernel and all packed entries one large packed
kernel, so the layouts keep their equalities at every N.

The all-windows kernel, `stft_mag_packed_allk`, replaces
`stft_mag_fused2_allk(packed=True)` (and computes what `stft_mag_fused2_buf`
computes): it reads the k hop-shifted windows of each stream straight out of
the carry+chunk sample planes and writes their magnitudes in window-major
order, row r*S + s (`csrc/stft_allk.cu`); with `emit_carry` it also writes
the next carry, as that function's `emit_carry=True` does.

Both take f32 sample planes, or the int16 PCM words of the i16_planes wire
mode (the TPU kernels' int16 operand form): an int16 plane reads half the
bytes, converts exactly to f32 in the kernel, and takes its 1/32768 wire
scale from the window, `packed_hann_i16` = `packed_hann` * 2^-15, an exact
exponent shift.  So an int16 row is bitwise the f32 row of x / 32768, in the
kernels and in the plain versions alike.

The split-real kernels (`csrc/stft_split.cu`) run each channel as its own
FFT of real input, |DFT_N(x * hann)| with `split_hann` (the reference's 2/W,
the TPU kernels' `_scaled_hann`), bins 0 .. B-1, f32 only, in the operand
layouts of the TPU's split-real kernels:

  * `stft_mag_split`: [rows, W] window planes; replaces `stft_mag_fused2`
    with `packed=False` (bodies `_kernel2_2d`, `_kernel2`, `_fft_mag_value`)
  * `stft_mag_split_allk`: the k windows of [S, L] carry+chunk buffers,
    window-major; replaces `stft_mag_fused2_allk(packed=False)` (body
    `_allk_kernel`), with `emit_carry` as the packed one
  * `stft_mag_split_carry`: the k windows of the planar carry [S, 2, C] and
    chunk [S, 2, k*hop] as two operands, returning the next carry too;
    replaces `stft_mag_fused2_split` (body `_split_kernel`), whose call
    `stft_mag_fused2_split` here mirrors with JAX's gate
  * `stft_mag_split_t`: the combined transposed operand [rows, 2, n1, m],
    x[n, c, j1, t] = sample t*n1 + j1 of channel c; replaces
    `stft_mag_fused2_t` (body `_kernel2_t`)
  * `stft_mag_split_tsplit`: the transposed carry [rows, 2, n1, c_cols] and
    hop chunk [rows, 2, n1, t_cols] as two operands, returning the next
    carry too; replaces `stft_mag_fused2_tsplit` (body `_tsplit_kernel`)

All run one row body (`stft_real_row` in `csrc/stft_fft.cuh`) with a sample
source per layout, so on the card they give the same bits for the same
window (JAX's split-operand body is only within 1 ulp of its planes body).
At even N the row is the N/2-point real-FFT pack: z[t] = x[2t] h[2t] +
i x[2t+1] h[2t+1], the body of N/2, and the unpack

    X[k] = ((Z[k] + conj Z[N/2-k]) - i e^{-2 pi i k/N} (Z[k] - conj Z[N/2-k])) / 2

(`split_fft_table`: N/2's body table, then the N/2 post-twiddles; odd N
runs the N-point body on (x, 0) with N's table).  So a split-real row holds
N/2 complex f32 and takes the large-N route only past that
(`is_large_split`: even N above 58,112 with a direct N/2); launches count
under `split_route(N)`, the body of N/2.

Each wrapper takes a CPU tensor to its plain version (torch.fft) and a CUDA
tensor to its kernel: an f32 plane to the f32 kernel, an int16 plane to the
packed kernels' int16 form (the split-real kernels take f32 only).  There is
no fallback between the two, and no cast: a CUDA tensor a kernel cannot take
raises.  Each launch counts under its kernel and under its FFT body, or
under "large" for the large-N route (`fft_route`, `split_route`,
`KernelLibrary.body_launches`).

Each kernel wrapper takes `launch`: None (or 0) launches with the table's
launch bounds, as `csrc/stft_fft.cuh` picks them from N; a value of
`LAUNCH_BOUNDS` names other bounds that the kernel instantiates
(`launch_candidates` lists them by family and N, `launch_rule` names the
table's pick).  Every choice gives the same bits; the autotuner
(`utils/autotune.py`) measures them.  The plain versions and the large-N
route, whose passes have fixed bounds, ignore it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from spectrogram_tpu_torch.ops.stft import hann_window_np
from spectrogram_tpu_torch.utils.profiling import span

KERNEL = "spk_stft_packed"
MIXED_KERNEL = "spk_stft_mixed"
ALLK_KERNEL = "spk_stft_allk"
ALLK_CARRY_KERNEL = "spk_stft_allk_carry"
SPLIT_KERNEL = "spk_stft_split"
SPLIT_ALLK_KERNEL = "spk_stft_split_allk"
SPLIT_ALLK_CARRY_KERNEL = "spk_stft_split_allk_carry"
SPLIT_CARRY_KERNEL = "spk_stft_split_carry"
SPLIT_T_KERNEL = "spk_stft_split_t"
SPLIT_TSPLIT_KERNEL = "spk_stft_split_tsplit"
KERNEL_I16 = "spk_stft_packed_i16"
MIXED_KERNEL_I16 = "spk_stft_mixed_i16"
ALLK_KERNEL_I16 = "spk_stft_allk_i16"
ALLK_CARRY_KERNEL_I16 = "spk_stft_allk_carry_i16"
LARGE_KERNEL = "spk_stft_large_packed"
LARGE_KERNEL_I16 = "spk_stft_large_packed_i16"
LARGE_SPLIT_KERNEL = "spk_stft_large_split"
PUSH_FUSED_KERNEL = "spk_push_fused"
# the kernels that run the split-real row (and read `FftConstants.split_table`)
_SPLIT_KERNELS = frozenset({SPLIT_KERNEL, SPLIT_ALLK_KERNEL, SPLIT_ALLK_CARRY_KERNEL,
                            SPLIT_CARRY_KERNEL, SPLIT_T_KERNEL, SPLIT_TSPLIT_KERNEL,
                            LARGE_SPLIT_KERNEL, PUSH_FUSED_KERNEL})
# each f32 kernel's int16 form
_I16_KERNELS = {KERNEL: KERNEL_I16, MIXED_KERNEL: MIXED_KERNEL_I16,
                ALLK_KERNEL: ALLK_KERNEL_I16, ALLK_CARRY_KERNEL: ALLK_CARRY_KERNEL_I16,
                LARGE_KERNEL: LARGE_KERNEL_I16}
WIRE_SCALE = 2.0 ** -15   # an int16 PCM word x stands for x * WIRE_SCALE
# One block's FFT buffer (N complex f32, or Bluestein's M) lives in the
# dynamic shared memory a Hopper block may opt into: 227 KB
# (csrc/stft_fft.cuh kMaxSmemBytes).  Larger buffers take the large-N route.
MAX_SMEM_BYTES = 232448
MAX_BUF = MAX_SMEM_BYTES // 8
# a split-real row whose buffer holds WIDE_ROW entries or more runs
# WIDE_THREADS threads a block (csrc/stft_fft.cuh kWideRow, kWideThreads)
WIDE_ROW, WIDE_THREADS = 16384, 1024
LARGE = "large"                 # the large-N route's body label
LARGE_SCRATCH_BYTES = 1 << 31   # the route's scratch per row group
# A launch choice (csrc/stft_fft.cuh kLaunchTable .. kLaunchNarrow): 0 the
# table's rule, else the launch bounds (threads, blocks per SM) it names.
LAUNCH_TABLE, LAUNCH_ROWS, LAUNCH_PAIR, LAUNCH_WIDE, LAUNCH_NARROW = range(5)
LAUNCH_BOUNDS = {LAUNCH_ROWS: (128, 5), LAUNCH_PAIR: (512, 2), LAUNCH_WIDE: (512, 1),
                 LAUNCH_NARROW: (1024, 1)}
ROW_BLOCKS = LAUNCH_BOUNDS[LAUNCH_ROWS][1]
# the launch families: kernel A and the packed all-windows kernels
# ("packed"), the split-real kernels ("split"), the fused push ("push")
LAUNCH_FAMILIES = ("packed", "split", "push")


def packed_hann(window_size: int) -> np.ndarray:
    """[W] f32 periodic Hann times 2/W times 1/2 (the TPU kernel's
    `_packed_hann`; exact scalings for power-of-two windows)."""
    return hann_window_np(window_size) * (2.0 / window_size) * 0.5


def split_hann(window_size: int) -> np.ndarray:
    """[W] f32 periodic Hann times 2/W, rounded as the TPU kernels'
    `_scaled_hann`: the window of the split-real kernels, twice
    `packed_hann` (which also folds in the stereo unpack's 1/2)."""
    return hann_window_np(window_size) * (2.0 / window_size)


def packed_hann_i16(window_size: int) -> np.ndarray:
    """`packed_hann` with the int16 wire scale 2^-15 folded in: the window
    of int16 sample planes."""
    return packed_hann(window_size) * np.float32(WIRE_SCALE)


def stft_bins(n_fft: int, window_size: int) -> int:
    """Magnitude bins per output row, max(N/2, W): bins 0 .. N/2-1 where
    pad_factor >= 2, bins 0 .. W-1 (the Nyquist bin of an even N included)
    where N = W, so that the colormap's taps (bins up to W-1) always fit."""
    return max(n_fft // 2, window_size)


def carry_len(window_size: int, hop: int) -> int:
    """The carry the framing keeps, W - hop samples (0 where hop >= W)."""
    return max(window_size - hop, 0)


def twiddle_table(n_fft: int) -> np.ndarray:
    """[N, 2] f32 (re, im) of exp(-2 pi i t / N), t = 0 .. N-1, computed in
    float64 and rounded once to f32."""
    t = np.arange(n_fft, dtype=np.float64)
    tw = np.exp(-2j * np.pi * t / n_fft)
    return np.stack([tw.real, tw.imag], axis=-1).astype(np.float32)


def _is_power_of_two(n: int) -> bool:
    return n & (n - 1) == 0


def _is_smooth(n: int) -> bool:
    for p in (2, 3, 5, 7):
        while n > 1 and n % p == 0:
            n //= p
    return n == 1


def mixed_radix_plan(n: int) -> tuple:
    """The radices of the MixedRadix body's stages for a 2^a 3^b 5^c 7^d n
    (4s, then one 2, then 3s, 5s and 7s; csrc/stft_fft.cuh
    `make_mixed_radix`): a 5-smooth n keeps the plan it had before radix 7."""
    radices, rest = [], n
    for r in (4, 2, 3, 5, 7):
        while rest % r == 0:
            radices.append(r)
            rest //= r
    if rest != 1 or n < 2:
        raise ValueError(f"{n} is not 2^a 3^b 5^c 7^d")
    return tuple(radices)


def digit_reversal(n: int) -> np.ndarray:
    """[n] slot(i) of the MixedRadix body of n: where its DIT pass reads
    sample i, and where its DIF pass leaves X[i] (csrc/stft_fft.cuh
    `MixedRadix::slot`)."""
    radices = mixed_radix_plan(n)
    i = np.arange(n, dtype=np.int64)
    pos = np.zeros(n, np.int64)
    span = n
    for r in reversed(radices):
        span //= r
        pos += (i % r) * span
        i //= r
    return pos


def bluestein_size(n_fft: int) -> int:
    """Bluestein's convolution length for N (csrc/stft_fft.cuh
    `bluestein_length`): of the 7-smooth M from 2N - 1 up to the least
    5-smooth one, the M whose plan has the fewest stages, then one without
    a radix 7, then the least."""
    m = max(2 * n_fft - 1, 2)
    best = best_key = None
    while True:
        if _is_smooth(m):
            plan = mixed_radix_plan(m)
            key = (len(plan), 7 in plan)
            if best is None or key < best_key:
                best, best_key = m, key
            if 7 not in plan:
                return best
        m += 1


def fft_body(n_fft: int) -> str:
    """The body the kernels run at N (csrc/stft_fft.cuh `with_fft_body`):
    "radix2", "mixed" (2^a 3^b 5^c 7^d) or "bluestein"."""
    if _is_power_of_two(n_fft):
        return "radix2"
    return "mixed" if _is_smooth(n_fft) else "bluestein"


def fft_buf_size(n_fft: int) -> int:
    """Complex f32 of a row's FFT buffer: N, or Bluestein's M."""
    return bluestein_size(n_fft) if fft_body(n_fft) == "bluestein" else n_fft


def is_large(n_fft: int) -> bool:
    """True where a packed row's FFT buffer passes the 227 KB of shared
    memory a Hopper block may hold, so the packed kernels take the large-N
    route."""
    return fft_buf_size(n_fft) > MAX_BUF


def fft_route(n_fft: int) -> str:
    """The label the packed STFT kernels' launches at N count under
    (`KernelLibrary.body_launches`): "large" on the large-N route, else
    `fft_body(N)`."""
    return LARGE if is_large(n_fft) else fft_body(n_fft)


def split_packs(n_fft: int) -> bool:
    """True where the split-real row runs as the N/2-point real-FFT pack:
    even N from 4 (csrc/stft_fft.cuh `real_packs`)."""
    return n_fft % 2 == 0 and n_fft >= 4


def split_size(n_fft: int) -> int:
    """The length of the split-real row's transform: N/2, or N at odd N."""
    return n_fft // 2 if split_packs(n_fft) else n_fft


def split_buf_size(n_fft: int) -> int:
    """Complex f32 of a split-real row's buffer: `split_size(N)`'s body
    buffer (N/2, or Bluestein's M of N/2)."""
    return fft_buf_size(split_size(n_fft))


def is_large_split(n_fft: int) -> bool:
    """True where a split-real row's buffer passes a block's shared memory,
    so the split-real kernels take the large-N route: even N above 58,112
    with a direct N/2, an N/2 whose Bluestein M passes 29,056, odd N as
    `is_large`."""
    return split_buf_size(n_fft) > MAX_BUF


def split_route(n_fft: int) -> str:
    """The label the split-real kernels' launches at N count under: "large"
    on the large-N route, else the body of `split_size(N)`."""
    return LARGE if is_large_split(n_fft) else fft_body(split_size(n_fft))


def push_smem_bytes(n_fft: int, window_size: int) -> int:
    """Shared memory of a fused-push block: the split-real row's FFT buffer
    and its two f32 planes."""
    return split_buf_size(n_fft) * 8 + 2 * stft_bins(n_fft, window_size) * 4


def launch_candidates(family: str, n_fft: int, window_size: int | None = None) -> tuple:
    """The launch choices the kernels of `family` ("packed", "split" or
    "push", `LAUNCH_FAMILIES`) instantiate at N, in `LAUNCH_BOUNDS` order;
    () where the family takes no choice there: the large-N route (fixed
    bounds), or a fused push whose block does not fit (the wrapper runs the
    chain).  The C tables refuse every other value (csrc/stft_fft.cuh
    `with_row_bounds`, `with_split_bounds`; csrc/push_fused.cuh
    `with_push_bounds`).  "push" needs the window size W."""
    if family == "packed":
        if is_large(n_fft):
            return ()
        if fft_body(n_fft) == "radix2":       # no (512, 2) form
            return (LAUNCH_ROWS, LAUNCH_WIDE)
        return (LAUNCH_ROWS, LAUNCH_PAIR, LAUNCH_WIDE)
    if family == "split":
        if is_large_split(n_fft):
            return ()
        if not split_packs(n_fft) and fft_body(n_fft) == "radix2":   # N = 2
            return (LAUNCH_ROWS, LAUNCH_WIDE)
        return (LAUNCH_ROWS, LAUNCH_WIDE, LAUNCH_NARROW)
    if family == "push":
        if push_smem_bytes(n_fft, window_size) > MAX_SMEM_BYTES:
            return ()
        return (LAUNCH_ROWS, LAUNCH_WIDE)
    raise ValueError(f"unknown launch family {family!r}; expected one of {LAUNCH_FAMILIES}")


def launch_rule(family: str, n_fft: int, window_size: int | None = None) -> int:
    """The launch choice the table's rule takes for `family` at N (one of
    `launch_candidates`), or LAUNCH_TABLE where the family takes none:
    `row_bounds_rule`, `split_bounds_rule` and `push_bounds_rule` of the C
    sources."""
    if not launch_candidates(family, n_fft, window_size):
        return LAUNCH_TABLE
    limit = MAX_SMEM_BYTES
    if family == "packed":
        smem = fft_buf_size(n_fft) * 8
        if smem * ROW_BLOCKS <= limit:
            return LAUNCH_ROWS
        if fft_body(n_fft) != "radix2" and smem * 2 <= limit:
            return LAUNCH_PAIR
        return LAUNCH_WIDE
    if family == "split":
        buf = split_buf_size(n_fft)
        if split_packs(n_fft) and buf >= WIDE_ROW:
            return LAUNCH_NARROW
        if buf * 8 * ROW_BLOCKS <= limit:
            return LAUNCH_ROWS
        if fft_body(split_size(n_fft)) == "radix2" or buf * 8 * 4 <= limit:
            return LAUNCH_WIDE
        return LAUNCH_NARROW
    smem = push_smem_bytes(n_fft, window_size)
    return LAUNCH_ROWS if smem * ROW_BLOCKS <= limit else LAUNCH_WIDE


def _choice(launch) -> int:
    """A wrapper's `launch` as the C entries take it (None: the table's)."""
    return LAUNCH_TABLE if launch is None else int(launch)


def check_fft_size(n_fft: int) -> None:
    """Raise ValueError for an N the STFT kernels do not take: below 2.
    Every other N runs, on the large-N route where the row buffer passes a
    block's shared memory."""
    if n_fft < 2:
        raise ValueError(f"the STFT needs an FFT of at least 2 points; got N={n_fft}")


def _body_table(n_fft: int) -> np.ndarray:
    """[T, 2] f32: the table of N's FFT body (see `fft_table`)."""
    if fft_body(n_fft) != "bluestein":
        return twiddle_table(n_fft)
    m = bluestein_size(n_fft)
    t = np.arange(n_fft, dtype=np.int64)
    chirp = np.exp(-1j * np.pi * ((t * t) % (2 * n_fft)) / n_fft)
    b = np.zeros(m, np.complex128)
    b[:n_fft] = np.conj(chirp)
    b[m - t[1:]] = np.conj(chirp[1:])
    filt = np.empty(m, np.complex128)
    filt[digit_reversal(m)] = np.fft.fft(b) / m
    table = np.concatenate([np.exp(-2j * np.pi * np.arange(m) / m), chirp, filt])
    return np.stack([table.real, table.imag], axis=-1).astype(np.float32)


def _body_rows(n_fft: int) -> int:
    """The rows of `_body_table(n_fft)`."""
    return n_fft if fft_body(n_fft) != "bluestein" else 2 * bluestein_size(n_fft) + n_fft


def large_span(n: int) -> int:
    """The entries of one local run of the large-N route's passes over a
    direct n-point transform (csrc/stft_large.cuh `large_local_stages` at
    the kernels' span): the product of the plan's first radices within
    MAX_BUF entries, leaving at least one stage."""
    radices, span = mixed_radix_plan(n), 1
    for r in radices[:-1]:
        if span * r > MAX_BUF:
            break
        span *= r
    return span


def _run_rows(n: int) -> int:
    """The rows of `_run_twiddles(n)`: the span of its runs, 0 for
    Bluestein's n."""
    return 0 if fft_body(n) == "bluestein" else large_span(n)


def _run_twiddles(n: int) -> np.ndarray:
    """[span, 2] f32: every G-th of a direct n's twiddles, G = n /
    `large_span(n)`, copied (not computed again): the twiddles the large-N
    route's runs read, contiguous; [0, 2] for Bluestein's n."""
    if fft_body(n) == "bluestein":
        return np.zeros((0, 2), np.float32)
    return np.ascontiguousarray(twiddle_table(n)[:: n // large_span(n)])


def fft_table(n_fft: int) -> np.ndarray:
    """[T, 2] f32 (re, im): the device table of N's FFT body, each entry
    computed in float64 and rounded once.  Direct bodies: the N twiddles
    (`twiddle_table`), then every G-th of them again for the large-N
    route's runs (`_run_twiddles`; the shared-memory bodies read the first
    N).  Bluestein: the M twiddles of its inner length, the N chirp entries
    c[t] = exp(-i pi t^2 / N) with t^2 reduced mod 2N in integers (so the
    angle stays in [0, 2 pi) at any N), and the M entries of the filter's
    transform F = DFT_M(b) / M, b[t] = b[M - t] = conj(c[t]) for t < N,
    stored at F[k] -> slot(k) (`digit_reversal(M)`), the order in which the
    kernel's DIF pass leaves the data's transform."""
    return np.concatenate([_body_table(n_fft), _run_twiddles(n_fft)])


def fft_table_shape(n_fft: int) -> tuple:
    """The shape of `fft_table(n_fft)`."""
    return (_body_rows(n_fft) + _run_rows(n_fft), 2)


def split_fft_table(n_fft: int) -> np.ndarray:
    """[T, 2] f32: the split-real kernels' table of N.  Even N (the N/2-point
    pack): the table of the body that transforms the pack, followed by the
    N/2 post-twiddles exp(-2 pi i k / N) of the unpack, each computed in
    float64 and rounded once, then the pack's run twiddles (as
    `fft_table(N/2)` ends).  Odd N: `fft_table(N)`."""
    if not split_packs(n_fft):
        return fft_table(n_fft)
    half = n_fft // 2
    post = np.exp(-2j * np.pi * np.arange(half) / n_fft)
    post = np.stack([post.real, post.imag], axis=-1).astype(np.float32)
    return np.concatenate([_body_table(half), post, _run_twiddles(half)])


def split_table_shape(n_fft: int) -> tuple:
    """The shape of `split_fft_table(n_fft)`."""
    if not split_packs(n_fft):
        return fft_table_shape(n_fft)
    half = n_fft // 2
    return (_body_rows(half) + half + _run_rows(half), 2)


class FftConstants(NamedTuple):
    """N and its FFT tables on one device: what the STFT kernels read
    besides the samples and the window.  `table` (`fft_table`) is the packed
    kernels', `split_table` (`split_fft_table`) the split-real kernels' and
    the fused push's; at odd N they are one tensor."""

    n_fft: int
    table: torch.Tensor         # [T, 2] f32
    split_table: torch.Tensor   # [T', 2] f32


@functools.lru_cache(maxsize=32)
def _fft_constants(n_fft: int, device: torch.device) -> FftConstants:
    table = torch.from_numpy(fft_table(n_fft)).to(device)
    split = (torch.from_numpy(split_fft_table(n_fft)).to(device)
             if split_packs(n_fft) else table)
    return FftConstants(n_fft, table, split)


def fft_constants(n_fft: int, device=None) -> FftConstants:
    """N's `FftConstants` on `device` (default the CPU), built once per N
    and device."""
    return _fft_constants(int(n_fft), torch.device(device or "cpu"))


def stft_mag_packed_plain(left: torch.Tensor, right: torch.Tensor,
                          hann: torch.Tensor, n_fft: int):
    """The plain PyTorch version: torch.fft on complex64, same unpack, bins
    0 .. stft_bins(N, W)-1.  int16 planes convert exactly to f32 first
    (`hann` then carries 2^-15)."""
    z = torch.complex(left.to(torch.float32) * hann, right.to(torch.float32) * hann)
    x = torch.fft.fft(z, n=n_fft)
    bins = stft_bins(n_fft, hann.shape[0])
    k = torch.arange(bins, device=left.device)
    a = x[:, :bins]
    b = x[:, (n_fft - k) % n_fft]          # Z[-k]; the k=0 partner is Z[0]
    return torch.abs(a + torch.conj(b)), torch.abs(a - torch.conj(b))


def buffer_tails(buf_l: torch.Tensor, buf_r: torch.Tensor, c: int) -> torch.Tensor:
    """[S, 2, c]: the last c samples of each buffer, the all-windows
    kernels' next carry."""
    length = buf_l.shape[1]
    return torch.stack([buf_l[:, length - c :], buf_r[:, length - c :]], dim=1)


def _windows_of(buf: torch.Tensor, w: int, k: int, hop: int) -> torch.Tensor:
    """The k windows buf[:, r*hop : r*hop+W] of [S, L] buffers, window-major."""
    return torch.cat([buf[:, r * hop : r * hop + w] for r in range(k)])


def _framed_allk(planes, buf_l, buf_r, hann, n_fft: int, k: int, hop: int,
                 emit_carry: bool):
    """`planes` (a window-plane STFT: (left, right, hann, N) -> (mag_l,
    mag_r)) over the k windows of [S, L] buffers, window-major; with
    `emit_carry` also the next carry (`buffer_tails`)."""
    w = hann.shape[0]
    mags = planes(_windows_of(buf_l, w, k, hop), _windows_of(buf_r, w, k, hop),
                  hann, n_fft)
    if emit_carry:
        return (*mags, buffer_tails(buf_l, buf_r, carry_len(w, hop)))
    return mags


def _framed_carry(planes, carry, chunk, hann, n_fft: int, k: int, hop: int):
    """`planes` over the k windows of the planar carry [S, 2, C] followed by
    the chunk, and the next carry: the last C samples, a new tensor."""
    buf = torch.cat([carry, chunk], dim=2)
    mags = _framed_allk(planes, buf[:, 0], buf[:, 1], hann, n_fft, k, hop, False)
    return (*mags, buf[:, :, buf.shape[2] - carry.shape[2] :].contiguous())


def _framed_t(planes, x, hann, n_fft: int):
    """`planes` over the transposed operand [rows, 2, n1, m] (x[n, c, j1, t]
    is sample t*n1 + j1), reordered into window planes."""
    rows, _, n1, m = x.shape
    left, right = (x[:, c].transpose(1, 2).reshape(rows, m * n1) for c in range(2))
    return planes(left, right, hann, n_fft)


def stft_mag_packed_allk_plain(buf_l: torch.Tensor, buf_r: torch.Tensor,
                               hann: torch.Tensor, n_fft: int, k: int,
                               hop: int, emit_carry: bool = False):
    """The plain version of the all-windows kernel: slice the k windows out
    of the buffers, window-major, and run `stft_mag_packed_plain`; with
    `emit_carry` also the next carry (`buffer_tails`)."""
    return _framed_allk(stft_mag_packed_plain, buf_l, buf_r, hann, n_fft, k, hop,
                        emit_carry)


def _cuda_kernel(name: str, samples: tuple, consts: FftConstants,
                 **tensors) -> tuple[str, torch.Tensor]:
    """(kernel `name` for f32 sample planes, its int16 form for int16
    planes; the FFT table it reads: `consts.split_table` for a split-real
    kernel, `consts.table` otherwise); raise unless the planes are
    contiguous f32 or int16 of one type on one CUDA device, the table and
    the other tensors contiguous f32 there, and N one the kernels take."""
    first = samples[0]
    if first.device.type != "cuda":
        raise ValueError(f"no STFT kernel for device {first.device}")
    if first.dtype not in (torch.float32, torch.int16):
        raise ValueError(
            f"sample planes must be float32 or int16 (the i16_planes wire "
            f"mode); got {first.dtype}")
    if first.dtype == torch.int16 and name not in _I16_KERNELS:
        raise ValueError(f"{name} takes float32 samples only; got int16")
    check_fft_size(consts.n_fft)
    table, shape = ((consts.split_table, split_table_shape(consts.n_fft))
                    if name in _SPLIT_KERNELS
                    else (consts.table, fft_table_shape(consts.n_fft)))
    named = [("samples", t, first.dtype) for t in samples]
    named += [("fft table", table, torch.float32)]
    named += [(arg, t, torch.float32) for arg, t in tensors.items()]
    for arg, t, dtype in named:
        if t.dtype != dtype or not t.is_contiguous() or t.device != first.device:
            raise ValueError(
                f"{arg} must be contiguous {dtype} on {first.device}; got "
                f"{t.dtype} on {t.device}, contiguous={t.is_contiguous()}"
            )
    if table.shape != shape:
        raise ValueError(
            f"the FFT table of N={consts.n_fft} is {shape}; got {tuple(table.shape)} "
            "(build it with fft_constants)")
    return (name if first.dtype == torch.float32 else _I16_KERNELS[name]), table


def _launch(name: str, device: torch.device, n_fft: int, *args) -> None:
    """Launch kernel `name` on the current stream of `device`, counting the
    launch under the kernel and under N's body label (`fft_route`, or
    `split_route` for a split-real kernel)."""
    from spectrogram_tpu_torch.ops.cuda import _build

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        body = split_route(n_fft) if name in _SPLIT_KERNELS else fft_route(n_fft)
        _build.library().launch(name, *args, stream, body=body)


def _planes(rows: int, n_fft: int, w: int, device) -> tuple:
    """Two empty [rows, stft_bins(N, W)] f32 output planes."""
    out_l = torch.empty((rows, stft_bins(n_fft, w)), dtype=torch.float32, device=device)
    return out_l, torch.empty_like(out_l)


def large_grouping(n_fft: int, rows: int, split: bool = False) -> tuple[int, int, int]:
    """(rows a group, groups, scratch bytes) of the large-N route over
    `rows` window rows at N: the packed rows (`split` False) or the
    split-real ones, two channels of `split_buf_size(N)` entries a row.
    The scratch holds one group's FFT buffers, at most LARGE_SCRATCH_BYTES
    (at least one row), and every group's launch writes it over; (0, 0, 0)
    for no rows."""
    if rows <= 0:
        return 0, 0, 0
    row_bytes = 2 * split_buf_size(n_fft) * 8 if split else fft_buf_size(n_fft) * 8
    group = max(1, min(rows, LARGE_SCRATCH_BYTES // row_bytes))
    return group, -(-rows // group), group * row_bytes


@functools.lru_cache(maxsize=None)
def large_pass1(n_fft: int, split: bool = False) -> tuple[int, int]:
    """(register passes over a run, threads a block) of the large-N route's
    pass 1 at N, the packed rows or the split-real ones (`split`), as its
    kernel launches it (csrc/stft_large.cuh `large_pass1_form`; the form
    follows from N, not W); (0, 0) where N takes Bluestein's passes.  Asks
    the kernel library once per (N, split)."""
    from spectrogram_tpu_torch.ops.cuda import _build

    return _build.library().large_pass1(n_fft, n_fft, split)


def _large_stft(kernel: str, left: torch.Tensor, right: torch.Tensor,
                hann: torch.Tensor, consts: FftConstants):
    """(mag_l, mag_r) of [rows, W] CUDA window planes on the large-N route:
    `kernel` spk_stft_large_split (f32) or spk_stft_large_packed (f32 or
    int16), over a scratch of at most LARGE_SCRATCH_BYTES, one launch per
    row group (`large_grouping`), each inside a `spk.stft.large` span."""
    n_fft = consts.n_fft
    rows, w = left.shape
    name, table = _cuda_kernel(kernel, (left, right), consts, hann=hann)
    out_l, out_r = _planes(rows, n_fft, w, left.device)
    if not rows:
        return out_l, out_r
    group, _, scratch_bytes = large_grouping(n_fft, rows, kernel in _SPLIT_KERNELS)
    scratch = torch.empty(scratch_bytes // 4, dtype=torch.float32, device=left.device)
    for r0 in range(0, rows, group):
        r1 = min(r0 + group, rows)
        with span("stft.large"):
            _launch(name, left.device, n_fft, left[r0].data_ptr(), right[r0].data_ptr(),
                    hann.data_ptr(), table.data_ptr(), scratch.data_ptr(),
                    out_l[r0].data_ptr(), out_r[r0].data_ptr(), r1 - r0, w, n_fft)
    return out_l, out_r


def _large_planes(kernel: str, consts: FftConstants):
    """The large-N route as a window-plane STFT for the framing helpers."""
    return lambda left, right, hann, n_fft: _large_stft(kernel, left, right, hann, consts)


def stft_mag_packed(left: torch.Tensor, right: torch.Tensor,
                    hann: torch.Tensor, consts: FftConstants, launch=None):
    """(mag_l, mag_r) [rows, stft_bins(N, W)] f32 of the [rows, W] f32 or
    int16 window planes, with N's `fft_constants` on the same device and
    hann `packed_hann(W)`, or `packed_hann_i16(W)` for int16.

    CPU tensors take the plain version; CUDA tensors take kernel A
    (stft_packed.cu for power-of-two N, stft_mixed.cu otherwise) under the
    launch bounds `launch` names (one of `launch_candidates("packed", N)`;
    None the table's), or the large-N route."""
    n_fft = consts.n_fft
    rows, w = left.shape
    if right.shape != left.shape or hann.shape != (w,) or w > n_fft:
        raise ValueError(
            f"window planes {tuple(left.shape)}/{tuple(right.shape)}, hann "
            f"{tuple(hann.shape)} and N={n_fft} do not fit"
        )
    if left.device.type == "cpu":
        return stft_mag_packed_plain(left, right, hann, n_fft)
    if is_large(n_fft):
        return _large_stft(LARGE_KERNEL, left, right, hann, consts)
    if _is_power_of_two(n_fft):
        name, size = KERNEL, n_fft.bit_length() - 1
    else:
        name, size = MIXED_KERNEL, n_fft
    name, table = _cuda_kernel(name, (left, right), consts, hann=hann)
    out_l, out_r = _planes(rows, n_fft, w, left.device)
    if rows:
        _launch(name, left.device, n_fft, left.data_ptr(), right.data_ptr(),
                hann.data_ptr(), table.data_ptr(), out_l.data_ptr(),
                out_r.data_ptr(), rows, w, size, _choice(launch))
    return out_l, out_r


def _check_buffers(buf_l, buf_r, hann, n_fft: int, k: int, hop: int) -> None:
    s, length = buf_l.shape
    w = hann.shape[0]
    if (buf_r.shape != buf_l.shape or hann.ndim != 1 or w > n_fft or k < 1
            or hop < 1 or length < w + (k - 1) * hop):
        raise ValueError(
            f"buffers {tuple(buf_l.shape)}/{tuple(buf_r.shape)}, hann "
            f"{tuple(hann.shape)}, k={k}, hop={hop} and N={n_fft} do not fit"
        )


def stft_mag_packed_allk(buf_l: torch.Tensor, buf_r: torch.Tensor,
                         hann: torch.Tensor, consts: FftConstants,
                         k: int, hop: int, emit_carry: bool = False, launch=None):
    """(mag_l, mag_r) [k*S, stft_bins(N, W)] f32 of the k windows buf[s,
    r*hop : r*hop+W] of the [S, L] f32 or int16 sample buffers (L >= W +
    (k-1)*hop), with row r*S + s holding window r of stream s and W =
    hann.shape[0]; hann and consts as for `stft_mag_packed`.  With
    `emit_carry` also the next carry [S, 2, W - hop] in the buffers' dtype,
    the last W - hop samples of each buffer (`buffer_tails`), a new tensor.

    CPU tensors take the plain version; CUDA tensors take the all-windows
    kernel, which never materializes the windows (and, with `emit_carry`,
    writes the next carry itself), under kernel A's `launch`, or at large N
    the windows framed as the plain version frames them, through the large-N
    route."""
    n_fft = consts.n_fft
    _check_buffers(buf_l, buf_r, hann, n_fft, k, hop)
    if buf_l.device.type == "cpu":
        return stft_mag_packed_allk_plain(buf_l, buf_r, hann, n_fft, k, hop, emit_carry)
    name, table = _cuda_kernel(ALLK_CARRY_KERNEL if emit_carry else ALLK_KERNEL,
                               (buf_l, buf_r), consts, hann=hann)
    if is_large(n_fft):
        return _framed_allk(_large_planes(LARGE_KERNEL, consts), buf_l, buf_r, hann, n_fft,
                            k, hop, emit_carry)
    return _launch_allk(name, table, buf_l, buf_r, hann, n_fft, k, hop, emit_carry, launch)


def _launch_allk(name: str, table: torch.Tensor, buf_l, buf_r, hann, n_fft: int,
                 k: int, hop: int, emit_carry: bool, launch):
    """Launch all-windows kernel `name` on its FFT `table` (its `_carry`
    form with `emit_carry`, which also takes the next carry in the buffers'
    dtype)."""
    s, length = buf_l.shape
    w = hann.shape[0]
    out_l, out_r = _planes(k * s, n_fft, w, buf_l.device)
    args = [buf_l.data_ptr(), buf_r.data_ptr(), hann.data_ptr(),
            table.data_ptr(), out_l.data_ptr(), out_r.data_ptr()]
    c = carry_len(w, hop)
    if emit_carry:
        next_carry = torch.empty((s, 2, c), dtype=buf_l.dtype, device=buf_l.device)
        args += [next_carry.data_ptr(), s, length, k, hop, w, n_fft, c, _choice(launch)]
    else:
        args += [s, length, k, hop, w, n_fft, _choice(launch)]
    if s:
        _launch(name, buf_l.device, n_fft, *args)
    return (out_l, out_r, next_carry) if emit_carry else (out_l, out_r)


# ---------------------------------------------------------------- split-real

def stft_mag_split_plain(left: torch.Tensor, right: torch.Tensor,
                         hann: torch.Tensor, n_fft: int):
    """The plain version of the split-real kernels: |X| of bins 0 ..
    stft_bins(N, W)-1 of each channel's windowed, zero-padded row, by
    torch.fft.rfft (torch.fft.fft where the bins pass N/2, at N = W)."""
    bins = stft_bins(n_fft, hann.shape[0])
    fft = torch.fft.rfft if bins <= n_fft // 2 + 1 else torch.fft.fft

    def mag(x: torch.Tensor) -> torch.Tensor:
        return torch.abs(fft(x * hann, n=n_fft)[:, :bins])

    return mag(left), mag(right)


def stft_mag_split_allk_plain(buf_l: torch.Tensor, buf_r: torch.Tensor,
                              hann: torch.Tensor, n_fft: int, k: int,
                              hop: int, emit_carry: bool = False):
    """Slice the k windows out of the buffers, window-major, and run
    `stft_mag_split_plain`; with `emit_carry` also the next carry
    (`buffer_tails`)."""
    return _framed_allk(stft_mag_split_plain, buf_l, buf_r, hann, n_fft, k, hop,
                        emit_carry)


def stft_mag_split_carry_plain(carry: torch.Tensor, chunk: torch.Tensor,
                               hann: torch.Tensor, n_fft: int, k: int, hop: int):
    """(mag_l, mag_r, next_carry): the k windows of the concatenated carry
    + chunk through `stft_mag_split_plain`, and the last C samples."""
    return _framed_carry(stft_mag_split_plain, carry, chunk, hann, n_fft, k, hop)


def stft_mag_split_t_plain(x: torch.Tensor, hann: torch.Tensor, n_fft: int):
    """Reorder the transposed operand [rows, 2, n1, m] (x[n, c, j1, t] is
    sample t*n1 + j1) into window planes and run `stft_mag_split_plain`."""
    return _framed_t(stft_mag_split_plain, x, hann, n_fft)


def split_next_carry(carry: torch.Tensor, chunk: torch.Tensor) -> torch.Tensor:
    """The next transposed carry [rows, 2, n1, c_cols] after a hop of
    t_cols columns: carry columns t_cols.. then the chunk, or the chunk's
    last c_cols columns where t_cols >= c_cols."""
    c_cols, t_cols = carry.shape[3], chunk.shape[3]
    if t_cols >= c_cols:
        return chunk[..., t_cols - c_cols :].contiguous()
    return torch.cat([carry[..., t_cols:], chunk], dim=3)


def stft_mag_split_tsplit_plain(carry: torch.Tensor, chunk: torch.Tensor,
                                hann: torch.Tensor, n_fft: int):
    """(mag_l, mag_r, next_carry): the window carry + chunk through
    `stft_mag_split_t_plain`, and `split_next_carry`."""
    return _framed_tsplit(stft_mag_split_plain, carry, chunk, hann, n_fft)


def _framed_tsplit(planes, carry, chunk, hann, n_fft: int):
    """`planes` over the transposed carry + chunk, and `split_next_carry`."""
    mag_l, mag_r = _framed_t(planes, torch.cat([carry, chunk], dim=3), hann, n_fft)
    return mag_l, mag_r, split_next_carry(carry, chunk)


def stft_mag_split(left: torch.Tensor, right: torch.Tensor,
                   hann: torch.Tensor, consts: FftConstants, launch=None):
    """(mag_l, mag_r) [rows, stft_bins(N, W)] f32 split-real magnitudes of
    the [rows, W] f32 window planes, hann `split_hann(W)`.

    CPU tensors take the plain version; CUDA tensors take spk_stft_split
    under the launch bounds `launch` names (one of
    `launch_candidates("split", N)`; None the table's), or the large-N
    route."""
    n_fft = consts.n_fft
    rows, w = left.shape
    if right.shape != left.shape or hann.shape != (w,) or w > n_fft:
        raise ValueError(
            f"window planes {tuple(left.shape)}/{tuple(right.shape)}, hann "
            f"{tuple(hann.shape)} and N={n_fft} do not fit"
        )
    if left.device.type == "cpu":
        return stft_mag_split_plain(left, right, hann, n_fft)
    if is_large_split(n_fft):
        return _large_stft(LARGE_SPLIT_KERNEL, left, right, hann, consts)
    name, table = _cuda_kernel(SPLIT_KERNEL, (left, right), consts, hann=hann)
    out_l, out_r = _planes(rows, n_fft, w, left.device)
    if rows:
        _launch(name, left.device, n_fft, left.data_ptr(), right.data_ptr(),
                hann.data_ptr(), table.data_ptr(), out_l.data_ptr(),
                out_r.data_ptr(), rows, w, n_fft, _choice(launch))
    return out_l, out_r


def stft_mag_split_allk(buf_l: torch.Tensor, buf_r: torch.Tensor,
                        hann: torch.Tensor, consts: FftConstants,
                        k: int, hop: int, emit_carry: bool = False, launch=None):
    """(mag_l, mag_r) [k*S, stft_bins(N, W)] f32 split-real magnitudes of
    the k windows buf[s, r*hop : r*hop+W] of the [S, L] f32 buffers, row
    r*S + s; hann `split_hann(W)`.  With `emit_carry` also the next carry
    [S, 2, W - hop], as `stft_mag_packed_allk` gives it.

    CPU tensors take the plain version; CUDA tensors take
    spk_stft_split_allk (spk_stft_split_allk_carry with `emit_carry`),
    which never materializes the windows, under `stft_mag_split`'s
    `launch`, or at large N the framed windows through the large-N route."""
    n_fft = consts.n_fft
    _check_buffers(buf_l, buf_r, hann, n_fft, k, hop)
    if buf_l.device.type == "cpu":
        return stft_mag_split_allk_plain(buf_l, buf_r, hann, n_fft, k, hop, emit_carry)
    name, table = _cuda_kernel(SPLIT_ALLK_CARRY_KERNEL if emit_carry else SPLIT_ALLK_KERNEL,
                               (buf_l, buf_r), consts, hann=hann)
    if is_large_split(n_fft):
        return _framed_allk(_large_planes(LARGE_SPLIT_KERNEL, consts), buf_l, buf_r, hann,
                            n_fft, k, hop, emit_carry)
    return _launch_allk(name, table, buf_l, buf_r, hann, n_fft, k, hop, emit_carry, launch)


def stft_mag_split_carry(carry: torch.Tensor, chunk: torch.Tensor,
                         hann: torch.Tensor, consts: FftConstants,
                         k: int, hop: int, launch=None):
    """(mag_l, mag_r, next_carry): the split-real magnitudes [k*S,
    stft_bins(N, W)] f32 of the k windows of each stream's planar carry
    [S, 2, C] followed by its chunk [S, 2, k*hop] (f32, C = W - hop, hann
    `split_hann(W)`), row r*S + s for window r of stream s, and the next
    carry [S, 2, C], the last C samples of carry + chunk, a new tensor.
    The rows are `stft_mag_split_allk`'s on the concatenated buffers.

    CPU tensors take the plain version; CUDA tensors take
    spk_stft_split_carry, which reads the two operands in place (no
    concatenation) and writes the next carry itself, under
    `stft_mag_split`'s `launch`; at large N the concatenated buffers'
    windows take the large-N route."""
    n_fft = consts.n_fft
    w = hann.shape[0]
    if carry.ndim != 3 or carry.shape[1] != 2:
        raise ValueError(f"expected a [S, 2, C] carry; got {tuple(carry.shape)}")
    s, _, c = carry.shape
    if (c != carry_len(w, hop) or chunk.shape != (s, 2, k * hop) or k < 1
            or hann.ndim != 1 or w > n_fft):
        raise ValueError(
            f"carry {tuple(carry.shape)}, chunk {tuple(chunk.shape)}, hann "
            f"{tuple(hann.shape)}, k={k}, hop={hop} and N={n_fft} do not fit "
            f"(the carry holds W - hop = {carry_len(w, hop)} samples)"
        )
    if carry.device.type == "cpu":
        return stft_mag_split_carry_plain(carry, chunk, hann, n_fft, k, hop)
    name, table = _cuda_kernel(SPLIT_CARRY_KERNEL, (carry, chunk), consts, hann=hann)
    if is_large_split(n_fft):
        return _framed_carry(_large_planes(LARGE_SPLIT_KERNEL, consts), carry, chunk, hann,
                             n_fft, k, hop)
    out_l, out_r = _planes(k * s, n_fft, w, carry.device)
    next_carry = torch.empty_like(carry)
    if s:
        _launch(name, carry.device, n_fft, carry.data_ptr(), chunk.data_ptr(),
                hann.data_ptr(), table.data_ptr(), out_l.data_ptr(), out_r.data_ptr(),
                next_carry.data_ptr(), s, c, k, hop, w, n_fft, _choice(launch))
    return out_l, out_r, next_carry


def stft_mag_fused2_split(carry: torch.Tensor, chunk_pl: torch.Tensor,
                          cfg, k: int = 1):
    """The counterpart of the JAX package's `stft_mag_fused2_split` at its
    call: (mag_l, mag_r, new_carry) of the [S, 2, W - hop] f32 carry and
    the [S, 2, k*hop] f32 planar chunk of `cfg`, as `stft_mag_split_carry`
    gives them, with the window and FFT table of `cfg` on the operands'
    device.  Raises ValueError where JAX's gate `split_framing_supported`
    refuses the geometry (hop not a multiple of the plan's n1, pad_factor
    below 2)."""
    from spectrogram_tpu_torch.ops import fft_plan

    plan = fft_plan.make_plan(cfg)
    if not fft_plan.split_framing_supported(cfg, k, plan):
        raise ValueError(f"split framing unsupported for {cfg} (plan={plan})")
    dev = carry.device
    hann = torch.from_numpy(split_hann(cfg.window_size)).to(dev)
    return stft_mag_split_carry(carry, chunk_pl, hann,
                                fft_constants(cfg.padded_size, dev), k, cfg.hop_size)


def stft_mag_split_t(x: torch.Tensor, hann: torch.Tensor, consts: FftConstants,
                     launch=None):
    """(mag_l, mag_r) [rows, stft_bins(N, n1*m)] f32 split-real magnitudes
    of the windows of the combined transposed operand x [rows, 2, n1, m]
    f32 (x[n, c, j1, t] = sample t*n1 + j1 of channel c), hann
    `split_hann(n1*m)`.

    CPU tensors take the plain version; CUDA tensors take spk_stft_split_t
    under `stft_mag_split`'s `launch`, or at large N the reordered window
    planes through the large-N route."""
    n_fft = consts.n_fft
    if x.ndim != 4 or x.shape[1] != 2:
        raise ValueError(f"expected a [rows, 2, n1, m] operand; got {tuple(x.shape)}")
    rows, _, n1, m = x.shape
    if hann.shape != (n1 * m,) or n1 * m > n_fft:
        raise ValueError(
            f"operand {tuple(x.shape)}, hann {tuple(hann.shape)} and N={n_fft} "
            "do not fit"
        )
    if x.device.type == "cpu":
        return stft_mag_split_t_plain(x, hann, n_fft)
    name, table = _cuda_kernel(SPLIT_T_KERNEL, (x,), consts, hann=hann)
    if is_large_split(n_fft):
        return _framed_t(_large_planes(LARGE_SPLIT_KERNEL, consts), x, hann, n_fft)
    out_l, out_r = _planes(rows, n_fft, n1 * m, x.device)
    if rows:
        _launch(name, x.device, n_fft, x.data_ptr(), hann.data_ptr(), table.data_ptr(),
                out_l.data_ptr(), out_r.data_ptr(), rows, n1, m, n_fft, _choice(launch))
    return out_l, out_r


def stft_mag_split_tsplit(carry: torch.Tensor, chunk: torch.Tensor,
                          hann: torch.Tensor, consts: FftConstants, launch=None):
    """(mag_l, mag_r, next_carry): the split-real magnitudes [rows,
    stft_bins(N, W)] f32 of the windows whose columns are the transposed
    carry [rows, 2, n1, c_cols] followed by the transposed hop chunk [rows,
    2, n1, t_cols] (f32; W = n1*(c_cols+t_cols), hann `split_hann(W)`), and
    the next carry [rows, 2, n1, c_cols] (`split_next_carry`), a new tensor.

    CPU tensors take the plain version; CUDA tensors take
    spk_stft_split_tsplit, which writes the next carry itself, under
    `stft_mag_split`'s `launch`; at large N the framed windows take the
    large-N route."""
    n_fft = consts.n_fft
    if carry.ndim != 4 or carry.shape[1] != 2:
        raise ValueError(f"expected a [rows, 2, n1, c_cols] carry; got {tuple(carry.shape)}")
    rows, _, n1, c_cols = carry.shape
    t_cols = chunk.shape[-1]
    w = n1 * (c_cols + t_cols)
    if chunk.shape != (rows, 2, n1, t_cols) or hann.shape != (w,) or w > n_fft:
        raise ValueError(
            f"carry {tuple(carry.shape)}, chunk {tuple(chunk.shape)}, hann "
            f"{tuple(hann.shape)} and N={n_fft} do not fit"
        )
    if carry.device.type == "cpu":
        return stft_mag_split_tsplit_plain(carry, chunk, hann, n_fft)
    name, table = _cuda_kernel(SPLIT_TSPLIT_KERNEL, (carry, chunk), consts, hann=hann)
    if is_large_split(n_fft):
        return _framed_tsplit(_large_planes(LARGE_SPLIT_KERNEL, consts), carry, chunk, hann,
                              n_fft)
    out_l, out_r = _planes(rows, n_fft, w, carry.device)
    next_carry = torch.empty_like(carry)
    if rows:
        _launch(name, carry.device, n_fft, carry.data_ptr(), chunk.data_ptr(),
                hann.data_ptr(), table.data_ptr(), out_l.data_ptr(), out_r.data_ptr(),
                next_carry.data_ptr(), rows, n1, c_cols, t_cols, n_fft, _choice(launch))
    return out_l, out_r, next_carry
