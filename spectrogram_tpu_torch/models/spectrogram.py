"""The streaming spectrogram pipeline on PyTorch.

The counterpart of `spectrogram_tpu/models/spectrogram.py`
(`SpectrogramPipeline`, `StreamState`).  Each push takes `chunk_hops` = k
hops of stereo PCM per stream and returns k colormapped rows per stream; with
`store_ring` it also keeps each stream's last `viewport_rows` magnitude rows
in a bf16 ring, which `render_viewport` draws.  A push is framing (carry +
chunk -> per-channel sample buffers, and the next carry), then two kernels:

  A. the packed STFT -> [k*S, N/2] magnitude planes, window-major (row
     r*S + s is window r of stream s): `stft_mag_packed` over the one window
     per stream at k=1, `stft_mag_packed_allk` over the k windows of the
     buffers at k>1 (the windows are never materialized on the card)
  B. the colormap: two-tap log-frequency resample, dB and pan laws,
     per-stream palette -> [k*S, H] int32 RGBA8888, by the kernel the
     state's tables pick: `colormap_builtin` (built-in tables, per row or
     one for all rows), `colormap_blockwise` (a block of rows with one
     palette reads one table), `colormap_generic` (a registry with a
     `FactoredScheme` outside the built-in mono/stereo structure: two
     factor tables per row) or `colormap_static` (`static_palette=`: one
     palette, passed to the kernel by value)

and, with the ring, a bf16 copy of bins 1..W-1 of the planes into it.
`render_viewport` runs the colormap again, over the ring's rows.

The multi-tenant serving mode is the JAX package's:

  * blockwise palettes ("auto"): a state whose palette layout leaves at
    least half the colormap's row blocks single-palette carries a zero-size
    marker in its tables tuple, and its pushes take the blockwise colormap;
  * `palette_sort`: a scattered layout whose stable argsort passes that test
    is stored sorted, (t_sorted, perm, inv) with perm/inv relative to the
    stream blocks of `stream_blocks`, or (t_sorted, perm, inv, marker) with a
    global perm where only a whole-state sort passes.  Without a ring the
    carry lives in sorted order (carry-sort mode): each push permutes the
    chunk into it and unpermutes the rows.  With a ring the magnitude planes
    are permuted into sorted order for the colormap (the mag-bridge) and the
    ring stays in external order.  Sorted rows equal per-row rows exactly;
  * `sorted_output` and `presorted_input` leave the row unpermute and the
    chunk permute to the host: `output_perm`, `input_perm` and `input_dest`
    say where each stream's rows and samples are; `unsort_state` leaves the
    sorted class;
  * `i16_planes`: carry, chunks and kernel operands stay int16 PCM words,
    half the bytes; rows equal the f32 pipeline's on x/32768 exactly.

Palette ids are always concrete here: `set_palette` reads them to the host,
so every layout decision inspects real ids.  The JAX rules for ids traced
under `jit` (keep the previous state's sortedness or marker) have no
counterpart.  `stream_blocks` only sets the sort-block layout: a push runs
all streams at once, with the block-relative permutations made global,
which gives the rows the JAX package's blocked push gives.

Palette registries are the JAX package's: schemes that fit the built-in
mono/stereo structure share [P, R*4] built-in tables; a registry holding any
other `FactoredScheme` keeps (U, V) factor tables for all its schemes, and its
states carry a (u, v) pair.  `static_palette` pins one scheme: its states
carry no tables, `set_palette` raises, and every row takes the static
colormap.  Neither a generic nor a static state is marked for the blockwise
colormap or palette-sorted (the JAX package gates both on built-in tables).

The JAX package's opt-in STFT layouts, with the gates of its Pallas chain
(the TPU plan `fft_plan` defines the transposed layout's n1):

  * `stft_packed=False`: the split-real STFT, one FFT of real input per
    channel: `stft_mag_split` over the window planes at k=1 and in
    `process()`, `stft_mag_split_allk` over the buffers at k>1;
  * `transposed_carry=True`: the carry is stored [S, 2, n1, C/n1] (sample
    t*n1 + j1 at [j1, t]); a push transposes only the chunk, concatenates
    and slices, and `stft_mag_split_t` reads the [k*S, 2, n1, m] windows;
  * `framing="tsplit"` (k=1): the same carry, and `stft_mag_split_tsplit`
    takes the carry and the transposed chunk as two operands and writes the
    next carry itself.

All three are split-real, and the four split-real kernels share one row
body, so their rows are the same bits; `process()` of such a pipeline takes
the split-real plane kernel, and streamed == `process()` stays exact.

Every geometry the JAX pipeline takes runs here: any FFT size (the kernels
pick radix 2, mixed radix or Bluestein from N, and take the large-N route
where a row's FFT buffer passes a block's shared memory, e.g. 48 kHz with a
0.5 s window) and pad_factor 1, where the planes are W bins wide
(`stft_kernel.stft_bins`) so that the colormap's taps and the ring's bins
1..W-1 fit them; the state keeps JAX's shapes.

On a CPU device the kernels run as their plain PyTorch versions; on a CUDA
device as the hand-written kernels in `csrc/`, unless the caller names JAX's
golden backend (`stft_backend="xla"`, `colormap_backend="xla"`), which runs
the plain STFT and colormap on the card.  No backend selects the ring write:
on the card it always takes its kernel (`csrc/ring_write.cu`), and
`with_plain_kernels()` is the only pipeline that launches no kernel.  There
is no fallback from one to the other.  Without a `device`, the pipeline runs
on the card.

The kernels' launch shapes are fixed tables in the C sources (the STFT
rows' launch bounds, the colormap tile's staged or direct form).  A
pipeline's `launch` (`override_launch`, which `autotune=True` calls with
`utils.autotune.tune`'s pick) names another shape per launch family
("packed", "split", "tile"; `launch_families` lists those its push runs),
and every launch of its push, `process()` and `render_viewport` takes it;
every shape gives the same bits.

While a `torch.profiler` records, a push opens a `utils.profiling.span` per
stage (`spk.push` around it; `spk.wire`, `spk.order.perms`,
`spk.order.chunk`, `spk.frame`, `spk.stft`, `spk.order.bridge`,
`spk.colormap`, `spk.order.rows`, `spk.ring`, `spk.state` inside; the
large-N STFT route's `spk.stft.large` around each row-group launch), and
`render_viewport` opens `spk.render`; with none recording they cost a flag
read each.  `SpectrogramPipeline.counters` counts the palette-layout
decisions and the order, ring and large-N STFT stages the pushes took, as
plain host integers, and `last_stft` records the last push's STFT route.
"""

from __future__ import annotations

import collections
import copy
from typing import NamedTuple, Optional

import numpy as np
import torch

from spectrogram_tpu_torch.config import SpectrogramConfig
from spectrogram_tpu_torch.ops import colormap as cmap_ops
from spectrogram_tpu_torch.ops import fft_plan
from spectrogram_tpu_torch.ops import stft as stft_ops
from spectrogram_tpu_torch.ops.cuda import colormap_kernel, ring_kernel, stft_kernel
from spectrogram_tpu_torch.utils.profiling import span

# Stream blocks of render_viewport hold at most this many bytes of f32 rows.
RENDER_BLOCK_BYTES = 1 << 29


class StreamState(NamedTuple):
    """Per-batch state.  Tensors lead with the stream axis except the
    scalars shared by the lockstep batch; the layout is the JAX package's."""

    carry: torch.Tensor       # [S, 2, window-hop] f32 (int16 with i16_planes);
                              # [S, 2, n1, (window-hop)/n1] f32 transposed
    ring: torch.Tensor        # [S, R, 2, B] bf16 magnitude rows (R = 0: no ring)
    cursor: torch.Tensor      # [] int32 — next ring row
    palette_id: torch.Tensor  # [S] int32 — per-stream palette index
    row_count: torch.Tensor   # [] int32 — rows produced since init
    # Pre-picked kernel tables, refreshed by init_state/set_palette and not
    # by a push: ([S, R*4],) per stream or ([1, R*4],) for one palette, plus
    # a zero-size int32 marker for the blockwise colormap; palette-sorted:
    # (t_sorted [S, R*4], perm [S], inv [S]) or, with a global perm,
    # (t_sorted, perm, inv, marker).  A generic registry's (u, v), each
    # [S|1, R*4]; () for a static_palette pipeline.
    tables: tuple = ()


def _is_marker(t: torch.Tensor) -> bool:
    return t.ndim == 1 and t.numel() == 0


def default_device(device=None) -> torch.device:
    """`device`, or the current CUDA card when it is None.  Without a card
    and without a device this raises: the port runs on the card unless the
    caller asks for the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is available, and the port runs on the card by "
            "default; pass device='cpu' to run the plain PyTorch versions"
        )
    return torch.device("cuda", torch.cuda.current_device())


class SpectrogramPipeline:
    """Streaming STFT -> colormap pipeline over a batch of S streams.

    Args:
      cfg: geometry/presentation config.
      chunk_hops: rows per push (k); a chunk is k * hop samples.
      viewport_rows: ring length (default cfg.viewport_rows), rounded up to
        a multiple of chunk_hops so that a push's rows never wrap.
      ring_dtype: ring storage: torch.bfloat16 (JAX's default), float16,
        float32 or float64, the dtypes the ring kernel takes; any other
        raises.  Rows are rounded to it to nearest even, and
        `render_viewport` reads them back as f32.
      lut_resolution: palette table size (default cfg.lut_resolution).
      store_ring: keep the row ring that render_viewport draws.
      stft_backend: "auto", "mxu", "pallas" or "xla", validated as in JAX
        (an unknown value raises; "mxu" and "pallas" raise where JAX's
        matrix-unit plan is unusable: no even-n1 factorization, or
        pad_factor 1).  "auto", "mxu" and "pallas" all run the hand-written
        STFT kernels; the layout knobs below take JAX's Pallas-chain gates
        under "auto" and "pallas" (a TPU's "auto") and raise under "mxu"
        and "xla", as in JAX.  "xla", JAX's golden path (`jnp.fft`), runs
        the plain PyTorch STFT on the pipeline's device: never a default.
      colormap_backend: "auto", "pallas" or "xla", validated as in JAX.
        "auto" and "pallas" run the colormap kernels; "xla" the plain
        PyTorch colormap on the pipeline's device.
      packed_output: emit [S, k, H] int32 RGBA8888 (byte 0 = R) instead of
        [S, k, H, 4] u8.
      precision_profile: "exact" or "fast".  Both compute the resample in
        true f32: "fast" relaxed only a TPU matrix-unit pass, and this port
        has no such pass.  Kept for API parity.
      kernel_interpret: accepted for API parity; changes nothing.  It ran
        JAX's Pallas kernels in interpret mode on a CPU; a CUDA kernel has
        no such mode (pass device="cpu" for the plain versions).
      autotune: on a CUDA pipeline, measure the launch shapes of the kernel
        families its push runs (`launch_families`: the STFT rows' launch
        bounds, the colormap tile's form) on the card with
        `utils.autotune.tune`, cached per (card name, geometry, these
        constructor arguments, kernel sources), and launch the pick
        (`override_launch`); the rows are the same bits.  A CPU pipeline
        measures nothing and launches nothing: it changes nothing there.
        JAX measures its matrix-unit plans and block sizes instead; the
        two caches never cross.
      sanitize_input: zero non-finite samples of float chunks (and of
        process()'s PCM) at the ingestion edge, so that one producer's NaN
        cannot poison its stream's carry.
      schemes: palette registry (default the 19 built-ins): `ColorScheme`s
        and `FactoredScheme`s.  Where every scheme fits the built-in
        mono/stereo structure the built-in colormap serves them; otherwise
        the generic two-table colormap serves the whole registry.
      static_palette: a scheme name or index: every stream takes that one
        palette, passed to the static colormap by value (the JAX package
        bakes it into its kernel); `set_palette` then raises.  At most
        `colormap_kernel.MAX_STATIC_RES` LUT entries.
      blockwise_palettes: "auto" marks states whose palette layout leaves at
        least half the colormap row blocks single-palette, and their pushes
        take the blockwise colormap; True always takes it, False never
        (sorted states take it regardless).  The rows are the same.
      stream_blocks: "auto" (4096-stream sort blocks from 12,288 streams in
        the k=1 streaming mode without a ring), an int (blocks of that many
        streams) or 0 (one block): the blocks within which palette_sort
        sorts.
      palette_sort: sort scattered per-stream palette layouts where the
        sorted layout passes the blockwise test (see the module docstring).
      sorted_output: with palette_sort, emit the rows of a sorted state in
        sorted stream order; `output_perm(state)` indexes them.
      presorted_input: without a ring and with palette_sort, take the chunk
        of a sorted state in sorted stream order: row i carries external
        stream `input_perm(state)[i]` (`input_dest` is the inverse).
      i16_planes: keep carry, chunks and kernel operands int16 PCM words;
        pushes then take int16 chunks only.  Packed STFT on the planar
        carry only: it raises with stft_packed=False, transposed_carry or
        framing="tsplit", as in JAX (which has no int16 split-real kernel).
      transposed_carry: store the carry [S, 2, n1, C/n1] and run the
        split-real STFT on the transposed windows.  Where the JAX gate
        refuses it (hop not a multiple of the plan's n1, a lane-padded plan,
        or k > 1 where the TPU's DMA-offset framing applies) it raises.
      framing: "auto", "allk", "planes" or "tsplit".  "tsplit" (k=1, with
        JAX's `tsplit_supported`) keeps the transposed carry and passes
        carry and chunk to the split-real kernel as two operands, which
        writes the next carry.  "allk" raises where the JAX all-windows gate
        fails; "auto", "allk" and "planes" all run the all-windows kernel at
        k > 1 (its rows equal the window-plane path's).
      stft_packed: "auto", True or False.  False takes the split-real
        kernels everywhere; "auto" and True the stereo-packed ones on every
        geometry the kernels take (True raises where the TPU's packed
        kernel did not apply, as in JAX).
      stft_unpack_split: "auto", 0, 2 or 3, validated as in JAX (nonzero
        needs the packed STFT).  It chose a TPU matrix-unit split of the
        unpack; the port's unpack is exact, which JAX's 0 and 3 are bit for
        bit and its 2 within 2^-17, so it changes nothing here.
      device: where state, constants and kernels live: "cuda" (the default)
        runs the kernels, "cpu" their plain versions.

    `counters` (a `collections.Counter` of host integers) counts each
    palette-layout decision where it is taken (`set_palette`,
    `restored_tables_for`, the mesh's sharded layouts): "layout.clustered"
    (the marker, no sort), "layout.sorted_blocks" (the block sort),
    "layout.sorted_global" (the length-4 form: the whole-state sort or the
    mesh's per-shard sort), "layout.unsorted" (the rule refused every order
    it tried, or the sort is off or cannot take the tables),
    "layout.generic" (a generic registry's (u, v) pair) and "layout.tests"
    (each blockwise test), and the pushes that took each gather of the
    palette order and the ring write: "push.order_chunk",
    "push.bridge", "push.order_rows", "push.ring", and those that took the
    large-N STFT route, "push.stft_large", with its row-group launches,
    "stft.large_groups".  `last_stft` records the last push's STFT:
    {"route", "n_fft", "rows", "groups", "scratch_bytes"}, the route "plain"
    (the plain versions), "large" or the FFT body its launches count under,
    the windows it took, and on the large-N route its row groups and the
    bytes of scratch each group's launch writes over (0 elsewhere); None
    before any push.  `last_layout` is
    {"blocks": row blocks, "uniform": single-palette blocks} of the last
    order the blockwise test read: the order the pushes run where the rule
    took one, else the last (most sorted) order it refused; None before
    any test.
    """

    def __init__(
        self,
        cfg: SpectrogramConfig,
        chunk_hops: int = 8,
        viewport_rows: Optional[int] = None,
        ring_dtype=torch.bfloat16,
        lut_resolution: Optional[int] = None,
        store_ring: bool = True,
        stft_backend: str = "auto",
        colormap_backend: str = "auto",
        packed_output: bool = False,
        precision_profile: str = "exact",
        kernel_interpret: bool = False,
        autotune: bool = False,
        sanitize_input: bool = False,
        schemes=None,
        static_palette=None,
        blockwise_palettes="auto",
        stream_blocks="auto",
        palette_sort: bool = True,
        sorted_output: bool = False,
        presorted_input: bool = False,
        i16_planes: bool = False,
        transposed_carry: bool = False,
        framing: str = "auto",
        stft_packed="auto",
        stft_unpack_split="auto",
        device=None,
    ):
        cfg.validate()
        if ring_dtype not in ring_kernel.RING_DTYPES:
            raise ValueError("ring_dtype must be torch.bfloat16, float16, float32 or float64 "
                             f"(the ring kernel's); got {ring_dtype!r}")
        if int(chunk_hops) < 1:
            raise ValueError(f"chunk_hops must be >= 1; got {chunk_hops}")
        if precision_profile not in ("exact", "fast"):
            raise ValueError(f"unknown precision_profile {precision_profile!r}")
        if stft_backend not in ("auto", "mxu", "xla", "pallas"):
            raise ValueError(f"unknown stft_backend {stft_backend!r}")
        if colormap_backend not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown colormap_backend {colormap_backend!r}")
        if blockwise_palettes not in (False, True, "auto"):
            raise ValueError(
                "blockwise_palettes must be False, True or 'auto'; got "
                f"{blockwise_palettes!r}"
            )
        if stream_blocks != "auto" and not isinstance(stream_blocks, int):
            raise ValueError(f"stream_blocks must be 'auto' or int, got "
                             f"{stream_blocks!r}")
        if sorted_output and not palette_sort:
            raise ValueError("sorted_output requires palette_sort=True")
        if presorted_input and not (palette_sort and not store_ring):
            raise ValueError(
                "presorted_input requires the sorted-carry streaming mode "
                "(palette_sort=True and store_ring=False)"
            )
        from spectrogram_tpu_torch.color.colorscheme import (
            DEFAULT_COLOR_SCHEMES,
            stacked_backgrounds,
        )

        self.cfg = cfg
        self.device = default_device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        k = self.chunk_hops = int(chunk_hops)
        rows = viewport_rows or cfg.viewport_rows
        self.viewport_rows = -(-rows // k) * k
        self.ring_dtype = ring_dtype
        self.store_ring = bool(store_ring)
        self.packed_output = bool(packed_output)
        self.precision_profile = precision_profile
        self.stft_backend = stft_backend
        self.colormap_backend = colormap_backend
        self.kernel_interpret = bool(kernel_interpret)
        self.autotune = bool(autotune)
        self.sanitize_input = bool(sanitize_input)
        self.blockwise_palettes = blockwise_palettes
        self.stream_blocks = stream_blocks
        self.palette_sort = bool(palette_sort)
        # without a ring the carry lives in sorted stream order
        self.carry_sort_mode = self.palette_sort and not self.store_ring
        self.sorted_output = bool(sorted_output)
        self.presorted_input = bool(presorted_input)
        self.i16_planes = bool(i16_planes)
        self.carry_dtype = torch.int16 if self.i16_planes else torch.float32
        self.schemes = tuple(schemes) if schemes is not None else DEFAULT_COLOR_SCHEMES
        self.scheme_names = tuple(s.name for s in self.schemes)
        res = lut_resolution or cfg.lut_resolution
        self._lut_resolution = res
        self.chunk_size = k * cfg.hop_size
        self.carry_size = stft_ops.carry_size(cfg)
        self.stft_block_rows = None
        self._stft_packed_arg = stft_packed
        self._stft_unpack_split_arg = stft_unpack_split
        self._stft_layout(cfg, stft_backend, stft_packed, stft_unpack_split,
                          transposed_carry, framing)
        dev = self.device
        # the registry's kind: built-in tables where every scheme fits the
        # built-in structure, else (U, V) factor tables for all of them
        try:
            tables = colormap_kernel.builtin_color_tables(res, self.schemes)
        except ValueError:
            tables = None
        if tables is not None:
            self.builtin_tables = torch.from_numpy(tables).to(dev)    # [P, R*4]
            self.generic_tables = None
        else:
            self.builtin_tables = None
            self.generic_tables = tuple(
                torch.from_numpy(t).to(dev)
                for t in colormap_kernel.generic_color_tables(res, self.schemes))
        # static_palette: one scheme's table (or its (u, v) factors), kept on
        # the host as numpy: the static colormap takes it by value
        self.static_table = None
        self.static_palette_id = None
        if static_palette is not None:
            pid = (static_palette if isinstance(static_palette, int)
                   else self.scheme_names.index(static_palette))
            if not 0 <= pid < len(self.schemes):
                raise ValueError(f"static_palette {static_palette!r} out of range")
            if res > colormap_kernel.MAX_STATIC_RES:
                raise ValueError(
                    f"static_palette takes at most "
                    f"{colormap_kernel.MAX_STATIC_RES} LUT entries (the static "
                    f"colormap receives its table as a kernel parameter); "
                    f"lut_resolution is {res}"
                )
            self.static_palette_id = int(pid)
            if tables is not None:
                self.static_table = tables[pid].copy()
            else:
                gu, gv = colormap_kernel.generic_color_tables(res, self.schemes)
                self.static_table = (gu[pid].copy(), gv[pid].copy())
        self.backgrounds = torch.from_numpy(
            stacked_backgrounds(self.schemes)).to(dev)                # [P, 3] u8
        self.hann = torch.from_numpy(
            stft_kernel.packed_hann(cfg.window_size)).to(dev)         # [W]
        self.hann_i16 = torch.from_numpy(
            stft_kernel.packed_hann_i16(cfg.window_size)).to(dev)     # [W]
        self.split_hann = torch.from_numpy(
            stft_kernel.split_hann(cfg.window_size)).to(dev)          # [W]
        self.fft_consts = stft_kernel.fft_constants(cfg.padded_size, dev)
        # the push reads [max(N/2, W)] planes (bin k at k); the ring holds
        # bins 1..W-1
        full = cmap_ops.resample_matrix_planes(cfg)                   # [H, W]
        self.taps = colormap_kernel.resample_taps(full, dev)          # [H] x 4
        self.ring_taps = colormap_kernel.resample_taps(
            cmap_ops.resample_matrix(cfg), dev)                       # [H] x 4
        # the bin band the JAX colormap's row block is sized for (its banded
        # plan, or the whole matrix where banding does not pay)
        segs = colormap_kernel.band_segments(full.T)
        self._cmap_band = (
            max(hi - lo for _, _, lo, hi in segs)
            if colormap_kernel._banded_worthwhile(segs, *full.T.shape)
            else full.shape[1]
        )
        self._time_taps = {}
        self._stft = stft_kernel.stft_mag_packed
        self._stft_allk = stft_kernel.stft_mag_packed_allk
        self._stft_split = stft_kernel.stft_mag_split
        self._stft_split_allk = stft_kernel.stft_mag_split_allk
        self._stft_split_t = stft_kernel.stft_mag_split_t
        self._stft_split_tsplit = stft_kernel.stft_mag_split_tsplit
        self._colormap = colormap_kernel.colormap_builtin
        self._colormap_bw = colormap_kernel.colormap_blockwise
        self._colormap_generic = colormap_kernel.colormap_generic
        self._colormap_static = colormap_kernel.colormap_static
        self._ring_write = ring_kernel.ring_write
        self._stft_plain = self.device.type == "cpu"
        if stft_backend == "xla":
            self._use_plain_stft()
        if colormap_backend == "xla":
            self._use_plain_colormap()
        self.launch = {}
        self.counters = collections.Counter()
        self.last_layout = None
        self.last_stft = None
        if self.autotune and self.device.type == "cuda":
            self.override_launch(self._tuned_launch())

    def _use_plain_stft(self) -> None:
        """Run the STFT as its plain PyTorch versions, on this device (they
        take no launch shape)."""
        sk = stft_kernel
        self._stft_plain = True
        self._stft = lambda left, right, hann, c, launch=None: (
            sk.stft_mag_packed_plain(left, right, hann, c.n_fft))
        self._stft_allk = lambda buf_l, buf_r, hann, c, k, hop, launch=None: (
            sk.stft_mag_packed_allk_plain(buf_l, buf_r, hann, c.n_fft, k, hop))
        self._stft_split = lambda left, right, hann, c, launch=None: (
            sk.stft_mag_split_plain(left, right, hann, c.n_fft))
        self._stft_split_allk = lambda buf_l, buf_r, hann, c, k, hop, launch=None: (
            sk.stft_mag_split_allk_plain(buf_l, buf_r, hann, c.n_fft, k, hop))
        self._stft_split_t = lambda x, hann, c, launch=None: (
            sk.stft_mag_split_t_plain(x, hann, c.n_fft))
        self._stft_split_tsplit = lambda carry, chunk, hann, c, launch=None: (
            sk.stft_mag_split_tsplit_plain(carry, chunk, hann, c.n_fft))

    def _use_plain_colormap(self) -> None:
        """Run the colormap as its plain PyTorch versions, on this device
        (they take no form)."""
        ck = colormap_kernel
        self._colormap = lambda *args, launch=None: ck.colormap_builtin_plain(*args)
        self._colormap_bw = lambda *args, block_rows, launch=None: (
            ck.colormap_blockwise_plain(*args))
        self._colormap_generic = lambda *args, launch=None: ck.colormap_generic_plain(*args)
        self._colormap_static = ck.colormap_static_plain

    def _use_plain_ring(self) -> None:
        """Write the ring with the plain PyTorch version, on this device."""
        self._ring_write = ring_kernel.ring_write_plain

    def with_plain_kernels(self) -> "SpectrogramPipeline":
        """This pipeline with the plain PyTorch versions in place of its
        kernels, on the same device: what the kernels are held against on
        the card."""
        twin = copy.copy(self)
        twin.counters = collections.Counter()
        twin._use_plain_stft()
        twin._use_plain_colormap()
        twin._use_plain_ring()
        return twin

    def _stft_layout(self, cfg: SpectrogramConfig, stft_backend: str, stft_packed,
                     stft_unpack_split, transposed_carry, framing: str) -> None:
        """The STFT backend and knobs, accepted and refused with the gates
        of the JAX pipeline (`spectrogram_tpu/models/spectrogram.py:148-346`):
        "mxu" and "pallas" need its usable plan (an even-n1 factorization
        and pad_factor >= 2); the layout knobs need its Pallas chain, which
        "auto" and "pallas" stand for here (a TPU's "auto")."""
        plan = fft_plan.make_plan(cfg) if stft_backend != "xla" else None
        usable = fft_plan.plan_usable(cfg, plan)
        if stft_backend in ("mxu", "pallas") and not usable:
            raise ValueError(
                f"stft_backend={stft_backend!r} needs an even-n1 MXU "
                f"factorization and pad_factor >= 2; geometry {cfg} has "
                f"plan={plan} pad_factor={cfg.pad_factor}. Use "
                "stft_backend='xla' or 'auto'."
            )
        self.fft_plan = plan if usable else None
        # JAX's fused Pallas chain, which "auto" and "pallas" stand for: the
        # knobs' gates read its plan only
        self.fused_chain = usable and stft_backend in ("auto", "pallas")
        plan = self.fft_plan if self.fused_chain else None
        lane_pad = plan is not None and fft_plan.lane_pad_default(plan)
        k = self.chunk_hops
        if stft_packed not in ("auto", True, False):
            raise ValueError(f"unknown stft_packed {stft_packed!r}")
        if (stft_packed != "auto" and bool(stft_packed)
                and not (plan is not None and fft_plan.packed_supported(plan, lane_pad))):
            raise ValueError(
                f"stft_packed=True requires a plan the TPU's packed kernel "
                f"takes (cfg {cfg}, plan={plan})"
            )
        # "auto": packed wherever the kernels take N (the TPU's gate was its
        # flat-2D orientation, which the port's packed kernel does not need)
        self.stft_packed = True if stft_packed == "auto" else bool(stft_packed)
        if stft_unpack_split not in ("auto", 0, 2, 3):
            raise ValueError(f"unknown stft_unpack_split {stft_unpack_split!r}")
        self.stft_unpack_split = ((3 if self.stft_packed else 0)
                                  if stft_unpack_split == "auto"
                                  else int(stft_unpack_split))
        if self.stft_unpack_split and not self.stft_packed:
            raise ValueError("stft_unpack_split requires the packed STFT formulation")
        self.carry_transposed = bool(transposed_carry) and (
            plan is not None
            and not lane_pad
            and fft_plan.carry_transposed_supported(cfg, plan)
            and not (k > 1 and fft_plan.buf_framing_supported(cfg, k, plan))
        )
        if transposed_carry and not self.carry_transposed:
            raise ValueError(
                f"transposed_carry requires hop % n1 == 0 on the TPU plan, no "
                f"lane padding, and at k > 1 a hop the DMA-offset framing does "
                f"not take (cfg {cfg}, plan {plan}, chunk_hops={k})"
            )
        if framing not in ("auto", "allk", "planes", "tsplit"):
            raise ValueError(f"unknown framing {framing!r}")
        self.framing = framing
        allk_ok = (plan is not None and not self.carry_transposed
                   and fft_plan.split_framing_supported(cfg, k, plan))
        if framing == "allk" and not allk_ok:
            raise ValueError(
                f"framing='allk' requires hop % n1 == 0 on the TPU plan "
                f"(cfg {cfg}, plan {plan})"
            )
        tsplit_ok = (plan is not None and not self.carry_transposed and k == 1
                     and fft_plan.tsplit_supported(cfg, k, plan, lane_pad=lane_pad))
        self.tsplit_framing = tsplit_ok and framing == "tsplit"
        if framing == "tsplit" and not tsplit_ok:
            raise ValueError(
                f"framing='tsplit' requires chunk_hops=1, hop % n1 == 0 and a "
                f"flip-capable TPU plan (cfg {cfg}, plan {plan})"
            )
        self._validate_i16_planes()

    def _validate_i16_planes(self) -> None:
        if self.i16_planes and (not self.stft_packed or self.carry_is_transposed):
            raise ValueError(
                "i16_planes requires the packed STFT on the planar carry "
                f"(stft_packed={self.stft_packed}, transposed_carry="
                f"{self.carry_transposed}, framing={self.framing!r}): there is "
                "no int16 split-real kernel"
            )

    def override_plan(self, plan, block_rows: Optional[int] = None) -> None:
        """The JAX pipeline's autotuner hook (`override_plan`): swap the FFT
        plan and recompute every decision derived from it, as JAX does: the
        lane-padded layout, `stft_packed` and `stft_unpack_split` from their
        arguments, the transposed carry and the tsplit framing (each kept
        only where the new plan still takes it), then revalidate
        `i16_planes`, which raises ValueError where the new layout has no
        int16 kernel.  The port's kernels need no plan and no row blocks:
        `plan` defines the transposed carry's n1 and the knobs' gates, and
        `block_rows` is kept as `stft_block_rows` for parity."""
        self.fft_plan = plan
        self.stft_block_rows = block_rows
        cfg, k = self.cfg, self.chunk_hops
        lane_pad = self.fused_chain and plan is not None and fft_plan.lane_pad_default(plan)
        arg = self._stft_packed_arg
        self.stft_packed = True if arg == "auto" else bool(arg)
        arg = self._stft_unpack_split_arg
        self.stft_unpack_split = ((3 if self.stft_packed else 0) if arg == "auto"
                                  else int(arg))
        self.carry_transposed = self.carry_transposed and (
            not lane_pad and fft_plan.carry_transposed_supported(cfg, plan))
        self.tsplit_framing = self.tsplit_framing and fft_plan.tsplit_supported(
            cfg, k, plan, lane_pad=lane_pad)
        self._validate_i16_planes()

    def launch_families(self) -> dict:
        """The launch families this pipeline's push runs, each with the
        shapes its kernels take here: the STFT rows' launch bounds
        ("packed" or "split", `stft_kernel.launch_candidates`; none on the
        large-N route) and the colormap tile's form at the push's taps
        ("tile", `colormap_kernel.tile_forms`; none for a static palette).
        The plain versions ("xla" backends) take none.  {family: choices}."""
        families = {}
        n = self.cfg.padded_size
        if self.stft_backend != "xla":
            family = "split" if self.split_real else "packed"
            choices = stft_kernel.launch_candidates(family, n)
            if choices:
                families[family] = choices
        if self.colormap_backend != "xla" and self.static_table is None:
            families["tile"] = colormap_kernel.tile_forms(*self._tile_args(self.taps))
        return families

    def launch_rules(self) -> dict:
        """{family: the shape the C tables' rule takes} for each family of
        `launch_families`: what a launch without a choice runs."""
        rules = {}
        for family in self.launch_families():
            if family == "tile":
                rules[family] = colormap_kernel.tile_rule(*self._tile_args(self.taps))
            else:
                rules[family] = stft_kernel.launch_rule(family, self.cfg.padded_size)
        return rules

    def _tile_args(self, taps) -> tuple:
        """(span, width, LUT entries, generic): what the tile's form
        depends on at `taps`."""
        generic = self.builtin_tables is None
        tables = self.generic_tables[0] if generic else self.builtin_tables
        return taps.span, taps.j0.shape[0], tables.shape[1] // 4, generic

    def override_launch(self, launch: Optional[dict]) -> None:
        """The port's autotuner hook, beside `override_plan`: launch every
        kernel of family f with the shape `launch[f]` names (a value of
        `launch_families()[f]`); a family left out takes the C tables'
        rule.  None or {} restores the tables everywhere.  The rows are the
        same bits whatever the shapes.  Raises ValueError for a family this
        pipeline's push does not run or a shape its kernels do not take.
        render_viewport's tile launches take the tile's form where it runs
        at the ring's taps, else the rule."""
        launch = dict(launch or {})
        families = self.launch_families()
        for family, choice in launch.items():
            if family not in families or choice not in families[family]:
                raise ValueError(
                    f"launch {family}={choice!r} is not one this pipeline's push "
                    f"takes ({families})")
        self.launch = launch

    def _tuned_launch(self) -> dict:
        """`utils.autotune.tune`'s pick for this pipeline: its geometry and
        the constructor arguments that change what its push launches."""
        from spectrogram_tpu_torch.utils import autotune

        return autotune.tune(self.cfg, pipeline_kwargs=self.tune_kwargs(),
                             device=self.device)

    def tune_kwargs(self) -> dict:
        """The constructor arguments that change which kernels this
        pipeline's push launches, or around them how much work it does: the
        deployment the tuner measures and keys its cache on (JAX passes its
        first four)."""
        return dict(
            chunk_hops=self.chunk_hops, store_ring=self.store_ring,
            packed_output=self.packed_output, precision_profile=self.precision_profile,
            viewport_rows=self.viewport_rows, ring_dtype=self.ring_dtype,
            lut_resolution=self._lut_resolution, stft_backend=self.stft_backend,
            colormap_backend=self.colormap_backend, schemes=self.schemes,
            static_palette=self.static_palette_id,
            blockwise_palettes=self.blockwise_palettes, stream_blocks=self.stream_blocks,
            palette_sort=self.palette_sort, sorted_output=self.sorted_output,
            presorted_input=self.presorted_input, i16_planes=self.i16_planes,
            transposed_carry=self.carry_transposed, framing=self.framing,
            stft_packed=self._stft_packed_arg, sanitize_input=self.sanitize_input,
        )

    def _tile_launch(self, taps):
        """The tile form the launches at `taps` take: the pipeline's where
        it runs there, else None (the rule)."""
        form = self.launch.get("tile")
        if form is None or form not in colormap_kernel.tile_forms(*self._tile_args(taps)):
            return None
        return form

    @property
    def carry_is_transposed(self) -> bool:
        """True when the state's carry is [S, 2, n1, C/n1]: transposed_carry
        or the tsplit framing."""
        return self.carry_transposed or self.tsplit_framing

    @property
    def split_real(self) -> bool:
        """True when pushes (and so `process()`) take the split-real STFT."""
        return not self.stft_packed or self.carry_is_transposed

    # ------------------------------------------------------------------ state

    def init_state(self, n_streams: int, palette_id: int = 1) -> StreamState:
        """Fresh state for S streams.  Default palette 1 = Magma, the
        reference widget's default (gpu_spectrogram.rs:88); a static_palette
        pipeline pins its own.  Under blockwise_palettes="auto" the
        one-palette layout of built-in tables is marked."""
        if self.static_palette_id is not None:
            palette_id = self.static_palette_id    # pinned by construction
        self._check_ids(np.asarray(palette_id))
        dev = self.device
        pid = torch.full((n_streams,), int(palette_id), dtype=torch.int32, device=dev)
        ring_rows = self.viewport_rows if self.store_ring else 0
        tables = self.state_tables_for(pid)
        if self.blockwise_palettes == "auto" and len(tables) == 1 and n_streams:
            tables += (self._bw_marker(),)     # one palette: every block uniform
        if self.carry_is_transposed:
            n1 = self.fft_plan.n1
            carry_shape = (n_streams, 2, n1, self.carry_size // n1)
        else:
            carry_shape = (n_streams, 2, self.carry_size)
        return StreamState(
            carry=torch.zeros(carry_shape, dtype=self.carry_dtype, device=dev),
            ring=torch.zeros((n_streams, ring_rows, 2, self.cfg.num_bins),
                             dtype=self.ring_dtype, device=dev),
            cursor=torch.zeros((), dtype=torch.int32, device=dev),
            palette_id=pid,
            row_count=torch.zeros((), dtype=torch.int32, device=dev),
            tables=tables,
        )

    def set_palette(self, state: StreamState, palette_id) -> StreamState:
        """Runtime palette switch, per stream ([S] ids) or for all streams
        (a scalar id): a state update that re-picks the kernel tables, so a
        push never touches the registry.  A scalar id stores one [1, R*4]
        table (or one (u, v) pair) that every row reads.  Per-stream ids on
        built-in tables are sorted (palette_sort) or marked (blockwise
        "auto") where that pays, and in carry-sort mode the carry follows the
        new stream order.  A static_palette pipeline raises ValueError."""
        if self.static_table is not None:
            raise ValueError(
                "this pipeline bakes static_palette="
                f"{self.scheme_names[self.static_palette_id]!r} into its "
                "kernels; runtime switching needs a pipeline without "
                "static_palette (or a new pipeline per palette)"
            )
        if isinstance(palette_id, torch.Tensor):
            ids = palette_id.detach().cpu().numpy()
        else:
            ids = np.asarray(palette_id)
        self._check_ids(ids)
        s = state.palette_id.shape[0]
        layout = np.broadcast_to(ids.astype(np.int32), (s,)).copy()
        pid = torch.from_numpy(layout).to(self.device)
        tables = self.state_tables_for(pid[:1] if ids.ndim == 0 else pid)
        if ids.ndim:
            tables = self._layout_tables(tables, layout)
        return state._replace(palette_id=pid, tables=tables,
                              carry=self._resorted_carry(state, tables))

    def _layout_tables(self, tables: tuple, layout: np.ndarray) -> tuple:
        """The layout class of per-stream ids `layout`: per-stream built-in
        tables get the blockwise marker (already clustered, "auto") or the
        palette sort where it pays; a generic (u, v) pair is neither marked
        nor sorted, as in JAX."""
        if len(tables) != 1:
            self.counters["layout.generic" if tables else "layout.unsorted"] += 1
            return tables
        if self._blockwise_auto_decision(layout):
            # already clustered: the marker, and no sort
            self.counters["layout.clustered"] += 1
            if self.blockwise_palettes == "auto":
                return tables + (self._bw_marker(),)
            return tables
        sorted_tables = self._sorted_tables(tables, layout) if self.palette_sort else None
        if sorted_tables is None:
            self.counters["layout.unsorted"] += 1
            return tables
        return sorted_tables

    def restored_tables_for(self, palette_id) -> tuple:
        """`state_tables_for` the [S] ids with the layout class `set_palette`
        gives them (the blockwise marker, or the palette-sorted tuple),
        re-derived from the concrete ids: for a state restored from a
        checkpoint, so that it keeps its kernel class (the JAX pipeline's
        `restored_tables_for`)."""
        if isinstance(palette_id, torch.Tensor):
            palette_id = palette_id.detach().cpu().numpy()
        layout = np.asarray(palette_id, np.int32).reshape(-1)
        self._check_ids(layout)
        tables = self.state_tables_for(self._device_index(layout))
        return self._layout_tables(tables, layout)

    def _check_ids(self, ids: np.ndarray) -> None:
        if ids.size and (ids.min() < 0 or ids.max() >= len(self.schemes)):
            raise ValueError(
                f"palette_id out of range 0..{len(self.schemes) - 1}: {ids!r}"
            )

    def state_tables_for(self, palette_id: torch.Tensor) -> tuple:
        """The kernel-table tuple for [S] (or [1]) palette ids: () for a
        static_palette pipeline, ([S, R*4],) for built-in tables, (u, v)
        for a generic registry."""
        if self.static_table is not None:
            return ()
        idx = palette_id.to(torch.int64)
        registry = ((self.builtin_tables,) if self.builtin_tables is not None
                    else self.generic_tables)
        return tuple(t.index_select(0, idx).contiguous() for t in registry)

    @staticmethod
    def _colormap_tables(tables: tuple) -> tuple:
        """A state's colormap operands: its 2-D tables (a sorted tuple's
        t_sorted; perm, inv and the marker are 1-D)."""
        return tuple(t for t in tables if t.ndim == 2)

    # --------------------------------------------------------- blockwise auto

    def _bw_marker(self) -> torch.Tensor:
        """The zero-size 1-D int32 tensor that marks a state for the
        blockwise colormap (real tables are 2-D, so it is unambiguous)."""
        return torch.zeros((0,), dtype=torch.int32, device=self.device)

    def _cmap_ts(self, n_rows: int) -> int:
        """The JAX colormap's row-block size for n_rows rows (its
        `_auto_blocks` over the band, with the n % block fallback): the
        granularity at which palette uniformity is counted, and the rows a
        blockwise CTA covers."""
        block_rows, _ = colormap_kernel._auto_blocks(self._cmap_band, None, None)
        return min(block_rows, n_rows) if n_rows % block_rows else block_rows

    # Blockwise economics threshold: engage when at least this fraction of
    # the colormap's row blocks are single-palette (the JAX package's value).
    _BW_AUTO_FRAC = 0.5

    def _blockwise_auto_decision(self, ids: np.ndarray) -> bool:
        """True when >= `_BW_AUTO_FRAC` of the row blocks of this per-stream
        palette layout are single-palette."""
        s = int(ids.shape[0])
        ts = self._cmap_ts(s * self.chunk_hops)
        nb = s // ts
        self.counters["layout.tests"] += 1
        if nb == 0:
            self.last_layout = {"blocks": 0, "uniform": 0}
            return bool(ids.size) and bool((ids == ids.flat[0]).all())
        head = ids[: nb * ts].reshape(nb, ts)
        uniform = (head == head[:, :1]).all(axis=1)
        self.last_layout = {"blocks": nb, "uniform": int(uniform.sum())}
        return float(uniform.mean()) >= self._BW_AUTO_FRAC

    def _state_blockwise(self, state: StreamState) -> bool:
        """Whether this state's pushes take the blockwise colormap: forced
        on, palette-sorted (the sort exists to feed it), or marked."""
        if self.blockwise_palettes is True or self._state_perm(state) is not None:
            return True
        return (self.blockwise_palettes == "auto" and bool(state.tables)
                and _is_marker(state.tables[-1]))

    # ----------------------------------------------------------- palette sort

    def _sorted_tables(self, tables: tuple, layout: np.ndarray):
        """Stable argsort within each sort block (the stream blocks of
        `stream_blocks`): (t_sorted, perm, inv) with block-relative perm and
        inv.  Where that sorted layout fails the blockwise test, the global
        sort (`_global_sorted_tables`), or None."""
        s = int(layout.shape[0])
        bs = self._push_block_streams(s) or s
        perm = np.empty(s, np.int32)
        inv = np.empty(s, np.int32)
        sorted_layout = np.empty_like(layout)
        for b0 in range(0, s, bs):
            b1 = min(b0 + bs, s)
            p = np.argsort(layout[b0:b1], kind="stable").astype(np.int32)
            perm[b0:b1] = p
            inv[b0:b1][p] = np.arange(b1 - b0, dtype=np.int32)
            sorted_layout[b0:b1] = layout[b0:b1][p]
        if not self._blockwise_auto_decision(sorted_layout):
            return self._global_sorted_tables(tables, layout, bs)
        self.counters["layout.sorted_blocks"] += 1
        gp = perm + (np.arange(s, dtype=np.int32) // bs) * bs
        return (tables[0].index_select(0, self._device_index(gp)),
                self._device_index(perm), self._device_index(inv))

    def _global_sorted_tables(self, tables: tuple, layout: np.ndarray, bs: int):
        """One whole-state stable argsort, (t_sorted, perm, inv, marker)
        with global perm and inv, where the sort blocks are smaller than the
        state (so the block sort was tried), in carry-sort mode, and the
        sorted layout passes the blockwise test; else None."""
        s = int(layout.shape[0])
        if (bs >= s or not self.carry_sort_mode
                or self.blockwise_palettes not in ("auto", True)):
            return None
        return self._view_sorted_tables(tables, layout, s)

    def _view_sorted_tables(self, tables: tuple, layout: np.ndarray, view_bs: int):
        """The length-4 sorted tuple with view blocks of `view_bs` streams:
        one stable argsort per view block, perm and inv holding global
        stream indices confined to their block (the JAX pipeline's
        `_view_sorted_tables`).  view_bs = S is the whole-state global sort;
        view_bs = S / ranks the per-shard sort of `parallel.mesh`, whose
        rank-local slices subtract their offset.  None where the
        view-sorted layout fails the blockwise test."""
        s = int(layout.shape[0])
        perm = np.empty(s, np.int32)
        inv = np.empty(s, np.int32)
        for b0 in range(0, s, view_bs):
            b1 = min(b0 + view_bs, s)
            p = b0 + np.argsort(layout[b0:b1], kind="stable").astype(np.int32)
            perm[b0:b1] = p
            inv[p] = np.arange(b0, b1, dtype=np.int32)
        if not self._blockwise_auto_decision(layout[perm]):
            return None
        self.counters["layout.sorted_global"] += 1
        return (tables[0].index_select(0, self._device_index(perm)),
                self._device_index(perm), self._device_index(inv),
                self._bw_marker())

    def _palette_sort_eligible(self, tables: tuple) -> bool:
        """Whether the palette sort may take a state with these tables: the
        built-in registry's per-stream 1-tuple, with palette_sort on."""
        return (self.palette_sort and self.static_table is None
                and self.builtin_tables is not None and len(tables) == 1)

    def _device_index(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(self.device)

    @staticmethod
    def _tables_perm(t: tuple):
        """(perm, inv) of a palette-sorted tables tuple, else None: only
        sorted tuples have length 3, or 4 with a trailing marker."""
        if (len(t) in (3, 4) and t[1].ndim == 1 and t[1].numel()
                and t[2].ndim == 1 and t[2].numel()
                and (len(t) == 3 or _is_marker(t[3]))):
            return t[1], t[2]
        return None

    @staticmethod
    def _tables_perm_global(t: tuple) -> bool:
        """True when a sorted tables tuple holds a global permutation (the
        length-4 form)."""
        return len(t) == 4 and SpectrogramPipeline._tables_perm(t) is not None

    def _state_perm(self, state: StreamState):
        return self._tables_perm(state.tables)

    _STREAM_BLOCK_AUTO_MIN = 12288
    _STREAM_BLOCK_SIZE = 4096

    def _push_block_streams(self, s: int) -> int:
        """Sort-block size for S streams (0 = one block): "auto" gives
        4096-stream blocks from 12,288 streams in the k=1 streaming mode
        without a ring, as the JAX package's stream-blocked push does."""
        sb = self.stream_blocks
        if sb == "auto":
            if (self.chunk_hops == 1 and not self.store_ring
                    and s >= self._STREAM_BLOCK_AUTO_MIN):
                return self._STREAM_BLOCK_SIZE
            return 0
        return sb if 0 < sb < s else 0

    def _global_perm(self, perm: torch.Tensor, s: int,
                     glob: bool = False) -> torch.Tensor:
        """A block-relative perm (or inv) as global stream indices; a
        global one (`glob`, the length-4 form) as it is."""
        bs = self._push_block_streams(s) or s
        if glob or bs >= s:
            return perm
        off = torch.arange(s, dtype=torch.int32, device=perm.device) // bs * bs
        return off + perm

    def _global_perms(self, state: StreamState):
        """(perm, inv) of a sorted state as global stream indices, or None:
        sorted[i] = external[perm[i]], external[e] = sorted[inv[e]]."""
        pi = self._state_perm(state)
        if pi is None:
            return None
        s = state.palette_id.shape[0]
        glob = self._tables_perm_global(state.tables)
        return self._global_perm(pi[0], s, glob), self._global_perm(pi[1], s, glob)

    def _resorted_carry(self, prev_state: StreamState,
                        new_tables: tuple) -> torch.Tensor:
        """Carry-sort mode: the carry in the stream order of `new_tables`,
        from the order of the previous state's (back to external order when
        leaving the sorted class, into the new order when entering or
        changing it)."""
        carry = prev_state.carry
        if not self.carry_sort_mode:
            return carry
        old = self._global_perms(prev_state)
        if old is not None:
            carry = carry.index_select(0, old[1])
        new = self._global_perms(prev_state._replace(tables=new_tables))
        if new is not None:
            carry = carry.index_select(0, new[0])
        return carry

    @staticmethod
    def _row_perm(perm: torch.Tensor, s: int, k: int) -> torch.Tensor:
        """A [S] stream permutation extended to the window-major [k*S] rows
        (row r*S + s_)."""
        if k == 1:
            return perm
        off = torch.arange(k, dtype=torch.int32, device=perm.device)[:, None] * s
        return (off + perm[None, :]).reshape(-1)

    # ------------------------------------------------- host-side stream order

    def output_perm(self, state: StreamState):
        """For `sorted_output` pipelines: when not None,
        `rows[output_perm(state)[e]]` are external stream e's rows in the
        push output.  None when the state is unsorted (the output is then in
        external order) or the pipeline does not sort its output.  numpy."""
        if not self.sorted_output:
            return None
        perms = self._global_perms(state)
        return None if perms is None else perms[1].cpu().numpy()

    def input_perm(self, state: StreamState):
        """For `presorted_input` pipelines: when not None, row i of a pushed
        chunk must carry external stream input_perm(state)[i]'s samples.
        None when the state is unsorted (deliver external order).  Query it
        again after every set_palette: the order changes with the layout.
        numpy."""
        perms = self._global_perms(state)
        return None if perms is None else perms[0].cpu().numpy()

    def input_dest(self, state: StreamState):
        """The chunk row external stream e's samples go to,
        input_dest(state)[e]: the inverse of `input_perm`, uint64 for the
        drain layer's destination rows; None when the state is unsorted."""
        p = self.input_perm(state)
        return None if p is None else np.argsort(p).astype(np.uint64)

    def unsort_state(self, state: StreamState) -> StreamState:
        """`state` in external stream order with the palette sort dropped
        (the same state when unsorted): per-row tables, and in carry-sort
        mode the carry unpermuted."""
        perms = self._global_perms(state)
        if perms is None:
            return state
        inv = perms[1]
        carry = state.carry.index_select(0, inv) if self.carry_sort_mode else state.carry
        return state._replace(carry=carry,
                              tables=(state.tables[0].index_select(0, inv),))

    # ------------------------------------------------------------------- push

    def push(self, state: StreamState, chunk: torch.Tensor):
        """Advance all streams by k hops.  chunk: [S, k*hop, 2] f32 PCM, or
        int16 PCM words (scaled by 1/32768 on the device; with i16_planes
        kept int16, and then required).  Returns (new_state, rows): [S, k, H]
        int32 RGBA8888 when packed_output, else [S, k, H, 4] u8, in external
        stream order unless sorted_output (see output_perm).  With
        store_ring the push writes its rows into the ring in place: the ring
        tensor is shared by the old and new state."""
        if chunk.ndim != 3 or tuple(chunk.shape[1:]) != (self.chunk_size, 2):
            raise ValueError(
                f"chunk must be [S, {self.chunk_size}, 2]; got {tuple(chunk.shape)}"
            )
        with span("push"):
            return self._push_core(state, self._chunk_in(chunk).transpose(1, 2))

    def push_planar(self, state: StreamState, chunk_planar: torch.Tensor):
        """As push, with the chunk channels-planar: [S, 2, k*hop]."""
        if chunk_planar.ndim != 3 or tuple(chunk_planar.shape[1:]) != (2, self.chunk_size):
            raise ValueError(
                f"planar chunk must be [S, 2, {self.chunk_size}]; got "
                f"{tuple(chunk_planar.shape)}"
            )
        with span("push"):
            return self._push_core(state, self._chunk_in(chunk_planar))

    def _chunk_in(self, chunk: torch.Tensor) -> torch.Tensor:
        """Wire-dtype edge: i16_planes pipelines keep int16 words (and take
        nothing else: a silent cast would be lossy); others convert to f32,
        int16 words scaled by 1/32768 on the device (the JAX pipeline's
        `_chunk_f32`)."""
        with span("wire"):
            chunk = chunk.to(self.device)
            if self.i16_planes:
                if chunk.dtype != torch.int16:
                    raise ValueError(
                        "i16_planes pipelines require int16 chunks (the wire "
                        f"dtype); got {chunk.dtype}"
                    )
                return chunk
            if chunk.dtype == torch.int16:
                return chunk.to(torch.float32) * (1.0 / 32768.0)
            return chunk.to(torch.float32)

    def frame_buffers(self, state: StreamState, chunk_pl: torch.Tensor):
        """Split-channel framing of one push: (buf_l, buf_r, new_carry) with
        buf_l/buf_r the [S, C + k*hop] sample planes of carry + chunk (f32,
        or int16 with i16_planes) and new_carry their last C samples, built
        from the sources."""
        with span("frame"):
            return self._frame_buffers(state, chunk_pl)

    def _frame_buffers(self, state: StreamState, chunk_pl: torch.Tensor):
        c, t = self.carry_size, self.chunk_size
        buf_l = torch.cat([state.carry[:, 0, :], chunk_pl[:, 0, :]], dim=1)
        buf_r = torch.cat([state.carry[:, 1, :], chunk_pl[:, 1, :]], dim=1)
        if t >= c:
            new_carry = chunk_pl[:, :, t - c:].contiguous()
        else:
            new_carry = torch.cat([state.carry[:, :, t:], chunk_pl], dim=2)
        return buf_l, buf_r, new_carry

    def frame_windows(self, state: StreamState, chunk_pl: torch.Tensor):
        """k=1 framing: (left, right, new_carry) with left/right the [S, W]
        window planes."""
        with span("frame"):
            buf_l, buf_r, new_carry = self._frame_buffers(state, chunk_pl)
            w = self.cfg.window_size
            return buf_l[:, :w].contiguous(), buf_r[:, :w].contiguous(), new_carry

    def _chunk_transposed(self, chunk_pl: torch.Tensor) -> torch.Tensor:
        """[S, 2, T] -> [S, 2, n1, T/n1]: sample t*n1 + j1 at [j1, t]."""
        n1 = self.fft_plan.n1
        s = chunk_pl.shape[0]
        return chunk_pl.reshape(s, 2, self.chunk_size // n1, n1).transpose(2, 3)

    def frame_transposed(self, state: StreamState, chunk_pl: torch.Tensor):
        """Transposed-carry framing (the JAX `_push_fused_t` glue): (x,
        new_carry) with x the [k*S, 2, n1, m] windows, window-major, of the
        carry + transposed chunk, and new_carry its last C/n1 columns."""
        with span("frame"):
            n1, m = self.fft_plan.n1, self.fft_plan.m
            buf_t = torch.cat([state.carry, self._chunk_transposed(chunk_pl)], dim=3)
            cols = buf_t.shape[3]
            new_carry = buf_t[..., cols - self.carry_size // n1 :].contiguous()
            if self.chunk_hops == 1:
                return buf_t, new_carry                      # cols == m
            hop_m = self.cfg.hop_size // n1
            x = torch.cat([buf_t[..., r * hop_m : r * hop_m + m]
                           for r in range(self.chunk_hops)])
            return x, new_carry

    def _framed_stft(self, state: StreamState, chunk_pl: torch.Tensor):
        """Framing and the STFT of one push, by the pipeline's layout:
        (mag_l, mag_r, new_carry), the planes [k*S, N/2] window-major.

        The `spk.frame` spans hold the framing done on the device before the
        kernel, the `spk.stft` spans the STFT launches alone; in the tsplit
        and transposed-carry layouts the kernel reads the carry and the
        chunk (or the framed windows) itself, so `spk.stft` holds that part
        of the framing too."""
        k, tw = self.chunk_hops, self.fft_consts
        self._record_stft(chunk_pl.shape[0] * k)
        split = self.launch.get("split")
        if self.tsplit_framing:
            with span("frame"):
                chunk_t = self._chunk_transposed(chunk_pl).contiguous()
            with span("stft"):
                return self._stft_split_tsplit(state.carry, chunk_t, self.split_hann, tw,
                                               launch=split)
        if self.carry_transposed:
            x, new_carry = self.frame_transposed(state, chunk_pl)
            with span("stft"):
                return (*self._stft_split_t(x, self.split_hann, tw, launch=split), new_carry)
        if not self.stft_packed:
            hann, stft, stft_allk = self.split_hann, self._stft_split, self._stft_split_allk
            launch = split
        else:
            hann = self.hann_i16 if chunk_pl.dtype == torch.int16 else self.hann
            stft, stft_allk = self._stft, self._stft_allk
            launch = self.launch.get("packed")
        if k == 1:
            left, right, new_carry = self.frame_windows(state, chunk_pl)
            with span("stft"):
                return (*stft(left, right, hann, tw, launch=launch), new_carry)
        buf_l, buf_r, new_carry = self.frame_buffers(state, chunk_pl)
        with span("stft"):
            return (*stft_allk(buf_l, buf_r, hann, tw, k, self.cfg.hop_size, launch=launch),
                    new_carry)

    def _record_stft(self, rows: int) -> None:
        """Count and record the STFT route a push takes over its `rows`
        windows (`last_stft`): "plain" for the plain versions, else the
        label its launches count under (`stft_kernel.fft_route`, or
        `split_route` for the split-real layouts); on the large-N route the
        row groups and scratch of `stft_kernel.large_grouping`, the function
        the route's wrapper launches by."""
        n = self.fft_consts.n_fft
        split = self.tsplit_framing or self.carry_transposed or not self.stft_packed
        route = ("plain" if self._stft_plain
                 else (stft_kernel.split_route if split else stft_kernel.fft_route)(n))
        groups = scratch = 0
        if route == stft_kernel.LARGE:
            _, groups, scratch = stft_kernel.large_grouping(n, rows, split)
            self.counters["push.stft_large"] += 1
            self.counters["stft.large_groups"] += groups
        self.last_stft = {"route": route, "n_fft": n, "rows": rows, "groups": groups,
                          "scratch_bytes": scratch}

    def _push_core(self, state: StreamState, chunk_pl: torch.Tensor):
        if state.carry.dtype != self.carry_dtype:
            raise ValueError(
                f"the state's carry is {state.carry.dtype}; this pipeline "
                f"keeps {self.carry_dtype} (i16_planes={self.i16_planes})"
            )
        if state.carry.ndim != (4 if self.carry_is_transposed else 3):
            raise ValueError(
                f"the state's carry is {tuple(state.carry.shape)}; this "
                f"pipeline keeps a "
                + ("transposed [S, 2, n1, C/n1]" if self.carry_is_transposed
                   else "planar [S, 2, C]")
                + " carry (carry_is_transposed="
                f"{self.carry_is_transposed})"
            )
        if self.sanitize_input and chunk_pl.dtype == torch.float32:
            # int16 words cannot carry NaN or inf: nothing to scrub
            chunk_pl = torch.where(torch.isfinite(chunk_pl), chunk_pl, 0.0)
        s, k = chunk_pl.shape[0], self.chunk_hops
        with span("order.perms"):
            perms = self._global_perms(state)
        if perms is not None and self.carry_sort_mode and not self.presorted_input:
            # the carry is at rest in sorted order: bring the chunk into it
            self.counters["push.order_chunk"] += 1
            with span("order.chunk"):
                chunk_pl = chunk_pl.index_select(0, perms[0])
        mag_l, mag_r, new_carry = self._framed_stft(state, chunk_pl)
        cm_l, cm_r = mag_l, mag_r
        if perms is not None and not self.carry_sort_mode:
            # the mag-bridge: the planes come in external order (the ring
            # keeps it); the sorted tables want them sorted
            self.counters["push.bridge"] += 1
            with span("order.bridge"):
                rp = self._row_perm(perms[0], s, k)
                cm_l, cm_r = mag_l.index_select(0, rp), mag_r.index_select(0, rp)
        # window-major rows r*S + s take table (r*S + s) % S = s
        rows = self._run_colormap(cm_l, cm_r, self.taps,
                                  self._colormap_tables(state.tables),
                                  self._state_blockwise(state))
        if perms is not None and not self.sorted_output:
            self.counters["push.order_rows"] += 1
            with span("order.rows"):
                rows = rows.index_select(0, self._row_perm(perms[1], s, k))
        if self.store_ring:
            self.counters["push.ring"] += 1
            self._write_ring(state, mag_l, mag_r)
        with span("state"):
            new_state = StreamState(
                carry=new_carry,
                ring=state.ring,
                cursor=(state.cursor + k) % self.viewport_rows,
                palette_id=state.palette_id,
                row_count=state.row_count + k,
                tables=state.tables,
            )
            return new_state, self._output(rows.view(k, s, -1).transpose(0, 1))

    def _run_colormap(self, mag_l: torch.Tensor, mag_r: torch.Tensor, taps,
                      tables: tuple, blockwise: bool,
                      rows_per_table: int = 1) -> torch.Tensor:
        """The colormap the tables pick: the static colormap for a
        static_palette pipeline, the generic one for a (u, v) pair, else the
        blockwise colormap for a blockwise state with per-row tables and
        kernel B otherwise (one table is uniform everywhere)."""
        with span("colormap"):
            cfg = self.cfg
            if self.static_table is not None:
                return self._colormap_static(mag_l, mag_r, taps, self.static_table, cfg)
            form = self._tile_launch(taps)
            if len(tables) == 2:
                return self._colormap_generic(mag_l, mag_r, taps, *tables, cfg,
                                              rows_per_table, launch=form)
            (t,) = tables
            if blockwise and t.shape[0] > 1:
                return self._colormap_bw(mag_l, mag_r, taps, t, cfg, rows_per_table,
                                         block_rows=self._cmap_ts(mag_l.shape[0]),
                                         launch=form)
            return self._colormap(mag_l, mag_r, taps, t, cfg, rows_per_table, launch=form)

    def _write_ring(self, state: StreamState, mag_l: torch.Tensor,
                    mag_r: torch.Tensor) -> None:
        """Bins 1..W-1 of the [k*S, N/2] window-major planes, rounded to the
        ring dtype (to nearest even, as JAX's astype), into ring rows cursor
        .. cursor+k-1 of every stream, in place: the ring is the largest
        tensor of the state, and a copy per push would double it."""
        r, _, b = state.ring.shape[1:]
        if r != self.viewport_rows:
            raise ValueError(
                f"the state's ring has {r} rows; this pipeline keeps "
                f"{self.viewport_rows} (store_ring={self.store_ring})"
            )
        if b != self.cfg.num_bins:
            raise ValueError(
                f"the state's ring has {b} bins; this pipeline keeps {self.cfg.num_bins}")
        with span("ring"):
            self._ring_write(state.ring, state.cursor, mag_l, mag_r, self.chunk_hops)

    def _output(self, packed: torch.Tensor) -> torch.Tensor:
        if self.packed_output:
            return packed
        return colormap_kernel.unpack_rgba_device(packed)

    # ----------------------------------------------------------------- render

    def render_viewport(self, state: StreamState, width: Optional[int] = None):
        """Full scrolling viewport per stream, oldest row first: [S, R', H, 4]
        u8 RGBA, or [S, R', H] int32 RGBA8888 when packed_output, with R' =
        width or viewport_rows — the batch analog of the fragment shader's
        `(uv.x * rows + offset) / rows` time wrap (gpu_spectrogram.rs:166-171).

        `width` renders the viewport at any time-axis size, as the GL
        widget's Linear sampler does (gpu_spectrogram.rs:166-174, :285): a
        two-tap interpolation over the row axis, in magnitude space before
        the colormap, with clamped edges (DESIGN.md D2).  Reads the bf16
        ring, so output precision matches the texture path, not the f32
        streaming path.  Works through blocks of streams to bound memory;
        the output is the same.  The ring is in external stream order, so a
        sorted state's viewport re-picks per-row tables from its ids."""
        if not self.store_ring:
            raise ValueError("this pipeline keeps no ring (store_ring=False)")
        with span("render"):
            ring = state.ring
            if self._state_perm(state) is not None:
                tables = self.state_tables_for(state.palette_id)
                blockwise = self.blockwise_palettes is True
            else:
                tables = self._colormap_tables(state.tables)
                blockwise = self._state_blockwise(state)
            s, r, _, b = ring.shape
            out_rows = r if width is None else int(width)
            j0, j1, w0, w1 = self._time_resample_taps(r, out_rows)
            cursor = state.cursor.to(torch.int64)
            i0, i1 = (cursor + j0) % r, (cursor + j1) % r
            block = max(1, RENDER_BLOCK_BYTES // (out_rows * 2 * b * 4))
            out = []
            for s0 in range(0, s, block):
                rows = ring[s0 : s0 + block]
                planes = []
                for c in range(2):
                    x = rows[:, :, c].index_select(1, i0).to(torch.float32)
                    if out_rows != r:
                        y = rows[:, :, c].index_select(1, i1).to(torch.float32)
                        x = w0 * x + w1 * y
                    planes.append(x.reshape(-1, b))
                tab = tuple(t if t.shape[0] == 1 else t[s0 : s0 + block] for t in tables)
                packed = self._run_colormap(planes[0], planes[1], self.ring_taps, tab,
                                            blockwise, rows_per_table=out_rows)
                out.append(packed.view(-1, out_rows, packed.shape[1]))
            return self._output(torch.cat(out))

    def _time_resample_taps(self, rows: int, width: int):
        """(j0, j1, w0, w1): column j of the [rows, width] time-resample
        matrix reads w0[j] * row j0[j] + w1[j] * row j1[j] of the
        chronological ring; weights shaped [width, 1] to broadcast over
        bins."""
        if (rows, width) not in self._time_taps:
            m = cmap_ops.time_resample_matrix(rows, width)
            taps = colormap_kernel.resample_taps(m.T, self.device)
            self._time_taps[rows, width] = (taps.j0.long(), taps.j1.long(),
                                            taps.w0[:, None], taps.w1[:, None])
        return self._time_taps[rows, width]

    def composite(self, rgba_u8: torch.Tensor, palette_id) -> torch.Tensor:
        """Blend [S, ..., 4] u8 RGBA rows over each stream's palette
        background (frame clear + alpha blend, gpu_spectrogram.rs:278-293):
        [S, ..., 3] u8, on the pipeline's device (host rows, such as the
        blocks `StreamGroupManager.tick` returns, are moved there)."""
        ids = torch.as_tensor(palette_id, device=self.device).to(torch.int64)
        bg = self.backgrounds.index_select(0, ids.reshape(-1))     # [S, 3] u8
        rgba = torch.as_tensor(rgba_u8).to(device=self.device, dtype=torch.float32) / 255.0
        shape = (rgba.shape[0],) + (1,) * (rgba.ndim - 2) + (3,)
        return cmap_ops.composite_over_background(rgba, bg.reshape(shape))

    # ------------------------------------------------------------ one-shot API

    def process(self, pcm: torch.Tensor, palette_id: Optional[int] = None) -> torch.Tensor:
        """Non-streaming form: [S, T, 2] (or [T, 2]) PCM -> rows for all
        complete windows, [S, rows, H] int32 (or [S, rows, H, 4] u8), every
        stream on one palette: `palette_id`, by default the pinned
        static_palette where there is one, else 1 (Magma).  A static_palette
        pipeline colors with its static table whatever the id.  Kernel A
        (the split-real plane kernel where the push is split-real) on the
        framed windows, then the colormap the push takes, so pushing the
        same samples in chunks gives the same rows exactly."""
        if palette_id is None:
            palette_id = (self.static_palette_id
                          if self.static_palette_id is not None else 1)
        self._check_ids(np.asarray(palette_id))
        squeeze = pcm.ndim == 2
        if squeeze:
            pcm = pcm[None]
        pcm = pcm.to(device=self.device, dtype=torch.float32)
        if self.sanitize_input:
            # the push's ingestion-edge guard, so that process() keeps
            # matching push()
            pcm = torch.where(torch.isfinite(pcm), pcm, 0.0)
        frames = stft_ops.frame_signal(pcm, self.cfg)      # [S, n, W, 2]
        s, n, w = frames.shape[:3]
        left = frames[..., 0].reshape(s * n, w).contiguous()
        right = frames[..., 1].reshape(s * n, w).contiguous()
        pid = torch.tensor([palette_id], dtype=torch.int32, device=self.device)
        if self.split_real:
            mag_l, mag_r = self._stft_split(left, right, self.split_hann, self.fft_consts,
                                            launch=self.launch.get("split"))
        else:
            mag_l, mag_r = self._stft(left, right, self.hann, self.fft_consts,
                                      launch=self.launch.get("packed"))
        rows = self._run_colormap(mag_l, mag_r, self.taps,
                                  self.state_tables_for(pid), blockwise=False)
        out = self._output(rows.reshape(s, n, -1))
        return out[0] if squeeze else out
