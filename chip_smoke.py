"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA card, `nvcc`, `g++`
(the host rings of phases 26-28) and `nvidia-smi`; it imports
`spectrogram_tpu_torch`, torch, numpy and (phase 27's PNG check) PIL only.
Phases, each of which fails the run with a non-zero exit:

  1. the card: torch sees it; nvidia-smi's name and power limit.
  2. build: csrc/*.cu -> build/kernels/libspectrogram_kernels.so (sm_90a).
  3. kernel A (packed STFT) against its plain version, 4096 rows of
     chirp+tone and of noise at BENCH_CONFIG: atol 3e-5 / rtol 1e-4.
  4. kernel B (built-in colormap) against its plain version on those planes
     with scattered per-row palettes: at most 1 u8 per channel.
  5. the k=1 main path: SpectrogramPipeline(BENCH_CONFIG, chunk_hops=1,
     store_ring=False, packed_output=True, device="cuda"), 4096 streams,
     palettes arange(S) % 19 (which the palette sort declines), 4 pushes of
     chirp+tone.  Both kernels' launch counts must rise; the rows must equal
     process() on the same PCM exactly, and the same push on the plain
     versions within 1 u8 on what the image shows; the next carry exactly.
  6. timing with CUDA events after a warm-up: ms/push and rows/s for the
     kernel path and the plain path, and each kernel against its plain
     version (both kernels in device time, `device_ms`); beside each
     colormap bound its sector floor (`sector_floor`: the bytes counted in
     the 32-byte sectors device memory moves).
  7. the mixed-radix kernel A at DEFAULT_CONFIG (N=4800) against its plain
     version, 4096 rows of chirp+tone and of noise, phase 3's bar; and
     torch.fft.fft on [4096, N] complex64 at N=4096 and N=4800, the library
     call beside kernel A.
  8. the all-windows STFT kernel against its plain version, k=8 at 4096
     streams, BENCH_CONFIG (buffers [4096, 7648]) and DEFAULT_CONFIG, phase
     3's bar.
  9. the display path, at BENCH_CONFIG and at DEFAULT_CONFIG:
     SpectrogramPipeline(cfg, chunk_hops=8, packed_output=True,
     device="cuda") with its ring (R=2048), 256 streams, palettes
     arange(S) % 19, 260 pushes of
     chirp+tone (the ring wraps), process() of the same PCM, and
     render_viewport at R and at width 800.  The launch counts of the
     all-windows kernel, kernel A (process) and kernel B must rise, the
     ring write's by one a push; the streamed rows must equal process() exactly; rows, ring and next carry
     must match the same pushes on the plain versions (1 u8 over what the
     image shows, 1 bf16 ulp beyond the STFT bar, exactly); both renders
     within 1 u8 of the plain render of the same state.
 10. timing with CUDA events after a warm-up: the k=8 push at BENCH_CONFIG,
     4096 streams, no ring; the display push and render_viewport at 256
     streams; each new kernel against its plain version (the all-windows
     kernel and torch.fft.fft beside it in device time), and torch.fft.fft
     on the all-windows rows at DEFAULT_CONFIG; peak device memory.
 11. the serving mode's kernels: the blockwise colormap at 10,240 rows of
     BENCH_CONFIG, on sorted tables (uniform blocks) and scattered ones
     (mixed blocks), in kernel B's staged form (the row tile), and at 4,096
     rows of N=16,384 on sorted tables in kernel B's direct form (span
     7,497), bit for bit kernel B and within 1 u8 of its plain version; the
     int16 forms of kernel A (N=4096, N=4800) and of the
     all-windows kernel (k=8, 4096 streams) on chirp+tone PCM words, bit for
     bit the f32 kernels on x/32768 and within phase 3's bar of plain.
 12. the multi-tenant serving path, SpectrogramPipeline(BENCH_CONFIG,
     chunk_hops=1, store_ring=False, packed_output=True), palettes
     arange(S) % 19, 3 pushes, at 10,240 streams (the block-relative sort)
     and 16,384 (the global sort over 4096-stream sort blocks): the sorted
     push with the defaults, then the full serving mode (i16_planes,
     presorted_input, sorted_output) with int16 chunks in input_perm order.
     The blockwise and int16 kernels' launch counts must rise; sorted rows
     must equal per-row rows (palette_sort=False) exactly and the plain
     kernels' within 1 u8; rows[output_perm] of the full serving mode must
     equal the f32 sorted rows exactly; carry[inv] the per-row carry.  Then
     int16 planes through the other STFT kernels: DEFAULT_CONFIG at k=1 and
     BENCH_CONFIG at k=8, 4096 streams, bit for bit the f32 pipeline.
 13. timing with CUDA events after a warm-up: ms/push and rows/s of the
     per-row, sorted and full-serving pipelines at both populations (in
     turns: a b c c b a); each new kernel against its plain version, the f32
     kernel beside each int16 one, kernel B beside the blockwise one, and
     the blockwise kernel at 32, 64 and 128 rows per block and in its direct
     form at N=16,384 (every kernel in device time); peak device memory.
 14. the palette kernels, on 4096 rows of BENCH_CONFIG planes of chirp+tone
     and of noise (H=1024), each within 1 u8 of its plain version over what
     the image shows (noise: every channel everywhere): the generic colormap
     over the registry (smoke-custom, a FactoredScheme outside the built-in
     structure, + 3 built-ins) with per-row tables arange(S) % 4 and with one
     table; the static colormap on Magma, on "Blue-Yellow-Red (Stereo)" and
     on smoke-custom.  Bit for bit: static built-in == kernel B with that
     one table, static generic == the generic kernel with one table.
 15. the palette paths, through SpectrogramPipeline: static_palette="Magma"
     at k=1, 4096 streams, no ring (the JAX bench's BENCH_STATIC_PALETTE
     mode); the stereo static palette at k=8, 256 streams, no ring (the JAX
     smoke's class_static); the generic registry at k=1, 4096 streams, ids
     arange(S) % 4 and then a scalar set_palette; the generic registry at
     k=8 with the ring (R=2048), 256 streams, 260 pushes, render_viewport at
     R and at 800.  Each passes when the new kernel's launch count rises
     (and the blockwise kernel's does not), streamed rows equal process()
     exactly, and rows, carry and renders match the same calls on the plain
     versions (phase 14's bar; carry exactly); set_palette on a static
     pipeline raises ValueError.
 16. timing with CUDA events after a warm-up: ms/push and rows/s at 4096
     streams, k=1, in turns (a b c d e f f e d c b a): built-in per-row,
     built-in uniform, static built-in, generic per-row, generic uniform,
     static generic; each new kernel beside its plain version, kernel B
     and its bound, as device time (`device_ms`: the card held while the
     host enqueues) and back to back as the other phases time kernels.

 17. the split-real STFT kernels (at even N the N/2-point real-FFT pack)
     against their plain versions (phase 3's bar), on chirp+tone: the
     window-plane kernel at 4096 rows of BENCH_CONFIG (N=4096) and of
     DEFAULT_CONFIG (N=4800), the all-windows
     kernel at k=8 with 4096 streams, the transposed kernel at 4096 rows and
     the tsplit kernel at 4096 streams of BENCH_CONFIG.  Bit for bit: the
     transposed rows, the tsplit rows and the all-windows rows equal the
     window-plane kernel's on the same windows, and tsplit's next carry the
     transposed framing's.  Device time of each (`device_ms`), its plain
     version's, and torch.fft.rfft over the same 2 x rows real rows of
     length N as the library call.
 18. the split-real paths through SpectrogramPipeline, palettes arange(S) %
     19: stft_packed=False at k=1 (4096 streams of BENCH_CONFIG and of
     DEFAULT_CONFIG) and at k=8 (4096 streams, no ring); transposed_carry at
     k=1 (4096 streams, no ring) and at k=8 with the ring (R=2048, 256
     streams, 260 pushes, render_viewport at R and at 800);
     framing="tsplit" at k=1 with 4096 streams, with 10,240 streams (the
     palette sort passes: carry-sort mode on the transposed carry) and with
     presorted_input + sorted_output.  Each passes when its kernel's launch
     count rises, streamed rows equal process() exactly, rows and carry
     match the same pushes on the plain versions (1 u8 over what the image
     shows; exactly), sorted rows equal the per-row pipeline's exactly, and
     rows lie within 1 u8 of the default packed pipeline's over what the
     image shows.
 19. ms/push of each split-real push beside the default push of the same
     configuration, in turns (a b c ... c b a), as device time.
 20. the FFT bodies past 5-smooth N: kernel A, the split-real plane
     kernel and the all-windows kernel (k=8) on the Bluestein body (N with
     a prime factor above 7: N=1410, M=2880; N=2204, M=4500; the odd N=435,
     M=875, whose split-real row is the N-point one) and on the radix-7
     mixed-radix body (N=4410 = 2 3^2 5 7^2, 44.1 kHz at the reference's
     0.05 s window; N=4802 = 2 7^4), 4096 rows or streams of chirp+tone,
     against their plain versions at phase 3's bar; device time of kernel A
     at N=2204 (the Bluestein row), N=1410, N=4410 and N=4800, their plain
     versions, torch.fft.fft, the bounds; the split-real plane kernel at the
     odd 7-smooth N=735 = 3 5 7^2 (the N-point row over radix 7, no pack).
 21. the pipelines at the sizes the kernels newly take, through
     SpectrogramPipeline: 44.1 kHz with DEFAULT_CONFIG's periods (N=4410) at
     k=1 with 4096 streams and no ring, and at k=8 with the ring (R=2048),
     256 streams, 260 pushes and render_viewport at R and 800; 44.1 kHz
     with a 1,102-sample window (N=2204 on the Bluestein body, phase 20's
     timed shape), k=1, 4096 streams;
     pad_factor=1 at BENCH_CONFIG's window (N=2048), k=1, 4096 streams; an
     odd N of the JAX fuzz's range (16 kHz, W=145, pad 3: N=435), k=1, 4096
     streams.  Each passes when its FFT body's launch count rises, streamed
     rows equal process() exactly, and rows, carry, ring and renders match
     the same calls on the plain versions (1 u8 over what the image shows;
     exactly; 1 bf16 ulp); then ms/push of each beside the 48 kHz
     DEFAULT_CONFIG push, in turns, device time.
 22. the carry+chunk pair and the fused push through their entry points at
     BENCH_CONFIG, 4096 streams: stft_mag_fused2_split at k=1 and k=8,
     emit_carry on the packed (f32, int16) and split-real all-windows
     kernels at k=8, push_fused_single with and without emit_mags (per-row
     tables arange(S) % 19).  Each kernel's launch count must rise.  Bit for
     bit: the split kernel's rows equal the split-real all-windows kernel's
     on the concatenated buffers, every next carry the buffers' tail, the
     magnitudes with emit_carry those without it, and the fused push the
     split-real plane kernel followed by kernel B; each within phase 3's bar
     (1 u8 for the push) of its plain version.  Device time of each beside
     what it replaces (the all-windows kernel after the two framing
     concatenations, the two-kernel chain), torch.fft.rfft and fft as the
     library calls, the bounds.
 23. long windows, against their plain versions at phase 3's bar on 4,096
     window rows: the large-N route's packed kernel (f32, int16 == f32 on
     x/32768; all-windows k=8 over 1,024 streams == window planes bit for
     bit) at N=32,768, 48,000 and 65,536 (4,096 rows there: one row group
     of exactly 2 GiB of scratch), its Bluestein passes at the prime
     N=16,411 (M=33,614) packed and split-real, its split-real kernel at
     N=65,536 (the N/2 pack past a block; all-windows k=8 over 128 streams);
     the split-real pack in shared memory at N=17,640, 32,768 and 48,000
     (all-windows at 48,000) and kernel A at N=17,640 (radix 7), with
     device times beside torch.fft; the split-real packs at 1,024 threads
     over radix 7 (N=35,280: N/2 = 17,640 direct; N=16,400: N/2 = 8200 on
     Bluestein's M = 16,807 = 7^5), 1,024 rows; the pipelines at 48 kHz with a 0.5 s
     window and at 44.1 kHz with a 0.2 s window, k=1 with 4,096 streams and
     k=8 with the ring at 16 streams over 260 pushes, stft_packed=False at
     k=1 (and at N=65,536 with 1,024 streams), at 48 kHz with a 0.17 s
     window (N=16,320 = 2^6 3 5 17: packed rows on the route's Bluestein
     passes, M=32,768; split-real rows on the Bluestein pack in shared
     memory, M=16,384) k=1 with 4,096 streams, and i16_planes at k=1 (rows
     == the f32 pipeline's on x/32768): each path's launches under its body
     label and the form kernel B takes (`colormap_kernel.tile_form`: the
     staged tile, or the direct form where the span is wide), kernel B and
     the generic kernel in the direct form on the N=48,000 and N=65,536
     planes within 1 u8 of their plain versions (the blockwise colormap too
     on the N=65,536 planes, sorted tables), streamed == process() exactly,
     within 1 u8 of with_plain_kernels(), carries exact, ring within 1 bf16
     ulp; the long-window serving deployment (portbench's long4k.k1.device:
     N=65,536, hop 800, 4,096 streams, k=1, the full serving mode, Zipf(1)
     palettes, int16 planar chunks through push_planar): each push one
     large int16 launch, one `large` body, one 2 GiB row group, rows bit for
     bit an f32 serving pipeline's on x/32768 and within 1 u8 of the plain
     twin, carries exact; ms/push beside DEFAULT_CONFIG's in turns.
 24. colormap_rows_fused at BENCH_CONFIG, 4,096 rows of [2, 2047], H=1024,
     per-row factors (the 19 built-ins, smoke-custom on every fifth row):
     packed and u8 within 1 u8 of the plain version, bit for bit
     colormap_generic on copies of the planes, u8 == the packed bytes, a
     4-tap matrix within 1 u8; the functional path (the verify recipe's
     chirp + tone at 48 kHz, stft_rows_planar -> colormap_rows_fused)
     within 1 u8 of rgba_f32_to_u8(colormap_rows(...)); the kernel each
     call launched, as the kernel reports it (the generic row tile staged at
     BENCH_CONFIG and direct on the functional path's H=512, one pixel per
     thread at four taps); device time, plain, bound.
 25. the redesigned kernels (the split-real pack; radix 7; the large-N
     route's two passes, packed f32 and int16 at N=48,000, packed at
     N=32,768, split-real at N=65,536; the radix-2 register passes, kernel
     A f32 and int16 at N=4096 and the packed all-windows kernel at k=8,
     with and without its next carry; the mixed-radix register passes,
     kernel A at N=4800 and 2204 (Bluestein) and the packed all-windows
     kernel at DEFAULT_CONFIG, k=8; kernel B and the generic kernel as a
     row tile, per-row tables at 4,096 rows; the blockwise colormap as
     kernel B at 10,240 sorted serving rows; the split-real row's load
     fused into its first pass, in the split-real kernels and the fused
     push at N=4096; colormap_rows_fused on the generic row tile at 4,096
     planar rows): each one's device time from phases 6, 10, 13, 16, 17,
     20, 22, 23 and 24 beside its first version's (FIRST_VERSION_MS, from
     PERF.md), its library call and its bound; the split-real kernels and
     the fused push at N=4096 also beside their times before the radix-2
     passes (BEFORE_PASSES_MS) and before the fused load
     (BEFORE_FUSED_LOAD_MS, with colormap_rows_fused before the tile).

 26. the serving loop on the card at full width, examples/serve.py's loop
     on the port: SpectrogramPipeline(BENCH_CONFIG, chunk_hops=1,
     store_ring=False, packed_output=True, i16_planes=True,
     presorted_input=True, sorted_output=True), 10,240 streams, palettes
     arange(S) % 19; a RingBank16 of 8,192 frames a ring, fed by producer
     threads that push 256-stream blocks of one seeded int16 chirp+tone
     array at the hop rate (push_matrix_range; the schedule starts once
     every thread runs, and each hop's lateness is logged); 24 ticks, each
     pop_matrix_i16_planar(800, pool.next(), dest=input_dest) into a pinned
     ChunkPool slot pushed by a depth-2 DeviceFeeder (H2D on its side
     stream).  Passes when rows[output_perm] equal an independent per-row
     pipeline's direct push_planar of the same samples bit for bit, no
     frame was dropped and the bank is empty, the int16 kernel A and
     blockwise launch counts rose, the state at tick 12 saved with
     save_state and restored with load_state into a fresh pipeline gives
     ticks 13-24 bit for bit, and an f32 drain (pop_matrix_f32_planar,
     4,096 per-row streams, readback="probe") gives its direct pushes' rows
     bit for bit through f32 kernel A and kernel B.  Then the host drain's
     ms per tick (p50 / p99), the H2D ms of a 32.8 MB chunk and the device
     ms per push (the feeder's CUDA events), the wall ms per tick at depth 1
     and 2 from rings holding ten hops (in turns 1 2 2 1) against the
     16.67 ms hop, a torch.profiler trace's share of H2D time under a
     kernel, the card and the host CPU.  A failed loop prints the tick of
     the first drop, the drops per tick, the drain's p99, the host's load
     averages and the live threads.
 27. multi-rate serving and the live display path, through the entry
     points a user calls: (a) a StreamGroupManager(group_capacity=4096,
     chunk_hops=1, store_ring=False) holding two geometry groups,
     BENCH_CONFIG at 48 kHz (N=4096, 16.67 ms cadence) and its window
     period at 44.1 kHz with an 8 ms hop (window 1881, hop 352, N=3762 on
     the Bluestein body, 7.98 ms), palettes arange(S) % 19, pushed
     directly with int16 tones / 32768: push_group rows bit for bit each
     geometry's own pipeline, within 1 u8 of its plain version, carries
     exact; a detached stream's reused slot gives a fresh stream's rows,
     its neighbours their own history's; the same reuse in a BENCH group
     on palettes i % 2, whose carry rests in sorted stream order
     (palette_sort, no ring); (b) the same groups with ingest
     (wire_int16, i16_planes, depth 2): producers push_pcm one hop of
     int16 tones per stream before each due tick of a synthetic clock, 24
     ticks of the slower group; the completed blocks bit for bit the f32
     pipelines' direct pushes of x / 32768, no drop; halfway, with a push
     in flight, one tenant per group leaves a stale backlog and its slot
     is reused: from then on that slot's rows are a fresh stream's; wall
     ms per tick and
     the host drain's p50 / p99 per group; (c) LiveSession at its
     defaults (48 kHz, N=4800, k=8, ring 2,048) with the scope and the
     analyzer, fed the registry's 440 Hz source in real time, TF32
     allowed: rows, ring and viewport bit for bit a direct pipeline's on
     the chunks it consumed, the analyzer's levels within 1e-6 of a
     float64 band product over the same ring rows, the scope's envelope
     the newest samples' min / max; (d) `python -m
     spectrogram_tpu_torch.app render` and `live --seconds 2 --streams 4`,
     plain, with `--view` and with `--view --multirate` (headless), in
     subprocesses: exit 0 and a PNG of the expected shape.  Kernel A
     (radix 2, Bluestein, their int16 forms), the all-windows kernel and
     kernel B must launch.
 28. the stream mesh over ranks (`spectrogram_tpu_torch.parallel`), each
     part's ranks started as subprocesses of this script (`--mesh-part`)
     under a time limit; a rank that fails, outlives it or disagrees fails
     the run, and the ranks' kernel launches join the counts below.  (a)
     one rank under NCCL on cuda:0: SpectrogramPipeline(BENCH_CONFIG,
     chunk_hops=1, store_ring=False, packed_output=True), 4,096 streams on
     palettes arange(S) % 19 (sharded_init, sharded_set_palette), 24
     shard_map_step pushes of chirp + tone: rows and carry bit for bit the
     unsharded pipeline's, global_rows summed through NCCL = 4,096 x 24;
     device time of the sharded and the unsharded push in turns, the
     all-reduce's time.  (b) two gloo ranks sharing cuda:0, the full
     serving mode (i16_planes, presorted_input, sorted_output) at 10,240
     streams, 5,120 a rank, palettes arange(S) % 19: each rank takes the
     per-shard sort; its HostShardIngest gets one hop of int16 tones a
     tick on local indices and drains it presorted (wire int16), 24 ticks,
     at tick 12 save_sharded (unsorted, DCP) and save_state (gathered npz):
     rows gathered on rank 0 in external order bit for bit one process's
     direct per-row pushes, no drop and empty banks, ticks 13-24 bit for
     bit from load_sharded onto the two ranks, from load_sharded in one
     process and from the npz; producer, drain, push and wall ms a tick,
     each rank's push device time alone and with the other's, an
     unsharded pipeline of 5,120 streams beside it, the gloo all-reduce.
     (c) StreamGroupManager(mesh=...) over two gloo ranks with phase 27's
     groups (4,096 slots at N=4096 and at N=3762 on the Bluestein body),
     a set_palette on each rank's half after four pushes, six pushes: both
     ranks' rows gathered on rank 0 bit for bit a single-card manager's.
     (d) `python -m spectrogram_tpu_torch.parallel.dryrun --ranks 2
     --device cuda:0 --backend gloo` exits 0.  Peak device memory per
     rank.
 29. the autotuner (`spectrogram_tpu_torch.utils.autotune`): (a) at
     BENCH_CONFIG k=1 (4,096 streams: radix-2 kernel A, kernel B),
     DEFAULT_CONFIG k=1 (N=4800, mixed radix), N=16,384 k=1, the full
     serving mode at 10,240 streams (int16 kernel A, blockwise),
     BENCH_CONFIG split-real k=1 and BENCH_CONFIG k=8 (the all-windows
     kernel), palettes arange(S) % 19, four pushes of chirp+tone under
     every launch shape of the push's families (`launch_families`: the
     STFT rows' launch bounds, the colormap tile's form): rows and next
     carry bit for bit the table's, the family's kernels launching; the
     fused push's shapes on 4,096 window rows bit for bit its table's;
     device ms of each beside the table's.  (b) `autotune.tune` at each
     of those geometries on a fresh cache in a temporary directory under
     build/: the pick, its ms, the table's, the seconds spent; a second
     call and SpectrogramPipeline(autotune=True) measure nothing, the
     tuned pipeline's rows and carry bit for bit the untuned one's; a
     StreamGroupManager(autotune=True) of BENCH_CONFIG and phase 27's
     44.1 kHz geometry launches each group's own pick.  Only correctness
     fails the run; the times are printed.
 30. the ring write (`csrc/ring_write.cu`) at the display cells' shape:
     2,048 streams, k=8, DEFAULT_CONFIG's 2,399 bins, a bf16 ring of
     R=2048 rows (40 GB, so offsets pass 2^31 elements), the planes the
     all-windows kernel makes of chirp+tone with NaN, inf, 3e38 and
     subnormals set in a few rows: at cursors 0 and R-8 the written rows
     bit for bit `ring_write_plain`'s on the same planes and every other
     row untouched.  Device ms (CUDA events, mean of 20) of the kernel and
     of `ring_write_plain` into that ring and into a 64-row one, beside an
     ATen cast of the same planes to bf16 (the same bytes, no ring) and
     its bound.

Then the whole run's seconds.  The second-to-last line is {"kernels": [...]}:
each kernel's launches on the main paths (phases 5, 9, 12, 15, 18, 21, 22,
23, 24, 26, 27, 28 and 29; the ring write's times are phase 30's; the Bluestein body's row counts every STFT launch at such an N
below the large-N route), its
largest error against its plain version, its time, its plain version's, the
library call's where one computes the same transform, and its bound: the
larger of its bytes (each input read once, each output written once) over
3.35 TB/s and its f32 operations over 67 TFLOP/s, the H100 SXM's published
peaks.  The last line is {"ok": true, ...}.
"""

from __future__ import annotations

import json
import os
import pathlib
import platform
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from spectrogram_tpu_torch import testing
from spectrogram_tpu_torch.testing import device_ms
from spectrogram_tpu_torch.config import BENCH_CONFIG, DEFAULT_CONFIG, SpectrogramConfig
from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline
from spectrogram_tpu_torch.ops import colormap as cmap_ops
from spectrogram_tpu_torch.ops.cuda import _build
from spectrogram_tpu_torch.ops.cuda import colormap_kernel as ck
from spectrogram_tpu_torch.ops.cuda import push_kernel as pk
from spectrogram_tpu_torch.ops.cuda import ring_kernel as rk
from spectrogram_tpu_torch.ops.cuda import stft_kernel as sk
from spectrogram_tpu_torch.io.feeder import ChunkPool, DeviceFeeder
from spectrogram_tpu_torch.io.ring import RingBank16
from spectrogram_tpu_torch.utils import checkpoint
from spectrogram_tpu_torch.utils.profiling import LatencyTracker, device_trace

STREAMS = 4096
PUSHES = 4
STFT_ATOL, STFT_RTOL = 3e-5, 1e-4
TIMED_ITERS = 20
K = 8                       # chunk_hops of the display path
DISPLAY_STREAMS = 256
SERVING_STREAMS = (10240, 16384)   # the JAX package's serving populations
SERVING_PUSHES = 3
DISPLAY_PUSHES = 260        # > 2048 / 8: the ring wraps
RENDER_WIDTH = 800
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
F32_FLOPS_PER_S = 67e12     # float32 outside the tensor cores
CMAP_OPS_PER_PIXEL = 50     # kernel B's f32 operations per pixel, from its source
# the generic kernel's: kernel B's with generic_word's 68 operations (two
# texel tap pairs, 8 reads, 4 products, 4 quantizations) in place of
# builtin_word's 38 (colormap_common.cuh)
CMAP_OPS_PER_PIXEL_GENERIC = CMAP_OPS_PER_PIXEL - 38 + 68
PALETTE_REGISTRY = 4        # smoke-custom + 3 built-ins
# phase 30: the display cells' ring (portbench's ref2k cells)
RING_STREAMS, RING_ROWS = 2048, 2048
# where the blockwise colormap takes kernel B's direct form: N=16,384, span
# 7,497 bins at H=1024
LONG_COLORMAP = SpectrogramConfig(window_period=8192 / 48000.0)

KERNELS = {
    sk.KERNEL: dict(
        name="stft_packed", source="spectrogram_tpu_torch/csrc/stft_packed.cu",
        replaces="spectrogram_tpu/ops/pallas/stft_kernel.py:509",
    ),
    sk.MIXED_KERNEL: dict(
        name="stft_mixed", source="spectrogram_tpu_torch/csrc/stft_mixed.cu",
        replaces="spectrogram_tpu/ops/pallas/stft_kernel.py:509",
    ),
    sk.ALLK_KERNEL: dict(
        name="stft_allk", source="spectrogram_tpu_torch/csrc/stft_allk.cu",
        replaces="spectrogram_tpu/ops/pallas/stft_kernel.py:894",
    ),
    ck.KERNEL: dict(
        name="colormap_builtin",
        source="spectrogram_tpu_torch/csrc/colormap_builtin.cu",
        replaces="spectrogram_tpu/ops/pallas/colormap_kernel.py:1072",
    ),
    ck.BLOCKWISE_KERNEL: dict(
        name="colormap_blockwise",
        source="spectrogram_tpu_torch/csrc/colormap_blockwise.cu",
        replaces="spectrogram_tpu/ops/pallas/colormap_kernel.py:536",
    ),
    sk.KERNEL_I16: dict(
        name="stft_packed_i16", source="spectrogram_tpu_torch/csrc/stft_packed.cu",
        replaces="spectrogram_tpu/ops/pallas/stft_kernel.py:509",
    ),
    sk.MIXED_KERNEL_I16: dict(
        name="stft_mixed_i16", source="spectrogram_tpu_torch/csrc/stft_mixed.cu",
        replaces="spectrogram_tpu/ops/pallas/stft_kernel.py:509",
    ),
    sk.ALLK_KERNEL_I16: dict(
        name="stft_allk_i16", source="spectrogram_tpu_torch/csrc/stft_allk.cu",
        replaces="spectrogram_tpu/ops/pallas/stft_kernel.py:894",
    ),
    ck.GENERIC_KERNEL: dict(
        name="colormap_generic", source="spectrogram_tpu_torch/csrc/colormap_generic.cu",
        replaces="spectrogram_tpu/ops/pallas/colormap_kernel.py:352",
    ),
    ck.STATIC_KERNEL: dict(
        name="colormap_static", source="spectrogram_tpu_torch/csrc/colormap_static.cu",
        replaces="spectrogram_tpu/ops/pallas/colormap_kernel.py:637",
    ),
    sk.SPLIT_KERNEL: dict(
        name="stft_split", source="spectrogram_tpu_torch/csrc/stft_split.cu",
        replaces="spectrogram_tpu/ops/pallas/stft_kernel.py:230",
    ),
    sk.SPLIT_ALLK_KERNEL: dict(
        name="stft_split_allk", source="spectrogram_tpu_torch/csrc/stft_split.cu",
        replaces="spectrogram_tpu/ops/pallas/stft_kernel.py:787",
    ),
    sk.SPLIT_T_KERNEL: dict(
        name="stft_split_t", source="spectrogram_tpu_torch/csrc/stft_split.cu",
        replaces="spectrogram_tpu/ops/pallas/stft_kernel.py:692",
    ),
    sk.SPLIT_TSPLIT_KERNEL: dict(
        name="stft_split_tsplit", source="spectrogram_tpu_torch/csrc/stft_split.cu",
        replaces="spectrogram_tpu/ops/pallas/stft_kernel.py:1467",
    ),
    # the FFT body the STFT kernels run at N with a prime factor above 7,
    # counted over every STFT kernel's launches at such N (its numbers at
    # N=2204)
    "bluestein": dict(
        name="fft_body_bluestein", source="spectrogram_tpu_torch/csrc/stft_fft.cuh",
        replaces="spectrogram_tpu/ops/pallas/stft_kernel.py:509",
    ),
    sk.ALLK_CARRY_KERNEL: dict(
        name="stft_allk_carry", source="spectrogram_tpu_torch/csrc/stft_allk.cu",
        replaces="spectrogram_tpu/ops/pallas/stft_kernel.py:894",
    ),
    sk.ALLK_CARRY_KERNEL_I16: dict(
        name="stft_allk_carry_i16", source="spectrogram_tpu_torch/csrc/stft_allk.cu",
        replaces="spectrogram_tpu/ops/pallas/stft_kernel.py:894",
    ),
    sk.SPLIT_ALLK_CARRY_KERNEL: dict(
        name="stft_split_allk_carry", source="spectrogram_tpu_torch/csrc/stft_split.cu",
        replaces="spectrogram_tpu/ops/pallas/stft_kernel.py:894",
    ),
    sk.SPLIT_CARRY_KERNEL: dict(
        name="stft_split_carry", source="spectrogram_tpu_torch/csrc/stft_split.cu",
        replaces="spectrogram_tpu/ops/pallas/stft_kernel.py:1118",
    ),
    pk.KERNEL: dict(
        name="push_fused", source="spectrogram_tpu_torch/csrc/push_fused.cu",
        replaces="spectrogram_tpu/ops/pallas/push_kernel.py:88",
    ),
    # the large-N route: every STFT entry where a row's FFT buffer passes a
    # block's shared memory (phase 23; its numbers at N=48,000, the split
    # kernel's at N=65,536)
    sk.LARGE_KERNEL: dict(
        name="stft_large_packed", source="spectrogram_tpu_torch/csrc/stft_large.cu",
        replaces="spectrogram_tpu/ops/pallas/stft_kernel.py:509",
    ),
    sk.LARGE_KERNEL_I16: dict(
        name="stft_large_packed_i16", source="spectrogram_tpu_torch/csrc/stft_large.cu",
        replaces="spectrogram_tpu/ops/pallas/stft_kernel.py:509",
    ),
    sk.LARGE_SPLIT_KERNEL: dict(
        name="stft_large_split", source="spectrogram_tpu_torch/csrc/stft_large.cu",
        replaces="spectrogram_tpu/ops/pallas/stft_kernel.py:509",
    ),
    ck.ROWS_KERNEL: dict(
        name="colormap_rows_fused", source="spectrogram_tpu_torch/csrc/colormap_rows.cu",
        replaces="spectrogram_tpu/ops/pallas/colormap_kernel.py:152",
    ),
    # no Pallas kernel: XLA's fusion of the ring's
    # dynamic_update_slice(rows.astype(ring_dtype))
    rk.KERNEL: dict(
        name="ring_write", source="spectrogram_tpu_torch/csrc/ring_write.cu",
        replaces="spectrogram_tpu/models/spectrogram.py:1442",
    ),
}
BLUESTEIN = "bluestein"


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"FAIL: {msg}")


def card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch.cuda.is_available() is false; this check needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    line = smi.stdout.strip().splitlines()[0]
    log(f"[1] card: {torch.cuda.get_device_name(0)}; nvidia-smi: {line}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return line


def time_ms(fn, iters: int = TIMED_ITERS) -> float:
    """Mean device time of fn() over `iters` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stft_work(rows: int, n_fft: int, w: int, input_floats: int,
              sample_bytes: int = 4) -> tuple[float, float]:
    """(bytes, flops) of packed STFT magnitudes for `rows` windows: the two
    input channels' `input_floats` samples (4 bytes each, 2 as int16), hann,
    the N/2 twiddles the stages read, two [rows, N/2] outputs; 5 N log2 N
    operations per complex FFT plus the window multiply and the unpack."""
    nbytes = (2 * sample_bytes * input_floats + 4 * (w + n_fft)
              + 4 * 2 * rows * (n_fft // 2))
    flops = rows * (5 * n_fft * np.log2(n_fft) + 2 * w + 12 * (n_fft // 2))
    return nbytes, flops


def cmap_work(rows: int, taps: ck.ResampleTaps, table_floats: int,
              ops_per_pixel: int = CMAP_OPS_PER_PIXEL) -> tuple[float, float]:
    """(bytes, flops) of a colormap kernel: the plane bins its taps touch,
    the taps, the device tables it reads (`table_floats` f32, 0 for the
    static kernel), the [rows, H] i32 output."""
    touched = torch.unique(torch.cat([taps.j0, taps.j1])).numel()
    h = taps.j0.numel()
    nbytes = 4 * 2 * rows * touched + 16 * h + 4 * table_floats + 4 * rows * h
    return nbytes, rows * h * ops_per_pixel


def sector_floor(rows: int, taps: ck.ResampleTaps, bins: int, table_floats: int,
                 h: int | None = None) -> float:
    """The least ms of a colormap kernel's bytes counted in the 32-byte
    sectors device memory moves: each row's distinct sectors of each plane
    that its taps touch (a row starting `row * bins` floats into its plane),
    the taps, the tables and the [rows, h] i32 output, over 3.35 TB/s.
    Printed beside `bound_ms`, whose definition stays cmap_work's."""
    j = torch.unique(torch.cat([taps.j0, taps.j1])).cpu().numpy().astype(np.int64)
    h = taps.j0.numel() if h is None else h
    offsets = np.bincount((np.arange(rows, dtype=np.int64) * bins) % 8, minlength=8)
    sectors = sum(int(c) * np.unique((o + j) // 8).size for o, c in enumerate(offsets) if c)
    nbytes = 2 * 32 * sectors + 16 * h + 4 * table_floats + 4 * rows * h
    return nbytes / HBM_BYTES_PER_S * 1e3


def windows(cfg, kind: str, rows: int, dev):
    frames = testing.make(kind, rows, cfg.window_size, cfg.sample_rate, seed=1)
    left = torch.from_numpy(np.ascontiguousarray(frames[..., 0])).to(dev)
    right = torch.from_numpy(np.ascontiguousarray(frames[..., 1])).to(dev)
    return left, right


def stft_errors(got, want) -> tuple[float, float, bool]:
    """(max abs err, max rel err above the absolute bar, within the bar)."""
    err = max(float((g - x).abs().max()) for g, x in zip(got, want))
    rel = max(float(((g - x).abs() / x.abs())[x.abs() >= STFT_ATOL].max())
              for g, x in zip(got, want))
    ok = all(torch.allclose(g, x, atol=STFT_ATOL, rtol=STFT_RTOL)
             for g, x in zip(got, want))
    return err, rel, ok


def _check_stft(phase: int, stats: dict, names: tuple, label: str, got, want) -> float:
    """Phase 3's bar between a kernel's output and its plain version's; the
    error goes to each of `names` in `stats`."""
    err, rel, ok = stft_errors(got, want)
    log(f"[{phase}] {label}: max abs err {err:.3e}, max rel err {rel:.3e} (bar atol "
        f"{STFT_ATOL} rtol {STFT_RTOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{label} disagrees with its plain version")
    for name in names:
        stats[name] = max(stats.get(name, 0.0), err)
    return err


def _identity(phase: int, label: str, got, want) -> None:
    same = all(torch.equal(g, x) for g, x in zip(got, want))
    log(f"[{phase}] {label}: {'equal' if same else 'DIFFER'} bit for bit")
    if not same:
        fail(f"{label}: not bit for bit")


def main() -> int:
    t_start = time.perf_counter()
    power_line = card()
    dev = torch.device("cuda", 0)
    cfg = BENCH_CONFIG

    t0 = time.perf_counter()
    path, nvcc_s = _build.build()
    lib = _build.library()
    log(f"[2] build: {path} (nvcc {nvcc_s:.2f} s, with load {time.perf_counter() - t0:.2f} s)")

    # -- 3. kernel A against torch.fft ---------------------------------------
    p = SpectrogramPipeline(cfg, chunk_hops=1, store_ring=False, packed_output=True,
                            device=dev)
    stats = {name: 0.0 for name in KERNELS}
    planes = {}
    for kind in ("chirp_tone", "noise"):
        left, right = windows(cfg, kind, STREAMS, dev)
        got = sk.stft_mag_packed(left, right, p.hann, p.fft_consts)
        want = sk.stft_mag_packed_plain(left, right, p.hann, cfg.padded_size)
        torch.cuda.synchronize()
        err, rel, ok = stft_errors(got, want)
        log(f"[3] stft_packed {kind}: max abs err {err:.3e}, max rel err {rel:.3e} "
            f"(bar atol {STFT_ATOL} rtol {STFT_RTOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("stft_packed disagrees with torch.fft")
        stats[sk.KERNEL] = max(stats[sk.KERNEL], err)
        planes[kind] = (left, right, *got)

    # -- 4. kernel B against its plain version -------------------------------
    ids = torch.arange(STREAMS, device=dev) % len(p.schemes)
    tables = p.builtin_tables.index_select(0, ids).contiguous()
    for kind, (_, _, ml, mr) in planes.items():
        got = ck.unpack_rgba(ck.colormap_builtin(ml, mr, p.taps, tables, cfg)).astype(np.int32)
        want = ck.unpack_rgba(ck.colormap_builtin_plain(ml, mr, p.taps, tables, cfg)).astype(np.int32)
        diff = np.abs(got - want)
        share = float((diff > 0).any(-1).mean())
        log(f"[4] colormap_builtin {kind}: max u8 diff {diff.max()}, "
            f"pixels differing {share:.3e} (bar 1 u8) {'ok' if diff.max() <= 1 else 'FAIL'}")
        if diff.max() > 1:
            fail("colormap_builtin disagrees with its plain version")
        stats[ck.KERNEL] = max(stats[ck.KERNEL], int(diff.max()))

    # -- 5. the k=1 main path -------------------------------------------------
    t = p.chunk_size
    pcm = testing.chirp_tone(STREAMS, PUSHES * t, cfg.sample_rate, seed=2)
    chunks = [torch.from_numpy(pcm[:, i * t : (i + 1) * t]).to(dev) for i in range(PUSHES)]
    pid = np.arange(STREAMS) % len(p.schemes)
    state = p.set_palette(p.init_state(STREAMS), pid)
    plain_carry, plain_tables = state.carry, state.tables
    torch.cuda.synchronize()
    lib.reset_launches()
    rows = []
    for chunk in chunks:
        state, r = p.push(state, chunk)
        rows.append(r)
    torch.cuda.synchronize()
    launches = dict(lib.launches)
    streamed = torch.cat(rows, dim=1)
    log(f"[5] main path: {PUSHES} pushes x {STREAMS} streams -> {tuple(streamed.shape)} "
        f"{streamed.dtype}; launches {launches}")
    if streamed.shape != (STREAMS, PUSHES, cfg.viewport_height) or streamed.dtype != torch.int32:
        fail("main path output has the wrong shape or type")
    if not (launches[sk.KERNEL] > 0 and launches[ck.KERNEL] > 0):
        fail("the main path did not launch every kernel")

    padded = torch.cat([torch.zeros(STREAMS, p.carry_size, 2, device=dev),
                        torch.from_numpy(pcm).to(dev)], dim=1)
    for palette in range(len(p.schemes)):
        sel = torch.from_numpy(np.flatnonzero(pid == palette)).to(dev)
        one = p.process(padded.index_select(0, sel), palette_id=palette)
        if not torch.equal(one, streamed.index_select(0, sel)):
            fail(f"streamed rows differ from process() for palette {palette}")
    log("[5] streamed rows equal process() exactly, every palette")

    plain = p.with_plain_kernels()
    plain_state = state._replace(carry=plain_carry, tables=plain_tables)
    worst = 0
    for i, chunk in enumerate(chunks):
        plain_state, r = plain.push(plain_state, chunk)
        worst = max(worst, testing.rgba_u8_diff(ck.unpack_rgba(rows[i]), ck.unpack_rgba(r)))
    if not torch.equal(plain_state.carry, state.carry):
        fail("next carry differs from the plain path's")
    log(f"[5] against the plain path on the card: max u8 diff {worst} over what "
        f"the image shows (bar 1); next carry equal")
    if worst > 1:
        fail("main path disagrees with the plain path")

    # -- 6. timing --------------------------------------------------------------
    left, right, ml, mr = planes["chirp_tone"]
    ms = {
        sk.KERNEL: device_ms(lambda: sk.stft_mag_packed(left, right, p.hann, p.fft_consts)),
        ck.KERNEL: device_ms(lambda: ck.colormap_builtin(ml, mr, p.taps, tables, cfg)),
    }
    plain_ms = {
        sk.KERNEL: time_ms(lambda: sk.stft_mag_packed_plain(left, right, p.hann, cfg.padded_size)),
        ck.KERNEL: time_ms(lambda: ck.colormap_builtin_plain(ml, mr, p.taps, tables, cfg)),
    }
    bounds = {
        sk.KERNEL: bound(*stft_work(STREAMS, cfg.padded_size, cfg.window_size,
                                    STREAMS * cfg.window_size)),
        ck.KERNEL: bound(*cmap_work(STREAMS, p.taps, tables.numel())),
    }
    push_state = [state]

    def kernel_push():
        push_state[0], _ = p.push(push_state[0], chunks[0])

    def plain_path_push():
        plain.push(state, chunks[0])

    push_ms = time_ms(kernel_push)
    plain_push_ms = time_ms(plain_path_push)
    for k in (sk.KERNEL, ck.KERNEL):
        floor = (f", sector floor {sector_floor(STREAMS, p.taps, ml.shape[1], tables.numel()):.4f}"
                 " ms" if k == ck.KERNEL else "")
        log(f"[6] {KERNELS[k]['name']}: {ms[k]:.4f} ms device time (plain {plain_ms[k]:.4f} ms, "
            f"bound {bounds[k][0]:.4f} ms by {bounds[k][1]}{floor})")
    log(f"[6] push at {STREAMS} streams: kernels {push_ms:.4f} ms/push "
        f"= {STREAMS / push_ms * 1e3:.1f} rows/s; plain {plain_push_ms:.4f} ms/push "
        f"= {STREAMS / plain_push_ms * 1e3:.1f} rows/s; card {power_line}")
    del planes, left, right, ml, mr, padded, streamed, rows, chunks, push_state

    # -- 7. the mixed-radix kernel A --------------------------------------------
    dcfg = DEFAULT_CONFIG
    pd = SpectrogramPipeline(dcfg, chunk_hops=1, store_ring=False, packed_output=True,
                             device=dev)
    for kind in ("chirp_tone", "noise"):
        dl, dr = windows(dcfg, kind, STREAMS, dev)
        got = sk.stft_mag_packed(dl, dr, pd.hann, pd.fft_consts)
        want = sk.stft_mag_packed_plain(dl, dr, pd.hann, dcfg.padded_size)
        torch.cuda.synchronize()
        err, rel, ok = stft_errors(got, want)
        log(f"[7] stft_mixed N={dcfg.padded_size} {kind}: max abs err {err:.3e}, max rel "
            f"err {rel:.3e} (bar atol {STFT_ATOL} rtol {STFT_RTOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("stft_mixed disagrees with torch.fft")
        stats[sk.MIXED_KERNEL] = max(stats[sk.MIXED_KERNEL], err)
    ms[sk.MIXED_KERNEL] = time_ms(lambda: sk.stft_mag_packed(dl, dr, pd.hann, pd.fft_consts))
    plain_ms[sk.MIXED_KERNEL] = time_ms(
        lambda: sk.stft_mag_packed_plain(dl, dr, pd.hann, dcfg.padded_size))
    bounds[sk.MIXED_KERNEL] = bound(*stft_work(
        STREAMS, dcfg.padded_size, dcfg.window_size, STREAMS * dcfg.window_size))
    library_ms = {ck.KERNEL: None}
    for name, n in ((sk.KERNEL, cfg.padded_size), (sk.MIXED_KERNEL, dcfg.padded_size)):
        z = torch.complex(torch.randn(STREAMS, n, device=dev), torch.randn(STREAMS, n, device=dev))
        library_ms[name] = device_ms(lambda: torch.fft.fft(z))
        log(f"[7] torch.fft.fft [{STREAMS}, {n}] complex64: {library_ms[name]:.4f} ms device time")
    del dl, dr, got, want, z

    # -- 8. the all-windows kernel ----------------------------------------------
    allk_inputs = {}
    for c, pp in ((cfg, p), (dcfg, pd)):
        length = c.window_size + (K - 1) * c.hop_size
        buf = testing.chirp_tone(STREAMS, length, c.sample_rate, seed=3)
        bl = torch.from_numpy(np.ascontiguousarray(buf[..., 0])).to(dev)
        br = torch.from_numpy(np.ascontiguousarray(buf[..., 1])).to(dev)
        got = sk.stft_mag_packed_allk(bl, br, pp.hann, pp.fft_consts, K, c.hop_size)
        want = sk.stft_mag_packed_allk_plain(bl, br, pp.hann, c.padded_size, K, c.hop_size)
        torch.cuda.synchronize()
        err, rel, ok = stft_errors(got, want)
        log(f"[8] stft_allk k={K} N={c.padded_size} buffers {tuple(bl.shape)}: max abs err "
            f"{err:.3e}, max rel err {rel:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("stft_allk disagrees with its plain version")
        stats[sk.ALLK_KERNEL] = max(stats[sk.ALLK_KERNEL], err)
        allk_inputs[c.padded_size] = (bl, br, pp)
    del got, want

    # -- 9. the display path ----------------------------------------------------
    redesign = {}          # phase 25's rows: label -> (device ms, library ms, bound ms)
    torch.cuda.reset_peak_memory_stats()
    main_launches = {name: launches.get(name, 0) for name in KERNELS}
    display = {}
    for c in (cfg, dcfg):
        display[c.padded_size] = display_path(c, dev, lib, main_launches)

    # -- 10. timing -------------------------------------------------------------
    bl, br, pp = allk_inputs[cfg.padded_size]
    hop = cfg.hop_size
    ms[sk.ALLK_KERNEL] = device_ms(
        lambda: sk.stft_mag_packed_allk(bl, br, pp.hann, pp.fft_consts, K, hop))
    plain_ms[sk.ALLK_KERNEL] = time_ms(
        lambda: sk.stft_mag_packed_allk_plain(bl, br, pp.hann, cfg.padded_size, K, hop))
    bounds[sk.ALLK_KERNEL] = bound(*stft_work(
        K * STREAMS, cfg.padded_size, cfg.window_size, bl.numel()))
    z = torch.complex(torch.randn(K * STREAMS, cfg.padded_size, device=dev),
                      torch.randn(K * STREAMS, cfg.padded_size, device=dev))
    library_ms[sk.ALLK_KERNEL] = device_ms(lambda: torch.fft.fft(z))
    del z
    dbl, dbr, dpp = allk_inputs[dcfg.padded_size]
    dms = device_ms(lambda: sk.stft_mag_packed_allk(dbl, dbr, dpp.hann, dpp.fft_consts, K,
                                                    dcfg.hop_size))
    dplain = time_ms(lambda: sk.stft_mag_packed_allk_plain(
        dbl, dbr, dpp.hann, dcfg.padded_size, K, dcfg.hop_size))
    dbound = bound(*stft_work(K * STREAMS, dcfg.padded_size, dcfg.window_size, dbl.numel()))
    z = torch.complex(torch.randn(K * STREAMS, dcfg.padded_size, device=dev),
                      torch.randn(K * STREAMS, dcfg.padded_size, device=dev))
    dlib = device_ms(lambda: torch.fft.fft(z))
    del z
    redesign["stft_allk N=4800 k=8"] = (dms, dlib, dbound[0])
    redesign["kernel A N=4096"] = (ms[sk.KERNEL], library_ms[sk.KERNEL], bounds[sk.KERNEL][0])
    redesign["kernel B per-row, 4096 rows"] = (ms[ck.KERNEL], None, bounds[ck.KERNEL][0])
    redesign["stft_allk N=4096 k=8"] = (ms[sk.ALLK_KERNEL], library_ms[sk.ALLK_KERNEL],
                                        bounds[sk.ALLK_KERNEL][0])
    for name in (sk.MIXED_KERNEL, sk.ALLK_KERNEL):
        log(f"[10] {KERNELS[name]['name']}: {ms[name]:.4f} ms (plain {plain_ms[name]:.4f} ms, "
            f"torch.fft.fft {library_ms[name]:.4f} ms, bound {bounds[name][0]:.4f} ms by "
            f"{bounds[name][1]})")
    log(f"[10] stft_allk k={K} at DEFAULT_CONFIG, {STREAMS} streams: {dms:.4f} ms device time "
        f"(plain {dplain:.4f} ms, torch.fft.fft [{K * STREAMS}, {dcfg.padded_size}] "
        f"{dlib:.4f} ms, bound {dbound[0]:.4f} ms by {dbound[1]})")
    del allk_inputs, bl, br, dbl, dbr

    # the JAX bench's BENCH_CHUNK_HOPS=8 mode: 4096 streams, no ring
    pk = SpectrogramPipeline(cfg, chunk_hops=K, store_ring=False, packed_output=True,
                             device=dev)
    kstate = [pk.set_palette(pk.init_state(STREAMS), pid)]
    kchunk = torch.from_numpy(
        testing.chirp_tone(STREAMS, pk.chunk_size, cfg.sample_rate, seed=4)).to(dev)
    plain_pk = pk.with_plain_kernels()

    def k8_push(q=pk):
        kstate[0], _ = q.push(kstate[0], kchunk)

    k8_ms = time_ms(k8_push)
    k8_plain = time_ms(lambda: k8_push(plain_pk))
    log(f"[10] k={K} push at {STREAMS} streams, no ring: kernels {k8_ms:.4f} ms/push = "
        f"{K * STREAMS / k8_ms * 1e3:.1f} rows/s; plain {k8_plain:.4f} ms/push = "
        f"{K * STREAMS / k8_plain * 1e3:.1f} rows/s")
    del kstate, kchunk
    for n, d in display.items():
        log(f"[10] display N={n}, {DISPLAY_STREAMS} streams: push {d['push_ms']:.4f} ms "
            f"(plain {d['plain_push_ms']:.4f} ms) = {K * DISPLAY_STREAMS / d['push_ms'] * 1e3:.1f} "
            f"rows/s; render_viewport {d['render_ms']:.4f} ms (plain {d['plain_render_ms']:.4f} ms), "
            f"width {RENDER_WIDTH} {d['render_w_ms']:.4f} ms")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[10] peak device memory over phases 9-10: {peak:.2f} GiB; card {power_line}")

    # -- 11-13. the serving mode ---------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    serving_kernels(dev, stats, ms, plain_ms, bounds, library_ms, redesign)
    serving = {s: serving_path(s, dev, lib, main_launches) for s in SERVING_STREAMS}
    i16_paths(dev, lib, main_launches)
    serving_timing(serving, power_line)

    # -- 14-16. user-defined and static palettes ---------------------------------
    torch.cuda.reset_peak_memory_stats()
    palette_kernels(dev, stats, ms, plain_ms, bounds, library_ms, redesign)
    palette_paths(dev, lib, main_launches)
    palette_timing(dev, power_line)

    # -- 17-19. the split-real STFT family ---------------------------------------
    torch.cuda.reset_peak_memory_stats()
    split_kernels(dev, stats, ms, plain_ms, bounds, library_ms, redesign)
    layout_paths(dev, lib, main_launches)
    layout_timing(dev, power_line)

    # -- 20-22. every FFT size; the carry+chunk pair and the fused push -------
    torch.cuda.reset_peak_memory_stats()
    bluestein_kernels(dev, stats, ms, plain_ms, bounds, library_ms, redesign)
    size_paths(dev, lib, main_launches)
    size_timing(dev, power_line)
    torch.cuda.reset_peak_memory_stats()
    carry_pair_and_push(dev, lib, main_launches, stats, ms, plain_ms, bounds, library_ms,
                        power_line, redesign)

    # -- 23. FFT sizes above a block's shared memory: the large-N route -------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    large_kernels(dev, stats, ms, plain_ms, bounds, library_ms, redesign)
    n = LARGE_BLUE.padded_size
    if not (sk.fft_route(n) == "large" and sk.fft_body(n) == BLUESTEIN
            and sk.split_route(n) == BLUESTEIN):
        fail(f"N={n} reaches neither the route's Bluestein passes nor the Bluestein pack")
    size_paths(dev, lib, main_launches, LARGE_PATHS, phase=23)
    large_i16_path(dev, lib, main_launches)
    long_window_path(dev, lib, main_launches)
    size_timing(dev, power_line, LARGE_TIMING, phase=23, phases="23")

    # -- 24. colormap_rows_fused at full width, and the functional path --------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rows_fused(dev, lib, main_launches, stats, ms, plain_ms, bounds, library_ms, power_line,
               redesign)

    # -- 25. the redesigned kernels beside their first versions --------------
    for label, first in FIRST_VERSION_MS.items():
        if label not in redesign:
            fail(f"phase 25: no time for {label}")
        t, lib_t, b = redesign[label]
        before = (f", before the radix-2 passes {BEFORE_PASSES_MS[label]:.4f} ms"
                  if label in BEFORE_PASSES_MS else "")
        if label in BEFORE_FUSED_LOAD_MS:
            before += (f", before the fused load and the tile "
                       f"{BEFORE_FUSED_LOAD_MS[label]:.4f} ms")
        library = ("library none" if lib_t is None
                   else f"library {lib_t:.4f} ms, {t / lib_t:.2f}x it")
        log(f"[25] {label}: {t:.4f} ms device time (first version {first:.4f} ms, "
            f"{first / t:.2f}x{before}; {library}; bound {b:.4f} ms); card {power_line}")

    # -- 26. the serving loop on the card at full width ----------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    serving_loop(dev, lib, main_launches, power_line)

    # -- 27. multi-rate serving and the live display path ----------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    multirate_and_display(dev, lib, main_launches, power_line)

    # -- 28. the stream mesh over ranks ----------------------------------------
    torch.cuda.empty_cache()
    mesh_serving(main_launches, power_line)

    # -- 29. the autotuner's launch shapes ---------------------------------------
    torch.cuda.empty_cache()
    tuner_phase(dev, lib, main_launches, power_line)

    # -- 30. the ring write at the display cells' shape ----------------------
    torch.cuda.empty_cache()
    ring_phase(dev, stats, ms, plain_ms, bounds, library_ms, power_line)

    log(f"[30] whole run {time.perf_counter() - t_start:.1f} s")
    print(power_line)
    print(json.dumps({"kernels": [
        dict(meta, route="cuda", launches=main_launches[k], max_abs_err=stats[k],
             ms=ms[k], plain_ms=plain_ms[k], bound_ms=bounds[k][0],
             bound_by=bounds[k][1], library_ms=library_ms[k])
        for k, meta in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def display_path(cfg, dev, lib, main_launches: dict) -> dict:
    """Phase 9 at one geometry; adds its launch counts to `main_launches`
    and returns its timings (phase 10)."""
    n = cfg.padded_size
    p = SpectrogramPipeline(cfg, chunk_hops=K, packed_output=True, device=dev)
    s, t = DISPLAY_STREAMS, p.chunk_size
    pid = np.arange(s) % len(p.schemes)
    state = p.set_palette(p.init_state(s), pid)
    pcm = torch.from_numpy(
        testing.chirp_tone(s, DISPLAY_PUSHES * t, cfg.sample_rate, seed=5)).to(dev)
    padded = torch.cat([torch.zeros(s, p.carry_size, 2, device=dev), pcm], dim=1)
    plain = p.with_plain_kernels()
    plain_state = state._replace(ring=state.ring.clone())
    torch.cuda.synchronize()

    # the path a display user drives: pushes, the one-shot form, renders
    lib.reset_launches()
    rows = []
    for i in range(DISPLAY_PUSHES):
        state, r = p.push(state, pcm[:, i * t : (i + 1) * t])
        rows.append(r)
    streamed = torch.cat(rows, dim=1)
    one_shot = {}
    for palette in range(len(p.schemes)):
        sel = torch.from_numpy(np.flatnonzero(pid == palette)).to(dev)
        one_shot[palette] = (sel, p.process(padded.index_select(0, sel), palette_id=palette))
    views = {w: p.render_viewport(state, w) for w in (None, RENDER_WIDTH)}
    torch.cuda.synchronize()
    launches = dict(lib.launches)
    for name in main_launches:
        main_launches[name] += launches.get(name, 0)
    log(f"[9] display N={n}: {DISPLAY_PUSHES} pushes x {s} streams -> "
        f"{tuple(streamed.shape)}, ring {tuple(state.ring.shape)} "
        f"({state.ring.numel() * 2 / 2**30:.2f} GiB), cursor {int(state.cursor)}, "
        f"row_count {int(state.row_count)}; launches {launches}")
    allk_or_a = sk.KERNEL if n & (n - 1) == 0 else sk.MIXED_KERNEL
    if not all(launches[name] > 0 for name in (sk.ALLK_KERNEL, allk_or_a, ck.KERNEL)):
        fail("the display path did not launch every kernel")
    if launches.get(rk.KERNEL, 0) != DISPLAY_PUSHES:
        fail(f"the display path launched the ring write {launches.get(rk.KERNEL, 0)} times "
             f"in {DISPLAY_PUSHES} pushes")
    if streamed.shape != (s, DISPLAY_PUSHES * K, cfg.viewport_height):
        fail("display rows have the wrong shape")
    for palette, (sel, one) in one_shot.items():
        if not torch.equal(one, streamed.index_select(0, sel)):
            fail(f"streamed rows differ from process() for palette {palette} at N={n}")
    log("[9] streamed rows equal process() exactly, every palette")
    del one_shot, streamed

    worst = 0
    for i in range(DISPLAY_PUSHES):
        plain_state, r = plain.push(plain_state, pcm[:, i * t : (i + 1) * t])
        worst = max(worst, testing.rgba_u8_diff(ck.unpack_rgba_device(rows[i]),
                                                ck.unpack_rgba_device(r)))
    carry_equal = torch.equal(plain_state.carry, state.carry)
    ulps = max(testing.bf16_ulps(state.ring[i : i + 16], plain_state.ring[i : i + 16], STFT_ATOL)
               for i in range(0, s, 16))
    log(f"[9] against the plain path: rows max u8 diff {worst} over what the image shows "
        f"(bar 1); ring {ulps:.3f} bf16 ulps beyond atol {STFT_ATOL} (bar 1); next carry "
        f"{'equal' if carry_equal else 'DIFFERS'}")
    if worst > 1 or ulps > 1 or not carry_equal:
        fail(f"the display push disagrees with its plain version at N={n}")
    del rows, plain_state

    for w, view in views.items():
        want = plain.render_viewport(state, w)
        rows_out = w or p.viewport_rows
        if view.shape != (s, rows_out, cfg.viewport_height):
            fail("render_viewport has the wrong shape")
        diff = max(testing.rgba_u8_diff(ck.unpack_rgba_device(view[i : i + 16]),
                                        ck.unpack_rgba_device(want[i : i + 16]))
                   for i in range(0, s, 16))
        log(f"[9] render_viewport width {w}: {tuple(view.shape)}, max u8 diff {diff} "
            f"against the plain render (bar 1)")
        if diff > 1:
            fail(f"render_viewport disagrees with the plain render at N={n}")
        del want
    del views

    chunk = pcm[:, :t]
    box = [state, plain.push(state._replace(ring=state.ring.clone()), chunk)[0]]

    def push(q=p, i=0):
        box[i], _ = q.push(box[i], chunk)

    timings = dict(
        push_ms=time_ms(push),
        plain_push_ms=time_ms(lambda: push(plain, 1)),
        render_ms=time_ms(lambda: p.render_viewport(state), iters=5),
        plain_render_ms=time_ms(lambda: plain.render_viewport(state), iters=3),
        render_w_ms=time_ms(lambda: p.render_viewport(state, RENDER_WIDTH), iters=5),
    )
    del box, state, pcm, padded
    return timings


def ring_phase(dev, stats, ms, plain_ms, bounds, library_ms, power_line: str) -> None:
    """Phase 30: the ring write at the display cells' shape, bit for bit
    the plain version on the same planes, and its times."""
    cfg, s, r = DEFAULT_CONFIG, RING_STREAMS, RING_ROWS
    p = SpectrogramPipeline(cfg, chunk_hops=K, viewport_rows=r, packed_output=True,
                            device=dev)
    b = cfg.num_bins
    length = cfg.window_size + (K - 1) * cfg.hop_size
    buf = testing.chirp_tone(s, length, cfg.sample_rate, seed=30)
    bl, br = (torch.from_numpy(np.ascontiguousarray(buf[..., c])).to(dev) for c in (0, 1))
    ml, mr = sk.stft_mag_packed_allk(bl, br, p.hann, p.fft_consts, K, cfg.hop_size)
    del buf, bl, br
    for plane, shift in ((ml, 0), (mr, 1)):
        for step, col, value in ((97, 5, float("nan")), (89, 7, float("inf")),
                                 (83, 9, 3.0e38), (79, 11, 1.0e-40)):
            plane[shift::step, col] = value
    ring = torch.full((s, r, 2, b), 7.0, dtype=torch.bfloat16, device=dev)
    fill = ring[0, 0, 0, 0].view(torch.int16).clone()
    want = torch.empty((s, K, 2, b), dtype=torch.bfloat16, device=dev)
    rk.ring_write_plain(want, torch.zeros((), dtype=torch.int32, device=dev), ml, mr, K)
    for c in (0, r - K):
        cursor = torch.tensor(c, dtype=torch.int32, device=dev)
        rk.ring_write(ring, cursor, ml, mr, K)
        torch.cuda.synchronize()
        same = torch.equal(ring[:, c:c + K].view(torch.int16), want.view(torch.int16))
        untouched = all(
            bool((part.view(torch.int16) == fill).all())
            for i in range(0, s, 128) for part in (ring[i:i + 128, :c], ring[i:i + 128, c + K:]))
        log(f"[30] ring_write at cursor {c}: rows {'equal' if same else 'DIFFER from'} "
            f"ring_write_plain's bit for bit; other rows {'untouched' if untouched else 'CHANGED'}")
        if not (same and untouched):
            fail(f"the ring write disagrees with its plain version at cursor {c}")
        ring[:, c:c + K] = 7.0
    stats[rk.KERNEL] = 0.0
    cursor = torch.tensor(r - K, dtype=torch.int32, device=dev)
    ms[rk.KERNEL] = device_ms(lambda: rk.ring_write(ring, cursor, ml, mr, K))
    plain_ms[rk.KERNEL] = device_ms(lambda: rk.ring_write_plain(ring, cursor, ml, mr, K))
    del ring
    small = torch.zeros((s, 64, 2, b), dtype=torch.bfloat16, device=dev)
    cursor = torch.tensor(64 - K, dtype=torch.int32, device=dev)
    small_ms = device_ms(lambda: rk.ring_write(small, cursor, ml, mr, K))
    small_plain = device_ms(lambda: rk.ring_write_plain(small, cursor, ml, mr, K))
    del small
    cast_ms = device_ms(lambda: (ml.to(torch.bfloat16), mr.to(torch.bfloat16)))
    bounds[rk.KERNEL] = bound(s * K * 2 * b * (4 + 2), 0)
    library_ms[rk.KERNEL] = None
    log(f"[30] ring_write, {s} streams, k={K}, {b} bins, bf16 ring of {r} rows: "
        f"{ms[rk.KERNEL]:.4f} ms device time (plain {plain_ms[rk.KERNEL]:.4f} ms; into a "
        f"64-row ring {small_ms:.4f} ms, plain {small_plain:.4f} ms; the ATen cast of the same "
        f"planes to bf16 {cast_ms:.4f} ms; bound {bounds[rk.KERNEL][0]:.4f} ms by "
        f"{bounds[rk.KERNEL][1]}); card {power_line}")


def serving_kernels(dev, stats, ms, plain_ms, bounds, library_ms, redesign) -> None:
    """Phase 11, and phase 13's kernel times: the blockwise colormap at
    10,240 rows of BENCH_CONFIG on sorted tables (uniform blocks) and on
    scattered ones (mixed blocks), staged, and at 4,096 rows of N=16,384 on
    sorted tables, direct: bit for bit kernel B and within 1 u8 of its
    plain version; the int16 forms of kernel A (N=4096, N=4800) and of
    the all-windows kernel (k=8, 4096 streams), bit for bit the f32 kernels
    on x / 32768 and within phase 3's bar of their plain versions."""
    cfg = BENCH_CONFIG
    rows = SERVING_STREAMS[0]
    p = SpectrogramPipeline(cfg, chunk_hops=1, store_ring=False, packed_output=True,
                            device=dev)
    left, right = windows(cfg, "chirp_tone", rows, dev)
    ml, mr = sk.stft_mag_packed(left, right, p.hann, p.fft_consts)
    ts = p._cmap_ts(rows)
    name = ck.BLOCKWISE_KERNEL
    for layout, ids in (("sorted", np.sort(np.arange(rows) % 19)),
                        ("scattered", np.arange(rows) % 19)):
        tables = p.builtin_tables.index_select(0, torch.from_numpy(ids).to(dev)).contiguous()
        _blockwise_check(ml, mr, p.taps, tables, cfg, ts, ids, layout, "staged", stats)
        if layout == "sorted":
            b_ms = device_ms(lambda: ck.colormap_builtin(ml, mr, p.taps, tables, cfg))
            ms[name] = device_ms(lambda: ck.colormap_blockwise(ml, mr, p.taps, tables, cfg,
                                                               block_rows=ts))
            plain_ms[name] = time_ms(
                lambda: ck.colormap_blockwise_plain(ml, mr, p.taps, tables, cfg), iters=5)
            bounds[name] = bound(*cmap_work(rows, p.taps, tables.numel()))
            library_ms[name] = None
            floor = sector_floor(rows, p.taps, ml.shape[1], tables.numel())
            log(f"[13] colormap_blockwise, {rows} rows, sorted tables: {ms[name]:.4f} ms "
                f"device time (kernel B on the same tables {b_ms:.4f} ms; plain "
                f"{plain_ms[name]:.4f} ms; bound {bounds[name][0]:.4f} ms by {bounds[name][1]}, "
                f"sector floor {floor:.4f} ms)")
            # block_rows changes no output, nor the launch
            sweep = {br: device_ms(lambda: ck.colormap_blockwise(ml, mr, p.taps, tables, cfg,
                                                                 block_rows=br))
                     for br in (32, 64, 128)}
            one = p.builtin_tables[:1].contiguous()
            one_ms = device_ms(lambda: ck.colormap_builtin(ml, mr, p.taps, one, cfg))
            log("[13] colormap_blockwise by block_rows: " + ", ".join(
                f"{br}: {t:.4f} ms" for br, t in sweep.items())
                + f"; kernel B with one table for all rows {one_ms:.4f} ms")
            redesign["blockwise sorted, 10240 rows"] = (ms[name], None, bounds[name][0])
    del left, right, ml, mr, tables
    # the direct form: the long windows' spans, sorted tables
    lp = SpectrogramPipeline(LONG_COLORMAP, chunk_hops=1, store_ring=False,
                             packed_output=True, device=dev)
    rows = STREAMS
    left, right = windows(LONG_COLORMAP, "chirp_tone", rows, dev)
    ml, mr = sk.stft_mag_packed(left, right, lp.hann, lp.fft_consts)
    ids = np.sort(np.arange(rows) % 19)
    tables = lp.builtin_tables.index_select(0, torch.from_numpy(ids).to(dev)).contiguous()
    ts = lp._cmap_ts(rows)
    _blockwise_check(ml, mr, lp.taps, tables, LONG_COLORMAP, ts, ids, "sorted", "direct",
                     stats)
    t = device_ms(lambda: ck.colormap_blockwise(ml, mr, lp.taps, tables, LONG_COLORMAP,
                                                block_rows=ts))
    b_ms = device_ms(lambda: ck.colormap_builtin(ml, mr, lp.taps, tables, LONG_COLORMAP))
    log(f"[13] colormap_blockwise at N={LONG_COLORMAP.padded_size}, {rows} rows, sorted "
        f"tables, the direct form: {t:.4f} ms device time (kernel B {b_ms:.4f} ms; bound "
        f"{bound(*cmap_work(rows, lp.taps, tables.numel()))[0]:.4f} ms)")
    del left, right, ml, mr, tables

    hop = cfg.hop_size
    cases = (
        (sk.KERNEL_I16, sk.KERNEL, cfg, (STREAMS, cfg.window_size), None),
        (sk.MIXED_KERNEL_I16, sk.MIXED_KERNEL, DEFAULT_CONFIG,
         (STREAMS, DEFAULT_CONFIG.window_size), None),
        (sk.ALLK_KERNEL_I16, sk.ALLK_KERNEL, cfg,
         (STREAMS, cfg.window_size + (K - 1) * hop), K),
    )
    for name, f32_name, c, shape, k in cases:
        pp = SpectrogramPipeline(c, chunk_hops=1, store_ring=False, packed_output=True,
                                 device=dev)
        pcm = testing.chirp_tone(shape[0], shape[1], c.sample_rate, seed=13)
        words = [torch.from_numpy(np.ascontiguousarray(
            np.round(pcm[..., ch] * 32767.0).astype(np.int16))).to(dev) for ch in range(2)]
        scaled = [w.to(torch.float32) / 32768.0 for w in words]
        if k is None:
            def kernel(x, hann):
                return sk.stft_mag_packed(*x, hann, pp.fft_consts)

            def plain():
                return sk.stft_mag_packed_plain(*words, pp.hann_i16, c.padded_size)
            rows_out = shape[0]
        else:
            def kernel(x, hann):
                return sk.stft_mag_packed_allk(*x, hann, pp.fft_consts, k, hop)

            def plain():
                return sk.stft_mag_packed_allk_plain(*words, pp.hann_i16, c.padded_size, k, hop)
            rows_out = k * shape[0]
        got = kernel(words, pp.hann_i16)
        same = all(torch.equal(g, x) for g, x in zip(got, kernel(scaled, pp.hann)))
        err, rel, ok = stft_errors(got, plain())
        log(f"[11] {KERNELS[name]['name']} N={c.padded_size} planes {tuple(words[0].shape)} int16: "
            f"{'equals' if same else 'DIFFERS from'} {KERNELS[f32_name]['name']} on x/32768; "
            f"against plain: max abs err {err:.3e}, max rel err {rel:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not same or not ok:
            fail(f"{KERNELS[name]['name']} disagrees with the f32 kernel or its plain version")
        stats[name] = err
        f32_ms = device_ms(lambda: kernel(scaled, pp.hann))
        ms[name] = device_ms(lambda: kernel(words, pp.hann_i16))
        plain_ms[name] = time_ms(plain, iters=5)
        bounds[name] = bound(*stft_work(rows_out, c.padded_size, c.window_size,
                                        words[0].numel(), sample_bytes=2))
        library_ms[name] = library_ms[f32_name]
        if name == sk.KERNEL_I16:
            redesign["kernel A int16 N=4096"] = (ms[name], library_ms[name], bounds[name][0])
        log(f"[13] {KERNELS[name]['name']}: {ms[name]:.4f} ms device time (the f32 kernel on the same "
            f"samples {f32_ms:.4f} ms; plain {plain_ms[name]:.4f} ms; torch.fft.fft "
            f"{library_ms[name]:.4f} ms; bound {bounds[name][0]:.4f} ms by {bounds[name][1]})")
        del words, scaled, got


def _blockwise_check(ml, mr, taps, tables, cfg, ts, ids, layout: str, form: str,
                     stats) -> None:
    """Phase 11's bars for one call of the blockwise colormap: the `form`
    its launch takes, bit for bit kernel B on the same tables, within 1 u8
    of its plain version."""
    rows = ml.shape[0]
    got = ck.colormap_blockwise(ml, mr, taps, tables, cfg, block_rows=ts)
    same = torch.equal(got, ck.colormap_builtin(ml, mr, taps, tables, cfg))
    diff = testing.rgba_u8_diff(
        ck.unpack_rgba_device(got),
        ck.unpack_rgba_device(ck.colormap_blockwise_plain(ml, mr, taps, tables, cfg)))
    blocks = [ids[b : b + ts] for b in range(0, rows, ts)]
    uniform = sum(int((b == b[0]).all()) for b in blocks)
    got_form = ck.tile_form(taps, cfg.lut_resolution)
    log(f"[11] colormap_blockwise at N={cfg.padded_size}, {rows} rows, {layout} tables, "
        f"the {got_form} form (span {taps.span}): {uniform} of "
        f"{len(blocks)} {ts}-row blocks uniform; {'equals' if same else 'DIFFERS from'} "
        f"kernel B; max u8 diff {diff} against the plain version (bar 1)")
    if got_form != form or not same or diff > 1:
        fail(f"colormap_blockwise: not the {form} form, or disagrees with kernel B or its "
             f"plain version")
    stats[ck.BLOCKWISE_KERNEL] = max(stats.get(ck.BLOCKWISE_KERNEL, 0), diff)


def serving_path(s: int, dev, lib, main_launches: dict) -> dict:
    """Phase 12 at S streams of BENCH_CONFIG (k=1, no ring), palettes
    arange(S) % 19: the sorted push and the full serving mode, launch counts
    added to `main_launches`; returns phase 13's timings."""
    cfg = BENCH_CONFIG
    kw = dict(chunk_hops=1, store_ring=False, packed_output=True, device=dev)
    p = SpectrogramPipeline(cfg, **kw)                         # palette_sort on
    per_row = SpectrogramPipeline(cfg, palette_sort=False, **kw)
    full = SpectrogramPipeline(cfg, i16_planes=True, presorted_input=True,
                               sorted_output=True, **kw)
    ids = np.arange(s) % len(p.schemes)
    state = p.set_palette(p.init_state(s), ids)
    blocks = p._push_block_streams(s)
    # from 12,288 streams: 4096-stream sort blocks, inside which 19 palettes
    # run too short for the colormap's blocks, so the sort is global
    want = ((4, p._STREAM_BLOCK_SIZE) if s >= p._STREAM_BLOCK_AUTO_MIN else (3, 0))
    log(f"[12] {s} streams: tables {[tuple(t.shape) for t in state.tables]}, sort blocks "
        f"{blocks or 'none'}, blockwise {p._state_blockwise(state)}")
    if (len(state.tables), blocks) != want or not p._state_blockwise(state):
        fail(f"the {s}-stream layout did not take the expected palette sort")
    rstate = per_row.set_palette(per_row.init_state(s), ids)
    fstate = full.set_palette(full.init_state(s), ids)
    plain, pstate = p.with_plain_kernels(), state
    t = p.chunk_size
    pcm = testing.chirp_tone(s, SERVING_PUSHES * t, cfg.sample_rate, seed=14)
    words = np.round(pcm * 32767.0).astype(np.int16)
    perm, out = full.input_perm(fstate), torch.from_numpy(full.output_perm(fstate)).to(dev)
    wire = [torch.from_numpy(words[:, i * t : (i + 1) * t]).to(dev) for i in range(SERVING_PUSHES)]
    f32 = [w.to(torch.float32) / 32768.0 for w in wire]
    presorted = [w.index_select(0, torch.from_numpy(perm).to(dev)) for w in wire]
    del pcm, words

    # the main path: the sorted push, then the full serving mode
    torch.cuda.synchronize()
    lib.reset_launches()
    sorted_rows = []
    for c in f32:
        state, r = p.push(state, c)
        sorted_rows.append(r)
    torch.cuda.synchronize()
    launches = {"sorted": dict(lib.launches)}
    lib.reset_launches()
    full_rows = []
    for c in presorted:
        fstate, r = full.push(fstate, c)
        full_rows.append(r)
    torch.cuda.synchronize()
    launches["full"] = dict(lib.launches)
    for counts in launches.values():
        for n, v in counts.items():
            main_launches[n] = main_launches.get(n, 0) + v
    log(f"[12] {s} streams, launches: sorted "
        f"{ {n: v for n, v in launches['sorted'].items() if v} }; full serving mode "
        f"{ {n: v for n, v in launches['full'].items() if v} }")
    if not (launches["sorted"][ck.BLOCKWISE_KERNEL] and launches["sorted"][sk.KERNEL]
            and launches["full"][ck.BLOCKWISE_KERNEL] and launches["full"][sk.KERNEL_I16]):
        fail("the serving path did not launch the blockwise and int16 kernels")

    worst, equal_rows, equal_full = 0, True, True
    for i, c in enumerate(f32):
        rstate, rr = per_row.push(rstate, c)
        pstate, pr = plain.push(pstate, c)
        equal_rows &= torch.equal(sorted_rows[i], rr)
        equal_full &= torch.equal(full_rows[i].index_select(0, out), sorted_rows[i])
        worst = max(worst, testing.rgba_u8_diff(ck.unpack_rgba_device(sorted_rows[i]),
                                                ck.unpack_rgba_device(pr)))
    ginv = p._global_perms(state)[1]
    carry_ok = (torch.equal(state.carry.index_select(0, ginv), rstate.carry)
                and torch.equal(pstate.carry, state.carry)
                and torch.equal(fstate.carry.to(torch.float32) / 32768.0, state.carry))
    log(f"[12] {s} streams, {SERVING_PUSHES} pushes: sorted rows "
        f"{'equal' if equal_rows else 'DIFFER from'} per-row rows; full serving mode "
        f"rows[output_perm] {'equal' if equal_full else 'DIFFER from'} the f32 sorted rows; "
        f"max u8 diff {worst} against the plain kernels (bar 1); carries "
        f"{'exact' if carry_ok else 'DIFFER'} (carry[inv] = per-row carry)")
    if not (equal_rows and equal_full and carry_ok) or worst > 1:
        fail(f"the {s}-stream serving path disagrees")
    del sorted_rows, full_rows, pstate

    box = {"per_row": rstate, "sorted": state, "full": fstate}
    pipes = {"per_row": (per_row, f32[0]), "sorted": (p, f32[0]), "full": (full, presorted[0])}

    def push(key):
        pipe, chunk = pipes[key]
        box[key], _ = pipe.push(box[key], chunk)

    timings = {key: [] for key in pipes}
    for key in (*pipes, *reversed(pipes)):       # in turns: a b c c b a
        timings[key].append(time_ms(lambda: push(key)))
    return timings


def i16_paths(dev, lib, main_launches: dict) -> None:
    """Phase 12, int16 planes on the other STFT kernels: DEFAULT_CONFIG at
    k=1 (the mixed-radix int16 kernel) and BENCH_CONFIG at k=8 (the int16
    all-windows kernel), 4096 streams, no ring, palettes arange(S) % 19, two
    pushes of int16 chunks: rows and carries bit for bit the f32 pipeline's
    on the same chunks (scaled by 1/32768 on the device)."""
    for cfg, k, name in ((DEFAULT_CONFIG, 1, sk.MIXED_KERNEL_I16),
                         (BENCH_CONFIG, K, sk.ALLK_KERNEL_I16)):
        kw = dict(chunk_hops=k, store_ring=False, packed_output=True, device=dev)
        p16 = SpectrogramPipeline(cfg, i16_planes=True, **kw)
        p32 = SpectrogramPipeline(cfg, **kw)
        ids = np.arange(STREAMS) % len(p16.schemes)
        s16 = p16.set_palette(p16.init_state(STREAMS), ids)
        s32 = p32.set_palette(p32.init_state(STREAMS), ids)
        t = p16.chunk_size
        words = np.round(testing.chirp_tone(STREAMS, 2 * t, cfg.sample_rate, seed=15)
                         * 32767.0).astype(np.int16)
        chunks = [torch.from_numpy(words[:, i * t : (i + 1) * t]).to(dev) for i in range(2)]
        del words
        torch.cuda.synchronize()
        lib.reset_launches()
        rows16 = []
        for c in chunks:
            s16, r = p16.push(s16, c)
            rows16.append(r)
        torch.cuda.synchronize()
        launches = {n: v for n, v in lib.launches.items() if v}
        for n, v in launches.items():
            main_launches[n] += v
        same = True
        for c, r16 in zip(chunks, rows16):
            s32, r32 = p32.push(s32, c)
            same &= torch.equal(r16, r32)
        carry_ok = torch.equal(s16.carry.to(torch.float32) / 32768.0, s32.carry)
        log(f"[12] i16_planes at N={cfg.padded_size}, k={k}, {STREAMS} streams: launches "
            f"{launches}; rows {'equal' if same else 'DIFFER from'} the f32 pipeline's, "
            f"carry {'exact' if carry_ok else 'DIFFERS'}")
        if not launches.get(name) or not same or not carry_ok:
            fail(f"the int16 path through {KERNELS[name]['name']} disagrees")
        del chunks, rows16, s16, s32


def serving_timing(serving: dict, power_line: str) -> None:
    """Phase 13: ms/push and rows/s of the three serving pipelines."""
    for s, timings in serving.items():
        for key, label in (("per_row", "per-row (palette_sort=False)"),
                           ("sorted", "sorted (the defaults)"),
                           ("full", "full serving mode (i16 + presorted + sorted_output)")):
            runs = " / ".join(f"{t:.4f}" for t in timings[key])
            rates = " / ".join(f"{s / t * 1e3:.1f}" for t in timings[key])
            log(f"[13] {s} streams, {label}: {runs} ms/push = {rates} rows/s")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[13] peak device memory over phases 11-13: {peak:.2f} GiB; card {power_line}")


def registry():
    """smoke-custom (`testing.custom_scheme`, outside the built-in
    structure) + 3 built-ins: a generic registry."""
    from spectrogram_tpu_torch.color.colorscheme import DEFAULT_COLOR_SCHEMES

    return (testing.custom_scheme(),) + DEFAULT_COLOR_SCHEMES[:PALETTE_REGISTRY - 1]


def u8_diff(got: torch.Tensor, want: torch.Tensor, everywhere: bool) -> int:
    """Largest u8 difference of two packed images: every channel everywhere,
    or over what the image shows (testing.rgba_u8_diff)."""
    a, b = ck.unpack_rgba_device(got), ck.unpack_rgba_device(want)
    if everywhere:
        return int((a.to(torch.int32) - b.to(torch.int32)).abs().max())
    return testing.rgba_u8_diff(a, b)


def palette_kernels(dev, stats, ms, plain_ms, bounds, library_ms, redesign) -> None:
    """Phase 14, and phase 16's kernel times: the generic and static
    colormaps against their plain versions, and the static kernel's two
    identities, at 4096 rows of BENCH_CONFIG."""
    from spectrogram_tpu_torch.color.colorscheme import scheme_index

    cfg = BENCH_CONFIG
    p = SpectrogramPipeline(cfg, chunk_hops=1, store_ring=False, packed_output=True,
                            device=dev)
    pg = SpectrogramPipeline(cfg, chunk_hops=1, store_ring=False, packed_output=True,
                             schemes=registry(), device=dev)
    if pg.generic_tables is None:
        fail("the custom registry did not take the generic tables")
    taps = p.taps
    ids = torch.arange(STREAMS, device=dev) % PALETTE_REGISTRY
    u, v = (t.index_select(0, ids).contiguous() for t in pg.generic_tables)
    u1, v1 = (t[:1].contiguous() for t in pg.generic_tables)
    gu, gv = ck.generic_color_tables(32, registry())
    builtin = ck.builtin_color_tables(32)
    statics = {"Magma": builtin[scheme_index("Magma")],
               "Blue-Yellow-Red (Stereo)": builtin[scheme_index("Blue-Yellow-Red (Stereo)")],
               "smoke-custom": (gu[0], gv[0])}
    gen, sta = ck.GENERIC_KERNEL, ck.STATIC_KERNEL
    planes = {}
    for kind in ("chirp_tone", "noise"):
        left, right = windows(cfg, kind, STREAMS, dev)
        ml, mr = sk.stft_mag_packed(left, right, p.hann, p.fft_consts)
        planes[kind] = (ml, mr)
        everywhere = kind == "noise"
        for label, (a, b) in (("per-row tables arange(S) % 4", (u, v)), ("one table", (u1, v1))):
            got = ck.colormap_generic(ml, mr, taps, a, b, cfg)
            diff = u8_diff(got, ck.colormap_generic_plain(ml, mr, taps, a, b, cfg), everywhere)
            log(f"[14] colormap_generic {kind}, {label}: max u8 diff {diff} against the "
                f"plain version (bar 1) {'ok' if diff <= 1 else 'FAIL'}")
            if diff > 1:
                fail("colormap_generic disagrees with its plain version")
            stats[gen] = max(stats.get(gen, 0), diff)
        for name, table in statics.items():
            got = ck.colormap_static(ml, mr, taps, table, cfg)
            diff = u8_diff(got, ck.colormap_static_plain(ml, mr, taps, table, cfg), everywhere)
            if isinstance(table, tuple):
                one = ck.colormap_generic(ml, mr, taps, u1, v1, cfg)
                twin = "the generic kernel with one table"
            else:
                one = ck.colormap_builtin(
                    ml, mr, taps, torch.from_numpy(table[None]).to(dev), cfg)
                twin = "kernel B with one table"
            same = torch.equal(got, one)
            log(f"[14] colormap_static {kind}, {name}: {'equals' if same else 'DIFFERS from'} "
                f"{twin} bit for bit; max u8 diff {diff} against the plain version (bar 1)")
            if not same or diff > 1:
                fail(f"colormap_static disagrees on {name}")
            stats[sta] = max(stats.get(sta, 0), diff)

    ml, mr = planes["chirp_tone"]
    magma, custom = statics["Magma"], statics["smoke-custom"]
    one_b = p.builtin_tables[1:2].contiguous()
    per_row_b = p.builtin_tables.index_select(0, torch.arange(STREAMS, device=dev) % 19).contiguous()
    calls = {
        "generic per-row": lambda: ck.colormap_generic(ml, mr, taps, u, v, cfg),
        "generic one table": lambda: ck.colormap_generic(ml, mr, taps, u1, v1, cfg),
        "static Magma": lambda: ck.colormap_static(ml, mr, taps, magma, cfg),
        "static smoke-custom": lambda: ck.colormap_static(ml, mr, taps, custom, cfg),
        "kernel B per-row": lambda: ck.colormap_builtin(ml, mr, taps, per_row_b, cfg),
        "kernel B one table": lambda: ck.colormap_builtin(ml, mr, taps, one_b, cfg),
    }
    torch.cuda.empty_cache()
    # device time, and the back-to-back time of the other phases beside it
    t = {k: device_ms(fn) for k, fn in calls.items()}
    back_to_back = {k: time_ms(fn) for k, fn in calls.items()}
    ms[gen], ms[sta] = t["generic per-row"], t["static Magma"]
    plain_ms[gen] = time_ms(lambda: ck.colormap_generic_plain(ml, mr, taps, u, v, cfg), iters=5)
    plain_ms[sta] = time_ms(lambda: ck.colormap_static_plain(ml, mr, taps, magma, cfg), iters=5)
    plain_one_b = time_ms(lambda: ck.colormap_builtin_plain(ml, mr, taps, one_b, cfg), iters=5)
    plain_one_g = time_ms(lambda: ck.colormap_generic_plain(ml, mr, taps, u1, v1, cfg), iters=5)
    plain_static_g = time_ms(lambda: ck.colormap_static_plain(ml, mr, taps, custom, cfg), iters=5)
    one_g_bound = bound(*cmap_work(STREAMS, taps, u1.numel() + v1.numel(),
                                   CMAP_OPS_PER_PIXEL_GENERIC))
    bounds[gen] = bound(*cmap_work(STREAMS, taps, u.numel() + v.numel(),
                                   CMAP_OPS_PER_PIXEL_GENERIC))
    bounds[sta] = bound(*cmap_work(STREAMS, taps, 0))
    static_generic_bound = bound(*cmap_work(STREAMS, taps, 0, CMAP_OPS_PER_PIXEL_GENERIC))
    library_ms[gen] = library_ms[sta] = None
    redesign["generic per-row, 4096 rows"] = (ms[gen], None, bounds[gen][0])
    bins = ml.shape[1]
    log(f"[16] colormap kernels, {STREAMS} rows, chirp+tone, device time (back to back): "
        + "; ".join(f"{k} {x:.4f} ({back_to_back[k]:.4f}) ms" for k, x in t.items()))
    log(f"[16] colormap_generic (per-row): {ms[gen]:.4f} ms (plain {plain_ms[gen]:.4f} ms, "
        f"bound {bounds[gen][0]:.4f} ms by {bounds[gen][1]}, sector floor "
        f"{sector_floor(STREAMS, taps, bins, u.numel() + v.numel()):.4f} ms); "
        f"colormap_static (Magma): "
        f"{ms[sta]:.4f} ms (plain {plain_ms[sta]:.4f} ms, bound {bounds[sta][0]:.4f} ms by "
        f"{bounds[sta][1]}, sector floor {sector_floor(STREAMS, taps, bins, 0):.4f} ms); "
        f"static generic: plain {plain_static_g:.4f} ms, bound "
        f"{static_generic_bound[0]:.4f} ms; generic with one table: plain {plain_one_g:.4f} ms, "
        f"bound {one_g_bound[0]:.4f} ms; kernel B with one table: plain {plain_one_b:.4f} ms")
    del planes, ml, mr, u, v


def palette_paths(dev, lib, main_launches: dict) -> None:
    """Phase 15: the static and generic paths through SpectrogramPipeline,
    launch counts added to `main_launches`."""
    cfg = BENCH_CONFIG
    reg = registry()
    paths = (
        ("static Magma, k=1", dict(chunk_hops=1, store_ring=False,
                                   static_palette="Magma"), STREAMS, None, 4),
        ("static stereo, k=8", dict(chunk_hops=K, store_ring=False,
                                    static_palette="Blue-Yellow-Red (Stereo)"),
         DISPLAY_STREAMS, None, 2),
        ("generic, k=1", dict(chunk_hops=1, store_ring=False, schemes=reg), STREAMS,
         "scattered, then one", 4),
        ("generic, k=8, ring", dict(chunk_hops=K, schemes=reg), DISPLAY_STREAMS,
         "scattered", DISPLAY_PUSHES),
    )
    for label, kw, s, layout, n in paths:
        p = SpectrogramPipeline(cfg, packed_output=True, device=dev, **kw)
        name = ck.STATIC_KERNEL if p.static_table is not None else ck.GENERIC_KERNEL
        state = p.init_state(s)
        if layout is not None:
            state = p.set_palette(state, np.arange(s) % PALETTE_REGISTRY)
        else:
            try:
                p.set_palette(state, 2)
                fail("set_palette on a static pipeline did not raise")
            except ValueError:
                pass
        t = p.chunk_size
        pcm = torch.from_numpy(testing.chirp_tone(s, n * t, cfg.sample_rate, seed=16)).to(dev)
        plain = p.with_plain_kernels()
        plain_state = state._replace(ring=state.ring.clone())
        start = state
        torch.cuda.synchronize()
        lib.reset_launches()
        rows, states = [], []
        for i in range(n):
            if layout == "scattered, then one" and i == n // 2:
                state = p.set_palette(state, 0)          # generic, one (u, v) pair
                states.append(state)
            state, r = p.push(state, pcm[:, i * t : (i + 1) * t])
            rows.append(r)
        views = ({w: p.render_viewport(state, w) for w in (None, RENDER_WIDTH)}
                 if p.store_ring else {})
        torch.cuda.synchronize()
        launches = dict(lib.launches)
        for k_, v in launches.items():
            main_launches[k_] = main_launches.get(k_, 0) + v
        log(f"[15] {label}, {s} streams, {n} pushes: tables "
            f"{[tuple(x.shape) for x in state.tables]}; launches "
            f"{ {k_: v for k_, v in launches.items() if v} }")
        if not launches[name] or launches[ck.BLOCKWISE_KERNEL]:
            fail(f"{label}: the {KERNELS[name]['name']} kernel did not launch, or the "
                 "blockwise kernel did")
        if states and states[0].tables[0].shape[0] != 1:
            fail("a scalar set_palette on the generic registry kept per-row tables")

        # streamed == process(), per palette and per stretch of one layout
        streamed = torch.cat(rows, dim=1)
        padded = torch.cat([torch.zeros(s, p.carry_size, 2, device=dev), pcm], dim=1)
        k = p.chunk_hops
        stretch = n // 2 if states else n
        ids = start.palette_id.cpu().numpy()
        for palette in np.unique(ids):
            sel = torch.from_numpy(np.flatnonzero(ids == palette)).to(dev)
            one = p.process(padded.index_select(0, sel), palette_id=int(palette))
            if not torch.equal(one[:, : stretch * k], streamed.index_select(0, sel)[:, : stretch * k]):
                fail(f"{label}: streamed rows differ from process() for palette {palette}")
        if states:
            one = p.process(padded, palette_id=0)
            if not torch.equal(one[:, stretch * k :], streamed[:, stretch * k :]):
                fail(f"{label}: streamed rows differ from process() after set_palette")
        del padded

        worst = 0
        for i in range(n):
            if states and i == n // 2:
                plain_state = plain_state._replace(tables=states[0].tables)
            plain_state, r = plain.push(plain_state, pcm[:, i * t : (i + 1) * t])
            worst = max(worst, u8_diff(rows[i], r, everywhere=False))
        carry_ok = torch.equal(plain_state.carry, state.carry)
        view_diff = max((u8_diff(view, plain.render_viewport(state, w), everywhere=False)
                         for w, view in views.items()), default=0)
        log(f"[15] {label}: streamed rows equal process() exactly; against the plain "
            f"path: rows max u8 diff {worst}, next carry {'equal' if carry_ok else 'DIFFERS'}"
            + (f", render_viewport at {p.viewport_rows} and {RENDER_WIDTH} max u8 diff "
               f"{view_diff}" if views else "") + " (bar 1)")
        if worst > 1 or view_diff > 1 or not carry_ok:
            fail(f"{label}: the path disagrees with its plain version")
        del rows, states, streamed, views, pcm, state, plain_state, start


def palette_timing(dev, power_line: str) -> None:
    """Phase 16: ms/push and rows/s of the six table kinds at 4096 streams,
    k=1, no ring, in turns."""
    cfg = BENCH_CONFIG
    kw = dict(chunk_hops=1, store_ring=False, packed_output=True, device=dev)
    reg = registry()
    s = STREAMS
    setups = {
        "built-in per-row": (dict(), np.arange(s) % 19),
        "built-in uniform": (dict(), 1),
        "static built-in (Magma)": (dict(static_palette="Magma"), None),
        "generic per-row": (dict(schemes=reg), np.arange(s) % PALETTE_REGISTRY),
        "generic uniform": (dict(schemes=reg), 0),
        "static generic (smoke-custom)": (dict(schemes=reg, static_palette=0), None),
    }
    chunk = torch.from_numpy(testing.chirp_tone(s, cfg.hop_size, cfg.sample_rate, seed=17)).to(dev)
    box = {}
    for label, (extra, ids) in setups.items():
        p = SpectrogramPipeline(cfg, **kw, **extra)
        state = p.init_state(s)
        box[label] = [p, state if ids is None else p.set_palette(state, ids)]

    def push(label):
        p, state = box[label]
        box[label][1], _ = p.push(state, chunk)

    timings = {label: [] for label in setups}
    for label in (*setups, *reversed(setups)):       # in turns: a b ... b a
        timings[label].append(time_ms(lambda: push(label)))
    for label, runs in timings.items():
        log(f"[16] k=1 push, {s} streams, {label}: "
            + " / ".join(f"{x:.4f}" for x in runs) + " ms/push = "
            + " / ".join(f"{s / x * 1e3:.1f}" for x in runs) + " rows/s")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[16] peak device memory over phases 14-16: {peak:.2f} GiB; card {power_line}")


# -- 17-19. the split-real STFT family ------------------------------------------

SPLIT_SERVING = SERVING_STREAMS[0]


def split_kernels(dev, stats, ms, plain_ms, bounds, library_ms, redesign) -> None:
    """Phase 17: the four split-real kernels at the paths' shapes against
    their plain versions, their three bitwise identities with the
    window-plane kernel, tsplit's next carry, and their times."""
    from spectrogram_tpu_torch.ops import fft_plan

    names = (sk.SPLIT_KERNEL, sk.SPLIT_ALLK_KERNEL, sk.SPLIT_T_KERNEL, sk.SPLIT_TSPLIT_KERNEL)

    def check(name, label, got, want):
        _check_stft(17, stats, (name,), f"{KERNELS[name]['name']} {label}", got, want)

    def identity(label, got, want):
        _identity(17, label, got, want)

    for c in (DEFAULT_CONFIG, BENCH_CONFIG):       # BENCH's inputs stay for timing
        n, w = c.padded_size, c.window_size
        hann = torch.from_numpy(sk.split_hann(w)).to(dev)
        tw = sk.fft_constants(n, dev)
        left, right = windows(c, "chirp_tone", STREAMS, dev)
        planes = sk.stft_mag_split(left, right, hann, tw)
        check(sk.SPLIT_KERNEL, f"{STREAMS} rows, N={n}", planes,
              sk.stft_mag_split_plain(left, right, hann, n))
    plan = fft_plan.make_plan(BENCH_CONFIG)
    n1, m, hop = plan.n1, plan.m, BENCH_CONFIG.hop_size
    t_cols = hop // n1
    x = torch.stack([left, right], 1).reshape(STREAMS, 2, m, n1).transpose(2, 3).contiguous()
    t_mags = sk.stft_mag_split_t(x, hann, tw)
    check(sk.SPLIT_T_KERNEL, f"[{STREAMS}, 2, {n1}, {m}]", t_mags,
          sk.stft_mag_split_t_plain(x, hann, n))
    identity("stft_split_t == stft_split on the same windows", t_mags, planes)
    carry = x[..., : m - t_cols].contiguous()
    chunk = x[..., m - t_cols :].contiguous()
    ts = sk.stft_mag_split_tsplit(carry, chunk, hann, tw)
    check(sk.SPLIT_TSPLIT_KERNEL, f"carry {tuple(carry.shape)} + chunk {tuple(chunk.shape)}",
          ts[:2], sk.stft_mag_split_tsplit_plain(carry, chunk, hann, n)[:2])
    identity("stft_split_tsplit == stft_split on the same windows", ts[:2], planes)
    framed = torch.cat([carry, chunk], dim=3)[..., t_cols:]     # the torch framing
    identity("stft_split_tsplit's next carry == the transposed framing's", ts[2:], (framed,))
    length = BENCH_CONFIG.window_size + (K - 1) * hop
    buf = testing.chirp_tone(STREAMS, length, BENCH_CONFIG.sample_rate, seed=3)
    bl, br = (torch.from_numpy(np.ascontiguousarray(buf[..., ch])).to(dev) for ch in range(2))
    allk = sk.stft_mag_split_allk(bl, br, hann, tw, K, hop)
    check(sk.SPLIT_ALLK_KERNEL, f"k={K}, buffers {tuple(bl.shape)}", allk,
          sk.stft_mag_split_allk_plain(bl, br, hann, n, K, hop))
    w = BENCH_CONFIG.window_size
    wl, wr = (torch.cat([b[:, r * hop : r * hop + w] for r in range(K)]) for b in (bl, br))
    identity("stft_split_allk == stft_split on the extracted windows", allk,
             sk.stft_mag_split(wl, wr, hann, tw))
    torch.cuda.synchronize()
    del t_mags, ts, framed, allk, wl, wr, planes

    calls = {
        sk.SPLIT_KERNEL: (lambda: sk.stft_mag_split(left, right, hann, tw),
                          lambda: sk.stft_mag_split_plain(left, right, hann, n), STREAMS),
        sk.SPLIT_T_KERNEL: (lambda: sk.stft_mag_split_t(x, hann, tw),
                            lambda: sk.stft_mag_split_t_plain(x, hann, n), STREAMS),
        sk.SPLIT_TSPLIT_KERNEL: (lambda: sk.stft_mag_split_tsplit(carry, chunk, hann, tw),
                                 lambda: sk.stft_mag_split_tsplit_plain(carry, chunk, hann, n),
                                 STREAMS),
        sk.SPLIT_ALLK_KERNEL: (lambda: sk.stft_mag_split_allk(bl, br, hann, tw, K, hop),
                               lambda: sk.stft_mag_split_allk_plain(bl, br, hann, n, K, hop),
                               K * STREAMS),
    }
    torch.cuda.empty_cache()
    packed_hann = torch.from_numpy(sk.packed_hann(w)).to(dev)
    packed_ms = device_ms(lambda: sk.stft_mag_packed(left, right, packed_hann, tw))
    for name, (kernel, plain, rows) in calls.items():
        ms[name] = device_ms(kernel)
        plain_ms[name] = time_ms(plain, iters=5)
        nbytes, flops = stft_work(rows, n, w, rows * w)
        if name == sk.SPLIT_TSPLIT_KERNEL:
            nbytes += 4 * carry.numel()          # the next carry it writes
        if name == sk.SPLIT_ALLK_KERNEL:
            nbytes, flops = stft_work(rows, n, w, bl.numel())
        bounds[name] = bound(nbytes, flops)
        real = torch.randn(2 * rows, n, device=dev)
        library_ms[name] = device_ms(lambda: torch.fft.rfft(real))
        del real
        log(f"[17] {KERNELS[name]['name']}, {rows} rows: {ms[name]:.4f} ms device time "
            f"(plain {plain_ms[name]:.4f} ms, torch.fft.rfft [{2 * rows}, {n}] "
            f"{library_ms[name]:.4f} ms, bound {bounds[name][0]:.4f} ms by {bounds[name][1]})")
    log(f"[17] stft_packed (kernel A) on the same {STREAMS} windows: {packed_ms:.4f} ms device time")
    for name, label in ((sk.SPLIT_KERNEL, "stft_split N=4096"),
                        (sk.SPLIT_T_KERNEL, "stft_split_t N=4096"),
                        (sk.SPLIT_ALLK_KERNEL, "stft_split_allk N=4096 k=8"),
                        (sk.SPLIT_TSPLIT_KERNEL, "stft_split_tsplit N=4096")):
        redesign[label] = (ms[name], library_ms[name], bounds[name][0])
    del x, carry, chunk, bl, br, left, right


# (label, config, pipeline arguments, streams, pushes, the kernel it must launch)
LAYOUT_PATHS = (
    ("stft_packed=False, k=1", BENCH_CONFIG,
     dict(chunk_hops=1, store_ring=False, stft_packed=False), STREAMS, PUSHES, sk.SPLIT_KERNEL),
    ("stft_packed=False, k=1, DEFAULT_CONFIG", DEFAULT_CONFIG,
     dict(chunk_hops=1, store_ring=False, stft_packed=False), STREAMS, PUSHES, sk.SPLIT_KERNEL),
    ("stft_packed=False, k=8", BENCH_CONFIG,
     dict(chunk_hops=K, store_ring=False, stft_packed=False), STREAMS, 2, sk.SPLIT_ALLK_KERNEL),
    ("transposed_carry, k=1", BENCH_CONFIG,
     dict(chunk_hops=1, store_ring=False, transposed_carry=True), STREAMS, PUSHES,
     sk.SPLIT_T_KERNEL),
    ("transposed_carry, k=8, ring", BENCH_CONFIG, dict(chunk_hops=K, transposed_carry=True),
     DISPLAY_STREAMS, DISPLAY_PUSHES, sk.SPLIT_T_KERNEL),
    ("tsplit, k=1", BENCH_CONFIG, dict(chunk_hops=1, store_ring=False, framing="tsplit"),
     STREAMS, PUSHES, sk.SPLIT_TSPLIT_KERNEL),
    ("tsplit, sorted", BENCH_CONFIG, dict(chunk_hops=1, store_ring=False, framing="tsplit"),
     SPLIT_SERVING, SERVING_PUSHES, sk.SPLIT_TSPLIT_KERNEL),
    ("tsplit, presorted_input + sorted_output", BENCH_CONFIG,
     dict(chunk_hops=1, store_ring=False, framing="tsplit", presorted_input=True,
          sorted_output=True), SPLIT_SERVING, SERVING_PUSHES, sk.SPLIT_TSPLIT_KERNEL),
)


def layout_paths(dev, lib, main_launches: dict) -> None:
    """Phase 18: each split-real path through SpectrogramPipeline, launch
    counts added to `main_launches`."""
    for label, cfg, kw, s, n, name in LAYOUT_PATHS:
        p = SpectrogramPipeline(cfg, packed_output=True, device=dev, **kw)
        base = dict(chunk_hops=kw["chunk_hops"], store_ring=kw.get("store_ring", True),
                    packed_output=True, device=dev)
        default = SpectrogramPipeline(cfg, **base)
        knob = {k_: v for k_, v in kw.items() if k_ not in ("presorted_input", "sorted_output")}
        per_row = SpectrogramPipeline(cfg, packed_output=True, device=dev, palette_sort=False,
                                      **knob)
        ids = np.arange(s) % len(p.schemes)
        state = p.set_palette(p.init_state(s), ids)
        sorted_state = p._state_perm(state) is not None
        t = p.chunk_size
        pcm = torch.from_numpy(testing.chirp_tone(s, n * t, cfg.sample_rate, seed=18)).to(dev)
        chunks = [pcm[:, i * t : (i + 1) * t] for i in range(n)]
        perm = p.input_perm(state) if p.presorted_input else None
        if perm is not None:
            perm_t = torch.from_numpy(perm).to(dev)
            pushed = [c.index_select(0, perm_t) for c in chunks]
        else:
            pushed = chunks
        out = p.output_perm(state)
        out = None if out is None else torch.from_numpy(out).to(dev)
        plain = p.with_plain_kernels()
        plain_state = state._replace(ring=state.ring.clone())
        start = state
        torch.cuda.synchronize()
        lib.reset_launches()
        rows = []
        for c in pushed:
            state, r = p.push(state, c)
            rows.append(r if out is None else r.index_select(0, out))
        views = ({w: p.render_viewport(state, w) for w in (None, RENDER_WIDTH)}
                 if p.store_ring else {})
        torch.cuda.synchronize()
        launches = {k_: v for k_, v in lib.launches.items() if v}
        for k_, v in launches.items():
            main_launches[k_] = main_launches.get(k_, 0) + v
        log(f"[18] {label}, {s} streams, {n} pushes: carry {tuple(state.carry.shape)}, "
            f"sorted {sorted_state}; launches {launches}")
        if not launches.get(name):
            fail(f"{label}: {KERNELS[name]['name']} did not launch")
        if sorted_state != (s == SPLIT_SERVING):
            fail(f"{label}: the palette sort did not decide as expected")

        # streamed == process(), per palette
        streamed = torch.cat(rows, dim=1)
        padded = torch.cat([torch.zeros(s, p.carry_size, 2, device=dev), pcm], dim=1)
        for palette in range(len(p.schemes)):
            sel = torch.from_numpy(np.flatnonzero(ids == palette)).to(dev)
            one = p.process(padded.index_select(0, sel), palette_id=palette)
            if not torch.equal(one, streamed.index_select(0, sel)):
                fail(f"{label}: streamed rows differ from process() for palette {palette}")
        del padded

        # the plain versions, the per-row pipeline, the default packed pipeline
        worst_plain = worst_default = 0
        equal_per_row = True
        rstate = per_row.set_palette(per_row.init_state(s), ids) if sorted_state else None
        dstate = default.set_palette(default.init_state(s), ids)
        for i, c in enumerate(chunks):
            plain_state, r = plain.push(plain_state, pushed[i])
            if out is not None:
                r = r.index_select(0, out)
            worst_plain = max(worst_plain, u8_diff(rows[i], r, everywhere=False))
            if sorted_state:
                rstate, rr = per_row.push(rstate, c)
                equal_per_row &= torch.equal(rows[i], rr)
            dstate, dr = default.push(dstate, c)
            worst_default = max(worst_default, u8_diff(rows[i], dr, everywhere=False))
        carry_ok = torch.equal(plain_state.carry, state.carry)
        if sorted_state:
            inv = p._global_perms(state)[1]
            carry_ok &= torch.equal(state.carry.index_select(0, inv), rstate.carry)
        ring_ulps = 0.0
        if p.store_ring:
            ring_ulps = max(testing.bf16_ulps(state.ring[i : i + 16], plain_state.ring[i : i + 16],
                                              STFT_ATOL) for i in range(0, s, 16))
        view_diff = max((u8_diff(view, plain.render_viewport(state, w), everywhere=False)
                         for w, view in views.items()), default=0)
        log(f"[18] {label}: streamed rows equal process() exactly; against the plain path "
            f"rows max u8 diff {worst_plain}, carry {'equal' if carry_ok else 'DIFFERS'}"
            + (f", ring {ring_ulps:.3f} bf16 ulps beyond atol, render_viewport at "
               f"{p.viewport_rows} and {RENDER_WIDTH} max u8 diff {view_diff}" if views else "")
            + (f"; sorted rows {'equal' if equal_per_row else 'DIFFER from'} per-row rows"
               if sorted_state else "")
            + f"; against the default packed pipeline max u8 diff {worst_default} (bars 1)")
        if (worst_plain > 1 or not carry_ok or ring_ulps > 1 or view_diff > 1
                or not equal_per_row or worst_default > 1):
            fail(f"{label}: the path disagrees")
        del rows, streamed, views, pcm, chunks, pushed, state, plain_state, start
        del rstate, dstate
        torch.cuda.empty_cache()


def layout_timing(dev, power_line: str) -> None:
    """Phase 19: ms/push (device time) of each split-real push beside the
    default push of the same configuration, in turns a b ... b a."""
    groups = {
        "BENCH_CONFIG, k=1, 4096 streams, no ring": (
            BENCH_CONFIG, dict(chunk_hops=1, store_ring=False), STREAMS,
            {"default (packed)": {}, "stft_packed=False": dict(stft_packed=False),
             "transposed_carry": dict(transposed_carry=True),
             "framing=tsplit": dict(framing="tsplit")}),
        "DEFAULT_CONFIG, k=1, 4096 streams, no ring": (
            DEFAULT_CONFIG, dict(chunk_hops=1, store_ring=False), STREAMS,
            {"default (packed)": {}, "stft_packed=False": dict(stft_packed=False)}),
        "BENCH_CONFIG, k=8, 4096 streams, no ring": (
            BENCH_CONFIG, dict(chunk_hops=K, store_ring=False), STREAMS,
            {"default (packed)": {}, "stft_packed=False": dict(stft_packed=False),
             "transposed_carry": dict(transposed_carry=True)}),
        "BENCH_CONFIG, k=8, ring 2048, 256 streams": (
            BENCH_CONFIG, dict(chunk_hops=K), DISPLAY_STREAMS,
            {"default (packed)": {}, "transposed_carry": dict(transposed_carry=True)}),
        f"BENCH_CONFIG, k=1, {SPLIT_SERVING} streams, sorted": (
            BENCH_CONFIG, dict(chunk_hops=1, store_ring=False), SPLIT_SERVING,
            {"default (packed, sorted)": {}, "framing=tsplit": dict(framing="tsplit"),
             "default + presorted + sorted_output": dict(presorted_input=True,
                                                         sorted_output=True),
             "tsplit + presorted + sorted_output": dict(framing="tsplit", presorted_input=True,
                                                        sorted_output=True)}),
    }
    for group, (cfg, base, s, setups) in groups.items():
        chunk = torch.from_numpy(testing.chirp_tone(
            s, base["chunk_hops"] * cfg.hop_size, cfg.sample_rate, seed=19)).to(dev)
        box = {}
        for label, extra in setups.items():
            p = SpectrogramPipeline(cfg, packed_output=True, device=dev, **base, **extra)
            box[label] = [p, p.set_palette(p.init_state(s), np.arange(s) % len(p.schemes))]

        def push(label):
            p, state = box[label]
            box[label][1], _ = p.push(state, chunk)

        timings = {label: [] for label in setups}
        for label in (*setups, *reversed(setups)):       # in turns: a b ... b a
            timings[label].append(device_ms(lambda: push(label)))
        rows = s * base["chunk_hops"]
        for label, runs in timings.items():
            log(f"[19] {group}, {label}: " + " / ".join(f"{x:.4f}" for x in runs)
                + " ms/push = " + " / ".join(f"{rows / x * 1e3:.1f}" for x in runs) + " rows/s")
        del box, chunk
        torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[19] peak device memory over phases 17-19: {peak:.2f} GiB; card {power_line}")


# -- 20-22. every FFT size; the carry+chunk pair and the fused push ---------------

SIZE_44K = SpectrogramConfig(sample_rate=44100.0)      # W=2205, N=4410 = 2 3^2 5 7^2
N4802 = SpectrogramConfig(sample_rate=48000.0, window_period=2401 / 48000.0)  # 2 7^4
# N with a prime factor above 7 keep the Bluestein body: N=2204 = 2^2 19 29
# (M=4500) and N=1410 = 2 3 5 47 (M=2880)
BLUE_2204 = SpectrogramConfig(sample_rate=44100.0, window_period=1102 / 44100.0)
BLUE_1410 = SpectrogramConfig(sample_rate=44100.0, window_period=0.016, hop_period=0.006)
PAD1 = SpectrogramConfig(sample_rate=48000.0, window_period=2048 / 48000.0,
                         hop_period=800 / 48000.0, pad_factor=1)         # N = W = 2048
# an odd N of the JAX fuzz's range (its seed 5: 16 kHz, W=145, hop 69, pad 3)
ODD = SpectrogramConfig(sample_rate=16000.0, window_period=145 / 16000.0,
                        hop_period=69 / 16000.0, pad_factor=3, viewport_height=100,
                        max_frequency=7950.0)                            # N = 435
# an odd 7-smooth N: the split-real row is the N-point row over
# MixedRadixT<7> (no pack), N = 735 = 3 5 7^2
ODD_735 = SpectrogramConfig(sample_rate=44100.0, window_period=245 / 44100.0,
                            hop_period=64 / 44100.0, pad_factor=3)
# The device times (PERF.md, H100 80GB HBM3, 700 W) of the first versions of
# the redesigned kernels: the split-real rows as N-point transforms (on the
# large-N route from N=17,640), N=4410 and packed N=17,640 on Bluestein; the
# large-N route as four passes (load, local pass, last stage, unpack); kernel
# A and the packed all-windows kernel with one shared-memory pass per
# radix-2 stage; kernel A at N=4800 and 2204 (Bluestein) with one pass per
# mixed-radix stage and its twiddles read from the table, and the
# all-windows kernel at DEFAULT_CONFIG as first measured; kernel B and the
# generic kernel with one pixel per thread and one row per CTA (device time);
# the blockwise colormap at 10,240 sorted serving rows with one CTA per
# block of rows and 128 pixels, before it ran as kernel B (device time); the
# fused push with the N-point split-real row; colormap_rows_fused with one
# pixel per thread (device time); 4096 rows unless named
FIRST_VERSION_MS = {
    "stft_split N=4096": 0.7932, "stft_split_t N=4096": 0.8231,
    "stft_split_allk N=4096 k=8": 6.2293, "stft_split_tsplit N=4096": 0.8144,
    "kernel A N=4410": 1.0516,
    "split-real N=17640": 13.9564, "split-real N=32768": 13.7192,
    "split-real N=48000": 16.3022, "packed N=17640": 7.2398,
    "large route packed N=48000": 12.4223, "large route packed int16 N=48000": 10.3921,
    "large route packed N=32768": 8.8779, "large route split-real N=65536": 15.5659,
    "kernel A N=4096": 0.4221, "kernel A int16 N=4096": 0.4116,
    "stft_allk N=4096 k=8": 3.1884, "stft_allk_carry N=4096 k=8": 3.1917,
    "kernel A N=4800": 0.5696, "kernel A N=2204": 0.4092, "stft_allk N=4800 k=8": 4.3991,
    "kernel B per-row, 4096 rows": 0.0443, "generic per-row, 4096 rows": 0.0577,
    "blockwise sorted, 10240 rows": 0.1386,
    "push_fused N=4096": 0.8176, "colormap_rows_fused, 4096 rows": 0.0506,
}
# The split-real kernels' device times before the radix-2 register passes
# (PERF.md, H100 80GB HBM3, 700 W)
BEFORE_PASSES_MS = {
    "stft_split N=4096": 0.3829, "stft_split_t N=4096": 0.4300,
    "stft_split_allk N=4096 k=8": 2.9907, "stft_split_tsplit N=4096": 0.4212,
    "push_fused N=4096": 0.3929,
}
# The same kernels' device times before the split-real row read its samples
# straight into its first pass and colormap_rows_fused ran the generic row
# tile (PERF.md, H100 80GB HBM3, 700 W)
BEFORE_FUSED_LOAD_MS = {
    "stft_split N=4096": 0.2011, "stft_split_t N=4096": 0.2182,
    "stft_split_allk N=4096 k=8": 1.4634, "stft_split_tsplit N=4096": 0.2716,
    "push_fused N=4096": 0.2296, "colormap_rows_fused, 4096 rows": 0.0506,
}


def _buffers(cfg, streams: int, length: int, seed: int, dev, dtype=torch.float32):
    """[S, L] left and right sample planes of chirp+tone (int16: PCM words)."""
    return testing.chirp_tone_planes(streams, length, cfg.sample_rate, seed, dev, dtype)


def bluestein_kernels(dev, stats, ms, plain_ms, bounds, library_ms, redesign) -> None:
    """Phase 20: kernel A, the split-real plane kernel and the all-windows
    kernel on the Bluestein body (N=1410, 2204, odd 435) and on the radix-7
    mixed-radix body (N=4410, 4802) against their plain versions; device
    times of kernel A at N=2204 (the Bluestein row), at N=1410 and at
    N=4410 beside N=4800, their plain versions, torch.fft.fft, the bounds."""
    for cfg, body in ((BLUE_1410, BLUESTEIN), (BLUE_2204, BLUESTEIN), (ODD, BLUESTEIN),
                      (SIZE_44K, "mixed"), (N4802, "mixed")):
        n, w, h = cfg.padded_size, cfg.window_size, cfg.hop_size
        if sk.fft_body(n) != body:
            fail(f"N={n} does not take the {body} body")
        names = (BLUESTEIN,) if body == BLUESTEIN else ()
        label = f"{body}, M={sk.fft_buf_size(n)}" if body == BLUESTEIN else \
            f"{body} {'-'.join(map(str, sk.mixed_radix_plan(n)))}"
        consts = sk.fft_constants(n, dev)
        hann = torch.from_numpy(sk.packed_hann(w)).to(dev)
        shann = torch.from_numpy(sk.split_hann(w)).to(dev)
        left, right = windows(cfg, "chirp_tone", STREAMS, dev)
        _check_stft(20, stats, (*names, sk.MIXED_KERNEL),
                    f"stft_mixed ({label}) N={n}, {STREAMS} rows",
                    sk.stft_mag_packed(left, right, hann, consts),
                    sk.stft_mag_packed_plain(left, right, hann, n))
        row = f"pack of N/2={n // 2}" if n % 2 == 0 else "N-point row"
        _check_stft(20, stats, (*names, sk.SPLIT_KERNEL),
                    f"stft_split ({sk.split_route(n)} {row}) N={n}, {STREAMS} rows",
                    sk.stft_mag_split(left, right, shann, consts),
                    sk.stft_mag_split_plain(left, right, shann, n))
        bl, br = _buffers(cfg, STREAMS, w + (K - 1) * h, 3, dev)
        _check_stft(20, stats, (*names, sk.ALLK_KERNEL),
                    f"stft_allk ({label}) N={n}, k={K}, buffers {tuple(bl.shape)}",
                    sk.stft_mag_packed_allk(bl, br, hann, consts, K, h),
                    sk.stft_mag_packed_allk_plain(bl, br, hann, n, K, h))
        torch.cuda.synchronize()
        del bl, br
    n, w = ODD_735.padded_size, ODD_735.window_size
    if sk.split_packs(n) or sk.split_route(n) != "mixed" or 7 not in sk.mixed_radix_plan(n):
        fail(f"N={n}: the split-real row is not the N-point row over radix 7")
    consts = sk.fft_constants(n, dev)
    shann = torch.from_numpy(sk.split_hann(w)).to(dev)
    left, right = windows(ODD_735, "chirp_tone", STREAMS, dev)
    _check_stft(20, stats, (sk.SPLIT_KERNEL,),
                f"stft_split (mixed {'-'.join(map(str, sk.mixed_radix_plan(n)))} N-point row) "
                f"N={n}, {STREAMS} rows", sk.stft_mag_split(left, right, shann, consts),
                sk.stft_mag_split_plain(left, right, shann, n))
    del left, right, consts

    def kernel_a(cfg):
        n, w = cfg.padded_size, cfg.window_size
        consts = sk.fft_constants(n, dev)
        hann = torch.from_numpy(sk.packed_hann(w)).to(dev)
        left, right = windows(cfg, "chirp_tone", STREAMS, dev)
        z = torch.complex(torch.randn(STREAMS, n, device=dev), torch.randn(STREAMS, n, device=dev))
        out = (device_ms(lambda: sk.stft_mag_packed(left, right, hann, consts)),
               time_ms(lambda: sk.stft_mag_packed_plain(left, right, hann, n), iters=5),
               device_ms(lambda: torch.fft.fft(z)), bound(*stft_work(STREAMS, n, w, STREAMS * w)))
        del z, left, right
        return out

    torch.cuda.empty_cache()
    ms[BLUESTEIN], plain_ms[BLUESTEIN], library_ms[BLUESTEIN], bounds[BLUESTEIN] = \
        kernel_a(BLUE_2204)
    n = BLUE_2204.padded_size
    redesign["kernel A N=2204"] = (ms[BLUESTEIN], library_ms[BLUESTEIN], bounds[BLUESTEIN][0])
    log(f"[20] Bluestein body, kernel A at N={n} (M={sk.fft_buf_size(n)}), {STREAMS} rows: "
        f"{ms[BLUESTEIN]:.4f} ms device time (plain {plain_ms[BLUESTEIN]:.4f} ms, torch.fft.fft "
        f"[{STREAMS}, {n}] {library_ms[BLUESTEIN]:.4f} ms, bound {bounds[BLUESTEIN][0]:.4f} ms "
        f"by {bounds[BLUESTEIN][1]})")
    for cfg in (BLUE_1410, SIZE_44K, DEFAULT_CONFIG):
        n = cfg.padded_size
        t, plain, lib_ms, b = kernel_a(cfg)
        log(f"[20] kernel A at N={n} ({sk.fft_body(n)}, buffer {sk.fft_buf_size(n)}), {STREAMS} "
            f"rows: {t:.4f} ms device time (plain {plain:.4f} ms, torch.fft.fft {lib_ms:.4f} ms, "
            f"bound {b[0]:.4f} ms)")
        if n == SIZE_44K.padded_size:
            redesign["kernel A N=4410"] = (t, lib_ms, b[0])
        if n == DEFAULT_CONFIG.padded_size:
            redesign["kernel A N=4800"] = (t, lib_ms, b[0])


# (label, config, pipeline arguments, streams, pushes)
SIZE_PATHS = (
    ("44.1 kHz N=4410, k=1", SIZE_44K, dict(chunk_hops=1, store_ring=False), STREAMS, PUSHES),
    ("44.1 kHz N=4410, k=8, ring", SIZE_44K, dict(chunk_hops=K), DISPLAY_STREAMS,
     DISPLAY_PUSHES),
    ("44.1 kHz N=2204 (Bluestein), k=1", BLUE_2204, dict(chunk_hops=1, store_ring=False),
     STREAMS, PUSHES),
    ("pad_factor=1 N=2048, k=1", PAD1, dict(chunk_hops=1, store_ring=False), STREAMS, PUSHES),
    ("odd N=435, k=1", ODD, dict(chunk_hops=1, store_ring=False), STREAMS, PUSHES),
)


def size_paths(dev, lib, main_launches: dict, paths=SIZE_PATHS, phase: int = 21) -> None:
    """Phase 21 (and 23 with the large-N paths): the pipelines at the sizes
    the port used to refuse, through SpectrogramPipeline on the card; launch
    counts added to `main_launches`."""
    for label, cfg, kw, s, n in paths:
        p = SpectrogramPipeline(cfg, packed_output=True, device=dev, **kw)
        # the split-real rows run the N/2 pack's body, the packed rows N's
        body = (sk.split_route if kw.get("stft_packed") is False else sk.fft_route)(
            cfg.padded_size)
        ids = np.arange(s) % len(p.schemes)
        state = p.set_palette(p.init_state(s), ids)
        t = p.chunk_size
        pcm = torch.from_numpy(testing.chirp_tone(s, n * t, cfg.sample_rate, seed=21)).to(dev)
        plain = p.with_plain_kernels()
        plain_state = state._replace(ring=state.ring.clone())
        torch.cuda.synchronize()
        lib.reset_launches()
        rows = []
        for i in range(n):
            state, r = p.push(state, pcm[:, i * t : (i + 1) * t])
            rows.append(r)
        streamed = torch.cat(rows, dim=1)
        padded = torch.cat([torch.zeros(s, p.carry_size, 2, device=dev), pcm], dim=1)
        one_shot = {}
        for palette in np.unique(ids).tolist():
            sel = torch.from_numpy(np.flatnonzero(ids == palette)).to(dev)
            one_shot[palette] = (sel, p.process(padded.index_select(0, sel), palette_id=palette))
        views = ({w: p.render_viewport(state, w) for w in (None, RENDER_WIDTH)}
                 if p.store_ring else {})
        torch.cuda.synchronize()
        launches = {k_: v for k_, v in lib.launches.items() if v}
        launches[BLUESTEIN] = lib.body_launches[BLUESTEIN]
        body_count = lib.body_launches[body]
        for k_, v in launches.items():
            main_launches[k_] = main_launches.get(k_, 0) + v
        res = cfg.lut_resolution
        forms = (f"kernel B {ck.tile_form(p.taps, res)} over {p.taps.span} of "
                 f"{p.taps.bins} bins" + (f", render_viewport's {ck.tile_form(p.ring_taps, res)}"
                                          if p.store_ring else ""))
        log(f"[{phase}] {label} (W={cfg.window_size}, hop {cfg.hop_size}, pad {cfg.pad_factor}, "
            f"{body} body), {s} streams, {n} pushes: rows {tuple(streamed.shape)}, carry "
            f"{tuple(state.carry.shape)}, ring {tuple(state.ring.shape)}; launches {launches}; "
            f"{body} launches {body_count}; {forms}")
        if not body_count:
            fail(f"{label}: the {body} body did not launch")
        if streamed.shape != (s, n * p.chunk_hops, cfg.viewport_height):
            fail(f"{label}: rows have the wrong shape")
        for palette, (sel, one) in one_shot.items():
            if not torch.equal(one, streamed.index_select(0, sel)):
                fail(f"{label}: streamed rows differ from process() for palette {palette}")
        del one_shot, padded

        worst = 0
        for i in range(n):
            plain_state, r = plain.push(plain_state, pcm[:, i * t : (i + 1) * t])
            worst = max(worst, u8_diff(rows[i], r, everywhere=False))
        carry_ok = torch.equal(plain_state.carry, state.carry)
        ring_ulps = 0.0
        if p.store_ring:
            step = max(1, (1 << 27) // state.ring[0].numel())   # f32 copies of 0.5 GB
            ring_ulps = max(testing.bf16_ulps(state.ring[i : i + step],
                                              plain_state.ring[i : i + step], STFT_ATOL)
                            for i in range(0, s, step))
        view_diff = max((u8_diff(view, plain.render_viewport(state, w), everywhere=False)
                         for w, view in views.items()), default=0)
        log(f"[{phase}] {label}: streamed rows equal process() exactly; against the plain path "
            f"rows max u8 diff {worst}, carry {'equal' if carry_ok else 'DIFFERS'}"
            + (f", ring {ring_ulps:.3f} bf16 ulps beyond atol, render_viewport at "
               f"{p.viewport_rows} and {RENDER_WIDTH} max u8 diff {view_diff}" if views else "")
            + " (bars 1)")
        if worst > 1 or not carry_ok or ring_ulps > 1 or view_diff > 1:
            fail(f"{label}: the path disagrees with its plain version")
        del rows, streamed, views, pcm, state, plain_state
        torch.cuda.empty_cache()


SIZE_TIMING = {
    f"k=1, {STREAMS} streams, no ring": (
        dict(chunk_hops=1, store_ring=False), STREAMS,
        {"DEFAULT_CONFIG 48 kHz (N=4800)": (DEFAULT_CONFIG, {}),
         "44.1 kHz (N=4410)": (SIZE_44K, {}), "BENCH_CONFIG (N=4096)": (BENCH_CONFIG, {}),
         "pad_factor=1 (N=2048)": (PAD1, {}), "odd N=435": (ODD, {})}),
    f"k={K}, ring 2048, {DISPLAY_STREAMS} streams": (
        dict(chunk_hops=K), DISPLAY_STREAMS,
        {"DEFAULT_CONFIG 48 kHz (N=4800)": (DEFAULT_CONFIG, {}),
         "44.1 kHz (N=4410)": (SIZE_44K, {})}),
}


def size_timing(dev, power_line: str, groups=SIZE_TIMING, phase: int = 21,
                phases: str = "20-21") -> None:
    """Phase 21's (and 23's) timing: ms/push (device time) of each size
    beside the 48 kHz DEFAULT_CONFIG push of the same shape, in turns a b
    ... b a; `groups` maps a label to (pipeline arguments, streams, {label:
    (config, more arguments)})."""
    for group, (base, s, setups) in groups.items():
        box = {}
        for label, (cfg, more) in setups.items():
            p = SpectrogramPipeline(cfg, packed_output=True, device=dev, **base, **more)
            chunk = torch.from_numpy(testing.chirp_tone(
                s, p.chunk_size, cfg.sample_rate, seed=19)).to(dev)
            box[label] = [p, p.set_palette(p.init_state(s), np.arange(s) % len(p.schemes)),
                          chunk]

        def push(label):
            p, state, chunk = box[label]
            box[label][1], _ = p.push(state, chunk)

        timings = {label: [] for label in setups}
        for label in (*setups, *reversed(setups)):       # in turns: a b ... b a
            timings[label].append(device_ms(lambda: push(label)))
        rows = s * base["chunk_hops"]
        for label, runs in timings.items():
            log(f"[{phase}] {group}, {label}: " + " / ".join(f"{x:.4f}" for x in runs)
                + " ms/push = " + " / ".join(f"{rows / x * 1e3:.1f}" for x in runs) + " rows/s")
        del box
        torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{phase}] peak device memory over phases {phases}: {peak:.2f} GiB; card {power_line}")


def carry_pair_and_push(dev, lib, main_launches: dict, stats, ms, plain_ms, bounds,
                        library_ms, power_line: str, redesign: dict) -> None:
    """Phase 22: the split kernel (k=1, k=8), `emit_carry` on the packed
    (f32, int16) and split-real all-windows kernels (k=8) and the fused
    push (with and without `emit_mags`) through their entry points at
    BENCH_CONFIG, 4096 streams, per-row tables arange(S) % 19; their
    identities and plain versions; device times."""
    cfg = BENCH_CONFIG
    n, w, h = cfg.padded_size, cfg.window_size, cfg.hop_size
    c = w - h
    s = STREAMS
    consts = sk.fft_constants(n, dev)
    hann = torch.from_numpy(sk.packed_hann(w)).to(dev)
    hann16 = torch.from_numpy(sk.packed_hann_i16(w)).to(dev)
    shann = torch.from_numpy(sk.split_hann(w)).to(dev)
    pcm = {k: testing.chirp_tone(s, c + k * h, cfg.sample_rate, seed=22 + k) for k in (1, K)}
    carry_chunk = {k: tuple(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1))).to(dev)
                            for x in (v[:, :c], v[:, c:]))
                   for k, v in pcm.items()}
    bufs = _buffers(cfg, s, w + (K - 1) * h, 22, dev)
    bufs16 = _buffers(cfg, s, w + (K - 1) * h, 22, dev, torch.int16)
    left, right = windows(cfg, "chirp_tone", s, dev)
    tables = ck.builtin_color_tables(32)[np.arange(s) % 19]
    tables = torch.from_numpy(tables).to(dev)
    mt = cmap_ops.resample_matrix_full(cfg).T
    taps = ck.resample_taps(mt.T, dev)
    torch.cuda.synchronize()

    # the main path of this slice: the entry points a JAX caller maps to
    lib.reset_launches()
    split = {k: sk.stft_mag_fused2_split(*carry_chunk[k], cfg, k=k) for k in (1, K)}
    carried = {
        sk.ALLK_CARRY_KERNEL: sk.stft_mag_packed_allk(*bufs, hann, consts, K, h, emit_carry=True),
        sk.ALLK_CARRY_KERNEL_I16: sk.stft_mag_packed_allk(*bufs16, hann16, consts, K, h,
                                                          emit_carry=True),
        sk.SPLIT_ALLK_CARRY_KERNEL: sk.stft_mag_split_allk(*bufs, shann, consts, K, h,
                                                           emit_carry=True),
    }
    pushed = {e: pk.push_fused_single(left, right, tables, mt, cfg, emit_mags=e)
              for e in (False, True)}
    torch.cuda.synchronize()
    launches = {k_: v for k_, v in lib.launches.items() if v}
    for k_, v in launches.items():
        main_launches[k_] = main_launches.get(k_, 0) + v
    log(f"[22] entry points at BENCH_CONFIG, {s} streams: launches {launches}")
    for name in (sk.SPLIT_CARRY_KERNEL, *carried, pk.KERNEL):
        if not launches.get(name):
            fail(f"{KERNELS[name]['name']} did not launch on its path")

    # the split kernel: the all-windows split kernel's rows on the
    # concatenated buffers, bit for bit; the next carry the buffers' tail
    for k, got in split.items():
        carry, chunk = carry_chunk[k]
        buf = torch.cat([carry, chunk], dim=2)
        allk = sk.stft_mag_split_allk(buf[:, 0].contiguous(), buf[:, 1].contiguous(), shann,
                                      consts, k, h)
        _identity(22, f"stft_split_carry k={k} == stft_split_allk on the concatenated buffers",
                  got[:2], allk)
        _identity(22, f"stft_split_carry k={k}: next carry == the buffers' last {c} samples",
                  got[2:], (buf[:, :, buf.shape[2] - c :],))
        _check_stft(22, stats, (sk.SPLIT_CARRY_KERNEL,), f"stft_split_carry k={k}", got[:2],
                    sk.stft_mag_split_carry_plain(carry, chunk, shann, n, k, h)[:2])
        del buf, allk
    # emit_carry: the same magnitudes as without it, the buffers' tail
    for name, got in carried.items():
        b, hn = (bufs16, hann16) if name == sk.ALLK_CARRY_KERNEL_I16 else (
            bufs, shann if name == sk.SPLIT_ALLK_CARRY_KERNEL else hann)
        wrapper, plain = ((sk.stft_mag_split_allk, sk.stft_mag_split_allk_plain)
                          if name == sk.SPLIT_ALLK_CARRY_KERNEL
                          else (sk.stft_mag_packed_allk, sk.stft_mag_packed_allk_plain))
        label = KERNELS[name]["name"]
        _identity(22, f"{label}: magnitudes == without emit_carry", got[:2],
                  wrapper(*b, hn, consts, K, h))
        _identity(22, f"{label}: next carry == the buffers' last {c} samples "
                  f"({got[2].dtype})", got[2:], (sk.buffer_tails(*b, c),))
        _check_stft(22, stats, (name,), f"{label} k={K}", got[:2], plain(*b, hn, n, K, h))
    # the fused push: split planes -> kernel B, bit for bit
    planes = sk.stft_mag_split(left, right, shann, consts)
    chain = ck.colormap_builtin(*planes, taps, tables, cfg)
    plain_rows = pk.push_fused_plain(left, right, shann, n, tables, taps, cfg)
    for emit, got in pushed.items():
        words = got[0] if emit else got
        _identity(22, f"push_fused (emit_mags={emit}) == stft_split -> colormap_builtin",
                  (words, *got[1:]) if emit else (words,),
                  (chain, *planes) if emit else (chain,))
        diff = u8_diff(words, plain_rows, everywhere=False)
        log(f"[22] push_fused (emit_mags={emit}): max u8 diff {diff} against its plain "
            f"version over what the image shows (bar 1)")
        if diff > 1:
            fail("push_fused disagrees with its plain version")
        stats[pk.KERNEL] = max(stats.get(pk.KERNEL, 0), diff)
    del split, carried, pushed, plain_rows
    torch.cuda.empty_cache()

    # device times
    carry8, chunk8 = carry_chunk[K]

    def framed_allk():
        # the framing the split kernel removes (two concatenations), then
        # the all-windows split kernel
        bl = torch.cat([carry8[:, 0], chunk8[:, 0]], dim=1)
        br = torch.cat([carry8[:, 1], chunk8[:, 1]], dim=1)
        return sk.stft_mag_split_allk(bl, br, shann, consts, K, h)

    bl8 = torch.cat([carry8[:, 0], chunk8[:, 0]], dim=1)
    br8 = torch.cat([carry8[:, 1], chunk8[:, 1]], dim=1)
    t = {
        "stft_split_carry k=8": device_ms(lambda: sk.stft_mag_split_carry(
            carry8, chunk8, shann, consts, K, h)),
        "stft_split_allk k=8": device_ms(lambda: sk.stft_mag_split_allk(
            bl8, br8, shann, consts, K, h)),
        "two concatenations + stft_split_allk k=8": device_ms(framed_allk),
        "stft_split_carry k=1": device_ms(lambda: sk.stft_mag_split_carry(
            *carry_chunk[1], shann, consts, 1, h)),
        "stft_allk k=8": device_ms(lambda: sk.stft_mag_packed_allk(*bufs, hann, consts, K, h)),
        "stft_allk_carry k=8": device_ms(lambda: sk.stft_mag_packed_allk(
            *bufs, hann, consts, K, h, emit_carry=True)),
        "stft_allk_carry_i16 k=8": device_ms(lambda: sk.stft_mag_packed_allk(
            *bufs16, hann16, consts, K, h, emit_carry=True)),
        "stft_split_allk_carry k=8": device_ms(lambda: sk.stft_mag_split_allk(
            *bufs, shann, consts, K, h, emit_carry=True)),
        "push_fused": device_ms(lambda: pk.push_fused(left, right, shann, consts, tables,
                                                      taps, cfg)),
        "push_fused emit_mags": device_ms(lambda: pk.push_fused(
            left, right, shann, consts, tables, taps, cfg, emit_mags=True)),
        "stft_split + colormap_builtin": device_ms(lambda: ck.colormap_builtin(
            *sk.stft_mag_split(left, right, shann, consts), taps, tables, cfg)),
    }
    log(f"[22] device time at BENCH_CONFIG, {s} streams: "
        + "; ".join(f"{k_} {x:.4f} ms" for k_, x in t.items()))
    ms[sk.SPLIT_CARRY_KERNEL] = t["stft_split_carry k=8"]
    ms[sk.ALLK_CARRY_KERNEL] = t["stft_allk_carry k=8"]
    ms[sk.ALLK_CARRY_KERNEL_I16] = t["stft_allk_carry_i16 k=8"]
    ms[sk.SPLIT_ALLK_CARRY_KERNEL] = t["stft_split_allk_carry k=8"]
    ms[pk.KERNEL] = t["push_fused"]
    plain_ms[sk.SPLIT_CARRY_KERNEL] = time_ms(lambda: sk.stft_mag_split_carry_plain(
        carry8, chunk8, shann, n, K, h), iters=5)
    plain_ms[sk.ALLK_CARRY_KERNEL] = time_ms(lambda: sk.stft_mag_packed_allk_plain(
        *bufs, hann, n, K, h, emit_carry=True), iters=5)
    plain_ms[sk.ALLK_CARRY_KERNEL_I16] = time_ms(lambda: sk.stft_mag_packed_allk_plain(
        *bufs16, hann16, n, K, h, emit_carry=True), iters=5)
    plain_ms[sk.SPLIT_ALLK_CARRY_KERNEL] = time_ms(lambda: sk.stft_mag_split_allk_plain(
        *bufs, shann, n, K, h, emit_carry=True), iters=5)
    plain_ms[pk.KERNEL] = time_ms(lambda: pk.push_fused_plain(
        left, right, shann, n, tables, taps, cfg), iters=5)
    rows8 = K * s
    carry_bytes = 4 * 2 * s * c
    bounds[sk.SPLIT_CARRY_KERNEL] = bound(
        *np.add(stft_work(rows8, n, w, carry8.numel() // 2 + chunk8.numel() // 2),
                (carry_bytes, 0)))
    bounds[sk.ALLK_CARRY_KERNEL] = bound(
        *np.add(stft_work(rows8, n, w, bufs[0].numel()), (carry_bytes, 0)))
    bounds[sk.ALLK_CARRY_KERNEL_I16] = bound(
        *np.add(stft_work(rows8, n, w, bufs16[0].numel(), sample_bytes=2), (carry_bytes // 2, 0)))
    bounds[sk.SPLIT_ALLK_CARRY_KERNEL] = bounds[sk.ALLK_CARRY_KERNEL]
    stft_b, stft_f = stft_work(s, n, w, s * w)
    cmap_b, cmap_f = cmap_work(s, taps, tables.numel())
    # the fused push reads no planes: its bytes are the STFT's inputs and
    # the colormap's taps, tables and words
    plane_bytes = 4 * 2 * s * (n // 2)
    touched = 4 * 2 * s * torch.unique(torch.cat([taps.j0, taps.j1])).numel()
    bounds[pk.KERNEL] = bound(stft_b - plane_bytes + cmap_b - touched, stft_f + cmap_f)
    real8 = torch.randn(2 * rows8, n, device=dev)
    rfft8 = device_ms(lambda: torch.fft.rfft(real8))
    del real8
    z8 = torch.complex(torch.randn(rows8, n, device=dev), torch.randn(rows8, n, device=dev))
    fft8 = device_ms(lambda: torch.fft.fft(z8))
    del z8
    real1 = torch.randn(2 * s, n, device=dev)
    rfft1 = device_ms(lambda: torch.fft.rfft(real1))
    del real1
    library_ms[sk.SPLIT_CARRY_KERNEL] = library_ms[sk.SPLIT_ALLK_CARRY_KERNEL] = rfft8
    library_ms[sk.ALLK_CARRY_KERNEL] = library_ms[sk.ALLK_CARRY_KERNEL_I16] = fft8
    library_ms[pk.KERNEL] = None
    redesign["push_fused N=4096"] = (ms[pk.KERNEL], None, bounds[pk.KERNEL][0])
    redesign["stft_allk_carry N=4096 k=8"] = (ms[sk.ALLK_CARRY_KERNEL], fft8,
                                              bounds[sk.ALLK_CARRY_KERNEL][0])
    for name in (sk.SPLIT_CARRY_KERNEL, sk.ALLK_CARRY_KERNEL, sk.ALLK_CARRY_KERNEL_I16,
                 sk.SPLIT_ALLK_CARRY_KERNEL, pk.KERNEL):
        log(f"[22] {KERNELS[name]['name']}: {ms[name]:.4f} ms device time (plain "
            f"{plain_ms[name]:.4f} ms, library {library_ms[name]} ms, bound "
            f"{bounds[name][0]:.4f} ms by {bounds[name][1]})")
    log(f"[22] torch.fft.rfft [{2 * s}, {n}] (the STFT of the k=1 split kernel and the fused "
        f"push): {rfft1:.4f} ms")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[22] peak device memory over phase 22: {peak:.2f} GiB; card {power_line}")


# ------------------------------------------------------------ phases 23-24

# Long windows, each hop 1.2 ms as DEFAULT_CONFIG's.  N = 2^15 (16,384-sample
# window) and 48,000 (0.5 s at 48 kHz): packed rows on the large-N route,
# split-real rows (the N/2 pack) in shared memory; N = 17,640 = 2^3 3^2 5 7^2
# (0.2 s at 44.1 kHz): both in shared memory (radix 7); N = 2^16 (32,768
# samples): split-real rows on the route too; the prime N = 16,411 (window
# planes of 8,205 samples): the route's Bluestein passes (M = 33,614).
LARGE_32K = SpectrogramConfig(sample_rate=48000.0, window_period=16384 / 48000.0)
LARGE_48K = SpectrogramConfig(window_period=0.5)
LARGE_44K = SpectrogramConfig(sample_rate=44100.0, window_period=0.2)
LARGE_64K = SpectrogramConfig(sample_rate=48000.0, window_period=32768 / 48000.0)
# the long-window serving deployment (portbench/configs/serve-long48k.json):
# LARGE_64K's window at BENCH_CONFIG's hop of 800
LONG_SERVE = SpectrogramConfig(sample_rate=48000.0, window_period=32768 / 48000.0,
                               hop_period=800 / 48000.0)
PRIME_N, PRIME_W = 16411, 8205
# split-real packs at kWideThreads threads over radix 7: N = 35,280 (44.1 kHz,
# 0.4 s; N/2 = 17,640 = 4 2 3 3 5 7 7) and N = 16,400 (N/2 = 8200 = 2^3 5^2
# 41: Bluestein over M = 16,807 = 7^5)
WIDE_SEVEN_N, WIDE_BLUE_N, WIDE_ROWS = 35280, 16400, 1024
# a 0.17 s window at 48 kHz: N = 16,320 = 2^6 3 5 17, Bluestein on the route
# for packed rows (M = 32,768) and in shared memory for the split-real pack
# (N/2 = 8,160, M = 16,384: the wide bound)
LARGE_BLUE = SpectrogramConfig(sample_rate=48000.0, window_period=0.17)
LARGE_ALLK_STREAMS = 1024      # k=8 windows each: 8,192 rows
LARGE_DISPLAY_STREAMS = 16     # a 2,048-row ring of 23,999 bins is 196 MB of bf16 per stream
LARGE_SPLIT_STREAMS = 1024     # N = 65,536 split-real: 32,768 bins per channel and row
LARGE_PATHS = (
    ("48 kHz, 0.5 s window (N=48000), k=1", LARGE_48K,
     dict(chunk_hops=1, store_ring=False), STREAMS, PUSHES),
    ("44.1 kHz, 0.2 s window (N=17640), k=1", LARGE_44K,
     dict(chunk_hops=1, store_ring=False), STREAMS, PUSHES),
    ("48 kHz N=48000, k=8, ring", LARGE_48K, dict(chunk_hops=K), LARGE_DISPLAY_STREAMS,
     DISPLAY_PUSHES),
    ("44.1 kHz N=17640, k=8, ring", LARGE_44K, dict(chunk_hops=K), LARGE_DISPLAY_STREAMS,
     DISPLAY_PUSHES),
    ("48 kHz N=48000, stft_packed=False, k=1", LARGE_48K,
     dict(chunk_hops=1, store_ring=False, stft_packed=False), STREAMS, PUSHES),
    ("48 kHz, 32,768-sample window (N=65536), stft_packed=False, k=1", LARGE_64K,
     dict(chunk_hops=1, store_ring=False, stft_packed=False), LARGE_SPLIT_STREAMS, PUSHES),
    ("48 kHz, 0.17 s window (N=16320, Bluestein), k=1", LARGE_BLUE,
     dict(chunk_hops=1, store_ring=False), STREAMS, PUSHES),
    ("48 kHz N=16320 (Bluestein), stft_packed=False, k=1", LARGE_BLUE,
     dict(chunk_hops=1, store_ring=False, stft_packed=False), STREAMS, PUSHES),
)
LARGE_TIMING = {
    f"k=1, {STREAMS} streams, no ring": (
        dict(chunk_hops=1, store_ring=False), STREAMS,
        {"DEFAULT_CONFIG 48 kHz (N=4800)": (DEFAULT_CONFIG, {}),
         "48 kHz 0.5 s (N=48000)": (LARGE_48K, {}),
         "44.1 kHz 0.2 s (N=17640)": (LARGE_44K, {}),
         "48 kHz 0.17 s (N=16320, Bluestein)": (LARGE_BLUE, {}),
         "48 kHz 0.5 s, stft_packed=False": (LARGE_48K, dict(stft_packed=False))}),
    f"k={K}, ring 2048, {LARGE_DISPLAY_STREAMS} streams": (
        dict(chunk_hops=K), LARGE_DISPLAY_STREAMS,
        {"DEFAULT_CONFIG 48 kHz (N=4800)": (DEFAULT_CONFIG, {}),
         "48 kHz 0.5 s (N=48000)": (LARGE_48K, {}),
         "44.1 kHz 0.2 s (N=17640)": (LARGE_44K, {})}),
}


def _large_operands(n: int, w: int, rows: int, dev, sample_rate: float = 48000.0):
    """(left, right) [rows, w] chirp+tone window planes and N's constants and
    windows (packed, packed int16, split-real) on the card."""
    left, right = testing.chirp_tone_planes(rows, w, sample_rate, 1, dev)
    hanns = tuple(torch.from_numpy(f(w)).to(dev) for f in (
        sk.packed_hann, sk.packed_hann_i16, sk.split_hann))
    return left, right, sk.fft_constants(n, dev), hanns


def colormap_direct(dev, stats, cfg, planes) -> None:
    """Phase 23: kernel B and the generic kernel in their direct form (planes
    too wide to stage in shared memory), per-row tables, against their plain
    versions."""
    ml, mr = planes
    rows = ml.shape[0]
    taps = ck.resample_taps(cmap_ops.resample_matrix_full(cfg), dev)
    tables = torch.from_numpy(ck.builtin_color_tables()).to(dev)
    tables = tables[torch.arange(rows, device=dev) % 19].contiguous()
    ids = torch.arange(rows, device=dev) % PALETTE_REGISTRY
    gu, gv = (torch.from_numpy(t).to(dev)[ids].contiguous()
              for t in ck.generic_color_tables(32, registry()))
    for name, got, want in (
            (ck.KERNEL, ck.colormap_builtin(ml, mr, taps, tables, cfg),
             ck.colormap_builtin_plain(ml, mr, taps, tables, cfg)),
            (ck.GENERIC_KERNEL, ck.colormap_generic(ml, mr, taps, gu, gv, cfg),
             ck.colormap_generic_plain(ml, mr, taps, gu, gv, cfg))):
        form = ck.tile_form(taps, cfg.lut_resolution, name == ck.GENERIC_KERNEL)
        diff = u8_diff(got, want, everywhere=True)
        log(f"[23] {KERNELS[name]['name']} at N={cfg.padded_size}, {rows} rows, taps over "
            f"{taps.span} of {taps.bins} bins: the {form} form; max u8 diff {diff} against "
            f"the plain version (bar 1)")
        if form != "direct" or diff > 1:
            fail(f"{KERNELS[name]['name']}: the direct form disagrees with its plain version")
        stats[name] = max(stats[name], diff)


def large_kernels(dev, stats, ms, plain_ms, bounds, library_ms, redesign) -> None:
    """Phase 23's kernels on 4,096 window rows unless named, each against
    its plain version at phase 3's bar: the large-N route's packed kernel
    (f32, int16 == f32 on x/32768, and through the all-windows entry at k=8
    over 1,024 streams, == window planes bit for bit) at N = 32,768 and
    48,000 (its row), and its Bluestein passes at N = 16,411, packed and
    split-real (odd: no pack); its split-real kernel at N = 65,536 (its
    row; all-windows at k=8 over 128 streams); the split-real pack in
    shared memory at N = 17,640, 32,768 and 48,000 (all-windows over 1,024
    streams at 48,000), and kernel A at N = 17,640.  Device times beside
    torch.fft and the bounds."""
    rows = STREAMS

    def timed(name, label, run, plain, library, work):
        t = device_ms(run)
        plain_t = time_ms(plain, iters=3)
        lib_t = device_ms(library)
        b = bound(*work)
        log(f"[23] {KERNELS[name]['name']} {label}: {t:.4f} ms device time (plain "
            f"{plain_t:.4f} ms, library {lib_t:.4f} ms, bound {b[0]:.4f} ms by {b[1]})")
        return t, plain_t, lib_t, b

    # the packed route, and its Bluestein passes (packed and split-real)
    for n, w, sr in ((LARGE_32K.padded_size, LARGE_32K.window_size, 48000.0),
                     (LARGE_48K.padded_size, LARGE_48K.window_size, 48000.0),
                     (LARGE_64K.padded_size, LARGE_64K.window_size, 48000.0),
                     (PRIME_N, PRIME_W, 48000.0)):
        if not sk.is_large(n):
            fail(f"N={n} does not take the large-N route")
        label = f"N={n} ({sk.fft_body(n)}, buffer {sk.fft_buf_size(n)})"
        left, right, consts, (hann, hann16, shann) = _large_operands(n, w, rows, dev, sr)
        words = [torch.round(x * 32767.0).to(torch.int16) for x in (left, right)]
        planes = sk.stft_mag_packed(left, right, hann, consts)
        _check_stft(23, stats, (sk.LARGE_KERNEL,), f"stft_large_packed {label}, {rows} rows",
                    planes, sk.stft_mag_packed_plain(left, right, hann, n))
        if n == LARGE_48K.padded_size:
            colormap_direct(dev, stats, LARGE_48K, planes)
        if n == LARGE_64K.padded_size:
            if sk.large_grouping(n, rows) != (rows, 1, sk.LARGE_SCRATCH_BYTES):
                fail(f"N={n}: {rows} rows are not one row group of exactly 2 GiB")
            colormap_direct(dev, stats, LARGE_64K, planes)
            lp = SpectrogramPipeline(LONG_SERVE, chunk_hops=1, store_ring=False,
                                     packed_output=True, device=dev)
            ids = np.sort(np.arange(rows) % 19)
            tables = lp.builtin_tables.index_select(0, torch.from_numpy(ids).to(dev))
            _blockwise_check(*planes, lp.taps, tables.contiguous(), LONG_SERVE,
                             lp._cmap_ts(rows), ids, "sorted", "direct", stats)
            del lp, tables
        del planes
        i16 = sk.stft_mag_packed(*words, hann16, consts)
        _identity(23, f"stft_large_packed_i16 {label} == f32 on x/32768", i16,
                  sk.stft_mag_packed(*(x.to(torch.float32) / 32768.0 for x in words), hann,
                                     consts))
        _check_stft(23, stats, (sk.LARGE_KERNEL_I16,), f"stft_large_packed_i16 {label}", i16,
                    sk.stft_mag_packed_plain(*words, hann16, n))
        del i16
        if n == PRIME_N:
            if not sk.is_large_split(n):
                fail(f"N={n}: the split-real rows do not take the large-N route")
            _check_stft(23, stats, (sk.LARGE_SPLIT_KERNEL,),
                        f"stft_large_split {label} (odd: the N-point row), {rows} rows",
                        sk.stft_mag_split(left, right, shann, consts),
                        sk.stft_mag_split_plain(left, right, shann, n))
        else:
            h = LARGE_48K.hop_size
            bl, br = _buffers(LARGE_48K, LARGE_ALLK_STREAMS, w + (K - 1) * h, 3, dev)
            wl, wr = (torch.cat([b[:, r * h : r * h + w] for r in range(K)]) for b in (bl, br))
            got = sk.stft_mag_packed_allk(bl, br, hann, consts, K, h)
            _check_stft(23, stats, (sk.LARGE_KERNEL,), f"stft_mag_packed_allk k={K}, {label}, "
                        f"buffers {tuple(bl.shape)}", got,
                        sk.stft_mag_packed_allk_plain(bl, br, hann, n, K, h))
            _identity(23, f"stft_mag_packed_allk {label} == stft_mag_packed on the windows",
                      got, sk.stft_mag_packed(wl, wr, hann, consts))
            del got, wl, wr, bl, br
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        z = torch.complex(torch.randn(rows, n, device=dev), torch.randn(rows, n, device=dev))
        t = {}
        for name, run, plain, hn, sb in (
                (sk.LARGE_KERNEL, lambda: sk.stft_mag_packed(left, right, hann, consts),
                 lambda: sk.stft_mag_packed_plain(left, right, hann, n), hann, 4),
                (sk.LARGE_KERNEL_I16, lambda: sk.stft_mag_packed(*words, hann16, consts),
                 lambda: sk.stft_mag_packed_plain(*words, hann16, n), hann16, 2)):
            t[name] = timed(name, f"{label}, {rows} rows", run, plain,
                            lambda: torch.fft.fft(z), stft_work(rows, n, w, rows * w, sb))
        del z
        if n == LARGE_48K.padded_size:
            for name, (tm, pm, lm, b) in t.items():
                ms[name], plain_ms[name], library_ms[name], bounds[name] = tm, pm, lm, b
        # the route's two passes beside its four (phase 25)
        for name, what in {LARGE_32K.padded_size: ((sk.LARGE_KERNEL, "packed"),),
                           LARGE_48K.padded_size: ((sk.LARGE_KERNEL, "packed"),
                                                   (sk.LARGE_KERNEL_I16, "packed int16"))
                           }.get(n, ()):
            tm, _, lm, b = t[name]
            redesign[f"large route {what} N={n}"] = (tm, lm, b[0])
        del left, right, words
        torch.cuda.empty_cache()

    # the split-real route at N = 65,536 (N/2 = 32,768 past a block)
    cfg = LARGE_64K
    n, w, h = cfg.padded_size, cfg.window_size, cfg.hop_size
    if not sk.is_large_split(n):
        fail(f"N={n}: the split-real rows do not take the large-N route")
    label = f"N={n} (split-real pack of N/2={n // 2} on the route)"
    left, right, consts, (_, _, shann) = _large_operands(n, w, rows, dev)
    _check_stft(23, stats, (sk.LARGE_SPLIT_KERNEL,), f"stft_large_split {label}, {rows} rows",
                sk.stft_mag_split(left, right, shann, consts),
                sk.stft_mag_split_plain(left, right, shann, n))
    streams = 128
    bl, br = _buffers(cfg, streams, w + (K - 1) * h, 3, dev)
    wl, wr = (torch.cat([b[:, r * h : r * h + w] for r in range(K)]) for b in (bl, br))
    got = sk.stft_mag_split_allk(bl, br, shann, consts, K, h)
    _check_stft(23, stats, (sk.LARGE_SPLIT_KERNEL,), f"stft_mag_split_allk k={K}, {label}, "
                f"buffers {tuple(bl.shape)}", got,
                sk.stft_mag_split_allk_plain(bl, br, shann, n, K, h))
    _identity(23, f"stft_mag_split_allk {label} == stft_mag_split on the windows", got,
              sk.stft_mag_split(wl, wr, shann, consts))
    del got, wl, wr, bl, br
    torch.cuda.empty_cache()
    real = torch.randn(2 * rows, n, device=dev)
    name = sk.LARGE_SPLIT_KERNEL
    ms[name], plain_ms[name], library_ms[name], bounds[name] = timed(
        name, f"{label}, {rows} rows",
        lambda: sk.stft_mag_split(left, right, shann, consts),
        lambda: sk.stft_mag_split_plain(left, right, shann, n),
        lambda: torch.fft.rfft(real), stft_work(rows, n, w, rows * w))
    redesign[f"large route split-real N={n}"] = (ms[name], library_ms[name], bounds[name][0])
    del real, left, right
    torch.cuda.empty_cache()

    # the split-real pack in shared memory where the route ran it before,
    # and kernel A at N = 17,640
    for cfg in (LARGE_44K, LARGE_32K, LARGE_48K):
        n, w, h = cfg.padded_size, cfg.window_size, cfg.hop_size
        if sk.is_large_split(n):
            fail(f"N={n}: the split-real pack left shared memory")
        label = (f"N={n} (split-real pack of N/2={n // 2}, {sk.split_route(n)}, "
                 f"{sk.split_buf_size(n) * 8 / 1024:.1f} KB rows)")
        left, right, consts, (hann, _, shann) = _large_operands(n, w, rows, dev, cfg.sample_rate)
        _check_stft(23, stats, (sk.SPLIT_KERNEL,), f"stft_split {label}, {rows} rows",
                    sk.stft_mag_split(left, right, shann, consts),
                    sk.stft_mag_split_plain(left, right, shann, n))
        if n == LARGE_48K.padded_size:
            bl, br = _buffers(cfg, LARGE_ALLK_STREAMS, w + (K - 1) * h, 3, dev)
            wl, wr = (torch.cat([b[:, r * h : r * h + w] for r in range(K)]) for b in (bl, br))
            got = sk.stft_mag_split_allk(bl, br, shann, consts, K, h)
            _check_stft(23, stats, (sk.SPLIT_ALLK_KERNEL,), f"stft_mag_split_allk k={K}, "
                        f"{label}, buffers {tuple(bl.shape)}", got,
                        sk.stft_mag_split_allk_plain(bl, br, shann, n, K, h))
            _identity(23, f"stft_mag_split_allk {label} == stft_mag_split on the windows",
                      got, sk.stft_mag_split(wl, wr, shann, consts))
            del got, wl, wr, bl, br
        torch.cuda.empty_cache()
        real = torch.randn(2 * rows, n, device=dev)
        t, _, lib_t, b = timed(sk.SPLIT_KERNEL, f"{label}, {rows} rows",
                               lambda: sk.stft_mag_split(left, right, shann, consts),
                               lambda: sk.stft_mag_split_plain(left, right, shann, n),
                               lambda: torch.fft.rfft(real), stft_work(rows, n, w, rows * w))
        redesign[f"split-real N={n}"] = (t, lib_t, b[0])
        del real
        if n == LARGE_44K.padded_size:
            if sk.is_large(n) or sk.fft_body(n) != "mixed":
                fail(f"N={n}: kernel A does not take the mixed-radix body")
            _check_stft(23, stats, (sk.MIXED_KERNEL,), f"stft_mixed N={n} (mixed "
                        f"{'-'.join(map(str, sk.mixed_radix_plan(n)))}), {rows} rows",
                        sk.stft_mag_packed(left, right, hann, consts),
                        sk.stft_mag_packed_plain(left, right, hann, n))
            z = torch.complex(torch.randn(rows, n, device=dev), torch.randn(rows, n, device=dev))
            t, _, lib_t, b = timed(sk.MIXED_KERNEL, f"N={n}, {rows} rows",
                                   lambda: sk.stft_mag_packed(left, right, hann, consts),
                                   lambda: sk.stft_mag_packed_plain(left, right, hann, n),
                                   lambda: torch.fft.fft(z), stft_work(rows, n, w, rows * w))
            redesign[f"packed N={n}"] = (t, lib_t, b[0])
            del z
        del left, right
        torch.cuda.empty_cache()

    # the N/2 packs at kWideThreads threads whose body holds radix 7: the
    # direct MixedRadixT<7> and a Bluestein M with a 7
    for n, sr in ((WIDE_SEVEN_N, 44100.0), (WIDE_BLUE_N, 48000.0)):
        w, half = n // 2, sk.split_size(n)
        m = sk.split_buf_size(n)
        if sk.is_large_split(n) or m < sk.WIDE_ROW or 7 not in sk.mixed_radix_plan(m):
            fail(f"N={n}: the split-real pack is not a 1,024-thread row over radix 7")
        label = (f"N={n} (split-real pack of N/2={half}, {sk.split_route(n)}, buffer {m} = "
                 f"{'-'.join(map(str, sk.mixed_radix_plan(m)))}, {sk.WIDE_THREADS} threads)")
        left, right, consts, (_, _, shann) = _large_operands(n, w, WIDE_ROWS, dev, sr)
        _check_stft(23, stats, (sk.SPLIT_KERNEL,), f"stft_split {label}, {WIDE_ROWS} rows",
                    sk.stft_mag_split(left, right, shann, consts),
                    sk.stft_mag_split_plain(left, right, shann, n))
        del left, right
        torch.cuda.empty_cache()


def large_i16_path(dev, lib, main_launches: dict) -> None:
    """Phase 23's int16 path: i16_planes at 48 kHz with a 0.5 s window,
    k=1, 4,096 streams: the large int16 kernel launches, and the rows and
    carry equal an f32 pipeline's fed the same words (x/32768) exactly."""
    cfg = LARGE_48K
    kw = dict(chunk_hops=1, store_ring=False, packed_output=True, device=dev)
    p16 = SpectrogramPipeline(cfg, i16_planes=True, **kw)
    p32 = SpectrogramPipeline(cfg, **kw)
    ids = np.arange(STREAMS) % len(p16.schemes)
    s16, s32 = (q.set_palette(q.init_state(STREAMS), ids) for q in (p16, p32))
    t = p16.chunk_size
    pcm = testing.chirp_tone(STREAMS, PUSHES * t, cfg.sample_rate, seed=23)
    words = torch.from_numpy(np.round(pcm * 32767.0).astype(np.int16)).to(dev)
    torch.cuda.synchronize()
    lib.reset_launches()
    rows16 = []
    for i in range(PUSHES):
        s16, r = p16.push(s16, words[:, i * t : (i + 1) * t])
        rows16.append(r)
    torch.cuda.synchronize()
    launches = {k_: v for k_, v in lib.launches.items() if v}
    for k_, v in launches.items():
        main_launches[k_] = main_launches.get(k_, 0) + v
    same = True
    for i in range(PUSHES):
        s32, r = p32.push(s32, words[:, i * t : (i + 1) * t])
        same = same and torch.equal(r, rows16[i])
    carry_same = torch.equal(s16.carry.to(torch.float32) / 32768.0, s32.carry)
    log(f"[23] i16_planes at N={cfg.padded_size}, {STREAMS} streams, {PUSHES} pushes: launches "
        f"{launches}; rows {'equal' if same else 'DIFFER from'} the f32 pipeline's on x/32768, "
        f"carry {'equal' if carry_same else 'DIFFERS'}")
    if not launches.get(sk.LARGE_KERNEL_I16):
        fail("the large int16 kernel did not launch on its path")
    if not (same and carry_same):
        fail("the int16 pipeline at large N differs from the f32 pipeline on x/32768")
    del rows16, s16, s32, words


def long_window_path(dev, lib, main_launches: dict) -> None:
    """Phase 23's long-window serving deployment, as portbench's
    long4k.k1.device pushes it: LONG_SERVE at k=1, 4,096 streams, no ring,
    i16_planes, presorted_input, sorted_output and the palette sort, Zipf(1)
    palettes over 1,024-stream strata, int16 planar chunks in input_perm
    order through push_planar.  Each push launches the large int16 kernel
    once, one `large` body, over one row group of exactly 2 GiB of scratch
    (the pipeline's counters and `last_stft` agree); rows and carry equal an
    f32 serving pipeline's on x/32768 bit for bit, the rows lie within 1 u8
    of the plain twin's and the carry equals it."""
    cfg, s = LONG_SERVE, STREAMS
    kw = dict(chunk_hops=1, store_ring=False, packed_output=True, presorted_input=True,
              sorted_output=True, device=dev)
    p = SpectrogramPipeline(cfg, i16_planes=True, **kw)
    p32 = SpectrogramPipeline(cfg, **kw)
    plain = p.with_plain_kernels()
    n_pal, stratum = len(p.schemes), min(1024, s)
    zipf = stratum / np.arange(1, n_pal + 1) / (1 / np.arange(1, n_pal + 1)).sum()
    counts = np.floor(zipf).astype(np.int64)
    counts[np.argsort(counts - zipf, kind="stable")[: stratum - counts.sum()]] += 1
    rng = np.random.default_rng(23)
    ids = np.concatenate([rng.permutation(np.repeat(np.arange(n_pal), counts))
                          for _ in range(s // stratum)]).astype(np.int32)
    state = p.set_palette(p.init_state(s), ids)
    s32 = p32.set_palette(p32.init_state(s), ids)
    pstate = state
    into = p.input_perm(state)
    if into is None:
        fail("the long-window serving layout did not take the palette sort")
        into = np.arange(s)
    perm = torch.from_numpy(into.astype(np.int64)).to(dev)
    t = p.chunk_size
    pcm = testing.chirp_tone(s, PUSHES * t, cfg.sample_rate, seed=24)
    words = torch.from_numpy(np.round(pcm * 32767.0).astype(np.int16)).to(dev)
    chunks = [words[:, i * t : (i + 1) * t].index_select(0, perm).transpose(1, 2).contiguous()
              for i in range(PUSHES)]
    del pcm, words
    torch.cuda.synchronize()
    lib.reset_launches()
    p.counters.clear()
    rows = []
    for c in chunks:
        state, r = p.push_planar(state, c)
        rows.append(r)
    torch.cuda.synchronize()
    launches = {k_: v for k_, v in lib.launches.items() if v}
    body = lib.body_launches[sk.LARGE]
    for k_, v in launches.items():
        main_launches[k_] = main_launches.get(k_, 0) + v
    record = {"route": sk.LARGE, "n_fft": cfg.padded_size, "rows": s, "groups": 1,
              "scratch_bytes": sk.LARGE_SCRATCH_BYTES}
    log(f"[23] long-window serving (N={cfg.padded_size}, hop {cfg.hop_size}, {s} streams, "
        f"full serving mode), {PUSHES} pushes: launches {launches}; {sk.LARGE} body launches "
        f"{body}; counters push.stft_large {p.counters['push.stft_large']}, stft.large_groups "
        f"{p.counters['stft.large_groups']}; last_stft {p.last_stft}; layout {p.last_layout}")
    if (launches.get(sk.LARGE_KERNEL_I16) != PUSHES or body != PUSHES
            or p.counters["push.stft_large"] != PUSHES
            or p.counters["stft.large_groups"] != PUSHES or p.last_stft != record):
        fail("the long-window serving push did not take the large int16 route once a push "
             "in one 2 GiB group")
    same, worst = True, 0
    for c, r in zip(chunks, rows):
        s32, r32 = p32.push_planar(s32, c.to(torch.float32) / 32768.0)
        pstate, pr = plain.push_planar(pstate, c)
        same = same and torch.equal(r, r32)
        worst = max(worst, u8_diff(r, pr, everywhere=False))
    carry_f32 = torch.equal(state.carry.to(torch.float32) / 32768.0, s32.carry)
    carry_plain = torch.equal(state.carry, pstate.carry)
    log(f"[23] long-window serving: rows {'equal' if same else 'DIFFER from'} the f32 serving "
        f"pipeline's on x/32768, carry {'equal' if carry_f32 else 'DIFFERS'}; against the "
        f"plain twin rows max u8 diff {worst} (bar 1), carry "
        f"{'equal' if carry_plain else 'DIFFERS'}")
    if not (same and carry_f32 and carry_plain) or worst > 1:
        fail("the long-window serving push disagrees with its f32 or plain twin")
    del rows, chunks, state, s32, pstate
    torch.cuda.empty_cache()


def rows_fused(dev, lib, main_launches: dict, stats, ms, plain_ms, bounds, library_ms,
               power_line: str, redesign: dict) -> None:
    """Phase 24: colormap_rows_fused at BENCH_CONFIG's full width (4,096 rows
    of [2, 2047], H=1024, resample_matrix(BENCH).T; the 19 built-ins'
    factors at arange % 19, smoke-custom's on every fifth row) and on the
    functional path (the verify recipe's 2.5 s chirp + 440 Hz tone at 48
    kHz -> stft_rows_planar -> colormap_rows_fused); its bars, identities
    and times."""
    from spectrogram_tpu_torch.color.colorscheme import scheme_by_name, stacked_factored_tables
    from spectrogram_tpu_torch.ops import stft as stft_ops

    cfg, n = BENCH_CONFIG, STREAMS
    w = cfg.window_size
    left, right = windows(cfg, "chirp_tone", n, dev)
    planes = sk.stft_mag_packed(left, right, torch.from_numpy(sk.packed_hann(w)).to(dev),
                                sk.fft_constants(cfg.padded_size, dev))
    rows = torch.stack([pl[:, 1:w] for pl in planes], dim=1).contiguous()   # [n, 2, 2047]
    del left, right, planes
    u, v = stacked_factored_tables(32)
    pid = np.arange(n) % 19
    u, v = u[pid].copy(), v[pid].copy()
    u[::5], v[::5] = testing.custom_factors()
    u, v = (torch.from_numpy(a).to(dev) for a in (u, v))
    m = cmap_ops.resample_matrix(cfg)                                      # [H, B]
    mt = np.ascontiguousarray(m.T)
    mt_dev = torch.from_numpy(mt).to(dev)

    # the functional path's inputs: the verify recipe
    fcfg = SpectrogramConfig(sample_rate=48000.0, viewport_height=512)
    fs = fcfg.sample_rate
    tt = np.arange(int(2.5 * fs)) / fs
    phase = 2 * np.pi * 100.0 * (np.exp(tt * np.log(80) / tt[-1]) - 1) * tt[-1] / np.log(80)
    pcm = torch.from_numpy(np.stack([0.5 * np.sin(phase), 0.2 * np.sin(2 * np.pi * 440 * tt)],
                                    -1).astype(np.float32)).to(dev)
    scheme = scheme_by_name("Blue-Yellow-Red (Stereo)")
    fm = cmap_ops.resample_matrix(fcfg)
    torch.cuda.synchronize()

    lib.reset_launches()
    packed = ck.colormap_rows_fused(rows, u, v, mt, cfg, packed=True)
    routes = [ck.rows_route()]
    u8 = ck.colormap_rows_fused(rows, u, v, mt, cfg)
    planar = stft_ops.stft_rows_planar(pcm, fcfg).contiguous()             # [r, 2, 2399]
    r = planar.shape[0]
    su, sv = (torch.from_numpy(a).to(dev)[None].expand(r, -1, -1).contiguous()
              for a in scheme.factored_tables(32))
    functional = ck.colormap_rows_fused(planar, su, sv, fm.T, fcfg)
    routes.append(ck.rows_route())
    torch.cuda.synchronize()
    launches = {k_: v_ for k_, v_ in lib.launches.items() if v_}
    for k_, v_ in launches.items():
        main_launches[k_] = main_launches.get(k_, 0) + v_
    log(f"[24] colormap_rows_fused at two taps launched the generic row tile's {routes[0]} "
        f"form at BENCH_CONFIG, its {routes[1]} form on the functional path")
    if routes != ["staged", "direct"]:
        fail("colormap_rows_fused's two-tap calls did not launch the row tile's forms phase "
             "24 checks")
    log(f"[24] colormap_rows_fused: rows {tuple(rows.shape)}, tables {tuple(u.shape)}, matrix "
        f"{mt.shape} -> packed {tuple(packed.shape)} {packed.dtype}, u8 {tuple(u8.shape)}; "
        f"functional path rows {tuple(planar.shape)} -> {tuple(functional.shape)}; launches "
        f"{launches}")
    if launches.get(ck.ROWS_KERNEL) != 3:
        fail("colormap_rows_fused did not launch its kernel on each call")

    plain_packed = ck.colormap_rows_fused_plain(rows, u, v, mt_dev, cfg, packed=True)
    plain_u8 = ck.colormap_rows_fused_plain(rows, u, v, mt_dev, cfg)
    d_packed = u8_diff(packed, plain_packed, everywhere=False)
    d_u8 = testing.rgba_u8_diff(u8, plain_u8)
    log(f"[24] against the plain version: packed max u8 diff {d_packed}, u8 {d_u8} over what "
        f"the image shows (bar 1)")
    if max(d_packed, d_u8) > 1:
        fail("colormap_rows_fused disagrees with its plain version")
    stats[ck.ROWS_KERNEL] = max(d_packed, d_u8)
    generic = ck.colormap_generic(rows[:, 0].contiguous(), rows[:, 1].contiguous(),
                                  ck.resample_taps(m, dev), u.reshape(n, -1),
                                  v.reshape(n, -1), cfg)
    _identity(24, "colormap_rows_fused == colormap_generic on the planes' copies", (packed,),
              (generic,))
    _identity(24, "colormap_rows_fused u8 == the packed words' bytes", (u8,),
              (ck.unpack_rgba_device(packed),))
    m4 = np.ascontiguousarray((0.5 * (m + np.roll(m, 2, axis=1))).T)
    taps4 = ck.resample_taps_k(m4, dev)
    got4 = ck.colormap_rows_fused(rows, u, v, taps4, cfg)
    route4 = ck.rows_route()
    d4 = testing.rgba_u8_diff(got4, ck.colormap_rows_fused_plain(
        rows, u, v, torch.from_numpy(m4).to(dev), cfg))
    log(f"[24] a {taps4.j.shape[1]}-tap matrix ({route4}): max u8 diff {d4} against the plain "
        f"version (bar 1)")
    if taps4.j.shape[1] != 4 or d4 > 1:
        fail("colormap_rows_fused disagrees with its plain version on a 4-tap matrix")
    if route4 != "pixels":
        fail("colormap_rows_fused at four taps did not launch its one-pixel-a-thread kernel")
    want = cmap_ops.rgba_f32_to_u8(cmap_ops.colormap_rows(
        planar.transpose(-1, -2), torch.from_numpy(fm).to(dev),
        torch.from_numpy(scheme.lookup_table(32)).to(dev), fcfg))
    d_f = testing.rgba_u8_diff(functional, want)
    log(f"[24] functional path, {scheme.name}: max u8 diff {d_f} against "
        f"rgba_f32_to_u8(colormap_rows(...)) over what the image shows (bar 1)")
    if d_f > 1:
        fail("the functional path disagrees with colormap_rows")
    stats[ck.ROWS_KERNEL] = max(stats[ck.ROWS_KERNEL], d4, d_f)
    del plain_packed, plain_u8, generic, got4, functional, want, planar, pcm

    taps = ck.resample_taps_k(mt, dev)
    ms[ck.ROWS_KERNEL] = device_ms(lambda: ck.colormap_rows_fused(rows, u, v, taps, cfg,
                                                                  packed=True))
    plain_ms[ck.ROWS_KERNEL] = time_ms(lambda: ck.colormap_rows_fused_plain(
        rows, u, v, mt_dev, cfg, packed=True), iters=3)
    generic_rows = (rows[:, 0].contiguous(), rows[:, 1].contiguous())
    two = ck.resample_taps(m, dev)
    u2, v2 = u.reshape(n, -1), v.reshape(n, -1)
    generic_ms = device_ms(lambda: ck.colormap_generic(*generic_rows, two, u2, v2, cfg))
    bounds[ck.ROWS_KERNEL] = bound(*cmap_work(n, two, u.numel() + v.numel(),
                                              CMAP_OPS_PER_PIXEL_GENERIC))
    library_ms[ck.ROWS_KERNEL] = None
    redesign["colormap_rows_fused, 4096 rows"] = (ms[ck.ROWS_KERNEL], None,
                                                  bounds[ck.ROWS_KERNEL][0])
    log(f"[24] colormap_rows_fused, {n} rows: {ms[ck.ROWS_KERNEL]:.4f} ms device time (plain "
        f"{plain_ms[ck.ROWS_KERNEL]:.4f} ms, library none, bound "
        f"{bounds[ck.ROWS_KERNEL][0]:.4f} ms by {bounds[ck.ROWS_KERNEL][1]}, sector floor "
        f"{sector_floor(n, two, 2 * rows.shape[2], u.numel() + v.numel()):.4f} ms, planar "
        f"rows counted at the left plane's offsets); colormap_generic on the planes' copies "
        f"{generic_ms:.4f} ms")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[24] peak device memory over phase 24: {peak:.2f} GiB; card {power_line}")


LOOP_STREAMS = 10240        # the serving cell (PERF.md section 4)
LOOP_TICKS = 24
LOOP_CHECKPOINT_TICK = 12
LOOP_CAPACITY = 8192        # frames per ring: ten hops of slack
LOOP_BLOCK = 256            # streams per producer thread, as examples/serve.py
LOOP_F32_STREAMS = 4096
LOOP_F32_TICKS = 6
LOOP_TIMED_TICKS = 9        # after one warm-up tick, from ten hops in the rings
BUILD = pathlib.Path(__file__).resolve().parent / "build"


def host_cpu() -> str:
    """The host CPU's model name and core count (the drain runs there)."""
    model = None
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
        model = next((line.split(":", 1)[1].strip() for line in out.splitlines()
                      if line.startswith("Model name")), None)
    except (OSError, subprocess.SubprocessError):
        pass
    return f"{model or 'model not reported'} ({platform.machine()}), {os.cpu_count()} cores"


def _planar_hop(hops: np.ndarray, t: int, dev) -> torch.Tensor:
    """Hop t of [T, S, n, 2] int16 words as a planar [S, 2, n] tensor on
    `dev`."""
    return torch.from_numpy(hops[t]).to(dev).transpose(1, 2).contiguous()


def _h2d_overlap(trace: pathlib.Path) -> tuple[int, float, float]:
    """(host-to-device copies, their microseconds, the microseconds of them
    during which a kernel ran) in a torch.profiler Chrome trace."""
    events = json.loads(trace.read_text())["traceEvents"]
    copies = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    merged = []
    for lo, hi in sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                         if e.get("cat") == "kernel"):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    total = sum(hi - lo for lo, hi in copies)
    covered = sum(max(0.0, min(hi, b) - max(lo, a))
                  for lo, hi in copies for a, b in merged)
    return len(copies), total, covered


def _feed_ticks(feeder, pool, bank, n: int, ticks: int, dest=None, f32: bool = False,
                drain: LatencyTracker = None, keep: bool = True) -> list:
    """`ticks` drains of the bank into pool slots, each pushed by the
    feeder; the rows of every push, in order (none unless `keep`: a
    consumer that drops each block as it comes)."""
    rows = []
    for _ in range(ticks):
        t0 = time.perf_counter()
        if f32:
            chunk, _ = bank.pop_matrix_f32_planar(n, pool.next(), dest=dest)
        else:
            chunk, _ = bank.pop_matrix_i16_planar(n, pool.next(), dest=dest)
        if drain is not None:
            drain.record(time.perf_counter() - t0)
        done = feeder.push(chunk)
        if done is not None and keep:
            rows.append(done)
    flushed = feeder.flush()
    return rows + flushed if keep else []


def _lateness(late: np.ndarray) -> str:
    """The producers' worst lateness per hop: ms after its schedule that
    the last of them had its hop in the bank (`late`: [producers, hops],
    NaN where a hop never landed)."""
    worst = [("-" if np.isnan(col).all() else f"{np.nanmax(col):.1f}") for col in late.T]
    return "[" + ", ".join(worst) + "]"


def _loop_diagnosis(dropped: list, drain: LatencyTracker, late: np.ndarray,
                    first_pop_ms) -> str:
    """What a failed paced loop shows: the tick of the first drop, the
    frames dropped in each tick (`dropped`: the bank's cumulative count
    after each tick), the drain's p99, the producers' worst lateness per
    hop, when the first tick drained, the host's load averages and the
    live threads."""
    per_tick = [b - a for a, b in zip([0] + dropped[:-1], dropped)]
    first = next((t + 1 for t, d in enumerate(per_tick) if d), None)
    p99 = f"{drain.p99_ms:.3f} ms" if drain.samples else "none drained"
    pop = "never" if first_pop_ms is None else f"{first_pop_ms:.1f} ms after the schedule's start"
    load = " / ".join(f"{v:.2f}" for v in os.getloadavg())
    return (f"first drop at tick {first}; dropped per tick {per_tick}; drain p99 {p99}; "
            f"producers' worst lateness per hop (ms) {_lateness(late)}; first drain {pop}; "
            f"load average (1, 5, 15 min) {load}; live threads {threading.active_count()}")


def serving_loop(dev, lib, main_launches: dict, power_line: str) -> None:
    """Phase 26: examples/serve.py's loop on the port at 10,240 streams of
    BENCH_CONFIG (k=1, no ring, packed rows, i16_planes, presorted_input,
    sorted_output, palettes arange(S) % 19): producer threads push 256-stream
    blocks of one seeded int16 chirp+tone array into a RingBank16 (8,192
    frames a ring) at the hop rate, on a schedule that starts once every
    thread runs, each hop's lateness recorded; each tick drains 800 frames a stream
    with pop_matrix_i16_planar(dest=input_dest) into a pinned ChunkPool slot
    that a depth-2 DeviceFeeder copies to the card on its side stream and
    pushes, its rows left on the card (readback="probe").  Checks: rows[output_perm] bit for bit an independent per-row
    pipeline's direct pushes of the same samples; no dropped frame and an
    empty bank; the int16 kernel A and blockwise launch counts; the state
    at tick 12, saved with save_state and restored with load_state into a
    fresh pipeline, gives ticks 13-24 bit for bit; an f32 drain at 4,096
    per-row streams with readback="probe" (f32 kernel A, kernel B) bit for
    bit its direct pushes.  Then the loop's times: host drain ms per tick,
    H2D ms per chunk and device ms per push (CUDA events of the feeder),
    wall ms per tick at depth 1 and 2 from rings holding ten hops, with the
    rows left on the card and read back to the host (each block dropped as
    it comes), and a torch.profiler trace of the depth-2 loop for the
    copies' overlap with the kernels."""
    t_phase = time.perf_counter()
    cfg = BENCH_CONFIG
    s, n = LOOP_STREAMS, cfg.hop_size
    hop_ms = n / cfg.sample_rate * 1e3
    kw = dict(chunk_hops=1, store_ring=False, packed_output=True, device=dev)
    full_kw = dict(kw, i16_planes=True, presorted_input=True, sorted_output=True)
    p = SpectrogramPipeline(cfg, **full_kw)
    ids = np.arange(s) % len(p.schemes)
    state0 = p.set_palette(p.init_state(s), ids)
    dest, out = p.input_dest(state0), p.output_perm(state0)
    if dest is None or out is None:
        fail("phase 26: the 10,240-stream layout did not take the palette sort")
    words = np.round(testing.chirp_tone(s, LOOP_TICKS * n, cfg.sample_rate, seed=26)
                     * 32767.0).astype(np.int16)
    # hop-major [T, S, n, 2]: any block of streams of one hop is contiguous,
    # so the producers push without a copy
    hops = np.ascontiguousarray(words.reshape(s, LOOP_TICKS, n, 2).transpose(1, 0, 2, 3))
    del words

    # the reference: a per-row pipeline, the same samples pushed directly
    per_row = SpectrogramPipeline(cfg, palette_sort=False, **dict(kw, i16_planes=True))
    rstate = per_row.set_palette(per_row.init_state(s), ids)
    ref_rows = []
    for t in range(LOOP_TICKS):
        rstate, r = per_row.push_planar(rstate, _planar_hop(hops, t, dev))
        ref_rows.append(r)
    DeviceFeeder(p, state0, depth=1, planar=True).push(np.zeros((s, 2, n), np.int16))  # warm-up
    torch.cuda.synchronize()

    # -- the paced loop -------------------------------------------------------
    bank = RingBank16(s, capacity=LOOP_CAPACITY)
    feeder = DeviceFeeder(p, state0, depth=2, planar=True, copy_chunks=False,
                          readback="probe")
    pool = ChunkPool.for_feeder(feeder, s, dtype=np.int16)
    if not (pool.pinned and all(torch.from_numpy(pool.next()).is_pinned()
                                for _ in range(len(pool)))):
        fail("phase 26: the ChunkPool of a CUDA pipeline is not pinned")
    errors = []
    blocks = range(0, s, LOOP_BLOCK)
    late = np.full((len(blocks), LOOP_TICKS), np.nan)    # ms after schedule, per hop
    go, start = threading.Event(), 0.0

    def producer(i: int, lo: int, hi: int) -> None:
        go.wait()
        try:
            for t in range(LOOP_TICKS):
                wait = start + t * hop_ms * 1e-3 - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                bank.push_matrix_range(lo, hops[t, lo:hi])
                late[i, t] = (time.perf_counter() - start) * 1e3 - t * hop_ms
        except Exception as exc:          # reported by the consumer
            errors.append(exc)

    threads = [threading.Thread(target=producer, args=(i, lo, min(lo + LOOP_BLOCK, s)),
                                daemon=True) for i, lo in enumerate(blocks)]
    drain, tick = LatencyTracker(), LatencyTracker()
    rows, snapshot, dropped, first_pop = [], None, [], None
    lib.reset_launches()
    for th in threads:
        th.start()
    start = time.perf_counter() + 0.01   # the schedule starts once every producer runs
    go.set()
    for t in range(LOOP_TICKS):
        give_up = time.perf_counter() + 5.0
        while bank.min_size() < n:
            if errors or time.perf_counter() > give_up:
                fail(f"phase 26: the producers stalled at tick {t + 1} ({errors}); "
                     f"dropped frames {bank.dropped_total}; drain {drain.summary()}, "
                     f"tick {tick.summary()}, H2D {feeder.h2d.summary()}, push "
                     f"{feeder.device_time.summary()}; "
                     f"{_loop_diagnosis(dropped + [bank.dropped_total], drain, late, first_pop)}")
            time.sleep(0.0002)
        t0 = time.perf_counter()
        if first_pop is None:
            first_pop = (t0 - start) * 1e3
        chunk, _ = bank.pop_matrix_i16_planar(n, pool.next(), dest=dest)
        drain.record(time.perf_counter() - t0)
        done = feeder.push(chunk)
        tick.record(time.perf_counter() - t0)
        if done is not None:
            rows.append(done)
        if t + 1 == LOOP_CHECKPOINT_TICK:
            snapshot = feeder.state       # a push never writes a state in place
        dropped.append(bank.dropped_total)
    rows.extend(feeder.flush())
    torch.cuda.synchronize()
    launches = {k: v for k, v in lib.launches.items() if v}
    for th in threads:
        th.join(timeout=10)
    if errors or any(th.is_alive() for th in threads):
        fail(f"phase 26: a producer failed ({errors})")
    for name, v in launches.items():
        main_launches[name] = main_launches.get(name, 0) + v
    left = max(bank.size(i) for i in range(s))
    log(f"[26] serving loop, {s} streams, {LOOP_TICKS} ticks paced at {hop_ms:.2f} ms, "
        f"depth 2, rows left on the card: launches {launches}; dropped frames "
        f"{bank.dropped_total}, frames left {left}; first drain {first_pop:.1f} ms after "
        f"the schedule's start; producers' worst lateness per hop (ms) {_lateness(late)}")
    if bank.dropped_total or left:
        fail(f"phase 26: the loop dropped frames or left frames in the bank; "
             f"{_loop_diagnosis(dropped, drain, late, first_pop)}")
    if not (launches.get(sk.KERNEL_I16) and launches.get(ck.BLOCKWISE_KERNEL)):
        fail("phase 26: the loop did not launch int16 kernel A and the blockwise colormap")
    out_t = torch.from_numpy(out).to(dev)
    same = len(rows) == LOOP_TICKS and all(
        r.is_cuda and torch.equal(r.index_select(0, out_t), w) for r, w in zip(rows, ref_rows))
    log(f"[26] rows[output_perm] {'equal' if same else 'DIFFER from'} the per-row "
        f"pipeline's direct pushes, bit for bit, all {LOOP_TICKS} ticks")
    if not same:
        fail("phase 26: the serving loop's rows differ from the direct pushes")

    # -- the checkpoint at tick 12 ----------------------------------------------
    path = BUILD / "checkpoint" / "tick12"
    path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    checkpoint.save_state(path, snapshot, cfg, pipeline=p)
    save_s = time.perf_counter() - t0
    p2 = SpectrogramPipeline(cfg, **full_kw)
    t0 = time.perf_counter()
    restored = checkpoint.load_state(path, p2)
    load_s = time.perf_counter() - t0
    dest2 = p2.input_dest(restored)
    bank2 = RingBank16(s, capacity=LOOP_CAPACITY)
    feeder2 = DeviceFeeder(p2, restored, depth=2, planar=True, copy_chunks=False,
                           readback="probe")
    pool2 = ChunkPool.for_feeder(feeder2, s, dtype=np.int16)
    resumed = []
    for t in range(LOOP_CHECKPOINT_TICK, LOOP_TICKS):
        bank2.push_matrix(hops[t])
        chunk, _ = bank2.pop_matrix_i16_planar(n, pool2.next(), dest=dest2)
        done = feeder2.push(chunk)
        if done is not None:
            resumed.append(done)
    resumed.extend(feeder2.flush())
    resumed_same = (np.array_equal(dest2, dest)
                    and len(resumed) == LOOP_TICKS - LOOP_CHECKPOINT_TICK
                    and all(torch.equal(a, b)
                            for a, b in zip(resumed, rows[LOOP_CHECKPOINT_TICK:])))
    mib = path.with_suffix(".npz").stat().st_size / 2**20
    log(f"[26] checkpoint at tick {LOOP_CHECKPOINT_TICK}: save_state {save_s:.2f} s "
        f"({mib:.1f} MiB), load_state into a fresh pipeline {load_s:.2f} s; ticks "
        f"{LOOP_CHECKPOINT_TICK + 1}-{LOOP_TICKS} "
        f"{'equal' if resumed_same else 'DIFFER from'} the uninterrupted run, bit for bit")
    if not resumed_same:
        fail("phase 26: the restored state does not resume the loop bit for bit")
    del ref_rows, rows, resumed, snapshot, restored, feeder2, pool2, bank2

    # -- the f32 drain with probe readback ----------------------------------------
    sf = LOOP_F32_STREAMS
    pf = SpectrogramPipeline(cfg, **kw)
    fstate = pf.set_palette(pf.init_state(sf), np.arange(sf) % len(pf.schemes))
    if pf._state_perm(fstate) is not None:
        fail("phase 26: the 4,096-stream f32 state took the palette sort")
    want, ws = [], fstate
    bankf = RingBank16(sf, capacity=LOOP_CAPACITY)
    for t in range(LOOP_F32_TICKS):
        ws, r = pf.push_planar(ws, _planar_hop(hops[:, :sf], t, dev).to(torch.float32) / 32768.0)
        want.append(r)
        bankf.push_matrix(hops[t, :sf])
    feederf = DeviceFeeder(pf, fstate, depth=2, planar=True, copy_chunks=False,
                           readback="probe")
    poolf = ChunkPool.for_feeder(feederf, sf)
    torch.cuda.synchronize()
    lib.reset_launches()
    got = _feed_ticks(feederf, poolf, bankf, n, LOOP_F32_TICKS, f32=True)
    torch.cuda.synchronize()
    flaunch = {k: v for k, v in lib.launches.items() if v}
    for name, v in flaunch.items():
        main_launches[name] = main_launches.get(name, 0) + v
    fsame = len(got) == LOOP_F32_TICKS and all(g.is_cuda and torch.equal(g, w)
                                              for g, w in zip(got, want))
    fcarry = torch.equal(feederf.state.carry, ws.carry)
    log(f"[26] f32 drain, {sf} per-row streams, readback=probe: launches {flaunch}; rows "
        f"on the card {'equal' if fsame else 'DIFFER from'} the direct pushes bit for bit, "
        f"carry {'exact' if fcarry else 'DIFFERS'}")
    if not (fsame and fcarry) or not (flaunch.get(sk.KERNEL) and flaunch.get(ck.KERNEL)):
        fail("phase 26: the f32 loop disagrees or missed f32 kernel A / kernel B")
    del got, want, feederf, poolf, bankf

    # -- timing: rings holding ten hops, drained as fast as the loop goes ---------
    timed_bank = RingBank16(s, capacity=LOOP_CAPACITY)
    walls = {(r, d): [] for r in ("probe", "full") for d in (1, 2)}
    h2d, dev_ms, drain_t = LatencyTracker(), LatencyTracker(), LatencyTracker()

    def timed(depth: int, readback: str, traced: bool = False) -> float:
        for t in range(LOOP_TIMED_TICKS + 1):
            timed_bank.push_matrix(hops[t])
        f = DeviceFeeder(p, state0, depth=depth, planar=True, copy_chunks=False,
                         readback=readback)
        pl = ChunkPool.for_feeder(f, s, dtype=np.int16)
        _feed_ticks(f, pl, timed_bank, n, 1, dest=dest)          # warm-up tick
        f.h2d.samples.clear()
        f.device_time.samples.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _feed_ticks(f, pl, timed_bank, n, LOOP_TIMED_TICKS, dest=dest,
                    drain=None if traced else drain_t, keep=False)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / LOOP_TIMED_TICKS * 1e3
        if not traced:
            h2d.samples += f.h2d.samples
            dev_ms.samples += f.device_time.samples
        return wall

    for readback in ("probe", "full"):
        for depth in (1, 2, 2, 1):                               # in turns
            walls[readback, depth].append(timed(depth, readback))
    trace_line = "not measured"
    try:
        trace_dir = BUILD / "trace" / "phase26"
        with device_trace(trace_dir):
            timed(2, "full", traced=True)
        copies, total_us, covered_us = _h2d_overlap(trace_dir / "trace.json")
        if copies:
            trace_line = (f"{copies} host-to-device copies, {total_us / copies / 1e3:.4f} ms "
                          f"each, {covered_us / total_us * 100:.1f}% of their time under a "
                          f"kernel")
        else:
            trace_line = "not measured (the trace holds no host-to-device copy)"
    except Exception as exc:               # the trace is a reading, not a check
        trace_line = f"not measured ({type(exc).__name__}: {exc})"

    if not (h2d.samples and dev_ms.samples):
        fail("phase 26: the feeder timed no host-to-device copy or push on the card")
    mb = s * 2 * n * 2 / 1e6
    cpu = host_cpu()
    log(f"[26] host drain (pop_matrix_i16_planar with dest, {s} streams): paced p50 "
        f"{drain.p50_ms:.3f} / p99 {drain.p99_ms:.3f} ms per tick; unpaced p50 "
        f"{drain_t.p50_ms:.3f} / p99 {drain_t.p99_ms:.3f} ms; host CPU {cpu}")
    log(f"[26] H2D of a {mb:.1f} MB int16 chunk from pinned memory on the copy stream "
        f"(CUDA events): p50 {h2d.p50_ms:.4f} / p99 {h2d.p99_ms:.4f} ms "
        f"= {mb / h2d.p50_ms:.2f} GB/s; device ms per push (compute stream) p50 "
        f"{dev_ms.p50_ms:.4f} / p99 {dev_ms.p99_ms:.4f}")
    for readback, label in (("probe", "rows left on the card"),
                            ("full", "rows read back to the host, dropped as they come")):
        log(f"[26] wall ms per tick, {label}, rings holding ten hops: depth 1 "
            + " / ".join(f"{w:.3f}" for w in walls[readback, 1]) + ", depth 2 "
            + " / ".join(f"{w:.3f}" for w in walls[readback, 2])
            + f" (in turns 1 2 2 1); hop budget {hop_ms:.2f} ms")
    log(f"[26] paced loop (depth 2, rows left on the card): drain + push p50 "
        f"{tick.p50_ms:.3f} / p99 {tick.p99_ms:.3f} ms per tick")
    log(f"[26] torch.profiler trace of the depth-2 loop: {trace_line}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[26] phase 26 {time.perf_counter() - t_phase:.1f} s; peak device memory "
        f"{peak:.2f} GiB; card {power_line}; host CPU {cpu}")



# ------------------------------------------------------------------ phase 27

MR_STREAMS = 4096           # a geometry group's capacity
MR_PUSHES = 4               # direct pushes per group in (a)
MR_TICKS = 24               # ticks of the slower group in (b)
# the second group: BENCH_CONFIG's window period at 44.1 kHz with an 8 ms
# hop: window 1881, hop 352, N = 3762 = 2 * 3^2 * 11 * 19 (the Bluestein body)
MR_44K = SpectrogramConfig(sample_rate=44100.0, window_period=BENCH_CONFIG.window_period,
                           hop_period=0.008)
MR_REUSE_SLOT = {BENCH_CONFIG: 1234, MR_44K: 2345}
MR_SORT_PALETTES = 2        # palettes i % 2: the carry-sort group of (a)
MR_STALE_FRAMES = 100       # a leaving tenant's backlog, dropped on reuse in (b)
SESSION_PUSHES = 48         # LiveSession pushes in (c): 384 rows, no ring wrap
ANALYZER_ATOL = 1e-6        # levels against a float64 band product
CLI_SECONDS = 2.0


def _mr_tones(s: int, hop: int, n: int, rate: float, lo: int = 0) -> np.ndarray:
    """Hop `hop` ([s, n, 2] int16) of the s stereo tones of streams lo ..
    lo+s-1, each stream its own pitch, phase and level (the producers' PCM
    in phases 27 and 28)."""
    i = np.arange(lo, lo + s)[:, None]
    f = 110.0 * 2.0 ** ((i % 61) / 12.0)
    amp = 3000.0 + (i * 397) % 24000
    t = (hop * n + np.arange(n))[None, :] / rate
    left = np.round(amp * np.sin(2 * np.pi * f * t + 0.37 * i))
    right = np.round(0.5 * amp * np.sin(3 * np.pi * f * t + 1.1 * i))
    return np.stack([left, right], axis=-1).astype(np.int16)


def _f32_words(words: np.ndarray, dev) -> torch.Tensor:
    """int16 words as the f32 samples x / 32768, on the card."""
    return torch.from_numpy(words).to(dev).to(torch.float32) / 32768.0


def _count(lib, main_launches: dict) -> dict:
    """This run's launches (kernels and the Bluestein body), added to
    `main_launches`."""
    launches = {k: v for k, v in lib.launches.items() if v}
    launches[BLUESTEIN] = lib.body_launches[BLUESTEIN]
    for k, v in launches.items():
        main_launches[k] = main_launches.get(k, 0) + v
    return launches


def multirate_direct(dev, lib, main_launches: dict) -> None:
    """Phase 27 (a): two geometry groups of 4,096 streams in one
    StreamGroupManager, pushed directly, against their own pipelines."""
    from spectrogram_tpu_torch.models.multirate import StreamGroupManager

    s, groups = MR_STREAMS, (BENCH_CONFIG, MR_44K)
    kw = dict(chunk_hops=1, store_ring=False)
    ids = np.arange(s) % 19
    t0 = time.perf_counter()
    mgr = StreamGroupManager(group_capacity=s, device=dev, **kw)
    sids = {cfg: [mgr.add_stream(cfg, palette_id=int(p)) for p in ids] for cfg in groups}
    add_s = time.perf_counter() - t0
    gs = {g.cfg: g for g in mgr.groups()}
    hops = {cfg: [_f32_words(_mr_tones(s, i, gs[cfg].pipeline.chunk_size, cfg.sample_rate), dev)
                  for i in range(MR_PUSHES + 1)] for cfg in groups}
    torch.cuda.synchronize()
    lib.reset_launches()
    rows = {cfg: [] for cfg in groups}
    for i in range(MR_PUSHES):
        for cfg in groups:
            rows[cfg].append(mgr.push_group(cfg, hops[cfg][i]))
    torch.cuda.synchronize()
    launches = _count(lib, main_launches)
    for cfg in groups:
        g = gs[cfg]
        log(f"[27] (a) group {cfg.sample_rate:.0f} Hz (W={cfg.window_size}, hop "
            f"{cfg.hop_size}, N={cfg.padded_size}, {sk.fft_route(cfg.padded_size)} body, "
            f"{g.chunk_period * 1e3:.2f} ms cadence): {s} streams, tables "
            f"{'palette-sorted' if g.pipeline._state_perm(g.state) is not None else 'per row'}")
    log(f"[27] (a) {len(groups)} groups x {MR_PUSHES} pushes x {s} streams (add_stream x "
        f"{len(groups) * s}: {add_s:.2f} s); launches {launches}; radix-2 body "
        f"{lib.body_launches['radix2']}")
    if not (launches.get(sk.KERNEL) and launches.get(sk.MIXED_KERNEL)
            and launches[BLUESTEIN] and launches.get(ck.KERNEL)):
        fail("phase 27 (a): the manager did not launch kernel A at N=4096 and on the "
             "Bluestein body at N=3762, and kernel B")

    for cfg in groups:
        g = gs[cfg]
        rp = SpectrogramPipeline(cfg, device=dev, **kw)
        plain = rp.with_plain_kernels()
        rs = ps = rp.set_palette(rp.init_state(s), ids)
        same, worst = True, 0
        for i in range(MR_PUSHES):
            rs, want = rp.push(rs, hops[cfg][i])
            ps, pw = plain.push(ps, hops[cfg][i])
            same &= torch.equal(rows[cfg][i], want)
            worst = max(worst, testing.rgba_u8_diff(rows[cfg][i], pw))
        carry_ok = torch.equal(g.state.carry, rs.carry) and torch.equal(g.state.carry, ps.carry)
        log(f"[27] (a) {cfg.sample_rate:.0f} Hz: push_group rows "
            f"{'equal' if same else 'DIFFER from'} the geometry's own pipeline's pushes, bit "
            f"for bit; against the plain path max u8 diff {worst} over what the image shows "
            f"(bar 1); carry {'exact' if carry_ok else 'DIFFERS'}")
        if not (same and carry_ok) or worst > 1:
            fail(f"phase 27 (a): the {cfg.sample_rate:.0f} Hz group disagrees")
        # a detached stream's slot, reused: the new tenant's rows are a fresh
        # stream's, its neighbours' continue their own history
        slot = MR_REUSE_SLOT[cfg]
        mgr.remove_stream(sids[cfg][slot])
        new_pid = int(ids[slot] + 5) % 19
        sid = mgr.add_stream(cfg, palette_id=new_pid)
        ids2 = ids.copy()
        ids2[slot] = new_pid
        got = mgr.push_group(cfg, hops[cfg][MR_PUSHES])
        _, fresh = rp.push(rp.set_palette(rp.init_state(s), ids2), hops[cfg][MR_PUSHES])
        _, cont = rp.push(rp.set_palette(rs, ids2), hops[cfg][MR_PUSHES])
        others = torch.arange(s, device=dev) != slot
        reuse_ok = (mgr.location(sid)[1] == slot and torch.equal(got[slot], fresh[slot])
                    and torch.equal(got[others], cont[others]))
        log(f"[27] (a) {cfg.sample_rate:.0f} Hz: slot {slot} detached and reused (palette "
            f"{ids[slot]} -> {new_pid}): its next rows {'equal' if reuse_ok else 'DIFFER from'} "
            f"a fresh stream's, the other {s - 1} streams' their continued history's, bit for bit")
        if not reuse_ok:
            fail(f"phase 27 (a): slot reuse leaks state at {cfg.sample_rate:.0f} Hz")
    del mgr, rows, hops


def multirate_sorted_reuse(dev) -> None:
    """Phase 27 (a), the carry-sort form: a BENCH group of 4,096 streams on
    palettes i % 2 with palette_sort=True and store_ring=False, so its
    carry rests in sorted stream order.  A slot detached and reused onto
    the other palette gives a fresh stream's rows, its neighbours their
    continued history's."""
    from spectrogram_tpu_torch.models.multirate import StreamGroupManager

    s, cfg = MR_STREAMS, BENCH_CONFIG
    kw = dict(chunk_hops=1, store_ring=False, palette_sort=True)
    ids = np.arange(s) % MR_SORT_PALETTES
    mgr = StreamGroupManager(group_capacity=s, device=dev, **kw)
    sids = [mgr.add_stream(cfg, palette_id=int(p)) for p in ids]
    g = next(mgr.groups())
    if not (g.pipeline.carry_sort_mode and g.pipeline._state_perm(g.state) is not None):
        fail("phase 27 (a): the i % 2 group did not take the palette-sorted path")
    hops = [_f32_words(_mr_tones(s, i, g.pipeline.chunk_size, cfg.sample_rate), dev)
            for i in range(3)]
    rp = SpectrogramPipeline(cfg, device=dev, **kw)
    rs = rp.set_palette(rp.init_state(s), ids)
    same = True
    for x in hops[:2]:
        rs, want = rp.push(rs, x)
        same &= torch.equal(mgr.push_group(cfg, x), want)
    slot = MR_REUSE_SLOT[cfg]
    crow = int(g.pipeline._global_perms(g.state)[1][slot])
    mgr.remove_stream(sids[slot])
    new_pid = 1 - int(ids[slot])
    sid = mgr.add_stream(cfg, palette_id=new_pid)
    ids2 = ids.copy()
    ids2[slot] = new_pid
    got = mgr.push_group(cfg, hops[2])
    _, fresh = rp.push(rp.set_palette(rp.init_state(s), ids2), hops[2])
    _, cont = rp.push(rp.set_palette(rs, ids2), hops[2])
    others = torch.arange(s, device=dev) != slot
    reuse_ok = (mgr.location(sid)[1] == slot and crow != slot
                and torch.equal(got[slot], fresh[slot]) and torch.equal(got[others], cont[others]))
    log(f"[27] (a) carry-sort group {cfg.sample_rate:.0f} Hz, {s} streams on palettes i % "
        f"{MR_SORT_PALETTES}: push_group rows {'equal' if same else 'DIFFER from'} the "
        f"pipeline's; slot {slot} (sorted carry row {crow}) detached and reused (palette "
        f"{ids[slot]} -> {new_pid}): its next rows {'equal' if reuse_ok else 'DIFFER from'} a "
        f"fresh stream's, the other {s - 1} streams' their continued history's, bit for bit")
    if not (same and reuse_ok):
        fail("phase 27 (a): slot reuse leaks state in the carry-sort group")


def multirate_ingest(dev, lib, main_launches: dict, power_line: str) -> None:
    """Phase 27 (b): the same two groups with ingest (int16 wire, int16
    planes, depth-2 feeders) on a synthetic clock: producers push_pcm one
    hop of int16 tones per stream before each due tick.  Halfway, between
    two ticks and with the last push in flight, one tenant of each group
    leaves a stale backlog and detaches, and a new one takes its slot."""
    from spectrogram_tpu_torch.models.multirate import StreamGroupManager

    s, groups = MR_STREAMS, (BENCH_CONFIG, MR_44K)
    ids = np.arange(s) % 19
    mgr = StreamGroupManager(group_capacity=s, ingest=True, wire_int16=True, feeder_depth=2,
                             device=dev, chunk_hops=1, store_ring=False, i16_planes=True)
    sids = {cfg: [mgr.add_stream(cfg, palette_id=int(p)) for p in ids] for cfg in groups}
    gs = {g.cfg: g for g in mgr.groups()}
    drains = {cfg: LatencyTracker() for cfg in groups}
    for cfg in groups:
        if not gs[cfg].pinned.pinned:
            fail("phase 27 (b): a group's ChunkPool is not pinned")
        bank, tracker = gs[cfg].bank, drains[cfg]

        def timed_pop(*args, _pop=bank.pop_matrix_i16_planar, _t=tracker, **kwargs):
            t0 = time.perf_counter()
            out = _pop(*args, **kwargs)
            _t.record(time.perf_counter() - t0)
            return out

        bank.pop_matrix_i16_planar = timed_pop       # times the manager's drain
    walls = {cfg: LatencyTracker() for cfg in groups}
    both = LatencyTracker()
    words = {cfg: [] for cfg in groups}
    blocks = {cfg: [] for cfg in groups}
    reuse = {}                  # cfg -> (index of the new tenant's first hop, its palette)
    produce_s, now = 0.0, 1000.0
    torch.cuda.synchronize()
    lib.reset_launches()
    while len(words[BENCH_CONFIG]) < MR_TICKS:
        due = [cfg for cfg in groups if gs[cfg].next_due == 0.0 or now >= gs[cfg].next_due]
        t0 = time.perf_counter()
        for cfg in due:
            if len(words[cfg]) == MR_TICKS // 2 and cfg not in reuse:
                slot = MR_REUSE_SLOT[cfg]
                mgr.push_pcm(sids[cfg][slot], np.full((MR_STALE_FRAMES, 2), 9999, np.int16))
                mgr.remove_stream(sids[cfg][slot])
                reuse[cfg] = (len(words[cfg]), int(ids[slot] + 5) % 19)
                sids[cfg][slot] = mgr.add_stream(cfg, palette_id=reuse[cfg][1])
            hop = _mr_tones(s, len(words[cfg]), gs[cfg].pipeline.chunk_size, cfg.sample_rate)
            for slot, sid in enumerate(sids[cfg]):
                mgr.push_pcm(sid, hop[slot])
            words[cfg].append(hop)
        produce_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        out = mgr.tick(now)
        wall = time.perf_counter() - t0
        (walls[due[0]] if len(due) == 1 else both).record(wall)
        for cfg, blk in out.items():
            # kept on the card: the pinned readback buffer goes back to the
            # host allocator's cache for the next tick
            blocks[cfg].append(torch.from_numpy(blk).to(dev))
        now = min(g.next_due for g in gs.values())
    for cfg, blks in mgr.flush().items():
        blocks[cfg].extend(torch.from_numpy(b).to(dev) for b in blks)
    torch.cuda.synchronize()
    launches = _count(lib, main_launches)
    metrics = mgr.metrics()
    log(f"[27] (b) ingest, {s} streams a group, int16 wire and planes, depth 2: "
        + ", ".join(f"{cfg.sample_rate:.0f} Hz {len(words[cfg])} ticks" for cfg in groups)
        + f" on a synthetic clock; launches {launches}; rows_produced "
        f"{metrics['rows_produced']}, dropped {metrics['dropped']}")
    if any(metrics["dropped"].values()):
        fail("phase 27 (b): the ingest groups dropped frames")
    if not (launches.get(sk.KERNEL_I16) and launches.get(sk.MIXED_KERNEL_I16)
            and launches[BLUESTEIN]):
        fail("phase 27 (b): the ingest groups did not launch int16 kernel A at N=4096 and "
             "on the Bluestein body")
    for cfg in groups:
        # the direct pushes of x / 32768; from the reuse on, the reused slot
        # against a fresh stream's pushes, the others against their history
        rp = SpectrogramPipeline(cfg, device=dev, chunk_hops=1, store_ring=False)
        rs = rp.set_palette(rp.init_state(s), ids)
        slot, (r, new_pid) = MR_REUSE_SLOT[cfg], reuse[cfg]
        ids2 = ids.copy()
        ids2[slot] = new_pid
        others = torch.arange(s, device=dev) != slot
        same = fresh_ok = len(blocks[cfg]) == len(words[cfg])
        for j, (blk, hop) in enumerate(zip(blocks[cfg], words[cfg])):
            x = _f32_words(hop, dev)
            if j == r:
                rs = rp.set_palette(rs, ids2)
                fs = rp.set_palette(rp.init_state(s), ids2)
            rs, want = rp.push(rs, x)
            if j < r:
                same &= torch.equal(blk, want)
            else:
                fs, fresh = rp.push(fs, x)
                same &= torch.equal(blk[others], want[others])
                fresh_ok &= torch.equal(blk[slot], fresh[slot])
        log(f"[27] (b) {cfg.sample_rate:.0f} Hz: {len(blocks[cfg])} completed blocks "
            f"{'equal' if same else 'DIFFER from'} the f32 pipeline's direct pushes of "
            f"x / 32768, bit for bit; slot {slot} reused before hop {r} (a stale "
            f"{MR_STALE_FRAMES}-frame backlog, palette {ids[slot]} -> {new_pid}): its rows "
            f"{'equal' if fresh_ok else 'DIFFER from'} a fresh stream's")
        if not (same and fresh_ok):
            fail(f"phase 27 (b): the {cfg.sample_rate:.0f} Hz ingest blocks differ")
    for cfg in groups:
        n = gs[cfg].pipeline.chunk_size
        log(f"[27] (b) {cfg.sample_rate:.0f} Hz (hop {n}, {gs[cfg].chunk_period * 1e3:.2f} ms): "
            f"wall ms per tick (drain + H2D + push + readback of the block one tick late) p50 "
            f"{walls[cfg].p50_ms:.3f} / p99 {walls[cfg].p99_ms:.3f} over "
            f"{len(walls[cfg].samples)} ticks alone; host drain (pop_matrix_i16_planar, "
            f"{s * n * 4 / 1e6:.1f} MB out) p50 {drains[cfg].p50_ms:.3f} / p99 "
            f"{drains[cfg].p99_ms:.3f} ms; card {power_line}")
    log(f"[27] (b) ticks firing both groups: wall p50 {both.p50_ms:.3f} ms over "
        f"{len(both.samples)}; producers' push_pcm {produce_s:.2f} s in all")


def display_session(dev, lib, main_launches: dict, power_line: str) -> None:
    """Phase 27 (c): LiveSession at its defaults (48 kHz, window 0.05 s,
    N=4800, k=8, ring 2,048) with the scope and the analyzer, fed the
    registry's 440 Hz sine source in real time."""
    from spectrogram_tpu_torch.models.spectrum_analyzer import band_product
    from spectrogram_tpu_torch.session import LiveSession, SessionConfig

    sess = LiveSession(SessionConfig(enable_scope=True, enable_analyzer=True), device=dev)
    ring = sess.registry.ring
    popped = []

    def recording_pop(n, _pop=ring.pop):
        frames = _pop(n)
        popped.append(frames.copy())
        return frames

    ring.pop = recording_pop                  # what the session consumed
    index = next(i for i, d in enumerate(sess.registry.inputs) if "440 Hz" in d.name)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True          # a caller's global switch:
    torch.set_float32_matmul_precision("medium")          # the analyzer ignores it
    rows = []
    try:
        sess.select_input(index)
        torch.cuda.synchronize()
        lib.reset_launches()
        t0 = time.perf_counter()
        while len(rows) < SESSION_PUSHES:
            if time.perf_counter() - t0 > 30.0:
                fail(f"phase 27 (c): the session made {len(rows)} pushes in 30 s")
            rows.extend(sess.process_available(max_chunks=SESSION_PUSHES - len(rows)))
        drive_s = time.perf_counter() - t0
    finally:
        sess.stop()
        torch.backends.cuda.matmul.allow_tf32 = tf32[0]
        torch.set_float32_matmul_precision(tf32[1])
    vp = sess.viewport()
    torch.cuda.synchronize()
    launches = _count(lib, main_launches)
    p, state = sess.pipeline, sess.state
    cfg, k = p.cfg, p.chunk_hops
    log(f"[27] (c) LiveSession (W={cfg.window_size}, N={cfg.padded_size}, hop {cfg.hop_size}, "
        f"k={k}, ring {p.viewport_rows}), the 440 Hz source in real time: {len(rows)} pushes "
        f"in {drive_s:.2f} s, push + readback p50 {sess.latency.p50_ms:.3f} / p99 "
        f"{sess.latency.p99_ms:.3f} ms; launches {launches}")
    if not (launches.get(sk.ALLK_KERNEL) and lib.body_launches["mixed"]
            and launches.get(ck.KERNEL)):
        fail("phase 27 (c): the session did not launch the all-windows kernel at N=4800 "
             "and kernel B")
    # the same chunks through a direct pipeline
    direct = SpectrogramPipeline(cfg, chunk_hops=k, device=dev)
    ds = direct.init_state(1, palette_id=sess.palette_id)
    same = len(popped) == len(rows) == SESSION_PUSHES
    for frames, got in zip(popped, rows):
        ds, r = direct.push(ds, torch.from_numpy(frames[None]).to(dev))
        same &= np.array_equal(r[0].cpu().numpy(), got)
    ring_ok = torch.equal(ds.ring, state.ring)
    view_ok = vp.shape == (p.viewport_rows, cfg.viewport_height, 4) and np.array_equal(
        direct.render_viewport(ds)[0].cpu().numpy(), vp)
    log(f"[27] (c) session rows {'equal' if same else 'DIFFER from'} a direct pipeline's "
        f"pushes of the chunks it consumed, bit for bit; ring {'equal' if ring_ok else 'DIFFERS'}"
        f"; viewport {tuple(vp.shape)} {'equal to' if view_ok else 'DIFFERS from'} the direct "
        f"render")
    if not (same and ring_ok and view_ok):
        fail("phase 27 (c): the session disagrees with a direct pipeline")
    # the analyzer: its levels against a float64 band product over the same
    # ring rows (the law's other steps in f32 on the host)
    n_rows = SESSION_PUSHES * k
    ring_rows_np = state.ring[0, :n_rows].to(torch.float32).cpu().numpy()      # [rows, 2, B]
    m64 = sess.analyzer.band_matrix.cpu().numpy().astype(np.float64)
    bands = np.einsum("gb,rcb->rgc", m64, ring_rows_np.astype(np.float64)).astype(np.float32)
    norm = np.sqrt(bands[..., 0] ** 2 + bands[..., 1] ** 2)
    new = np.clip((np.float32(10.0) * np.log10(norm + np.float32(1e-7)) - np.float32(-70.0))
                  / np.float32(60.0), 0.0, 1.0)
    want = np.full(new.shape[1], 0.3, np.float32)
    for v in new:
        want = np.maximum(v, want * np.float32(0.99))
    got = sess.levels[0].cpu().numpy()
    lv_err = float(np.abs(got - want).max())
    # the product alone, with TF32 allowed, against float64
    x = state.ring[0, :n_rows].to(torch.float32).reshape(-1, cfg.num_bins)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        prod = band_product(sess.analyzer.band_matrix, x).cpu().numpy().astype(np.float64)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32[0]
    ref = ring_rows_np.reshape(-1, cfg.num_bins).astype(np.float64) @ m64.T
    prod_rel = float((np.abs(prod - ref) / np.maximum(np.abs(ref), 1e-12))[
        np.abs(ref) > 1e-6].max())
    log(f"[27] (c) analyzer levels ({sess.analyzer.n_bands} bands, {n_rows} ring rows, TF32 "
        f"allowed): max abs err {lv_err:.3e} against a float64 band product (bar "
        f"{ANALYZER_ATOL}); the band product's max rel err {prod_rel:.3e}; levels in "
        f"[{got.min():.4f}, {got.max():.4f}]")
    if not lv_err <= ANALYZER_ATOL:
        fail("phase 27 (c): the analyzer's levels are not within the bar of float64")
    # the scope: the newest samples' min / max per column
    cat = np.concatenate(popped)
    width = 1024
    per_col = sess.scope.buffer_size // width
    newest = cat[len(cat) - width * per_col:].reshape(width, per_col, 2)
    env_want = np.stack([newest.min(axis=1), newest.max(axis=1)], axis=-1)
    env = sess.scope.envelope(sess.scope_state, width)[0].cpu().numpy()
    scope_ok = len(cat) >= sess.scope.buffer_size and np.array_equal(env, env_want)
    log(f"[27] (c) oscilloscope ({sess.scope.buffer_size}-sample ring, {len(cat)} samples "
        f"pushed): envelope at width {width} {'equal to' if scope_ok else 'DIFFERS from'} the "
        f"min / max of the newest samples; card {power_line}")
    if not scope_ok:
        fail("phase 27 (c): the oscilloscope's envelope is wrong")


def cli_runs(dev) -> None:
    """Phase 27 (d): the port's CLI in subprocesses on the card."""
    from PIL import Image

    from spectrogram_tpu_torch.ops.stft import num_rows

    root = pathlib.Path(__file__).resolve().parent
    out = BUILD / "phase27"
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(root), env.get("PYTHONPATH")]))
    cfg = SpectrogramConfig(window_period=0.05, hop_period=2.5 / 2048.0)  # the CLI's defaults
    render = out / "render.png"
    live = ["--seconds", str(CLI_SECONDS), "--streams", "4"]
    viewport = (cfg.viewport_height, cfg.viewport_rows, 3)
    runs = {
        "render": (["render", "--source", "chirp", str(render), "--seconds", str(CLI_SECONDS)],
                   render,
                   (cfg.viewport_height, num_rows(int(CLI_SECONDS * cfg.sample_rate), cfg), 3)),
        # headless: with no terminal the viewer draws into a no-op sink, and
        # --multirate composites the host blocks `tick` returns on the card
        **{name: (["live", str(out / f"{name}.png"), *live, *view], out / f"{name}.png",
                  viewport)
           for name, view in (("live", []), ("live_view", ["--view"]),
                              ("live_view_multirate", ["--view", "--multirate"]))},
    }
    for name, (args, path, shape) in runs.items():
        path.unlink(missing_ok=True)
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "spectrogram_tpu_torch.app", *args],
                           capture_output=True, text=True, timeout=300, env=env, cwd=root)
        wall = time.perf_counter() - t0
        if r.returncode:
            fail(f"phase 27 (d): `app {' '.join(args)}` exited {r.returncode}: "
                 f"{r.stderr[-2000:]}")
        got = np.asarray(Image.open(path)).shape if path.exists() else None
        said = (r.stdout.strip().splitlines() or ["(no output)"])[-1]
        log(f"[27] (d) python -m spectrogram_tpu_torch.app {' '.join(args)}: exit 0 in "
            f"{wall:.1f} s; {said}; PNG {got} (expected {shape})")
        if got != shape:
            fail(f"phase 27 (d): `app {' '.join(args)}` wrote no PNG of the expected shape")


def multirate_and_display(dev, lib, main_launches: dict, power_line: str) -> None:
    """Phase 27: multi-rate serving and the live display path on the card."""
    t_phase = time.perf_counter()
    multirate_direct(dev, lib, main_launches)
    multirate_sorted_reuse(dev)
    torch.cuda.empty_cache()
    multirate_ingest(dev, lib, main_launches, power_line)
    torch.cuda.empty_cache()
    display_session(dev, lib, main_launches, power_line)
    cli_runs(dev)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[27] phase 27 {time.perf_counter() - t_phase:.1f} s; peak device memory "
        f"{peak:.2f} GiB; card {power_line}")


MESH_A_STREAMS = 4096       # (a): BENCH_CONFIG at full width, one rank
MESH_B_STREAMS = 10240      # (b): the serving cell over two ranks
MESH_TICKS = 24
MESH_CHECKPOINT_TICK = 12
MESH_SET_PALETTE = ((100, 5), (3000, 7))    # (c): (slot, palette) edits, one a rank
MESH_TIMED_REDUCES = 200
# each part's ranks in all, seconds; a rank that outlives it is killed
MESH_TIMEOUT_S = {"a": 150.0, "bc": 300.0, "d": 150.0}
MESH_RANK_SCRIPT = pathlib.Path(__file__).resolve()
MESH_WORKDIR = BUILD / "mesh"


def _mesh_lines(text: str) -> list[str]:
    return [line for line in text.splitlines() if line.startswith("[28]")]


def mesh_serving(main_launches: dict, power_line: str) -> None:
    """Phase 28: the stream mesh over ranks, each part's ranks in
    subprocesses of this script (`--mesh-part`), under a time limit; a rank
    that fails, outlives the limit or disagrees fails the run.  The ranks'
    kernel launches join the main paths' counts."""
    import shutil

    from spectrogram_tpu_torch.parallel.distributed import run_ranks

    t_phase = time.perf_counter()
    shutil.rmtree(MESH_WORKDIR, ignore_errors=True)
    MESH_WORKDIR.mkdir(parents=True)
    shared = ["--device", "cuda:0", "--backend", "gloo"]
    # (b) and (c) share their two rank processes: each start costs seconds
    for part, world, extra in (("a", 1, []), ("bc", 2, shared)):
        t0 = time.perf_counter()

        def argv(r: int, part=part, world=world, extra=extra) -> list[str]:
            return [sys.executable, str(MESH_RANK_SCRIPT), "--mesh-part", part,
                    "--world", str(world), "--init",
                    f"file://{MESH_WORKDIR}/{part}.rendezvous", "--out",
                    str(MESH_WORKDIR), *extra]

        results = run_ranks(argv, world, MESH_TIMEOUT_S[part], MESH_WORKDIR / f"logs_{part}",
                            cwd=str(MESH_RANK_SCRIPT.parent))
        for rc, out in results:
            for line in _mesh_lines(out):
                log(f"{line}; card {power_line}")
        if any(rc != 0 for rc, _ in results):
            for r, (rc, out) in enumerate(results):
                print(f"--- phase 28 ({part}) rank {r}: exit {rc}\n{out[-6000:]}", flush=True)
            fail(f"phase 28 ({part}): a rank failed, disagreed or outlived "
                 f"{MESH_TIMEOUT_S[part]:.0f} s")
        for r in range(world):
            doc = json.loads((MESH_WORKDIR / f"{part}_r{r}.json").read_text())
            for k, v in doc["launches"].items():
                main_launches[k] = main_launches.get(k, 0) + v
        log(f"[28] ({part}) {world} rank(s): {time.perf_counter() - t0:.1f} s with the "
            "ranks' start")
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "spectrogram_tpu_torch.parallel.dryrun", "--ranks", "2",
           "--device", "cuda:0", "--backend", "gloo", "--timeout", str(MESH_TIMEOUT_S["d"])]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, cwd=str(MESH_RANK_SCRIPT.parent),
                             timeout=MESH_TIMEOUT_S["d"] + 30)
    except subprocess.TimeoutExpired:
        fail("phase 28 (d): the dry run outlived its time limit")
    if out.returncode != 0:
        print(out.stdout[-6000:] + out.stderr[-6000:], flush=True)
        fail("phase 28 (d): the dry run failed")
    said = next((line for line in out.stdout.splitlines() if line.startswith("dryrun OK")), "")
    log(f"[28] (d) python -m spectrogram_tpu_torch.parallel.dryrun --ranks 2 --device cuda:0 "
        f"--backend gloo: {said} ({time.perf_counter() - t0:.1f} s)")
    log(f"[28] phase 28 {time.perf_counter() - t_phase:.1f} s; card {power_line}")


def _rank_log(mesh, msg: str) -> None:
    from spectrogram_tpu_torch.parallel import mesh as pmesh

    log(f"[28] rank {pmesh.mesh_rank(mesh)}: {msg}")


def _rank_launches(lib) -> dict:
    launches = {k: v for k, v in lib.launches.items() if v}
    if lib.body_launches[BLUESTEIN]:
        launches[BLUESTEIN] = lib.body_launches[BLUESTEIN]
    return launches


def _reduce_ms(mesh, dev) -> float:
    """Mean wall ms of one all-reduce of the row count (the step's one
    collective), its tensor where the backend takes it."""
    import torch.distributed as dist

    from spectrogram_tpu_torch.parallel import mesh as pmesh

    group = mesh.get_group(pmesh.STREAM_AXIS)
    t = torch.ones(1, dtype=torch.int64, device=pmesh._collective_device(group))
    dist.all_reduce(t, group=group)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(MESH_TIMED_REDUCES):
        dist.all_reduce(t, group=group)
        if t.is_cuda:
            torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / MESH_TIMED_REDUCES * 1e3


def mesh_part_a(mesh, dev, lib) -> dict:
    """Phase 28 (a): one rank under NCCL on cuda:0, BENCH_CONFIG at full
    width (k=1, no ring, packed rows), 4,096 streams on palettes arange(S) %
    19 laid out by sharded_set_palette over sharded_init; 24 shard_map_step
    pushes of chirp + tone.  Rows bit for bit the unsharded pipeline's,
    global_rows summed through NCCL = 4,096 x 24."""
    from spectrogram_tpu_torch.parallel import mesh as pmesh

    cfg, s, n = BENCH_CONFIG, MESH_A_STREAMS, BENCH_CONFIG.hop_size
    kw = dict(chunk_hops=1, store_ring=False, packed_output=True, device=dev)
    p = SpectrogramPipeline(cfg, **kw)
    ids = np.arange(s) % len(p.schemes)
    st = pmesh.sharded_set_palette(p, pmesh.sharded_init(p, s, mesh), ids, mesh)
    pcm = torch.from_numpy(testing.chirp_tone(s, MESH_TICKS * n, cfg.sample_rate,
                                              seed=28)).to(dev)
    chunks = [pcm[:, t * n:(t + 1) * n].contiguous() for t in range(MESH_TICKS)]
    del pcm
    step = pmesh.shard_map_step(p, mesh)
    torch.cuda.synchronize(dev)
    lib.reset_launches()
    rows, total, ticks = [], 0, []
    for chunk in chunks:
        t0 = time.perf_counter()
        st, r, g = step(st, chunk)
        total += int(g)                 # reads the NCCL sum on the card
        ticks.append((time.perf_counter() - t0) * 1e3)
        rows.append(r)
    torch.cuda.synchronize(dev)
    launches = _rank_launches(lib)
    if str(g.device) != str(dev):
        fail(f"phase 28 (a): the NCCL row count lives on {g.device}, not the card")
    rp = SpectrogramPipeline(cfg, **kw)
    rs = rp.set_palette(rp.init_state(s), ids)
    same = True
    for chunk, r in zip(chunks, rows):
        rs, want = rp.push(rs, chunk)
        same &= torch.equal(r, want)
    same &= torch.equal(st.carry, rs.carry)
    klass = "per-shard sorted" if p._state_perm(st) is not None else "per row"
    _rank_log(mesh, f"(a) NCCL world 1, BENCH_CONFIG, {s} streams, tables {klass} (the "
              f"unsharded state's {'sorted' if rp._state_perm(rs) is not None else 'per row'}); "
              f"{MESH_TICKS} shard_map_step pushes: rows and carry "
              f"{'equal' if same else 'DIFFER from'} the unsharded pipeline's bit for bit; "
              f"global_rows summed {total} (want {s * MESH_TICKS}); launches {launches}")
    if not same or total != s * MESH_TICKS:
        fail("phase 28 (a): the world-1 mesh disagrees with the unsharded pipeline")
    push = pmesh.sharded_push(p, mesh)
    times = {"sharded": [], "unsharded": []}
    for who in ("sharded", "unsharded", "unsharded", "sharded"):
        fn = ((lambda: push(st, chunks[0])) if who == "sharded"
              else (lambda: rp.push(rs, chunks[0])))
        times[who].append(device_ms(fn))
    reduce_ms = _reduce_ms(mesh, dev)
    sharded_ms, unsharded_ms = (float(np.mean(times[k])) for k in ("sharded", "unsharded"))
    _rank_log(mesh, f"(a) push device time at {s} streams: sharded {sharded_ms:.4f} ms, "
              f"unsharded {unsharded_ms:.4f} ms (turns a b b a); wall per tick with the NCCL "
              f"sum read p50 {np.median(ticks):.3f} ms; all-reduce {reduce_ms:.4f} ms; peak "
              f"device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return launches


def _planar_words(words: np.ndarray, dev) -> torch.Tensor:
    """[S, n, 2] int16 words as a planar [S, 2, n] tensor on `dev`."""
    return torch.from_numpy(words).to(dev).transpose(1, 2).contiguous()


def mesh_part_b(mesh, dev, lib) -> dict:
    """Phase 28 (b): two gloo ranks sharing cuda:0, the full serving mode
    (BENCH_CONFIG, k=1, no ring, i16_planes, presorted_input,
    sorted_output) at 10,240 streams, 5,120 a rank, palettes arange(S) %
    19 (the per-shard sort).  Each rank's HostShardIngest takes one hop of
    int16 tones a tick on local indices and drains it presorted; 24 ticks,
    a DCP save (unsorted) and a gathered npz at tick 12.  Rows gathered on
    rank 0 in external order equal one process's direct per-row pushes bit
    for bit; no drop; load_sharded resumes ticks 13-24 bit for bit on the
    two ranks and in one process, and so does the npz."""
    import torch.distributed as dist

    from spectrogram_tpu_torch.parallel import distributed as pdist
    from spectrogram_tpu_torch.parallel import mesh as pmesh

    cfg, s, n = BENCH_CONFIG, MESH_B_STREAMS, BENCH_CONFIG.hop_size
    rate = cfg.sample_rate
    lo, hi = pmesh.local_stream_range(mesh, s)
    rank = pmesh.mesh_rank(mesh)
    kw = dict(chunk_hops=1, store_ring=False, packed_output=True, device=dev)
    full_kw = dict(kw, i16_planes=True, presorted_input=True, sorted_output=True)
    p = SpectrogramPipeline(cfg, **full_kw)
    ids = np.arange(s) % len(p.schemes)
    st = pmesh.sharded_set_palette(p, pmesh.sharded_init(p, s, mesh), ids, mesh)
    sorted_ok = p._tables_perm_global(st.tables)
    _rank_log(mesh, f"(b) streams [{lo}, {hi}) of {s}: tables "
              f"{'per-shard sorted (t_sorted, perm, inv, marker), rank-local perm' if sorted_ok else 'NOT sorted'}")
    if not sorted_ok:
        fail("phase 28 (b): the per-shard sort did not engage at 10,240 streams")
    # hop-major int16 tones [T, S, n, 2]: rank 0 makes every stream's (its
    # reference pushes the whole batch), rank 1 its own
    if rank == 0:
        every = np.stack([_mr_tones(s, t, n, rate) for t in range(MESH_TICKS)])
        words = every[:, lo:hi]
    else:
        words = np.stack([_mr_tones(hi - lo, t, n, rate, lo=lo) for t in range(MESH_TICKS)])
    ingest = pdist.HostShardIngest(mesh, s, n, capacity=LOOP_CAPACITY, wire_int16=True)
    step = pmesh.shard_map_step(p, mesh, planar=True)
    dest = p.input_dest(st)
    out_perm = torch.from_numpy(p.output_perm(st)).to(dev)
    ck_dir, npz = MESH_WORKDIR / "b_dcp", MESH_WORKDIR / "b_gathered"
    torch.cuda.synchronize(dev)
    lib.reset_launches()
    rows, total = [], 0
    ticks = {"producer": [], "drain": [], "push": [], "wall": []}
    for t in range(MESH_TICKS):
        t0 = time.perf_counter()
        ingest.bank.push_matrix(words[t])                      # the producer
        t1 = time.perf_counter()
        chunk = ingest.drain(dest=dest)                        # with its copy to the card
        t2 = time.perf_counter()
        st, r, g = step(st, chunk)
        rows.append(r.index_select(0, out_perm))
        torch.cuda.synchronize(dev)
        t3 = time.perf_counter()
        for k, a, b in (("producer", t0, t1), ("drain", t1, t2), ("push", t2, t3),
                        ("wall", t0, t3)):
            ticks[k].append((b - a) * 1e3)
        total += int(g)
        if t + 1 == MESH_CHECKPOINT_TICK:
            checkpoint.save_sharded(ck_dir, p.unsort_state(st), cfg, pipeline=p, mesh=mesh)
            checkpoint.save_state(npz, st, cfg, pipeline=p, mesh=mesh)
    launches = _rank_launches(lib)
    m = ingest.metrics()
    empty = all(ingest.bank.size(i) == 0 for i in range(hi - lo))
    spans = "; ".join(f"{k} p50 {np.median(v):.3f} ms" for k, v in ticks.items())
    _rank_log(mesh, f"(b) {MESH_TICKS} ticks: global_rows summed {total} (want {s * MESH_TICKS}); "
              f"dropped {m['dropped']}, bank {'empty' if empty else 'NOT empty'}; launches "
              f"{launches}; per tick (the push with its all-reduce, the wall with the "
              f"checkpoint tick) {spans}, wall p99 {np.percentile(ticks['wall'], 99):.3f} ms")
    if total != s * MESH_TICKS or m["dropped"] or not empty:
        fail("phase 28 (b): rows lost, frames dropped or frames left in the bank")

    # the two-rank restore: ticks 13-24 from the DCP checkpoint
    r2 = checkpoint.load_sharded(ck_dir, p, mesh)
    resumed = p._tables_perm_global(r2.tables)
    in_perm = torch.from_numpy(p.input_perm(r2)).to(dev)
    out_perm2 = torch.from_numpy(p.output_perm(r2)).to(dev)
    for t in range(MESH_CHECKPOINT_TICK, MESH_TICKS):
        r2, got, _ = step(r2, _planar_words(words[t], dev).index_select(0, in_perm))
        resumed &= torch.equal(got.index_select(0, out_perm2), rows[t])
    _rank_log(mesh, f"(b) load_sharded onto the two ranks at tick {MESH_CHECKPOINT_TICK}: "
              f"per-shard sorted again, ticks {MESH_CHECKPOINT_TICK + 1}-{MESH_TICKS} "
              f"{'equal' if resumed else 'DIFFER from'} the uninterrupted run bit for bit")
    if not resumed:
        fail("phase 28 (b): the two-rank restore does not resume bit for bit")

    whole = [pmesh.gather_streams(r, mesh) for r in rows]
    if rank == 0:
        per_row = SpectrogramPipeline(cfg, palette_sort=False, **dict(kw, i16_planes=True))
        rs = per_row.set_palette(per_row.init_state(s), ids)
        same = True
        for t in range(MESH_TICKS):
            rs, want = per_row.push_planar(rs, _planar_words(every[t], dev))
            same &= torch.equal(whole[t], want)
        one = SpectrogramPipeline(cfg, **full_kw)
        restores = {}
        for name, state in (("load_sharded, one process", checkpoint.load_sharded(ck_dir, one)),
                            ("load_state of the gathered npz", checkpoint.load_state(npz, one))):
            ok = one._state_perm(state) is not None
            in_perm = torch.from_numpy(one.input_perm(state)).to(dev)
            out_perm1 = torch.from_numpy(one.output_perm(state)).to(dev)
            for t in range(MESH_CHECKPOINT_TICK, MESH_TICKS):
                state, got = one.push_planar(
                    state, _planar_words(every[t], dev).index_select(0, in_perm))
                ok &= torch.equal(got.index_select(0, out_perm1), whole[t])
            restores[name] = ok
        _rank_log(mesh, f"(b) rows of both ranks gathered on rank 0 in external order "
                  f"{'equal' if same else 'DIFFER from'} one process's direct per-row pushes "
                  f"of the same samples, bit for bit; "
                  + "; ".join(f"{k}: ticks {MESH_CHECKPOINT_TICK + 1}-{MESH_TICKS} "
                              f"{'equal' if v else 'DIFFER'}" for k, v in restores.items()))
        if not (same and all(restores.values())):
            fail("phase 28 (b): the two ranks' rows or a one-process restore disagree")
    del whole

    # times: each rank's push alone, then both at once; rank 0 also times an
    # unsharded pipeline of the same 5,120 streams
    chunk = ingest.drain(dest=p.input_dest(st))
    push = pmesh.sharded_push(p, mesh, planar=True)
    alone = {}
    for turn in range(mesh.size()):
        dist.barrier()
        if turn == rank:
            alone["sharded"] = device_ms(lambda: push(st, chunk))
            if rank == 0:
                local = SpectrogramPipeline(cfg, **full_kw)
                ls = local.set_palette(local.init_state(hi - lo), ids[lo:hi])
                alone["unsharded"] = device_ms(lambda: local.push_planar(ls, chunk))
                del local, ls
    dist.barrier()
    together = device_ms(lambda: push(st, chunk))
    reduce_ms = _reduce_ms(mesh, dev)
    unsharded = (f", an unsharded pipeline of the same {hi - lo} streams alone "
                 f"{alone['unsharded']:.4f} ms" if "unsharded" in alone else "")
    _rank_log(mesh, f"(b) push device time of {hi - lo} streams: alone {alone['sharded']:.4f} ms"
              f"{unsharded}; with the other rank's pushes on the card {together:.4f} ms; gloo "
              f"all-reduce (host tensor) {reduce_ms:.4f} ms; peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return launches


def mesh_part_c(mesh, dev, lib) -> dict:
    """Phase 28 (c): StreamGroupManager(mesh=...) over two gloo ranks on
    cuda:0 with phase 27's two geometries (4,096-slot groups at N=4096 and
    at N=3762 on the Bluestein body, k=1, no ring, palettes arange(S) %
    19), each rank pushing its own streams; a set_palette on each rank's
    half mid-stream.  The rows of both ranks, gathered on rank 0, equal a
    single-card manager's bit for bit before and after."""
    from spectrogram_tpu_torch.models.multirate import StreamGroupManager
    from spectrogram_tpu_torch.parallel import mesh as pmesh

    s, groups = MR_STREAMS, (BENCH_CONFIG, MR_44K)
    kw = dict(chunk_hops=1, store_ring=False)
    ids = np.arange(s) % 19
    lo, hi = pmesh.local_stream_range(mesh, s)
    rank = pmesh.mesh_rank(mesh)

    def drive(mgr, a: int, b: int, count: bool) -> dict:
        sids = {cfg: [mgr.add_stream(cfg, palette_id=int(q)) for q in ids] for cfg in groups}
        gs = {g.cfg: g for g in mgr.groups()}
        torch.cuda.synchronize(dev)
        if count:
            lib.reset_launches()
        rows = {cfg: [] for cfg in groups}
        for i in range(MR_PUSHES + 2):
            if i == MR_PUSHES:
                for cfg in groups:
                    for slot, palette in MESH_SET_PALETTE:
                        mgr.set_palette(sids[cfg][slot], palette)
            for cfg in groups:
                words = _mr_tones(b - a, i, gs[cfg].pipeline.chunk_size, cfg.sample_rate, lo=a)
                rows[cfg].append(mgr.push_group(cfg, _f32_words(words, dev)))
        torch.cuda.synchronize(dev)
        return rows, gs

    t0 = time.perf_counter()
    mgr = StreamGroupManager(group_capacity=s, mesh=mesh, device=dev, **kw)
    rows, gs = drive(mgr, lo, hi, count=True)
    launches = _rank_launches(lib)
    classes = {cfg.padded_size: ("per-shard sorted" if gs[cfg].pipeline._state_perm(gs[cfg].state)
                                 is not None else "per row") for cfg in groups}
    _rank_log(mesh, f"(c) mesh manager, streams [{lo}, {hi}) of two {s}-slot groups "
              f"(N={BENCH_CONFIG.padded_size}, N={MR_44K.padded_size} on the "
              f"{sk.fft_body(MR_44K.padded_size)} body), tables {classes}: {MR_PUSHES + 2} "
              f"pushes a group in {time.perf_counter() - t0:.1f} s with the add_stream calls; "
              f"launches {launches}")
    if not (launches.get(sk.KERNEL) and launches.get(BLUESTEIN)):
        fail("phase 28 (c): the mesh manager did not launch kernel A at N=4096 and the "
             "Bluestein body at N=3762")
    whole = {cfg: [pmesh.gather_streams(r, mesh) for r in rows[cfg]] for cfg in groups}
    if rank == 0:
        single = StreamGroupManager(group_capacity=s, device=dev, **kw)
        want, _ = drive(single, 0, s, count=False)
        same = {cfg.padded_size: [torch.equal(a, b) for a, b in zip(whole[cfg], want[cfg])]
                for cfg in groups}
        _rank_log(mesh, "(c) both ranks' rows gathered on rank 0 against a single-card "
                  "manager, push by push (a set_palette on each rank's half before push "
                  f"{MR_PUSHES + 1}): {same}")
        if not all(all(v) for v in same.values()):
            fail("phase 28 (c): the mesh manager disagrees with the single-card manager")
    return launches


def mesh_rank_main(argv: list) -> int:
    """One rank of phase-28 parts (`python chip_smoke.py --mesh-part a` or
    `bc`, started by `mesh_serving`): brings up the process group, runs
    the parts in turn and writes their kernel launches to
    <out>/<parts>_r<rank>.json."""
    import argparse

    import torch.distributed as dist

    from spectrogram_tpu_torch.parallel import distributed as pdist
    from spectrogram_tpu_torch.parallel import mesh as pmesh

    ap = argparse.ArgumentParser()
    for flag in ("--mesh-part", "--init", "--out", "--device", "--backend"):
        ap.add_argument(flag, default=None)
    ap.add_argument("--world", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch.cuda.is_available() is false; this check needs a CUDA card")
    rank = int(os.environ["RANK"])
    pdist.initialize(init_method=None if args.world == 1 else args.init, world_size=args.world,
                     rank=rank, backend=args.backend, device=args.device)
    mesh = pdist.global_mesh()
    dev = pmesh.rank_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = _build.library()
    parts = {"a": mesh_part_a, "b": mesh_part_b, "c": mesh_part_c}
    _rank_log(mesh, f"({args.mesh_part}) {dist.get_backend()} world {args.world}, device {dev}")
    launches = {}
    for name in args.mesh_part:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        for k, v in parts[name](mesh, dev, lib).items():
            launches[k] = launches.get(k, 0) + v
        dist.barrier()
    doc = dict(launches=launches)
    pathlib.Path(args.out, f"{args.mesh_part}_r{rank}.json").write_text(json.dumps(doc))
    dist.destroy_process_group()
    return 0


# ------------------------------------------------------------------ phase 29

TUNE_STREAMS = 4096
TUNE_PUSHES = 4
TUNE_KW = dict(chunk_hops=1, store_ring=False, packed_output=True)
SERVING_KW = dict(TUNE_KW, i16_planes=True, presorted_input=True, sorted_output=True)
# (label, config, pipeline arguments, streams): the geometries whose every
# launch candidate phase 29 holds to the table's bits
TUNE_GEOMETRIES = (
    ("BENCH k=1 (radix-2 kernel A, kernel B)", BENCH_CONFIG, TUNE_KW, TUNE_STREAMS),
    ("DEFAULT k=1 (mixed radix, N=4800)", DEFAULT_CONFIG, TUNE_KW, TUNE_STREAMS),
    ("N=16,384 k=1 (radix 2, the direct tile)", LONG_COLORMAP, TUNE_KW, TUNE_STREAMS),
    ("full serving mode (int16 kernel A, blockwise)", BENCH_CONFIG, SERVING_KW, 10240),
    ("BENCH split-real k=1", BENCH_CONFIG, dict(TUNE_KW, stft_packed=False), TUNE_STREAMS),
    ("BENCH k=8 (the all-windows kernel)", BENCH_CONFIG, dict(TUNE_KW, chunk_hops=K),
     TUNE_STREAMS),
)
# each launch family's kernels on the paths above
FAMILY_KERNELS = {
    "packed": (sk.KERNEL, sk.MIXED_KERNEL, sk.ALLK_KERNEL, sk.KERNEL_I16),
    "split": (sk.SPLIT_KERNEL,),
    "tile": (ck.KERNEL, ck.BLOCKWISE_KERNEL, ck.GENERIC_KERNEL),
}


def _tune_streams(p, s: int, cfg, seed: int, dev):
    """(state on palettes arange(S) % 19, the chunks of TUNE_PUSHES pushes
    of chirp+tone in the order and dtype the pipeline takes)."""
    state = p.set_palette(p.init_state(s), np.arange(s) % len(p.schemes))
    pcm = testing.chirp_tone(s, TUNE_PUSHES * p.chunk_size, cfg.sample_rate, seed=seed)
    chunks = [pcm[:, i * p.chunk_size : (i + 1) * p.chunk_size] for i in range(TUNE_PUSHES)]
    perm = p.input_perm(state)
    if perm is not None:
        chunks = [c[perm] for c in chunks]
    if p.i16_planes:
        chunks = [np.round(c * 32767.0).astype(np.int16) for c in chunks]
    return state, [torch.from_numpy(np.ascontiguousarray(c)).to(dev) for c in chunks]


def _pushed(p, state, chunks):
    rows = []
    for chunk in chunks:
        state, r = p.push(state, chunk)
        rows.append(r)
    return torch.cat(rows, dim=1), state.carry


def launch_candidates_check(dev, lib, main_launches: dict, power_line: str) -> None:
    """Phase 29 (a): at each TUNE_GEOMETRIES geometry, every launch shape of
    the push's families (`launch_families`) gives the table's rows and next
    carry bit for bit over TUNE_PUSHES pushes, its family's kernels
    launching; device ms per push beside the table's.  The fused push's
    shapes on the split-real geometry's windows, against its table bits."""
    for label, cfg, kw, s in TUNE_GEOMETRIES:
        p = SpectrogramPipeline(cfg, device=dev, **kw)
        state, chunks = _tune_streams(p, s, cfg, 29, dev)
        p.override_launch({})
        want_rows, want_carry = _pushed(p, state, chunks)
        timed = [state]

        def push():
            timed[0], _ = p.push(timed[0], chunks[0])

        table_ms = device_ms(push)
        families = p.launch_families()
        log(f"[29] (a) {label}, {s} streams: families {families}; the table's launch "
            f"{table_ms:.4f} ms/push")
        for family, choices in families.items():
            for choice in choices:
                p.override_launch({family: choice})
                torch.cuda.synchronize()
                lib.reset_launches()
                rows, carry = _pushed(p, state, chunks)
                torch.cuda.synchronize()
                launched = _count(lib, main_launches)
                same = torch.equal(rows, want_rows) and torch.equal(carry, want_carry)
                ran = any(launched.get(k) for k in FAMILY_KERNELS[family])
                ms = device_ms(push)
                log(f"[29] (a)   {family}={choice} "
                    f"({sk.LAUNCH_BOUNDS.get(choice) if family != 'tile' else ck.TILE_FORMS[choice]}): "
                    f"rows and carry {'equal' if same else 'DIFFER from'} the table's bit for bit; "
                    f"{ms:.4f} ms/push ({ms / table_ms:.3f}x the table's)")
                if not same:
                    fail(f"phase 29: {label} {family}={choice} changes the rows")
                if not ran:
                    fail(f"phase 29: {label} {family}={choice} launched no kernel of its "
                         f"family ({launched})")
        p.override_launch({})
        del state, chunks, want_rows, want_carry, timed
        if not kw.get("stft_packed", True):
            fused_push_candidates(p, cfg, dev, lib, main_launches)
        torch.cuda.empty_cache()
    log(f"[29] (a) card {power_line}")


def fused_push_candidates(p, cfg, dev, lib, main_launches: dict) -> None:
    """The fused push's launch shapes at `cfg` on TUNE_STREAMS window rows
    of chirp+tone, per-row tables arange % 19: each bit for bit the
    table's, launching spk_push_fused; device ms beside the table's."""
    left, right = windows(cfg, "chirp_tone", TUNE_STREAMS, dev)
    ids = torch.arange(TUNE_STREAMS, device=dev) % len(p.schemes)
    tables = p.builtin_tables.index_select(0, ids).contiguous()

    def run(launch=None):
        return pk.push_fused(left, right, p.split_hann, p.fft_consts, tables, p.taps, cfg,
                             launch=launch)

    want = run()
    table_ms = device_ms(run)
    for choice in sk.launch_candidates("push", cfg.padded_size, cfg.window_size):
        lib.reset_launches()
        got = run(choice)
        torch.cuda.synchronize()
        launched = _count(lib, main_launches)
        ms = device_ms(lambda: run(choice))
        same = torch.equal(got, want)
        log(f"[29] (a)   fused push={choice} ({sk.LAUNCH_BOUNDS[choice]}), "
            f"{TUNE_STREAMS} rows: {'equal' if same else 'DIFFER from'} the table's bit for "
            f"bit; {ms:.4f} ms ({ms / table_ms:.3f}x the table's {table_ms:.4f} ms)")
        if not same or not launched.get(pk.KERNEL):
            fail(f"phase 29: the fused push at {choice} disagrees or did not launch")


def tuner_runs(dev, lib, main_launches: dict, power_line: str) -> None:
    """Phase 29 (b): `autotune.tune` on a fresh cache in a temporary
    directory at each TUNE_GEOMETRIES geometry, with its pipeline's
    `tune_kwargs`: the pick, its ms, the table's, the seconds spent; a
    second call measures nothing; SpectrogramPipeline(autotune=True) from
    that cache measures nothing and gives the untuned pipeline's rows bit
    for bit; a StreamGroupManager(autotune=True) of two geometries keeps
    each group's own pick."""
    import tempfile

    from spectrogram_tpu_torch.models.multirate import StreamGroupManager
    from spectrogram_tpu_torch.utils import autotune

    calls = []
    plain_measure = autotune.measure_push

    def counted(*args, **kw):
        calls.append(args[1])
        return plain_measure(*args, **kw)

    saved = autotune.DEFAULT_CACHE
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        autotune.DEFAULT_CACHE = pathlib.Path(tmp) / "autotune.json"
        try:
            picks = {}
            for label, cfg, kw, s in TUNE_GEOMETRIES:
                untuned = SpectrogramPipeline(cfg, device=dev, **kw)
                tkw = untuned.tune_kwargs()
                n0, t0 = len(calls), time.perf_counter()
                pick = autotune.tune(cfg, pipeline_kwargs=tkw, measure=counted, device=dev)
                spent = time.perf_counter() - t0
                key = autotune._cache_key(cfg, torch.cuda.get_device_name(dev), tkw)
                entry = autotune._load_cache(autotune.DEFAULT_CACHE).get(key, {})
                times = entry.get("ms", {})
                table = entry.get("table", pick)
                shown = "; ".join(
                    f"{f}: "
                    + (" / ".join(f"{c} {t:.4f}" for c, t in times[f].items())
                       + f" ms, pick {pick[f]} ({times[f][str(pick[f])]:.4f} ms), table "
                       f"{table[f]}" if f in times
                       else f"{pick[f]} (one candidate, not measured)")
                    for f in pick)
                log(f"[29] (b) tune {label}: {len(calls) - n0} measurements in {spent:.1f} s; "
                    f"{shown or 'nothing to tune'}")
                n1 = len(calls)
                again = autotune.tune(cfg, pipeline_kwargs=tkw, measure=counted, device=dev)
                tuned = SpectrogramPipeline(cfg, device=dev, autotune=True, **kw)
                if again != pick or len(calls) != n1 or tuned.launch != pick:
                    fail(f"phase 29: {label}: the second tune or the autotune=True pipeline "
                         f"measured again or picked otherwise ({again}, {tuned.launch}, "
                         f"{len(calls) - n1} measurements)")
                state, chunks = _tune_streams(untuned, min(s, TUNE_STREAMS), cfg, 30, dev)
                a = _pushed(untuned, state, chunks)
                b = _pushed(tuned, state, chunks)
                same = all(torch.equal(x, y) for x, y in zip(a, b))
                log(f"[29] (b)   SpectrogramPipeline(autotune=True) from the cache: launch "
                    f"{tuned.launch}, no measurement; rows and carry "
                    f"{'equal' if same else 'DIFFER from'} the untuned pipeline's bit for bit")
                if not same:
                    fail(f"phase 29: {label}: the tuned pipeline's rows differ")
                picks[label] = pick
                del untuned, tuned, state, chunks, a, b
                torch.cuda.empty_cache()
            # two geometries in one manager, each group's pipeline its own pick
            n2, t0 = len(calls), time.perf_counter()
            autotune.measure_push = counted
            try:
                mgr = StreamGroupManager(group_capacity=TUNE_STREAMS, device=dev,
                                         autotune=True, **TUNE_KW)
                for cfg in (BENCH_CONFIG, MR_44K):
                    mgr.add_stream(cfg)
            finally:
                autotune.measure_push = plain_measure
            own = {}
            for cfg, group in mgr._groups.items():
                own[cfg.padded_size] = autotune.tune(
                    cfg, pipeline_kwargs=group.pipeline.tune_kwargs(), measure=counted,
                    device=dev)
                if group.pipeline.launch != own[cfg.padded_size]:
                    fail(f"phase 29: the manager's N={cfg.padded_size} group does not launch "
                         f"its own pick ({group.pipeline.launch} against {own})")
            differ = len({tuple(sorted(v.items())) for v in own.values()}) > 1
            log(f"[29] (b) StreamGroupManager(autotune=True), groups N=4096 and "
                f"N={MR_44K.padded_size}: launches {own} ({'different' if differ else 'the same'}"
                f" picks, each group its own); {len(calls) - n2} measurements "
                f"(the N={MR_44K.padded_size} group tuned on adding it) in "
                f"{time.perf_counter() - t0:.1f} s")
            del mgr
        finally:
            autotune.DEFAULT_CACHE = saved
    log(f"[29] (b) card {power_line}")


def tuner_phase(dev, lib, main_launches: dict, power_line: str) -> None:
    """Phase 29: the autotuner's launch shapes on the card."""
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    launch_candidates_check(dev, lib, main_launches, power_line)
    tuner_runs(dev, lib, main_launches, power_line)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[29] phase 29 {time.perf_counter() - t_phase:.1f} s; peak device memory "
        f"{peak:.2f} GiB; card {power_line}")


if __name__ == "__main__":
    if "--mesh-part" in sys.argv:
        sys.exit(mesh_rank_main(sys.argv[1:]))
    sys.exit(main())
