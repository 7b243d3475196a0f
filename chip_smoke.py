"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA card, `nvcc` and
`nvidia-smi`; it imports `spectrogram_tpu_torch`, torch and numpy only.
Phases, each of which fails the run with a non-zero exit:

  1. the card: torch sees it; nvidia-smi's name and power limit.
  2. build: csrc/*.cu -> build/kernels/libspectrogram_kernels.so (sm_90a).
  3. kernel A (packed STFT) against its plain version, 4096 rows of
     chirp+tone and of noise at BENCH_CONFIG: atol 3e-5 / rtol 1e-4.
  4. kernel B (built-in colormap) against its plain version on those planes
     with scattered per-row palettes: at most 1 u8 per channel.
  5. the k=1 main path: SpectrogramPipeline(BENCH_CONFIG, device="cuda",
     store_ring=False), 4096 streams, palettes arange(S) % 19, 4 pushes of
     chirp+tone.  Both kernels' launch counts must rise; the rows must equal
     process() on the same PCM exactly, and the same push on the plain
     versions within 1 u8 on what the image shows; the next carry exactly.
  6. timing with CUDA events after a warm-up: ms/push and rows/s for the
     kernel path and the plain path, and each kernel against its plain
     version.
  7. the mixed-radix kernel A at DEFAULT_CONFIG (N=4800) against its plain
     version, 4096 rows of chirp+tone and of noise, phase 3's bar; and
     torch.fft.fft on [4096, N] complex64 at N=4096 and N=4800, the library
     call beside kernel A.
  8. the all-windows STFT kernel against its plain version, k=8 at 4096
     streams, BENCH_CONFIG (buffers [4096, 7648]) and DEFAULT_CONFIG, phase
     3's bar.
  9. the display path, at BENCH_CONFIG and at DEFAULT_CONFIG:
     SpectrogramPipeline(cfg, chunk_hops=8, device="cuda") with its ring
     (R=2048), 256 streams, palettes arange(S) % 19, 260 pushes of
     chirp+tone (the ring wraps), process() of the same PCM, and
     render_viewport at R and at width 800.  The launch counts of the
     all-windows kernel, kernel A (process) and kernel B must rise; the
     streamed rows must equal process() exactly; rows, ring and next carry
     must match the same pushes on the plain versions (1 u8 over what the
     image shows, 1 bf16 ulp beyond the STFT bar, exactly); both renders
     within 1 u8 of the plain render of the same state.
 10. timing with CUDA events after a warm-up: the k=8 push at BENCH_CONFIG,
     4096 streams, no ring; the display push and render_viewport at 256
     streams; each new kernel against its plain version; peak device memory.

The second-to-last line is {"kernels": [...]}: each kernel's launches on the
main paths (phases 5 and 9), its largest error against its plain version,
its time, its plain version's, the library call's where one computes the
same transform, and its bound: the larger of its bytes (each input read
once, each output written once) over 3.35 TB/s and its f32 operations over
67 TFLOP/s, the H100 SXM's published peaks.  The last line is
{"ok": true, ...}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from spectrogram_tpu_torch import testing
from spectrogram_tpu_torch.config import BENCH_CONFIG, DEFAULT_CONFIG
from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline
from spectrogram_tpu_torch.ops.cuda import _build
from spectrogram_tpu_torch.ops.cuda import colormap_kernel as ck
from spectrogram_tpu_torch.ops.cuda import stft_kernel as sk

STREAMS = 4096
PUSHES = 4
STFT_ATOL, STFT_RTOL = 3e-5, 1e-4
TIMED_ITERS = 20
K = 8                       # chunk_hops of the display path
DISPLAY_STREAMS = 256
DISPLAY_PUSHES = 260        # > 2048 / 8: the ring wraps
RENDER_WIDTH = 800
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
F32_FLOPS_PER_S = 67e12     # float32 outside the tensor cores
CMAP_OPS_PER_PIXEL = 50     # kernel B's f32 operations per pixel, from its source

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
}


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


def stft_work(rows: int, n_fft: int, w: int, input_floats: int) -> tuple[float, float]:
    """(bytes, flops) of packed STFT magnitudes for `rows` windows: the two
    input channels' `input_floats` samples, hann, the N/2 twiddles the
    stages read, two [rows, N/2] outputs; 5 N log2 N operations per complex
    FFT plus the window multiply and the unpack."""
    nbytes = 4 * (2 * input_floats + w + n_fft) + 4 * 2 * rows * (n_fft // 2)
    flops = rows * (5 * n_fft * np.log2(n_fft) + 2 * w + 12 * (n_fft // 2))
    return nbytes, flops


def cmap_work(rows: int, taps: ck.ResampleTaps, tables: torch.Tensor) -> tuple[float, float]:
    """(bytes, flops) of kernel B: the plane bins its taps touch, the taps,
    the tables, the [rows, H] i32 output."""
    touched = torch.unique(torch.cat([taps.j0, taps.j1])).numel()
    h = taps.j0.numel()
    nbytes = 4 * 2 * rows * touched + 16 * h + 4 * tables.numel() + 4 * rows * h
    return nbytes, rows * h * CMAP_OPS_PER_PIXEL


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


def main() -> int:
    power_line = card()
    dev = torch.device("cuda", 0)
    cfg = BENCH_CONFIG

    t0 = time.perf_counter()
    path, nvcc_s = _build.build()
    lib = _build.library()
    log(f"[2] build: {path} (nvcc {nvcc_s:.2f} s, with load {time.perf_counter() - t0:.2f} s)")

    # -- 3. kernel A against torch.fft ---------------------------------------
    p = SpectrogramPipeline(cfg, store_ring=False, device=dev)
    stats = {name: 0.0 for name in KERNELS}
    planes = {}
    for kind in ("chirp_tone", "noise"):
        left, right = windows(cfg, kind, STREAMS, dev)
        got = sk.stft_mag_packed(left, right, p.hann, p.twiddles)
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
        sk.KERNEL: time_ms(lambda: sk.stft_mag_packed(left, right, p.hann, p.twiddles)),
        ck.KERNEL: time_ms(lambda: ck.colormap_builtin(ml, mr, p.taps, tables, cfg)),
    }
    plain_ms = {
        sk.KERNEL: time_ms(lambda: sk.stft_mag_packed_plain(left, right, p.hann, cfg.padded_size)),
        ck.KERNEL: time_ms(lambda: ck.colormap_builtin_plain(ml, mr, p.taps, tables, cfg)),
    }
    bounds = {
        sk.KERNEL: bound(*stft_work(STREAMS, cfg.padded_size, cfg.window_size,
                                    STREAMS * cfg.window_size)),
        ck.KERNEL: bound(*cmap_work(STREAMS, p.taps, tables)),
    }
    push_state = [state]

    def kernel_push():
        push_state[0], _ = p.push(push_state[0], chunks[0])

    def plain_path_push():
        plain.push(state, chunks[0])

    push_ms = time_ms(kernel_push)
    plain_push_ms = time_ms(plain_path_push)
    for k in (sk.KERNEL, ck.KERNEL):
        log(f"[6] {KERNELS[k]['name']}: {ms[k]:.4f} ms (plain {plain_ms[k]:.4f} ms, "
            f"bound {bounds[k][0]:.4f} ms by {bounds[k][1]})")
    log(f"[6] push at {STREAMS} streams: kernels {push_ms:.4f} ms/push "
        f"= {STREAMS / push_ms * 1e3:.1f} rows/s; plain {plain_push_ms:.4f} ms/push "
        f"= {STREAMS / plain_push_ms * 1e3:.1f} rows/s; card {power_line}")
    del planes, left, right, ml, mr, padded, streamed, rows, chunks, push_state

    # -- 7. the mixed-radix kernel A --------------------------------------------
    dcfg = DEFAULT_CONFIG
    pd = SpectrogramPipeline(dcfg, store_ring=False, device=dev)
    for kind in ("chirp_tone", "noise"):
        dl, dr = windows(dcfg, kind, STREAMS, dev)
        got = sk.stft_mag_packed(dl, dr, pd.hann, pd.twiddles)
        want = sk.stft_mag_packed_plain(dl, dr, pd.hann, dcfg.padded_size)
        torch.cuda.synchronize()
        err, rel, ok = stft_errors(got, want)
        log(f"[7] stft_mixed N={dcfg.padded_size} {kind}: max abs err {err:.3e}, max rel "
            f"err {rel:.3e} (bar atol {STFT_ATOL} rtol {STFT_RTOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("stft_mixed disagrees with torch.fft")
        stats[sk.MIXED_KERNEL] = max(stats[sk.MIXED_KERNEL], err)
    ms[sk.MIXED_KERNEL] = time_ms(lambda: sk.stft_mag_packed(dl, dr, pd.hann, pd.twiddles))
    plain_ms[sk.MIXED_KERNEL] = time_ms(
        lambda: sk.stft_mag_packed_plain(dl, dr, pd.hann, dcfg.padded_size))
    bounds[sk.MIXED_KERNEL] = bound(*stft_work(
        STREAMS, dcfg.padded_size, dcfg.window_size, STREAMS * dcfg.window_size))
    library_ms = {ck.KERNEL: None}
    for name, n in ((sk.KERNEL, cfg.padded_size), (sk.MIXED_KERNEL, dcfg.padded_size)):
        z = torch.complex(torch.randn(STREAMS, n, device=dev), torch.randn(STREAMS, n, device=dev))
        library_ms[name] = time_ms(lambda: torch.fft.fft(z))
        log(f"[7] torch.fft.fft [{STREAMS}, {n}] complex64: {library_ms[name]:.4f} ms")
    del dl, dr, got, want, z

    # -- 8. the all-windows kernel ----------------------------------------------
    allk_inputs = {}
    for c, pp in ((cfg, p), (dcfg, pd)):
        length = c.window_size + (K - 1) * c.hop_size
        buf = testing.chirp_tone(STREAMS, length, c.sample_rate, seed=3)
        bl = torch.from_numpy(np.ascontiguousarray(buf[..., 0])).to(dev)
        br = torch.from_numpy(np.ascontiguousarray(buf[..., 1])).to(dev)
        got = sk.stft_mag_packed_allk(bl, br, pp.hann, pp.twiddles, K, c.hop_size)
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
    torch.cuda.reset_peak_memory_stats()
    main_launches = {name: launches.get(name, 0) for name in KERNELS}
    display = {}
    for c in (cfg, dcfg):
        display[c.padded_size] = display_path(c, dev, lib, main_launches)

    # -- 10. timing -------------------------------------------------------------
    bl, br, pp = allk_inputs[cfg.padded_size]
    hop = cfg.hop_size
    ms[sk.ALLK_KERNEL] = time_ms(lambda: sk.stft_mag_packed_allk(bl, br, pp.hann, pp.twiddles, K, hop))
    plain_ms[sk.ALLK_KERNEL] = time_ms(
        lambda: sk.stft_mag_packed_allk_plain(bl, br, pp.hann, cfg.padded_size, K, hop))
    bounds[sk.ALLK_KERNEL] = bound(*stft_work(
        K * STREAMS, cfg.padded_size, cfg.window_size, bl.numel()))
    z = torch.complex(torch.randn(K * STREAMS, cfg.padded_size, device=dev),
                      torch.randn(K * STREAMS, cfg.padded_size, device=dev))
    library_ms[sk.ALLK_KERNEL] = time_ms(lambda: torch.fft.fft(z))
    del z
    dbl, dbr, dpp = allk_inputs[dcfg.padded_size]
    dms = time_ms(lambda: sk.stft_mag_packed_allk(dbl, dbr, dpp.hann, dpp.twiddles, K, dcfg.hop_size))
    dplain = time_ms(lambda: sk.stft_mag_packed_allk_plain(
        dbl, dbr, dpp.hann, dcfg.padded_size, K, dcfg.hop_size))
    dbound = bound(*stft_work(K * STREAMS, dcfg.padded_size, dcfg.window_size, dbl.numel()))
    for name in (sk.MIXED_KERNEL, sk.ALLK_KERNEL):
        log(f"[10] {KERNELS[name]['name']}: {ms[name]:.4f} ms (plain {plain_ms[name]:.4f} ms, "
            f"torch.fft.fft {library_ms[name]:.4f} ms, bound {bounds[name][0]:.4f} ms by "
            f"{bounds[name][1]})")
    log(f"[10] stft_allk k={K} at DEFAULT_CONFIG, {STREAMS} streams: {dms:.4f} ms "
        f"(plain {dplain:.4f} ms, bound {dbound[0]:.4f} ms by {dbound[1]})")
    del allk_inputs, bl, br, dbl, dbr

    # the JAX bench's BENCH_CHUNK_HOPS=8 mode: 4096 streams, no ring
    pk = SpectrogramPipeline(cfg, chunk_hops=K, store_ring=False, device=dev)
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
    p = SpectrogramPipeline(cfg, chunk_hops=K, device=dev)
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
        main_launches[name] += launches[name]
    log(f"[9] display N={n}: {DISPLAY_PUSHES} pushes x {s} streams -> "
        f"{tuple(streamed.shape)}, ring {tuple(state.ring.shape)} "
        f"({state.ring.numel() * 2 / 2**30:.2f} GiB), cursor {int(state.cursor)}, "
        f"row_count {int(state.row_count)}; launches {launches}")
    allk_or_a = sk.KERNEL if n & (n - 1) == 0 else sk.MIXED_KERNEL
    if not all(launches[name] > 0 for name in (sk.ALLK_KERNEL, allk_or_a, ck.KERNEL)):
        fail("the display path did not launch every kernel")
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


if __name__ == "__main__":
    sys.exit(main())
