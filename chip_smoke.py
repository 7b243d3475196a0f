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
  5. the main path: SpectrogramPipeline(BENCH_CONFIG, device="cuda"), 4096
     streams, palettes arange(S) % 19, 4 pushes of chirp+tone.  Both kernels'
     launch counts must rise; the rows must equal process() on the same PCM
     exactly, and the same push on the plain versions within 1 u8 on what
     the image shows; the next carry exactly.
  6. timing with CUDA events after a warm-up: ms/push and rows/s for the
     kernel path and the plain path, and each kernel against its plain
     version.

The second-to-last line is {"kernels": [...]}, the last {"ok": true, ...}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from spectrogram_tpu_torch import testing
from spectrogram_tpu_torch.config import BENCH_CONFIG
from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline
from spectrogram_tpu_torch.ops.cuda import _build
from spectrogram_tpu_torch.ops.cuda import colormap_kernel as ck
from spectrogram_tpu_torch.ops.cuda import stft_kernel as sk

STREAMS = 4096
PUSHES = 4
STFT_ATOL, STFT_RTOL = 3e-5, 1e-4
TIMED_ITERS = 20

KERNELS = {
    sk.KERNEL: dict(
        name="stft_packed", source="spectrogram_tpu_torch/csrc/stft_packed.cu",
        replaces="spectrogram_tpu/ops/pallas/stft_kernel.py:509",
    ),
    ck.KERNEL: dict(
        name="colormap_builtin",
        source="spectrogram_tpu_torch/csrc/colormap_builtin.cu",
        replaces="spectrogram_tpu/ops/pallas/colormap_kernel.py:1072",
    ),
}


def log(msg: str) -> None:
    print(msg, flush=True)


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


def plain_push(p: SpectrogramPipeline, state, chunk):
    """The push of `p` on the plain PyTorch versions of both kernels."""
    left, right, new_carry = p.frame_windows(state, chunk.transpose(1, 2))
    ml, mr = sk.stft_mag_packed_plain(left, right, p.hann, p.cfg.padded_size)
    rows = ck.colormap_builtin_plain(ml, mr, p.taps, state.tables[0], p.cfg)
    return new_carry, rows.reshape(left.shape[0], 1, -1)


def main() -> int:
    power_line = card()
    dev = torch.device("cuda", 0)
    cfg = BENCH_CONFIG

    t0 = time.perf_counter()
    path, nvcc_s = _build.build()
    lib = _build.library()
    log(f"[2] build: {path} (nvcc {nvcc_s:.2f} s, with load {time.perf_counter() - t0:.2f} s)")

    # -- 3. kernel A against torch.fft ---------------------------------------
    p = SpectrogramPipeline(cfg, device=dev)
    w = cfg.window_size
    stats = {sk.KERNEL: 0.0, ck.KERNEL: 0}
    planes = {}
    for kind in ("chirp_tone", "noise"):
        frames = testing.make(kind, STREAMS, w, cfg.sample_rate, seed=1)
        left = torch.from_numpy(np.ascontiguousarray(frames[..., 0])).to(dev)
        right = torch.from_numpy(np.ascontiguousarray(frames[..., 1])).to(dev)
        got = sk.stft_mag_packed(left, right, p.hann, p.twiddles)
        want = sk.stft_mag_packed_plain(left, right, p.hann, cfg.padded_size)
        torch.cuda.synchronize()
        err = max(float((g - x).abs().max()) for g, x in zip(got, want))
        # relative error where it means something: above the absolute bar
        rel = max(float(((g - x).abs() / x.abs())[x.abs() >= STFT_ATOL].max())
                  for g, x in zip(got, want))
        ok = all(torch.allclose(g, x, atol=STFT_ATOL, rtol=STFT_RTOL)
                 for g, x in zip(got, want))
        log(f"[3] stft_packed {kind}: max abs err {err:.3e}, max rel err {rel:.3e} "
            f"(bar atol {STFT_ATOL} rtol {STFT_RTOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("FAIL: stft_packed disagrees with torch.fft")
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
            raise SystemExit("FAIL: colormap_builtin disagrees with its plain version")
        stats[ck.KERNEL] = max(stats[ck.KERNEL], int(diff.max()))

    # -- 5. the main path -----------------------------------------------------
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
        raise SystemExit("FAIL: main path output has the wrong shape or type")
    if not all(launches[k] > 0 for k in KERNELS):
        raise SystemExit("FAIL: the main path did not launch every kernel")

    padded = torch.cat([torch.zeros(STREAMS, p.carry_size, 2, device=dev),
                        torch.from_numpy(pcm).to(dev)], dim=1)
    for palette in range(len(p.schemes)):
        sel = torch.from_numpy(np.flatnonzero(pid == palette)).to(dev)
        one = p.process(padded.index_select(0, sel), palette_id=palette)
        if not torch.equal(one, streamed.index_select(0, sel)):
            raise SystemExit(f"FAIL: streamed rows differ from process() for palette {palette}")
    log("[5] streamed rows equal process() exactly, every palette")

    plain_state = state._replace(carry=plain_carry, tables=plain_tables)
    worst = 0
    for i, chunk in enumerate(chunks):
        new_carry, r = plain_push(p, plain_state, chunk)
        worst = max(worst, testing.rgba_u8_diff(ck.unpack_rgba(rows[i]), ck.unpack_rgba(r)))
        plain_state = plain_state._replace(carry=new_carry)
    if not torch.equal(plain_state.carry, state.carry):
        raise SystemExit("FAIL: next carry differs from the plain path's")
    log(f"[5] against the plain path on the card: max u8 diff {worst} over what "
        f"the image shows (bar 1); next carry equal")
    if worst > 1:
        raise SystemExit("FAIL: main path disagrees with the plain path")

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
    push_state = [state]

    def kernel_push():
        push_state[0], _ = p.push(push_state[0], chunks[0])

    def plain_path_push():
        plain_push(p, state, chunks[0])

    push_ms = time_ms(kernel_push)
    plain_push_ms = time_ms(plain_path_push)
    for k, meta in KERNELS.items():
        log(f"[6] {meta['name']}: {ms[k]:.4f} ms (plain {plain_ms[k]:.4f} ms)")
    log(f"[6] push at {STREAMS} streams: kernels {push_ms:.4f} ms/push "
        f"= {STREAMS / push_ms * 1e3:.1f} rows/s; plain {plain_push_ms:.4f} ms/push "
        f"= {STREAMS / plain_push_ms * 1e3:.1f} rows/s; card {power_line}")

    print(power_line)
    print(json.dumps({"kernels": [
        dict(meta, route="cuda", launches=launches[k], max_abs_err=stats[k],
             ms=ms[k], plain_ms=plain_ms[k])
        for k, meta in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
