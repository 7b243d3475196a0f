"""Production-shaped serving loop on the PyTorch/CUDA port: int16 ingest ->
async device feed -> packed rows.

`examples/serve.py`'s loop on `spectrogram_tpu_torch`, scaled by --streams
(default 512 so it runs quickly anywhere):

  producer threads -> RingBank16 (int16 SPSC rings, counted drops)
      -> pop_matrix_f32_planar (one multithreaded drain per hop tick;
         i16->f32 conversion AND channel deinterleave fused into the copy),
         or pop_matrix_i16_planar with --wire-int16 (raw words, half the
         host->device bytes)
      -> DeviceFeeder (depth 2; pinned ChunkPool slots copied to the card
         on a side stream while the previous push runs)
      -> packed RGBA8888 rows out

Run: python examples/serve_torch.py [--streams 512] [--seconds 5]
     [--device cpu]

With --presorted-input the drain writes each stream straight into its
palette-sorted chunk row (`pipeline.input_dest`, re-derived after every
`set_palette`), and --palette-sort lets the rows leave the card in sorted
order (`pipeline.output_perm` says where each stream's rows are).
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import threading
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

from spectrogram_tpu_torch.config import SpectrogramConfig
from spectrogram_tpu_torch.io.feeder import ChunkPool, DeviceFeeder
from spectrogram_tpu_torch.io.ring import RingBank16
from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline
from spectrogram_tpu_torch.ops.cuda.colormap_kernel import unpack_rgba
from spectrogram_tpu_torch.utils.profiling import LatencyTracker


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=512)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument(
        "--uniform-palette", type=str, default=None, dest="uniform_palette",
        help="serve every stream with ONE palette (name or index): one "
        "table for all rows, still runtime-switchable via set_palette",
    )
    ap.add_argument(
        "--probe-readback", action="store_true",
        help="force completion without copying full row blocks to the host "
        "(rows stay on the device)",
    )
    ap.add_argument(
        "--wire-int16", action="store_true", dest="wire_int16",
        help="drain the ingest bank as RAW int16 and scale 1/32768 on the "
        "device (bit-identical to the f32 drain): HALF the host->device "
        "bytes per push — the production wire format for PCM sources",
    )
    ap.add_argument(
        "--palette-sort", action="store_true", dest="palette_sort",
        help="multi-tenant scattered palettes + sorted_output: set a "
        "worst-case scattered layout (the library's palette_sort — default "
        "ON — sorts it onto the blockwise colormap, sorted-carry streaming "
        "mode) and let rows leave the device in sorted order; the drain "
        "reindexes via pipeline.output_perm",
    )
    ap.add_argument(
        "--presorted-input", action="store_true", dest="presorted_input",
        help="host-sorted drain: the bank pops each stream straight into "
        "its SORTED chunk row (pipeline.input_dest -> the drain's dest "
        "parameter), so the device-side per-push chunk gather never exists. "
        "Implies --palette-sort's scattered layout",
    )
    ap.add_argument(
        "--i16-planes", action="store_true", dest="i16_planes",
        help="int16 sample planes end-to-end: the carry, the framing and "
        "the STFT kernel's operands stay in the wire dtype, bitwise. "
        "Implies --wire-int16",
    )
    ap.add_argument(
        "--device", type=str, default=None,
        help="the pipeline's device (default: the current CUDA card; 'cpu' "
        "runs the plain PyTorch versions)",
    )
    args = ap.parse_args()
    if args.presorted_input:
        args.palette_sort = True
    if args.i16_planes:
        args.wire_int16 = True

    cfg = SpectrogramConfig(
        sample_rate=48_000.0,
        window_period=2048 / 48_000.0,
        hop_period=800 / 48_000.0,  # 60 rows/s/stream
    )
    pipeline = SpectrogramPipeline(
        cfg, chunk_hops=1, store_ring=False, packed_output=True,
        # palette_sort itself defaults on; the flag opts into sorted_output
        sorted_output=args.palette_sort,
        presorted_input=args.presorted_input,
        i16_planes=args.i16_planes,
        device=args.device,
    )
    s = args.streams
    bank = RingBank16(s, capacity=8192)

    # Producer: one batched bank16 push per hop tick for each block of 256
    # streams — a single native call fans [Sblk, n, 2] across the rings with
    # counted drops.  Stands in for the network/capture edge.  Each tone
    # is a multiple of 60 Hz, a whole number of periods per 800-sample hop,
    # so one synthesized hop per stream block repeats seamlessly: producing
    # the signal costs the host nothing per tick (synthesizing every hop of
    # 10,240 tones would load the host's cores more than the drain does).
    stop = threading.Event()

    def producer(lo: int, hi: int):
        n = cfg.hop_size
        freqs = 60.0 * (2 + np.arange(lo, hi) % 32)           # [Sblk]
        t = np.arange(n) / cfg.sample_rate
        x = (np.sin(2 * np.pi * freqs[:, None] * t) * 12000).astype(np.int16)
        sub = np.ascontiguousarray(np.stack([x, x], axis=-1))  # [Sblk, n, 2]
        while not stop.is_set():
            bank.push_matrix_range(lo, sub)
            time.sleep(n / cfg.sample_rate * 0.9)

    state0 = pipeline.init_state(s)
    if args.uniform_palette is not None:
        from spectrogram_tpu_torch.color.colorscheme import scheme_index

        up = args.uniform_palette
        pid = int(up) if up.lstrip("-").isdigit() else scheme_index(up)
        state0 = pipeline.set_palette(state0, pid)  # scalar -> one table
    elif args.palette_sort:
        # worst-case multi-tenant layout: every neighbor a different palette
        state0 = pipeline.set_palette(
            state0, (np.arange(s) % 19).astype(np.int32)
        )
        op = pipeline.output_perm(state0)
        print(
            f"palette_sort: engaged={op is not None} "
            f"(drain indexes rows via output_perm)", flush=True,
        )
    # Host-sorted drain: the pop scatters stream e into chunk row
    # input_dest[e]; it is re-derived here, after the last set_palette,
    # because the sort (and so every stream's row) changes with the layout.
    in_dest = (
        pipeline.input_dest(state0) if args.presorted_input else None
    )
    if args.presorted_input:
        print(f"presorted_input: dest engaged={in_dest is not None}",
              flush=True)
    feeder = DeviceFeeder(
        pipeline, state0, depth=2, planar=True,
        readback="probe" if args.probe_readback else "full",
        copy_chunks=False,
    )
    wire = np.int16 if args.wire_int16 else np.float32
    # Copy-free drain: the bank pops straight into a rotating depth+1 pool
    # of pinned buffers (ChunkPool safety contract in io/feeder.py).
    pool = ChunkPool.for_feeder(feeder, s, dtype=wire)

    # Warm up (build the kernel library) on a throwaway state BEFORE
    # opening the ingest: a first build would otherwise overflow every ring.
    warm = DeviceFeeder(pipeline, pipeline.init_state(s), depth=1, planar=True,
                        readback=feeder.readback)
    t0 = time.perf_counter()
    warm.push(np.zeros((s, 2, pipeline.chunk_size), wire))
    print(f"warmup/build: {time.perf_counter()-t0:.1f}s", flush=True)

    threads = [
        threading.Thread(target=producer, args=(lo, min(lo + 256, s)), daemon=True)
        for lo in range(0, s, 256)
    ]
    for t in threads:
        t.start()
    tracker = LatencyTracker()
    rows_out = 0
    deadline = time.time() + args.seconds
    hop_s = cfg.hop_size / cfg.sample_rate

    while time.time() < deadline:
        if bank.min_size() < pipeline.chunk_size:
            time.sleep(0.001)
            continue
        t0 = time.perf_counter()
        chunk, _ = (
            bank.pop_matrix_i16_planar(
                pipeline.chunk_size, pool.next(), dest=in_dest
            )
            if args.wire_int16
            else bank.pop_matrix_f32_planar(
                pipeline.chunk_size, pool.next(), dest=in_dest
            )
        )
        done = feeder.push(chunk)
        if done is not None:
            rows_out += done.shape[0] * done.shape[1]
        tracker.record(time.perf_counter() - t0)

    stop.set()
    for t in threads:
        t.join(timeout=2.0)
    blocks = feeder.flush()
    for blk in blocks:
        rows_out += blk.shape[0] * blk.shape[1]
    print(
        f"served {rows_out} rows across {s} streams in {args.seconds:.0f}s "
        f"({rows_out / args.seconds:,.0f} rows/s incl. warmup/build)"
    )
    print(f"hop budget {hop_s*1e3:.2f} ms; drain+dispatch {tracker.summary()}")
    if feeder.h2d.samples:
        print(f"h2d copy {feeder.h2d.summary()}; device push "
              f"{feeder.device_time.summary()}")
    print(f"dropped frames (counted, not silent): {bank.dropped_total}")
    if blocks:
        # a packed row block is [S, k, H] int32; show the wire->pixels view
        last = unpack_rgba(blocks[-1])
        print(
            f"last block unpacked: {last.shape} u8, "
            f"sample px {last[0,0,200].tolist()}"
        )


if __name__ == "__main__":
    main()
