"""Device time of the push and of render_viewport, by kernel, on one card.

    python -m spectrogram_tpu_torch.profile_push [--pushes 50] [--renders 5]

Profiles, each with torch.profiler over a steady window after a warm-up:

  1. the k=8 push at BENCH_CONFIG, 4096 streams, no ring (the JAX bench's
     BENCH_CHUNK_HOPS=8 mode);
  2. the display push (k=8, ring R=2048, 256 streams, palettes
     arange(S) % 19) at BENCH_CONFIG and at DEFAULT_CONFIG;
  3. render_viewport of that display state;
  4. the multi-tenant serving push at BENCH_CONFIG, k=1, no ring, 10,240
     streams, palettes arange(S) % 19: per-row (palette_sort=False), sorted
     (the defaults), and the full serving mode (i16_planes, presorted_input,
     sorted_output, int16 chunks in input_perm order);
  5. the k=1 push at BENCH_CONFIG, 4096 streams, no ring, by palette kind:
     built-in per-row (arange(S) % 19), static_palette="Magma", and a
     generic registry (a FactoredScheme outside the built-in structure + 3
     built-ins) per-row (arange(S) % 4) and with one palette;
  6. the split-real layouts at BENCH_CONFIG, no ring, palettes arange(S) %
     19: stft_packed=False, transposed_carry and framing="tsplit" at k=1 and
     4096 streams, and framing="tsplit" in the 10,240-stream serving push
     (sorted carry);
  7. the sizes beyond 2^a 3^b 5^c and pad_factor 2: the k=1 push at 4096
     streams, no ring, at 44.1 kHz with DEFAULT_CONFIG's periods (N=4410,
     the radix-7 mixed-radix body), at BENCH_CONFIG's window with
     pad_factor=1 (N=2048) and at an odd N (16 kHz, W=145, pad 3: N=435,
     Bluestein), and the display push at 44.1 kHz;
  8. the long windows: the k=1 push at 4096 streams, no ring, at 48 kHz
     with a 0.5 s window (N=48,000: the packed kernels' large-N route; with
     stft_packed=False the split-real pack in shared memory) and at 44.1
     kHz with a 0.2 s window (N=17,640, direct in shared memory), and the
     display push at N=48,000 with 16 streams.

For each it prints the host wall time per call over the window (ended by a
synchronize), the device busy time per call (the sum of its kernels), the
idle share 1 - busy/wall, and the kernels by device time, the large-N
route's by the pass each runs (`ROUTE_PASSES`).  It needs a CUDA card and
fails without one, or when the profiler records no device time.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch

from spectrogram_tpu_torch import testing
from spectrogram_tpu_torch.config import BENCH_CONFIG, DEFAULT_CONFIG, SpectrogramConfig
from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline


# the large-N route's kernels (csrc/stft_large.cu) by the pass each runs
ROUTE_PASSES = {
    "large_load_local_kernel": "route pass 1: load + local stages",
    "large_last_unpack_kernel": "route pass 2: last stage + stereo unpack",
    "large_last_magnitude_kernel": "route pass 2: last stage + split-real unpack",
    "large_pass_kernel": "route: a global stage",
    "large_load_packed_kernel": "route, Bluestein: load",
    "large_load_real_kernel": "route, Bluestein: load",
    "large_local_kernel": "route, Bluestein: local pass",
    "large_unpack_kernel": "route, Bluestein: unpack",
    "large_magnitude_kernel": "route, Bluestein: unpack",
}


def _short(name: str) -> str:
    """A kernel's name without its return type, namespaces and template
    arguments."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("<")[0].split("(")[0].split("::")[-1][:60]


def profile(label: str, fn, calls: int) -> None:
    """Print wall, busy and idle per call of fn, and its kernels."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    kernels = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total:
            key = _short(ev.key)
            ms, n = kernels.get(key, (0.0, 0))
            kernels[key] = (ms + ev.self_device_time_total / 1e3 / calls, n + ev.count)
    busy = sum(ms for ms, _ in kernels.values())
    if busy <= 0:
        raise SystemExit(f"FAIL: the profiler recorded no device time for {label}")
    print(f"== {label}: wall {wall:.4f} ms/call, device busy {busy:.4f} ms/call, "
          f"idle share {1 - busy / wall:.3f} ({calls} calls)")
    for key, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0]):
        what = f" ({ROUTE_PASSES[key]})" if key in ROUTE_PASSES else ""
        print(f"   {ms:9.4f} ms/call {ms / busy:6.1%}  x{n / calls:g}/call  {key}{what}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pushes", type=int, default=50)
    ap.add_argument("--renders", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: no CUDA card; this script measures the card")
    smi = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
           "--format=csv,noheader"]
    print("card:", subprocess.run(smi, capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda", 0)

    p = SpectrogramPipeline(BENCH_CONFIG, chunk_hops=8, store_ring=False,
                            packed_output=True, device=dev)
    state = [p.set_palette(p.init_state(4096), np.arange(4096) % 19)]
    chunk = torch.from_numpy(testing.chirp_tone(4096, p.chunk_size, 48000.0, seed=4)).to(dev)

    def push():
        state[0], _ = p.push(state[0], chunk)

    profile("k=8 push, BENCH_CONFIG, 4096 streams, no ring", push, args.pushes)
    del state, chunk

    for name, cfg in (("BENCH_CONFIG", BENCH_CONFIG), ("DEFAULT_CONFIG", DEFAULT_CONFIG)):
        p = SpectrogramPipeline(cfg, chunk_hops=8, packed_output=True, device=dev)
        state = [p.set_palette(p.init_state(256), np.arange(256) % 19)]
        chunk = torch.from_numpy(
            testing.chirp_tone(256, p.chunk_size, cfg.sample_rate, seed=5)).to(dev)
        profile(f"display push, {name}, 256 streams, ring {p.viewport_rows}", push,
                args.pushes)
        profile(f"render_viewport, {name}, 256 streams",
                lambda: p.render_viewport(state[0]), args.renders)
        del state, chunk

    s = 10240
    ids = np.arange(s) % 19
    words = np.round(testing.chirp_tone(s, BENCH_CONFIG.hop_size, 48000.0, seed=6)
                     * 32767.0).astype(np.int16)
    for label, kw in (("per-row (palette_sort=False)", dict(palette_sort=False)),
                      ("sorted", {}),
                      ("full serving mode", dict(i16_planes=True, presorted_input=True,
                                                 sorted_output=True))):
        p = SpectrogramPipeline(BENCH_CONFIG, chunk_hops=1, store_ring=False,
                                packed_output=True, device=dev, **kw)
        state = [p.set_palette(p.init_state(s), ids)]
        perm = p.input_perm(state[0]) if p.presorted_input else None
        wire = torch.from_numpy(words if perm is None else words[perm]).to(dev)
        chunk = wire if p.i16_planes else wire.to(torch.float32) / 32768.0
        profile(f"serving push, BENCH_CONFIG, k=1, {s} streams, {label}", push, args.pushes)
        del state, chunk, wire

    from spectrogram_tpu_torch.color.colorscheme import DEFAULT_COLOR_SCHEMES

    registry = (testing.custom_scheme(),) + DEFAULT_COLOR_SCHEMES[:3]
    s = 4096
    chunk = torch.from_numpy(testing.chirp_tone(s, BENCH_CONFIG.hop_size, 48000.0, seed=7)).to(dev)
    for label, kw, ids in (("built-in per-row", {}, np.arange(s) % 19),
                           ("static_palette=Magma", dict(static_palette="Magma"), None),
                           ("generic per-row", dict(schemes=registry), np.arange(s) % 4),
                           ("generic, one palette", dict(schemes=registry), 0)):
        p = SpectrogramPipeline(BENCH_CONFIG, chunk_hops=1, store_ring=False,
                                packed_output=True, device=dev, **kw)
        state = [p.init_state(s) if ids is None else p.set_palette(p.init_state(s), ids)]
        profile(f"k=1 push, BENCH_CONFIG, {s} streams, {label}", push, args.pushes)
        del state
    for label, kw, s in (("stft_packed=False", dict(stft_packed=False), 4096),
                         ("transposed_carry", dict(transposed_carry=True), 4096),
                         ("framing=tsplit", dict(framing="tsplit"), 4096),
                         ("framing=tsplit, sorted", dict(framing="tsplit"), 10240)):
        p = SpectrogramPipeline(BENCH_CONFIG, chunk_hops=1, store_ring=False,
                                packed_output=True, device=dev, **kw)
        state = [p.set_palette(p.init_state(s), np.arange(s) % 19)]
        chunk = torch.from_numpy(
            testing.chirp_tone(s, BENCH_CONFIG.hop_size, 48000.0, seed=8)).to(dev)
        profile(f"k=1 push, BENCH_CONFIG, {s} streams, {label}", push, args.pushes)
        del state, chunk
    sizes = (("44.1 kHz, N=4410", SpectrogramConfig(sample_rate=44100.0), 1, 4096),
             ("pad_factor=1, N=2048", SpectrogramConfig(
                 sample_rate=48000.0, window_period=2048 / 48000.0,
                 hop_period=800 / 48000.0, pad_factor=1), 1, 4096),
             ("odd N=435", SpectrogramConfig(
                 sample_rate=16000.0, window_period=145 / 16000.0, hop_period=69 / 16000.0,
                 pad_factor=3, viewport_height=100, max_frequency=7950.0), 1, 4096),
             ("44.1 kHz, N=4410, display, ring", SpectrogramConfig(sample_rate=44100.0), 8, 256),
             ("48 kHz, 0.5 s window, N=48000", SpectrogramConfig(window_period=0.5), 1, 4096),
             ("48 kHz, 0.5 s window, N=48000, stft_packed=False",
              SpectrogramConfig(window_period=0.5), 1, 4096),
             ("44.1 kHz, 0.2 s window, N=17640", SpectrogramConfig(
                 sample_rate=44100.0, window_period=0.2), 1, 4096),
             ("48 kHz, N=48000, display, ring", SpectrogramConfig(window_period=0.5), 8, 16))
    for label, cfg, k, s in sizes:
        split = {"stft_packed": False} if "stft_packed=False" in label else {}
        p = SpectrogramPipeline(cfg, chunk_hops=k, store_ring=k > 1, packed_output=True,
                                device=dev, **split)
        state = [p.set_palette(p.init_state(s), np.arange(s) % 19)]
        chunk = torch.from_numpy(
            testing.chirp_tone(s, p.chunk_size, cfg.sample_rate, seed=9)).to(dev)
        profile(f"k={k} push, {label}, {s} streams", push, args.pushes)
        del state, chunk
    print("card:", subprocess.run(smi, capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
