"""Device times of the STFT kernels of one or more checkouts, in turns.

    python -m spectrogram_tpu_torch.time_stft [--sizes N,N,...] [--packed] [ROOT ...]

Each ROOT is the root of a checkout of this repository (default: this one),
e.g. a parent commit unpacked with `git archive` into a directory git
ignores.  The roots are timed in turns, a b ... b a, each in a process of
its own that imports `spectrogram_tpu_torch` from its root and builds that
root's kernels there, so two versions of a kernel are compared on one card
in one call.  Per root and turn it prints two lines.  `TIMES {json}`: the
device time in ms (mean of 10 calls after a warm-up, the card held while the
host enqueues) of kernel A (`stft_mag_packed`) and of the split-real plane
kernel (`stft_mag_split`) on 4,096 window rows of chirp+tone at each N of
`SIZES` (the large-N route where N takes it: packed from N=32,768 and at the
prime 16,411, split-real at N=65,536 and 16,411), and at N=4096 of kernel A
on int16 words, of the split-real all-windows (k=8, 4,096 streams),
transposed and packed all-windows kernels, and of the packed all-windows
kernel on int16 words and with its next carry; at N=4800 also kernel A on
int16 words and the packed all-windows kernel at DEFAULT_CONFIG's geometry
(k=8, hop 58, 4,096 streams) on f32 and int16 buffers and with its next
carry.  `DIGESTS {json}`: under the same keys, a SHA-256
prefix of each call's output planes, so that two roots whose kernels give
the same bits print the same digests.  `--sizes` times only the named N of
`SIZES`, `--packed` only the packed kernels (kernel A and the packed
all-windows kernel), so that an experiment tree may leave the split-real
kernels out of its build.  It needs a CUDA card.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import subprocess
import sys

# (sample rate, window W, N): radix 2 (4096; 8192 and 16,384, whose packed
# rows take the wide launch bounds); radix 7 (4410 = 2 3^2 5 7^2); the
# Bluestein N 1410, 2204, 4406 and the odd 4801; 5-smooth 4800; the long
# windows 17,640, 32,768, 48,000 and 65,536 (the split-real route), and the
# prime 16,411 (the route's Bluestein passes)
SIZES = ((48000.0, 2048, 4096), (48000.0, 4096, 8192), (48000.0, 8192, 16384),
         (44100.0, 2205, 4410), (44100.0, 705, 1410),
         (44100.0, 1102, 2204), (44100.0, 2203, 4406), (48000.0, 2400, 4801),
         (48000.0, 2400, 4800), (44100.0, 8820, 17640), (48000.0, 16384, 32768),
         (48000.0, 24000, 48000), (48000.0, 32768, 65536), (48000.0, 8205, 16411))
ROWS = 4096


def _tools():
    """This checkout's `testing` module, loaded from its file: the timing
    and operand helpers stay the same whichever root's package is timed."""
    import importlib.util

    path = pathlib.Path(__file__).with_name("testing.py")
    spec = importlib.util.spec_from_file_location("_time_stft_testing", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _worker(sizes: list[int], packed_only: bool) -> None:
    import torch

    from spectrogram_tpu_torch.ops.cuda import _build
    from spectrogram_tpu_torch.ops.cuda import stft_kernel as sk

    tools = _tools()

    digests = {}

    def device_ms(fn, key: str) -> float:
        """fn's device time; its output's digest into `digests[key]`."""
        t = tools.device_ms(fn, iters=10)
        h = hashlib.sha256()
        for plane in fn():
            h.update(plane.contiguous().cpu().numpy().tobytes())
        digests[key] = h.hexdigest()[:16]
        return t

    def planes(rows, length, sr, seed):
        return tools.chirp_tone_planes(rows, length, sr, seed, dev)

    if not torch.cuda.is_available():
        raise SystemExit("time_stft needs a CUDA card")
    dev = torch.device("cuda", 0)
    _build.build()
    out = {}
    for sr, w, n in SIZES:
        if sizes and n not in sizes:
            continue
        left, right = planes(ROWS, w, sr, 1)
        consts = sk.fft_constants(n, dev)
        packed_hann = torch.from_numpy(sk.packed_hann(w)).to(dev)
        split_hann = torch.from_numpy(sk.split_hann(w)).to(dev)
        for key, fn in ((f"packed {n}", lambda: sk.stft_mag_packed(left, right, packed_hann,
                                                                   consts)),
                        (f"split {n}", lambda: sk.stft_mag_split(left, right, split_hann,
                                                                 consts))):
            if not (packed_only and key.startswith("split")):
                out[key] = device_ms(fn, key)
        if n == 4096:
            hop, k = 800, 8
            words = [(x * 32767.0).round().to(torch.int16) for x in (left, right)]
            hann_i16 = torch.from_numpy(sk.packed_hann_i16(w)).to(dev)
            out["packed_i16 4096"] = device_ms(
                lambda: sk.stft_mag_packed(*words, hann_i16, consts), "packed_i16 4096")
            bl, br = planes(ROWS, w + (k - 1) * hop, sr, 3)
            if not packed_only:
                out["split_allk 4096 k8"] = device_ms(
                    lambda: sk.stft_mag_split_allk(bl, br, split_hann, consts, k, hop),
                    "split_allk 4096 k8")
            out["allk 4096 k8"] = device_ms(
                lambda: sk.stft_mag_packed_allk(bl, br, packed_hann, consts, k, hop),
                "allk 4096 k8")
            bwords = [(x * 32767.0).round().to(torch.int16) for x in (bl, br)]
            out["allk_i16 4096 k8"] = device_ms(
                lambda: sk.stft_mag_packed_allk(*bwords, hann_i16, consts, k, hop),
                "allk_i16 4096 k8")
            out["allk_carry 4096 k8"] = device_ms(
                lambda: sk.stft_mag_packed_allk(bl, br, packed_hann, consts, k, hop,
                                                emit_carry=True),
                "allk_carry 4096 k8")
            x = torch.stack([left, right], 1).reshape(ROWS, 2, 64, 32).transpose(2, 3)
            x = x.contiguous()
            if not packed_only:
                out["split_t 4096"] = device_ms(
                    lambda: sk.stft_mag_split_t(x, split_hann, consts), "split_t 4096")
            del bl, br, x, words, bwords
        if n == 4800:
            hop, k = 58, 8
            words = [(x * 32767.0).round().to(torch.int16) for x in (left, right)]
            hann_i16 = torch.from_numpy(sk.packed_hann_i16(w)).to(dev)
            out["packed_i16 4800"] = device_ms(
                lambda: sk.stft_mag_packed(*words, hann_i16, consts), "packed_i16 4800")
            bl, br = planes(ROWS, w + (k - 1) * hop, sr, 3)
            bwords = [(x * 32767.0).round().to(torch.int16) for x in (bl, br)]
            for key, fn in (
                    ("allk 4800 k8", lambda: sk.stft_mag_packed_allk(bl, br, packed_hann,
                                                                     consts, k, hop)),
                    ("allk_i16 4800 k8", lambda: sk.stft_mag_packed_allk(*bwords, hann_i16,
                                                                         consts, k, hop)),
                    ("allk_carry 4800 k8", lambda: sk.stft_mag_packed_allk(
                        bl, br, packed_hann, consts, k, hop, emit_carry=True))):
                out[key] = device_ms(fn, key)
            del bl, br, words, bwords
        del left, right
        torch.cuda.empty_cache()
    print("TIMES " + json.dumps(out), flush=True)
    print("DIGESTS " + json.dumps(digests), flush=True)


def main(argv: list[str]) -> int:
    sizes, packed_only = [], False
    while argv[:1] in (["--sizes"], ["--packed"]):
        if argv[0] == "--sizes":
            sizes, argv = [int(n) for n in argv[1].split(",")], argv[2:]
        else:
            packed_only, argv = True, argv[1:]
    if argv[:1] == ["--worker"]:
        _worker(sizes, packed_only)
        return 0
    roots = [pathlib.Path(r).resolve() for r in argv] or [pathlib.Path(__file__).parents[1]]
    for root in (*roots, *reversed(roots)):
        print(f"== {root}", flush=True)
        worker = (["--sizes", ",".join(map(str, sizes))] if sizes else []) + \
            (["--packed"] if packed_only else [])
        code = ("import runpy, sys; "
                f"sys.argv = [sys.argv[0], *{worker!r}, '--worker']; "
                f"sys.path.insert(0, {str(root)!r}); "
                f"runpy.run_path({str(pathlib.Path(__file__).resolve())!r}, "
                "run_name='__main__')")
        subprocess.run([sys.executable, "-c", code], check=True, cwd=root)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
