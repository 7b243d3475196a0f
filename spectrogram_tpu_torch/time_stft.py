"""Device times of the STFT or colormap kernels of one or more checkouts, in turns.

    python -m spectrogram_tpu_torch.time_stft [--sizes N,N,...] [--packed | --split] [ROOT ...]
    python -m spectrogram_tpu_torch.time_stft --colormap [ROOT ...]

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
carry.  At N = 4096, 4800 and 17,640 (`SPLIT_HOPS`) also every kernel
over the split-real row: the transposed kernel, the tsplit kernel, the
split-real all-windows kernel with and without its next carry and the
carry+chunk kernel (k=8, 4,096 streams, the N's hop), and the fused push
(`push_fused`: split-real STFT -> kernel B on per-row tables) with and
without its magnitude planes.  `DIGESTS {json}`: under the same keys, a
SHA-256 prefix of each call's output planes, so that two roots whose
kernels give the same bits print the same digests.  `--sizes` times only
the named N of `SIZES`, `--packed` only the packed kernels (kernel A and
the packed all-windows kernel), `--split` only the split-real ones and the
fused push, so that an experiment tree may leave the others out of its
build.

`--colormap` times kernel B (`colormap_builtin`) and the generic kernel
(`colormap_generic`) in place of the STFT kernels, on magnitude planes of
chirp+tone from the plain STFT (`COLORMAP_KEYS`): per-row tables
(`arange(rows) % 19`, 20 generic palettes) and one table at BENCH_CONFIG's
4,096 rows; the k=8 push's 32,768 rows (a table per stream of 4,096) and
the DEFAULT_CONFIG display push's 2,048 (256 streams); a viewport render
block (32,768 rows of 2,047-bin ring planes, 16 streams,
`rows_per_table` = 2,048); 10,240 serving rows; H=1021; H=512 at N=2400,
4096 and 6400; N=4410 (B=2205);
the spans between the main paths' and the long windows' (N=6400, 8192,
12,000 and 15,360: spans 2,930, 3,749, 5,491 and 7,029 bins); N=16,384 and
N=48,000 (the long windows).  Then the blockwise colormap
(`colormap_blockwise`, `BLOCKWISE_KEYS`) on 10,240 BENCH_CONFIG rows with
sorted tables (uniform blocks) and scattered ones (mixed blocks), each row
holding its own copy as the serving state does, at the serving pipeline's
`block_rows` and at 32, and at spans where kernel B takes its direct form
(H=512; N=6400, 8192, 16,384 and 48,000); and the static colormap
(`colormap_static`, `STATIC_KEYS`) on Magma and on smoke-custom at 4,096
rows of BENCH_CONFIG, of the spans above and of N=16,384 and 48,000; and
`colormap_rows_fused` on 4,096 planar rows [4096, 2, 2047] of BENCH_CONFIG
(ring planes, bins 1 .. W-1) with per-row factors, at the two-tap
`resample_matrix` and at a 4-tap matrix (`ROWS_KEYS`).  It needs a CUDA
card.
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
# N -> the hop of the split-real kernels' k=8 keys: BENCH_CONFIG's,
# DEFAULT_CONFIG's and 44.1 kHz's at DEFAULT_CONFIG's periods (W=8820)
SPLIT_HOPS = {4096: 800, 4800: 58, 17640: 53}
# (label, taps): colormap_rows_fused at the two-tap matrix and a 4-tap one
ROWS_KEYS = (("rows_fused 4096", 2), ("rows_fused_k4 4096", 4))


def _tools():
    """This checkout's `testing` module, loaded from its file: the timing
    and operand helpers stay the same whichever root's package is timed."""
    import importlib.util

    path = pathlib.Path(__file__).with_name("testing.py")
    spec = importlib.util.spec_from_file_location("_time_stft_testing", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# (label, config, rows, plane source, tables, rows_per_table): the plane
# source is the config's window planes ("planes", [rows, max(N/2, W)]) or
# its ring planes ("ring", bins 1..W-1, with `resample_matrix`'s taps); the
# tables "per-row" (row n reads table n % 19 of the built-in palettes, or
# of 20 generic factor pairs), "per-stream" (row n reads table n % (rows /
# 8), a k=8 push's window-major rows), "one" (one table) or "stream-major"
# (16 tables, `rows_per_table` rows each)
COLORMAP_KEYS = (
    ("per-row", "bench", 4096, "planes", "per-row", 1),
    ("one table", "bench", 4096, "planes", "one", 1),
    ("k8 32768 rows", "bench", 32768, "planes", "per-stream", 1),
    ("display 2048 rows", "default", 2048, "planes", "per-stream", 1),
    ("viewport rpt=2048", "bench", 32768, "ring", "stream-major", 2048),
    ("serving 10240 rows", "bench", 10240, "planes", "per-row", 1),
    ("H=1021", "h1021", 4096, "planes", "per-row", 1),
    ("H=512 N=2400", "h512n2400", 4096, "planes", "per-row", 1),
    ("H=512", "h512", 4096, "planes", "per-row", 1),
    ("H=512 N=6400", "h512n6400", 4096, "planes", "per-row", 1),
    ("N=4410", "n4410", 4096, "planes", "per-row", 1),
    ("N=6400", "n6400", 4096, "planes", "per-row", 1),
    ("N=8192", "n8192", 4096, "planes", "per-row", 1),
    ("N=12000", "n12000", 4096, "planes", "per-row", 1),
    ("N=15360", "n15360", 4096, "planes", "per-row", 1),
    ("N=16384", "n16384", 4096, "planes", "per-row", 1),
    ("N=48000", "n48000", 4096, "planes", "per-row", 1),
)


# (label, config, rows, tables, block_rows): the blockwise colormap with row
# n reading its own copy of built-in palette ids[n], ids "sorted"
# (sort(arange(rows) % 19): uniform blocks) or "scattered" (arange(rows) %
# 19: mixed blocks); block_rows None takes the k=1 serving pipeline's
# (`palette_layout.block_rows`: 128 at BENCH_CONFIG)
BLOCKWISE_KEYS = (
    ("sorted 10240 rows", "bench", 10240, "sorted", None),
    ("scattered 10240 rows", "bench", 10240, "scattered", None),
    ("sorted 10240 rows br=32", "bench", 10240, "sorted", 32),
    ("scattered 10240 rows br=32", "bench", 10240, "scattered", 32),
    ("H=512", "h512", 4096, "sorted", None),
    ("N=6400", "n6400", 4096, "sorted", None),
    ("N=8192", "n8192", 4096, "sorted", None),
    ("N=16384", "n16384", 4096, "sorted", None),
    ("N=48000", "n48000", 4096, "sorted", None),
)
# (label, config): the static colormap on ROWS rows, Magma and smoke-custom
STATIC_KEYS = (
    ("4096 rows", "bench"), ("H=1021", "h1021"), ("N=4410", "n4410"),
    ("N=6400", "n6400"), ("N=8192", "n8192"), ("H=512 N=2400", "h512n2400"),
    ("H=512", "h512"), ("H=512 N=6400", "h512n6400"), ("N=16384", "n16384"),
    ("N=48000", "n48000"),
)


def _colormap_worker() -> None:
    import dataclasses

    import numpy as np
    import torch

    from spectrogram_tpu_torch.color.colorscheme import scheme_index, stacked_factored_tables
    from spectrogram_tpu_torch.config import BENCH_CONFIG, DEFAULT_CONFIG, SpectrogramConfig
    from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline
    from spectrogram_tpu_torch.ops import colormap as cmap_ops
    from spectrogram_tpu_torch.ops.cuda import _build
    from spectrogram_tpu_torch.ops.cuda import colormap_kernel as ck
    from spectrogram_tpu_torch.ops.cuda import stft_kernel as sk

    tools = _tools()
    if not torch.cuda.is_available():
        raise SystemExit("time_stft needs a CUDA card")
    dev = torch.device("cuda", 0)
    _build.build()
    configs = {"bench": BENCH_CONFIG, "default": DEFAULT_CONFIG,
               "h1021": dataclasses.replace(BENCH_CONFIG, viewport_height=1021),
               "h512n2400": SpectrogramConfig(window_period=1200 / 48000.0,
                                              viewport_height=512),
               "h512": dataclasses.replace(BENCH_CONFIG, viewport_height=512),
               "h512n6400": SpectrogramConfig(window_period=3200 / 48000.0,
                                              viewport_height=512),
               "n4410": SpectrogramConfig(sample_rate=44100.0, window_period=0.05),
               "n6400": SpectrogramConfig(window_period=3200 / 48000.0),
               "n8192": SpectrogramConfig(window_period=4096 / 48000.0),
               "n12000": SpectrogramConfig(window_period=6000 / 48000.0),
               "n15360": SpectrogramConfig(window_period=7680 / 48000.0),
               "n16384": SpectrogramConfig(window_period=8192 / 48000.0),
               "n48000": SpectrogramConfig(window_period=0.5)}
    builtin = torch.from_numpy(ck.builtin_color_tables()).to(dev)
    u, v = (torch.from_numpy(t.reshape(19, -1)).to(dev) for t in stacked_factored_tables(32))
    cu, cv = (torch.from_numpy(t.reshape(1, -1)).to(dev) for t in tools.custom_factors())
    generic = torch.cat([cu, u]), torch.cat([cv, v])            # 20 palettes
    planes = {}
    out, digests, forms = {}, {}, {}

    def planes_of(geometry, rows):
        """[rows, N/2] chirp+tone magnitude planes of the plain STFT."""
        key = (geometry, rows)
        if key not in planes:
            planes.clear()
            torch.cuda.empty_cache()
            cfg = configs[geometry]
            left, right = tools.chirp_tone_planes(rows, cfg.window_size, cfg.sample_rate,
                                                  1, dev)
            hann = torch.from_numpy(sk.packed_hann(cfg.window_size)).to(dev)
            planes[key] = sk.stft_mag_packed_plain(left, right, hann, cfg.padded_size)
        return planes[key]

    def record(name, fn, form=None):
        out[name] = tools.device_ms(fn, iters=10)
        digests[name] = hashlib.sha256(fn().cpu().numpy().tobytes()).hexdigest()[:16]
        if form is not None:
            forms[name] = form

    for label, geometry, rows, source, layout, rpt in COLORMAP_KEYS:
        cfg = configs[geometry]
        ml, mr = planes_of(geometry, rows)
        matrix = cmap_ops.resample_matrix_full(cfg)
        if source == "ring":
            w = cfg.window_size
            ml, mr = ml[:, 1:w].contiguous(), mr[:, 1:w].contiguous()
            matrix = cmap_ops.resample_matrix(cfg)
        taps = ck.resample_taps(matrix, dev)
        n = {"per-row": rows, "per-stream": rows, "one": 1, "stream-major": rows // rpt}[layout]
        streams = rows // 8 if layout == "per-stream" else None
        ids = torch.arange(n, device=dev) % (streams or 19)
        gids = torch.arange(n, device=dev) % (streams or 20)
        tb = builtin.index_select(0, ids % 19).contiguous()
        gu, gv = (t.index_select(0, gids % 20).contiguous() for t in generic)
        for word, fn in (
                ("kernel B", lambda: ck.colormap_builtin(ml, mr, taps, tb, cfg, rpt)),
                ("generic", lambda: ck.colormap_generic(ml, mr, taps, gu, gv, cfg, rpt))):
            record(f"{word} {label}", fn,
                   ck.tile_form(taps, 32, word == "generic") if hasattr(ck, "tile_form")
                   else None)
        del ml, mr
    for label, geometry, rows, layout, block_rows in BLOCKWISE_KEYS:
        cfg = configs[geometry]
        ml, mr = planes_of(geometry, rows)
        taps = ck.resample_taps(cmap_ops.resample_matrix_full(cfg), dev)
        ids = np.arange(rows) % 19
        tb = builtin.index_select(0, torch.from_numpy(
            np.sort(ids) if layout == "sorted" else ids).to(dev)).contiguous()
        br = block_rows or SpectrogramPipeline(
            cfg, chunk_hops=1, store_ring=False, device=dev).palette_layout.block_rows(rows)
        record(f"blockwise {label}",
               lambda: ck.colormap_blockwise(ml, mr, taps, tb, cfg, block_rows=br))
        del ml, mr, tb
    magma = ck.builtin_color_tables()[scheme_index("Magma")]
    custom = tuple(t.reshape(-1) for t in tools.custom_factors())
    for label, geometry in STATIC_KEYS:
        cfg = configs[geometry]
        ml, mr = planes_of(geometry, ROWS)
        taps = ck.resample_taps(cmap_ops.resample_matrix_full(cfg), dev)
        for word, table in (("Magma", magma), ("smoke-custom", custom)):
            record(f"static {word} {label}",
                   lambda: ck.colormap_static(ml, mr, taps, table, cfg))
        del ml, mr
    cfg, w = BENCH_CONFIG, BENCH_CONFIG.window_size
    ml, mr = planes_of("bench", ROWS)
    rows = torch.stack([ml[:, 1:w], mr[:, 1:w]], dim=1).contiguous()   # [4096, 2, 2047]
    planes.clear()
    del ml, mr
    fu, fv = stacked_factored_tables(32)
    fu, fv = (torch.from_numpy(t[np.arange(ROWS) % 19]).to(dev) for t in (fu, fv))
    m = cmap_ops.resample_matrix(cfg)
    for label, k in ROWS_KEYS:
        mk = m if k == 2 else 0.5 * (m + np.roll(m, 2, axis=1))
        taps = ck.resample_taps_k(np.ascontiguousarray(mk.T), dev)
        assert taps.j.shape[1] == k
        record(label, lambda: ck.colormap_rows_fused(rows, fu, fv, taps, cfg, packed=True))
    del rows
    print("TIMES " + json.dumps(out), flush=True)
    print("DIGESTS " + json.dumps(digests), flush=True)
    if forms:
        print("FORMS " + json.dumps(forms), flush=True)


def _transposed(left, right, n1: int):
    """The transposed operand [rows, 2, n1, m] of window planes:
    x[r, c, j1, t] = sample t*n1 + j1."""
    import torch

    rows, w = left.shape
    x = torch.stack([left, right], 1).reshape(rows, 2, w // n1, n1)
    return x.transpose(2, 3).contiguous()


def _n1(w: int) -> int:
    """The largest divisor of w at most sqrt(w): the JAX plan's n1 at the
    timed N (32 at W=2048, 48 at 2400, 90 at 8820)."""
    return max(d for d in range(1, int(w**0.5) + 1) if w % d == 0)


def _worker(sizes: list[int], packed_only: bool, split_only: bool) -> None:
    import numpy as np
    import torch

    from spectrogram_tpu_torch.config import SpectrogramConfig
    from spectrogram_tpu_torch.ops import colormap as cmap_ops
    from spectrogram_tpu_torch.ops.cuda import _build
    from spectrogram_tpu_torch.ops.cuda import colormap_kernel as ck
    from spectrogram_tpu_torch.ops.cuda import push_kernel as pk
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
    packed = not split_only
    split = not packed_only
    for sr, w, n in SIZES:
        if sizes and n not in sizes:
            continue
        left, right = planes(ROWS, w, sr, 1)
        consts = sk.fft_constants(n, dev)
        packed_hann = torch.from_numpy(sk.packed_hann(w)).to(dev)
        split_hann = torch.from_numpy(sk.split_hann(w)).to(dev)
        if packed:
            out[f"packed {n}"] = device_ms(
                lambda: sk.stft_mag_packed(left, right, packed_hann, consts), f"packed {n}")
        if split:
            out[f"split {n}"] = device_ms(
                lambda: sk.stft_mag_split(left, right, split_hann, consts), f"split {n}")
        if n == 4096 and packed:
            hop, k = 800, 8
            words = [(x * 32767.0).round().to(torch.int16) for x in (left, right)]
            hann_i16 = torch.from_numpy(sk.packed_hann_i16(w)).to(dev)
            out["packed_i16 4096"] = device_ms(
                lambda: sk.stft_mag_packed(*words, hann_i16, consts), "packed_i16 4096")
            bl, br = planes(ROWS, w + (k - 1) * hop, sr, 3)
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
            del bl, br, words, bwords
        if n == 4800 and packed:
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
        if n in SPLIT_HOPS and split:
            # every kernel over the split-real row, and the fused push
            hop, k = SPLIT_HOPS[n], 8
            n1 = _n1(w)
            x = _transposed(left, right, n1)
            t_cols = max(1, x.shape[3] // 4)
            carry, chunk = (x[..., : x.shape[3] - t_cols].contiguous(),
                            x[..., x.shape[3] - t_cols :].contiguous())
            del x
            bl, br = planes(ROWS, w + (k - 1) * hop, sr, 3)
            c_len = w - hop
            pc = torch.stack([bl[:, :c_len], br[:, :c_len]], 1).contiguous()
            pch = torch.stack([bl[:, c_len:], br[:, c_len:]], 1).contiguous()
            cfg = SpectrogramConfig(sample_rate=sr, window_period=w / sr)
            assert cfg.window_size == w and cfg.padded_size == n
            taps = ck.resample_taps(cmap_ops.resample_matrix_full(cfg), dev)
            tables = torch.from_numpy(ck.builtin_color_tables(32)[np.arange(ROWS) % 19]).to(dev)
            xt = _transposed(left, right, n1)
            keys = {
                f"split_t {n}": lambda: sk.stft_mag_split_t(xt, split_hann, consts),
                f"split_tsplit {n}": lambda: sk.stft_mag_split_tsplit(carry, chunk, split_hann,
                                                                       consts),
                f"split_allk {n} k8": lambda: sk.stft_mag_split_allk(bl, br, split_hann,
                                                                      consts, k, hop),
                f"split_allk_carry {n} k8": lambda: sk.stft_mag_split_allk(
                    bl, br, split_hann, consts, k, hop, emit_carry=True),
                f"split_carry {n} k8": lambda: sk.stft_mag_split_carry(pc, pch, split_hann,
                                                                        consts, k, hop),
                f"push_fused {n}": lambda: (pk.push_fused(left, right, split_hann, consts,
                                                          tables, taps, cfg),),
                f"push_fused_mags {n}": lambda: pk.push_fused(
                    left, right, split_hann, consts, tables, taps, cfg, emit_mags=True),
            }
            for key, fn in keys.items():
                out[key] = device_ms(fn, key)
            del carry, chunk, bl, br, pc, pch, xt, tables
        del left, right
        torch.cuda.empty_cache()
    print("TIMES " + json.dumps(out), flush=True)
    print("DIGESTS " + json.dumps(digests), flush=True)


def main(argv: list[str]) -> int:
    sizes, packed_only, split_only, colormap = [], False, False, False
    while argv[:1] in (["--sizes"], ["--packed"], ["--split"], ["--colormap"]):
        if argv[0] == "--sizes":
            sizes, argv = [int(n) for n in argv[1].split(",")], argv[2:]
        elif argv[0] == "--packed":
            packed_only, argv = True, argv[1:]
        elif argv[0] == "--split":
            split_only, argv = True, argv[1:]
        else:
            colormap, argv = True, argv[1:]
    if argv[:1] == ["--worker"]:
        if colormap:
            _colormap_worker()
        else:
            _worker(sizes, packed_only, split_only)
        return 0
    roots = [pathlib.Path(r).resolve() for r in argv] or [pathlib.Path(__file__).parents[1]]
    for root in (*roots, *reversed(roots)):
        print(f"== {root}", flush=True)
        worker = (["--sizes", ",".join(map(str, sizes))] if sizes else []) + \
            (["--packed"] if packed_only else []) + (["--split"] if split_only else []) + \
            (["--colormap"] if colormap else [])
        code = ("import runpy, sys; "
                f"sys.argv = [sys.argv[0], *{worker!r}, '--worker']; "
                f"sys.path.insert(0, {str(root)!r}); "
                f"runpy.run_path({str(pathlib.Path(__file__).resolve())!r}, "
                "run_name='__main__')")
        subprocess.run([sys.executable, "-c", code], check=True, cwd=root)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
