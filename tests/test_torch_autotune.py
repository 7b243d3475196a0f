"""The port's autotuner (`spectrogram_tpu_torch/utils/autotune.py`) on the
CPU: its candidates against the C launch tables, its cache, the pipeline's
wiring, and the tuned pipeline against the JAX package's `autotune=True`
pipeline.

The tuner ranks the launch shapes of the kernel families a push runs (the
STFT rows' launch bounds, the colormap tile's form).  Every shape must give
the same bits: the launch tables are compiled for the CPU through
`tests/cuda_host_stub/` (`stft_host_launch`, `colormap_host_launch_form`)
and the Python candidate lists are held to them, the row under each
candidate's pass bound to the table's row, and the staged tile at spans
wider than its speed rule admits to the per-pixel rows.  The measurement
itself runs on the card (`chip_smoke.py` phase 29); here `measure` is
replaced.
"""

import ctypes
import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectrogram_tpu.config as jcfg
from spectrogram_tpu.models.spectrogram import SpectrogramPipeline as JaxPipeline
from spectrogram_tpu.utils import autotune as jax_autotune

from spectrogram_tpu_torch import testing
from spectrogram_tpu_torch.config import BENCH_CONFIG, DEFAULT_CONFIG, SpectrogramConfig
from spectrogram_tpu_torch.models.convert import state_from_jax
from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline
from spectrogram_tpu_torch.ops.cuda import colormap_kernel as ck
from spectrogram_tpu_torch.ops.cuda import stft_kernel as sk
from spectrogram_tpu_torch.utils import autotune

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
STUB = ROOT / "tests" / "cuda_host_stub"
CSRC = ROOT / "spectrogram_tpu_torch" / "csrc"
SMALL = dict(sample_rate=8000.0, window_period=0.032, hop_period=0.008,
             viewport_height=64, viewport_rows=16)          # W=256, N=512
CFG = SpectrogramConfig(**SMALL)
GEOMETRIES = {
    "bench": BENCH_CONFIG,                                        # N=4096, radix 2
    "default": DEFAULT_CONFIG,                                    # N=4800, mixed radix
    "bluestein": SpectrogramConfig(sample_rate=22050.0),          # N=2204
    "n16384": SpectrogramConfig(window_period=8192 / 48000.0),    # N=16,384
    "n48000": SpectrogramConfig(window_period=0.5),               # the large-N route
}
STREAM_KW = dict(chunk_hops=1, store_ring=False, packed_output=True)
FAMILY_CODE = {"packed": 0, "split": 1, "push": 2}       # stft_host_launch's family
PICKED, NARROW = 2, 5                                    # the stub's body argument
# N across the bodies and the tables' thresholds: radix 2 to 2^16, mixed
# radix (with radix 7), Bluestein, odd N, the (512, 2) and wide-pack edges
LAUNCH_SIZES = (2, 3, 4, 8, 35, 64, 435, 512, 735, 1410, 2204, 4096, 4410, 4800, 4801,
                5811, 5812, 9604, 16384, 16400, 17640, 29056, 32768, 35280, 48000,
                58112, 65536)


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """(stft_host, colormap_host): the launch tables and the rows, built for
    the CPU."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler to build the device code for the CPU")
    out = tmp_path_factory.mktemp("autotune_host")
    libs = []
    for src in ("stft_host.cpp", "colormap_host.cpp"):
        so = out / f"lib{src[:-4]}.so"
        subprocess.run(
            [cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
             f"-I{STUB}", f"-I{CSRC}", "-o", str(so), str(STUB / src)],
            check=True, capture_output=True, timeout=300,
        )
        libs.append(ctypes.CDLL(str(so)))
    stft, cmap = libs
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    stft.stft_host_launch.argtypes = (i, i, i, i, p, p)
    stft.stft_host_launch.restype = i
    for fn in (stft.stft_host_rows, stft.stft_host_split):
        fn.argtypes = (i, i, i, i, p, p, p, p, p, p)
        fn.restype = i
    cmap.colormap_host_launch_form.argtypes = (i, i, i, i, i)
    cmap.colormap_host_launch_form.restype = i
    cmap.colormap_host_rows.argtypes = (p, p, i, i, p, p, p, p, i, p, p, i, i, i,
                                        f, f, f, f, p)
    cmap.colormap_host_rows.restype = i
    cmap.colormap_host_tile.argtypes = (p, p, i, i, i, p, p, p, p, i, p, p, i, i, i,
                                        f, f, f, f, p, p)
    cmap.colormap_host_tile.restype = i
    return stft, cmap


def _table(family: str, n: int) -> np.ndarray:
    return sk.fft_table(n) if family == "packed" else sk.split_fft_table(n)


def _launch(lib, family: str, n: int, w: int, choice: int):
    """(code, [bounds threads, blocks, threads launched, group cap])."""
    table = _table(family, n)
    out = np.zeros(4, np.int32)
    code = lib.stft_host_launch(FAMILY_CODE[family], n, w, choice, table.ctypes.data,
                                out.ctypes.data)
    return code, [int(v) for v in out]


def _routed(family: str, n: int, w: int) -> bool:
    """True where the family's kernels run at N (not the large-N route)."""
    if family == "packed":
        return not sk.is_large(n)
    return not sk.is_large_split(n)


# ------------------------------------------------------- candidates and tables


@pytest.mark.parametrize("family", ["packed", "split", "push"])
def test_host_stub_pins_the_candidates_to_the_c_tables(host_libs, family):
    """At every N of LAUNCH_SIZES the C tables take exactly the Python
    candidates, each under the bounds LAUNCH_BOUNDS names, with a thread
    count the block can hold and the pass bound those bounds leave; the
    table's rule is `launch_rule`'s bounds, and every other value is
    refused."""
    stft, _ = host_libs
    for n in LAUNCH_SIZES:
        w = max(n // 2, 1) if n >= 4 else n
        if not _routed(family, n, w):
            assert family != "push" or not sk.launch_candidates(family, n, w)
            assert sk.launch_candidates(family, n, w) == ()
            continue
        cands = sk.launch_candidates(family, n, w)
        legal = []
        for choice in range(1, 6):
            code, (bt, bb, threads, cap) = _launch(stft, family, n, w, choice)
            if code:
                continue
            legal.append(choice)
            assert (bt, bb) == sk.LAUNCH_BOUNDS[choice], (n, choice)
            assert 32 <= threads <= bt and threads % 32 == 0, (n, choice, threads)
            assert cap == (25 if 65536 // (bt * bb) >= 96 else 7)
        assert tuple(legal) == cands, (family, n)
        code, rule = _launch(stft, family, n, w, sk.LAUNCH_TABLE)
        if not cands:                     # a fused push whose block does not fit
            assert code and sk.launch_rule(family, n, w) == sk.LAUNCH_TABLE
            continue
        assert code == 0
        assert tuple(rule[:2]) == sk.LAUNCH_BOUNDS[sk.launch_rule(family, n, w)], (family, n)
        assert rule == _launch(stft, family, n, w, sk.launch_rule(family, n, w))[1]


@pytest.mark.parametrize("n_fft", [1410, 2204, 4096, 4800, 4801, 17640, 16384])
@pytest.mark.parametrize("family", ["packed", "split"])
def test_rows_under_each_candidate_equal_the_table(host_libs, family, n_fft):
    """A candidate moves the threads and the pass bound (`group_cap`) only:
    the rows under each candidate's bound (the stub's picked body, or body
    5 at the narrow bound) equal the table's bit for bit."""
    stft, _ = host_libs
    w = n_fft // 2
    fn = stft.stft_host_rows if family == "packed" else stft.stft_host_split
    hann = sk.packed_hann(w) if family == "packed" else sk.split_hann(w)
    pcm = testing.chirp_tone(2, w, 48000.0, seed=n_fft)
    left, right = (np.ascontiguousarray(pcm[..., c]) for c in range(2))
    table = _table(family, n_fft)

    def rows(cap):
        bins = sk.stft_bins(n_fft, w)
        out = np.zeros((2, 2, bins), np.float32)
        assert fn(PICKED if cap == 25 else NARROW, n_fft, 2, w, left.ctypes.data,
                  right.ctypes.data, hann.ctypes.data, table.ctypes.data,
                  out[0].ctypes.data, out[1].ctypes.data) == 0
        return out

    want = rows(_launch(stft, family, n_fft, w, sk.LAUNCH_TABLE)[1][3])
    caps = {_launch(stft, family, n_fft, w, c)[1][3]
            for c in sk.launch_candidates(family, n_fft)}
    for cap in caps:
        np.testing.assert_array_equal(rows(cap), want)


@pytest.mark.parametrize("generic", [False, True])
def test_tile_forms_pin_the_c_rule(host_libs, generic):
    """`tile_forms` and `tile_rule` against colormap_tile.cuh's
    `tile_launch_form` over spans, widths and table sizes: the staged form
    wherever its stages fit, the direct form always, the rule as
    `tile_staged`; any other form refused."""
    _, cmap = host_libs
    for h in (64, 256, 512, 1024, 2048):
        for res in (8, 32, 64, 256):
            for span in (1, 100, 575, 1152, 2047, 2304, 2900, 3000, 3100, 4096, 7497):
                forms = tuple(f for f in (ck.TILE_STAGED, ck.TILE_DIRECT)
                              if cmap.colormap_host_launch_form(span, h, res, generic, f) == f)
                assert forms == ck.tile_forms(span, h, res, generic), (span, h, res)
                assert (cmap.colormap_host_launch_form(span, h, res, generic, ck.TILE_RULE)
                        == ck.tile_rule(span, h, res, generic))
                assert cmap.colormap_host_launch_form(span, h, res, generic, 3) == -1


@pytest.mark.parametrize("generic", [False, True])
@pytest.mark.parametrize("span,h", [(2900, 256), (2000, 128), (2930, 64)])
def test_staged_tile_holds_past_its_speed_rule(host_libs, generic, span, h):
    """The staged tile at spans the rule leaves to the direct form (11x and
    more the width) but whose stages fit: every word the per-pixel code's,
    stored once, so the tuner may admit it."""
    _, cmap = host_libs
    res, rows, bins = 32, 9, span + 5
    assert ck.TILE_STAGED in ck.tile_forms(span, h, res, generic)
    assert ck.tile_rule(span, h, res, generic) == ck.TILE_DIRECT
    rng = np.random.default_rng(span + h)
    ml = (rng.random((rows, bins)) * 0.3).astype(np.float32)
    mr = (rng.random((rows, bins)) * 0.3).astype(np.float32)
    j0 = np.sort(rng.integers(0, span - 1, h)).astype(np.int32)
    j0[-1] = span - 2
    j1 = (j0 + 1).astype(np.int32)
    w0 = rng.random(h).astype(np.float32)
    w1 = (1 - w0).astype(np.float32)
    u = rng.random((rows, res * 4)).astype(np.float32)
    v = rng.random((rows, res * 4)).astype(np.float32) if generic else None
    args = (h, u.ctypes.data, None if v is None else v.ctypes.data, rows, 1, res,
            BENCH_CONFIG.min_db, BENCH_CONFIG.max_db - BENCH_CONFIG.min_db,
            BENCH_CONFIG.db_epsilon, 1.0 / (res - 1))
    want = np.zeros((rows, h), np.uint32)
    assert cmap.colormap_host_rows(ml.ctypes.data, mr.ctypes.data, rows, bins,
                                   j0.ctypes.data, j1.ctypes.data, w0.ctypes.data,
                                   w1.ctypes.data, *args, want.ctypes.data) == 0
    got = np.zeros((rows, h), np.uint32)
    count = np.zeros((rows, h), np.int32)
    assert cmap.colormap_host_tile(ml.ctypes.data, mr.ctypes.data, rows, bins, span,
                                   j0.ctypes.data, j1.ctypes.data, w0.ctypes.data,
                                   w1.ctypes.data, *args, got.ctypes.data,
                                   count.ctypes.data) == 0
    np.testing.assert_array_equal(got, want)
    assert (count == 1).all()


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_candidate_lists_are_valid(name, tmp_path, monkeypatch):
    """Each geometry's families and candidates: the STFT family by layout
    (none on the large-N route), the tile's forms at the push's taps, the
    table's pick among them; a geometry with nothing to choose is not
    measured."""
    cfg = GEOMETRIES[name]
    p = SpectrogramPipeline(cfg, device="cpu", **STREAM_KW)
    families = p.launch_families()
    n = cfg.padded_size
    assert families.get("packed", ()) == sk.launch_candidates("packed", n)
    assert "split" not in families and "push" not in families
    if name == "n48000":
        assert "packed" not in families
    else:
        assert families["packed"] == ((1, 3) if sk.fft_body(n) == "radix2" else (1, 2, 3))
        assert sk.launch_rule("packed", n) in families["packed"]
    assert families["tile"] == ck.tile_forms(p.taps.span, cfg.viewport_height,
                                             p.builtin_tables.shape[1] // 4)
    split = SpectrogramPipeline(cfg, device="cpu", stft_packed=False, **STREAM_KW)
    assert split.launch_families()["split"] == sk.launch_candidates("split", n)
    _, rule = autotune.launch_families(cfg, p.tune_kwargs())
    for family, choice in rule.items():
        assert choice in families[family]
    if not any(len(c) > 1 for c in families.values()):
        monkeypatch.setattr(autotune, "_device_name", lambda d: pytest.fail("no card"))
        picks = autotune.tune(cfg, cache_path=tmp_path / "t.json", pipeline_kwargs=p.tune_kwargs(),
                              measure=lambda *a, **k: pytest.fail("must not measure"))
        assert picks == rule
        assert not (tmp_path / "t.json").exists()


def test_pipelines_families_follow_backends_and_palettes():
    """The plain backends take no shape; a static palette no tile; a
    generic registry the generic tile's forms."""
    cfg = CFG
    assert SpectrogramPipeline(cfg, device="cpu", stft_backend="xla",
                               colormap_backend="xla").launch_families() == {}
    static = SpectrogramPipeline(cfg, device="cpu", static_palette="Magma")
    assert "tile" not in static.launch_families()
    generic = SpectrogramPipeline(cfg, device="cpu",
                                  schemes=(testing.custom_scheme(),))
    res = generic.generic_tables[0].shape[1] // 4
    assert generic.launch_families()["tile"] == ck.tile_forms(
        generic.taps.span, cfg.viewport_height, res, generic=True)


# ---------------------------------------------------------------- the cache


def _fake(calls, fast=None):
    """A measure that records each launch and favors the picks in `fast`."""
    fast = fast or {}

    def measure(cfg, launch, **kw):
        calls.append(dict(launch))
        return 1.0 - sum(0.1 for f, c in fast.items() if launch.get(f) == c)

    return measure


@pytest.fixture
def card_name(monkeypatch):
    monkeypatch.setattr(autotune, "_device_name", lambda device: "NVIDIA H100 80GB HBM3")


def test_tune_measures_once_then_caches(tmp_path, card_name):
    calls = []
    kw = SpectrogramPipeline(CFG, device="cpu", **STREAM_KW).tune_kwargs()
    families, rule = autotune.launch_families(CFG, kw)
    # radix 2 at (128, 5) or (512, 1); the tile direct by its rule (span
    # 256 > 2.25 x 64) or staged
    assert families == {"packed": (1, 3), "tile": (1, 2)} and rule == {"packed": 1, "tile": 2}
    cache = tmp_path / "tune.json"
    picks = autotune.tune(CFG, cache_path=cache, pipeline_kwargs=kw,
                          measure=_fake(calls, {"packed": 3, "tile": 1}))
    assert picks == {"packed": 3, "tile": 1}
    # one family at a time, the second at the first's pick; the shared
    # launch measured once
    assert calls == [{"packed": 1, "tile": 2}, {"packed": 3, "tile": 2},
                     {"packed": 3, "tile": 1}]
    entry = next(iter(json.loads(cache.read_text()).values()))
    assert entry["launch"] == picks and entry["table"] == rule and entry["measured"] == 3
    again = autotune.tune(CFG, cache_path=cache, pipeline_kwargs=kw,
                          measure=lambda *a, **k: pytest.fail("must not re-measure"))
    assert again == picks


def test_ties_keep_the_table(tmp_path, card_name):
    """A candidate within TIE_SPREAD of the table's pick never replaces it."""
    kw = SpectrogramPipeline(CFG, device="cpu", **STREAM_KW).tune_kwargs()

    def measure(cfg, launch, **k):
        return 1.0 - 0.01 * (launch["packed"] == 3) - 0.05 * (launch["tile"] == 1)

    picks = autotune.tune(CFG, cache_path=tmp_path / "t.json", pipeline_kwargs=kw,
                          measure=measure)
    assert picks == {"packed": 1, "tile": 1}


def test_cache_key_separates_card_kwargs_and_sources(monkeypatch):
    kw = dict(chunk_hops=1, store_ring=False)
    base = autotune._cache_key(CFG, "NVIDIA H100 80GB HBM3", kw)
    assert base != autotune._cache_key(CFG, "NVIDIA H100 PCIe", kw)
    assert base != autotune._cache_key(CFG, "NVIDIA H100 80GB HBM3", dict(kw, chunk_hops=8))
    assert base != autotune._cache_key(CFG, "NVIDIA H100 80GB HBM3", dict(kw, i16_planes=True))
    assert base != autotune._cache_key(BENCH_CONFIG, "NVIDIA H100 80GB HBM3", kw)
    assert autotune._source_digest() in base
    monkeypatch.setattr(autotune, "_source_digest", lambda: "0" * 64)
    assert base != autotune._cache_key(CFG, "NVIDIA H100 80GB HBM3", kw)
    # a registry keys by its schemes' names
    named = autotune._cache_key(CFG, "x", dict(schemes=(testing.custom_scheme(),)))
    assert "schemes=(smoke-custom)" in named


def test_sources_change_the_digest(tmp_path, monkeypatch):
    """The key's digest is the kernel build's: a changed source moves it."""
    from spectrogram_tpu_torch.ops.cuda import _build

    for src in CSRC.iterdir():
        shutil.copy(src, tmp_path / src.name)
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    before = autotune._source_digest()
    with open(tmp_path / "stft_fft.cuh", "a") as f:
        f.write("\n")
    assert autotune._source_digest() != before


def test_failing_candidates_are_skipped_and_all_failing_raise(tmp_path, card_name):
    kw = SpectrogramPipeline(CFG, device="cpu", **STREAM_KW).tune_kwargs()

    def some_fail(cfg, launch, **k):
        if launch["packed"] == 3:
            raise RuntimeError("spk_stft_packed: CUDA launch failed (7): too many resources")
        return 1.0 - 0.1 * (launch["tile"] == 1)

    picks = autotune.tune(CFG, cache_path=tmp_path / "a.json", pipeline_kwargs=kw,
                          measure=some_fail)
    assert picks == {"packed": 1, "tile": 1}

    def all_fail(cfg, launch, **k):
        raise RuntimeError(f"launch {launch} failed")

    with pytest.raises(RuntimeError, match="all 2 candidates of packed failed") as err:
        autotune.tune(CFG, cache_path=tmp_path / "b.json", pipeline_kwargs=kw,
                      measure=all_fail)
    assert "failed" in str(err.value.__cause__)
    assert not (tmp_path / "b.json").exists()


def test_stale_cached_pick_is_measured_again(tmp_path, card_name):
    kw = SpectrogramPipeline(CFG, device="cpu", **STREAM_KW).tune_kwargs()
    cache = tmp_path / "t.json"
    key = autotune._cache_key(CFG, "NVIDIA H100 80GB HBM3", kw)
    # (512, 2) is no radix-2 candidate; a family the push does not run
    for stale in ({"packed": 2, "tile": 1}, {"packed": 1, "split": 1, "tile": 1},
                  {"packed": 1}):
        cache.write_text(json.dumps({key: {"launch": stale}}))
        calls = []
        picks = autotune.tune(CFG, cache_path=cache, pipeline_kwargs=kw,
                              measure=_fake(calls, {"packed": 3}))
        assert picks == {"packed": 3, "tile": 2} and len(calls) == 3
    cache.write_text("{not json")
    assert autotune.tune(CFG, cache_path=cache, pipeline_kwargs=kw,
                         measure=_fake([], {"packed": 3})) == {"packed": 3, "tile": 2}
    assert json.loads(cache.read_text())[key]["launch"] == {"packed": 3, "tile": 2}


def test_a_cache_that_cannot_be_written_never_fails(tmp_path, card_name):
    blocker = tmp_path / "file"
    blocker.write_text("")
    kw = SpectrogramPipeline(CFG, device="cpu", **STREAM_KW).tune_kwargs()
    picks = autotune.tune(CFG, cache_path=blocker / "sub" / "t.json", pipeline_kwargs=kw,
                          measure=_fake([], {"tile": 1}))
    assert picks == {"packed": 1, "tile": 1}
    assert list(tmp_path.iterdir()) == [blocker]


def test_two_processes_storing_at_once_leave_valid_json(tmp_path):
    """Ranks of a mesh may tune at once: each store goes through a
    temporary file of its own, so the cache is whole JSON after any
    interleaving and no temporary file is left."""
    cache = tmp_path / "t.json"
    code = (
        "import sys\n"
        "from spectrogram_tpu_torch.utils import autotune as a\n"
        "import pathlib\n"
        "p = pathlib.Path(sys.argv[1])\n"
        "for i in range(150):\n"
        "    c = a._load_cache(p)\n"
        "    c[f'{sys.argv[2]}-{i}'] = {'launch': {'packed': 1}, 'pad': 'x' * 4000}\n"
        "    a._store_cache(p, c)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(cache), str(r)], env=env,
                              cwd=ROOT) for r in range(2)]
    assert all(proc.wait(timeout=240) == 0 for proc in procs)
    data = json.loads(cache.read_text())
    assert any(k.startswith("0-") for k in data) or any(k.startswith("1-") for k in data)
    assert [p.name for p in tmp_path.iterdir()] == ["t.json"]


# ------------------------------------------------------------- the pipeline


def test_pipeline_autotune_flag_uses_the_cache(tmp_path, monkeypatch, card_name):
    """A CPU pipeline with autotune=True measures nothing and launches
    nothing new; the wiring a CUDA pipeline takes (`_tuned_launch`, then
    `override_launch`) reaches `tune` with the pipeline's deployment,
    measures once, then hits the cache, and the rows stay the same."""
    monkeypatch.setattr(autotune, "DEFAULT_CACHE", tmp_path / "t.json")
    monkeypatch.setattr(autotune, "measure_push",
                        lambda *a, **k: pytest.fail("a CPU pipeline must not measure"))
    p = SpectrogramPipeline(CFG, chunk_hops=2, autotune=True, device="cpu")
    assert p.autotune and p.launch == {}
    assert not (tmp_path / "t.json").exists()

    calls = []
    monkeypatch.setattr(autotune, "measure_push", _fake(calls, {"packed": 3, "tile": 1}))
    picks = p._tuned_launch()
    assert picks == {"packed": 3, "tile": 1} and len(calls) == 3
    assert all(c["packed"] in (1, 3) for c in calls)
    key = next(iter(json.loads((tmp_path / "t.json").read_text())))
    assert "chunk_hops=2" in key and "store_ring=True" in key
    assert p._tuned_launch() == picks and len(calls) == 3
    plain = SpectrogramPipeline(CFG, chunk_hops=2, device="cpu")
    p.override_launch(picks)
    assert p.launch == picks
    pcm = testing.chirp_tone(3, 2 * p.chunk_size, CFG.sample_rate, seed=5)
    s, t = p.init_state(3), plain.init_state(3)
    for i in range(2):
        chunk = torch.from_numpy(pcm[:, i * p.chunk_size : (i + 1) * p.chunk_size])
        s, a = p.push(s, chunk)
        t, b = plain.push(t, chunk)
        assert torch.equal(a, b) and torch.equal(s.carry, t.carry)
    assert torch.equal(p.render_viewport(s), plain.render_viewport(t))
    assert torch.equal(p.process(torch.from_numpy(pcm)), plain.process(torch.from_numpy(pcm)))


def test_override_launch_refuses_shapes_the_push_does_not_take():
    p = SpectrogramPipeline(CFG, device="cpu", **STREAM_KW)
    with pytest.raises(ValueError, match="packed=2"):
        p.override_launch({"packed": 2})                  # radix 2: no (512, 2)
    with pytest.raises(ValueError, match="split"):
        p.override_launch({"split": 1})
    with pytest.raises(ValueError, match="tile"):
        SpectrogramPipeline(CFG, device="cpu", static_palette=1).override_launch({"tile": 1})
    p.override_launch({"packed": 3})
    assert p.launch == {"packed": 3}
    p.override_launch(None)
    assert p.launch == {}


def test_tile_form_follows_the_taps():
    """The pipeline's tile form goes to a launch only where it runs at that
    launch's taps; elsewhere the launch takes the rule."""
    p = SpectrogramPipeline(BENCH_CONFIG, device="cpu", **STREAM_KW)
    p.override_launch({"tile": ck.TILE_STAGED})
    assert p._tile_launch(p.taps) == ck.TILE_STAGED
    wide = ck.resample_taps(np.eye(1024, 8000, k=6000, dtype=np.float32), "cpu")
    assert ck.TILE_STAGED not in ck.tile_forms(*p._tile_args(wide))
    assert p._tile_launch(wide) is None
    p.override_launch({})
    assert p._tile_launch(p.taps) is None


def test_stream_groups_keep_their_own_choices(tmp_path, monkeypatch, card_name):
    """Two geometries in one manager tune and keep their own picks: the
    choice belongs to the pipeline, never to the process."""
    from spectrogram_tpu_torch.models.multirate import StreamGroupManager

    monkeypatch.setattr(autotune, "DEFAULT_CACHE", tmp_path / "t.json")
    other = SpectrogramConfig(**dict(SMALL, sample_rate=11025.0))     # N=704, mixed radix
    fast = {CFG.padded_size: 3, other.padded_size: 2}

    def measure(cfg, launch, **k):
        return 1.0 - 0.2 * (launch.get("packed") == fast[cfg.padded_size])

    monkeypatch.setattr(autotune, "measure_push", measure)
    mgr = StreamGroupManager(group_capacity=2, device="cpu", autotune=True, **STREAM_KW)
    mgr.add_stream(CFG)
    mgr.add_stream(other)
    pipes = {cfg.padded_size: g.pipeline for cfg, g in mgr._groups.items()}
    picks = {n: p._tuned_launch() for n, p in pipes.items()}
    for n, p in pipes.items():
        p.override_launch(picks[n])
    assert pipes[CFG.padded_size].launch["packed"] == 3
    assert pipes[other.padded_size].launch["packed"] == 2
    assert len(json.loads((tmp_path / "t.json").read_text())) == 2


# ------------------------------------------------ against the JAX package


@pytest.mark.parametrize("kind", ["chirp_tone", "noise"])
def test_tuned_pipeline_matches_jax_autotune(tmp_path, monkeypatch, card_name, kind):
    """The same seeded PCM through JAX's SpectrogramPipeline(autotune=True)
    (its `measure_stft` replaced, a temporary cache, as its own test does)
    and the port's, tuned to shapes other than the table's: RGBA within 1
    u8 over what the image shows, the carry exact."""
    monkeypatch.setattr(jax_autotune, "measure_stft",
                        lambda cfg, plan, ts, **kw: float(plan.n1))
    monkeypatch.setattr(jax_autotune, "DEFAULT_CACHE", tmp_path / "jax.json")
    monkeypatch.setattr(autotune, "DEFAULT_CACHE", tmp_path / "torch.json")
    monkeypatch.setattr(autotune, "measure_push", _fake([], {"packed": 3, "tile": 1}))
    kw = dict(chunk_hops=2, packed_output=True, palette_sort=False)
    jp = JaxPipeline(jcfg.SpectrogramConfig(**SMALL), autotune=True, **kw)
    tp = SpectrogramPipeline(CFG, autotune=True, device="cpu", **kw)
    tp.override_launch(tp._tuned_launch())
    assert tp.launch == {"packed": 3, "tile": 1}
    ids = np.array([0, 1, 3, 8])
    js = jp.set_palette(jp.init_state(len(ids)), ids)
    ts = state_from_jax({k: (np.asarray(v) if k != "tables" else
                             tuple(np.asarray(t) for t in v))
                         for k, v in js._asdict().items()}, device="cpu")
    pcm = testing.make(kind, len(ids), 3 * jp.chunk_size, CFG.sample_rate, seed=18)
    worst = 0
    for i in range(3):
        chunk = pcm[:, i * jp.chunk_size : (i + 1) * jp.chunk_size]
        js, jr = jp.push(js, jnp.asarray(chunk))
        ts, tr = tp.push(ts, torch.from_numpy(chunk))
        np.testing.assert_array_equal(ts.carry.numpy(), np.asarray(js.carry))
        worst = max(worst, testing.rgba_u8_diff(ck.unpack_rgba(np.asarray(jr)),
                                                ck.unpack_rgba(tr)))
    assert worst <= 1
