"""Runtime launch-shape autotuning on the card: the FFTW `Flag::MEASURE`
analog.

The counterpart of `spectrogram_tpu/utils/autotune.py`.  The JAX tuner
measures the TPU's choices that its cost model cannot settle (the four-step
factorization and the Pallas block rows); the port's kernels need neither.
What the port's launch code decides from fixed tables instead is tuned
here, per launch family (`SpectrogramPipeline.launch_families`):

* "packed": the launch bounds of kernel A and the packed all-windows
  kernels (csrc/stft_fft.cuh `with_row_bounds`: (128, 5), (512, 2) except
  at radix 2, (512, 1));
* "split": those of the split-real kernels (`with_split_bounds`: (128, 5),
  (512, 1), (1024, 1));
* "tile": the form of the colormap tile that kernel B, the blockwise
  colormap and the generic kernel launch (csrc/colormap_tile.cuh
  `tile_launch_form`: staged wherever its stages fit, or direct).

Every candidate gives the same bits (the C sources say why), so a pick
changes speed only.  The fused push's bounds (`push_fused.cu`) take the
same argument but no pipeline push runs the fused push, so no pipeline
tunes it; the large-N route and the static colormap have fixed shapes.

A pick is measured on the whole push (`measure_push`: device time with CUDA
events over seeded chunks), one family at a time with the others at their
current pick, and kept in a JSON cache keyed by the card's name, the
geometry, the pipeline's deployment arguments and the kernel sources'
digest (`_build._source_digest`), so a kernel change drops stale rankings
by itself.  The cache is the port's own (`DEFAULT_CACHE`): the JAX
package's keys name a TPU kind and FFT plans, and the two never cross.
The measurement costs seconds a geometry on the card once the kernels are
built; warm the cache before a latency-sensitive start by calling `tune`
per geometry with the deployment's kwargs.
"""

from __future__ import annotations

import json
import os
import pathlib
import time
from typing import Optional

import numpy as np
import torch

from spectrogram_tpu_torch.config import SpectrogramConfig

DEFAULT_CACHE = pathlib.Path(
    os.environ.get(
        "SPECTROGRAM_TPU_TORCH_TUNE_CACHE",
        os.path.expanduser("~/.cache/spectrogram_tpu_torch/autotune.json"),
    )
)
# A candidate must beat the table's rule by more than this share of the
# rule's time to replace it, so that noise never flips a launch.
TIE_SPREAD = 0.02
# measure_push's ring, at most this many bytes: a display pipeline's ring
# of 2,048 rows holds 16.8 MB a stream at BENCH_CONFIG
RING_BUDGET_BYTES = 1 << 32


def _source_digest() -> str:
    from spectrogram_tpu_torch.ops.cuda import _build

    return _build._source_digest()


def _key_value(value) -> str:
    """A deployment argument as the cache key spells it: a palette
    registry by its schemes' names."""
    if isinstance(value, (tuple, list)) and value and hasattr(value[0], "name"):
        return "(" + ",".join(s.name for s in value) + ")"
    return str(value)


def _cache_key(cfg: SpectrogramConfig, device_name: str, pipeline_kwargs: dict) -> str:
    # The deployment arguments change the measured push (chunk_hops picks
    # the all-windows kernel, the layout knobs the split-real family, the
    # registry the generic tile), so rankings cached for one deployment
    # must not shadow another's.
    extras = ",".join(f"{k}={_key_value(pipeline_kwargs[k])}" for k in sorted(pipeline_kwargs))
    return (f"{_source_digest()}|{device_name}|n={cfg.padded_size}|w={cfg.window_size}"
            f"|hop={cfg.hop_size}|h={cfg.viewport_height}|rate={cfg.sample_rate}|{extras}")


def _load_cache(path: pathlib.Path) -> dict:
    try:
        with open(path) as f:
            cache = json.load(f)
    except (OSError, ValueError):
        return {}
    return cache if isinstance(cache, dict) else {}


def _store_cache(path: pathlib.Path, cache: dict) -> None:
    """Write the cache atomically through a temporary file unique to this
    process and thread, so that two processes (the mesh's ranks) storing
    at once each leave whole JSON."""
    tmp = path.with_name(f"{path.name}.{os.getpid()}.{time.monotonic_ns()}.tmp")
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(cache, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass  # the cache is an optimization; never fail the pipeline over it
    finally:
        try:
            tmp.unlink()
        except OSError:
            pass


def _device_name(device) -> str:
    return torch.cuda.get_device_name(device)


def _measured_kwargs(pipeline_kwargs: dict | None) -> dict:
    """JAX's measurement deployment (k=1, no ring, packed rows), updated by
    the caller's, never tuning itself."""
    kwargs = dict(chunk_hops=1, store_ring=False, packed_output=True,
                  precision_profile="fast")
    kwargs.update(pipeline_kwargs or {})
    kwargs["autotune"] = False
    return kwargs


def measure_push(cfg: SpectrogramConfig, launch: dict, n_streams: int = 4096,
                 iters: int = 20, trials: int = 2,
                 pipeline_kwargs: dict | None = None, device=None) -> float:
    """Device ms of the FULL push with `launch` (`override_launch`) on the
    card: the pipeline of `pipeline_kwargs` on palettes arange(S) % P,
    pushed seeded chunks of noise, timed by `testing.device_ms` (CUDA
    events, the card held while the host enqueues); the least of `trials`
    means of `iters` pushes.  The whole push, not the kernel alone: the
    framing and gathers around it share the card's caches with it.  A
    pipeline with a ring takes at most the streams whose ring fits
    RING_BUDGET_BYTES."""
    from spectrogram_tpu_torch import testing
    from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline

    device = torch.device(device or "cuda")
    pipeline = SpectrogramPipeline(cfg, device=device, **_measured_kwargs(pipeline_kwargs))
    pipeline.override_launch(launch)
    s = _measured_streams(pipeline, n_streams)
    state = pipeline.init_state(s)
    if pipeline.static_table is None:
        state = pipeline.set_palette(state, np.arange(s) % len(pipeline.schemes))
    pcm = testing.noise(s, pipeline.chunk_size, seed=0)
    if pipeline.i16_planes:
        words = np.round(np.clip(pcm, -1.0, 1.0) * 32767.0).astype(np.int16)
        chunk = torch.from_numpy(words).to(device)
    else:
        chunk = torch.from_numpy(pcm).to(device)
    held = [state]

    def push():
        held[0], _ = pipeline.push(held[0], chunk)

    with torch.cuda.device(device):
        return min(testing.device_ms(push, iters=iters) for _ in range(trials))


def _measured_streams(pipeline, n_streams: int) -> int:
    """The streams `measure_push` runs: n_streams, fewer where the ring
    would pass RING_BUDGET_BYTES."""
    if not pipeline.store_ring:
        return n_streams
    per_stream = (pipeline.viewport_rows * 2 * pipeline.cfg.num_bins
                  * torch.finfo(pipeline.ring_dtype).bits // 8)
    return max(1, min(n_streams, RING_BUDGET_BYTES // per_stream))


def launch_families(cfg: SpectrogramConfig,
                    pipeline_kwargs: dict | None = None) -> tuple[dict, dict]:
    """({family: candidates}, {family: the table's pick}) of the push the
    deployment runs, from a twin of its pipeline on the CPU (the families
    depend on the geometry and the arguments, not on the device)."""
    from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline

    twin = SpectrogramPipeline(cfg, device="cpu", **_measured_kwargs(pipeline_kwargs))
    return twin.launch_families(), twin.launch_rules()


def tune(cfg: SpectrogramConfig, cache_path: Optional[pathlib.Path] = None,
         measure=None, verbose: bool = False, pipeline_kwargs: dict | None = None,
         device=None) -> dict:
    """{family: choice} for this geometry AND deployment (pass the
    pipeline's `tune_kwargs()`: they change the measured push), for every
    launch family its push runs: cached if seen before on this card name
    with these kernel sources, measured otherwise, and stored.

    A family with one candidate is not measured; a candidate that fails to
    launch is skipped, and where every candidate of a family fails this
    raises with the last error chained.  A candidate replaces the table's
    pick only where it is faster by more than TIE_SPREAD.  A cached pick
    that is no longer among today's candidates is measured again."""
    measure = measure or measure_push          # late bind (testable / patchable)
    pipeline_kwargs = dict(pipeline_kwargs or {})
    families, rule = launch_families(cfg, pipeline_kwargs)
    if not any(len(c) > 1 for c in families.values()):
        return dict(rule)                      # nothing to measure
    path = pathlib.Path(cache_path or DEFAULT_CACHE)
    key = _cache_key(cfg, _device_name(device), pipeline_kwargs)
    hit = _load_cache(path).get(key)
    if isinstance(hit, dict):
        picks = hit.get("launch")
        if (isinstance(picks, dict) and set(picks) == set(families)
                and all(picks[f] in families[f] for f in families)):
            return dict(picks)

    picks = dict(rule)
    measured = {}
    results = {}

    def timed(launch: dict) -> float:
        at = tuple(sorted(launch.items()))
        if at not in measured:
            measured[at] = measure(cfg, dict(launch), pipeline_kwargs=pipeline_kwargs,
                                   device=device)
        return measured[at]

    for family, choices in families.items():
        if len(choices) < 2:
            continue
        times, failures = {}, []
        for choice in choices:
            try:
                times[choice] = timed(dict(picks, **{family: choice}))
            except Exception as e:  # noqa: BLE001 — a candidate that cannot
                # launch (a resource limit) is simply not viable; skip it
                failures.append(e)
                if verbose:
                    print(f"  tune {family}={choice}: FAILED {type(e).__name__}: {e}")
                continue
            if verbose:
                print(f"  tune {family}={choice}: {times[choice]:.4f} ms")
        if not times:
            raise RuntimeError(
                f"autotune: all {len(failures)} candidates of {family} failed; "
                f"last error follows") from failures[-1]
        best = min(times, key=times.get)
        table = rule[family]
        if table in times and times[best] >= times[table] * (1.0 - TIE_SPREAD):
            best = table
        picks[family] = best
        results[family] = {str(c): round(t, 5) for c, t in times.items()}
    cache = _load_cache(path)
    cache[key] = {"launch": picks, "table": rule, "ms": results,
                  "measured": len(measured)}
    _store_cache(path, cache)
    return picks
