"""One run of one cell: set-up, the measured window, the check of what the
window produced against the plain reference, and the result.

A cell is an entry of `BENCHMARK.json`'s workloads.  Everything that
belongs to one configuration, traffic mix, metric, layer or cell sits in a
file of its own, found by name:

  configs/<config>.json     the deployment: geometry, pipeline arguments,
                            streams, wire, palette layout rule, guarantees
  traffic/<traffic>.json    the loop kind, its depth, pools, palettes, signal
  loops/<loop>.py           the loop kinds (`setup`, `window`)
  metrics/<metric>.py       one reader per metric (`read(record)`); a name
                            `<metric>.<group>` falls back to `<metric>`'s
  work/<layer>.py           a layer's bytes and operations, for its roofline
  layers/<bucket>/*.json    which device operations are a layer's
  checks/<cell>.json        the limits of the numbers `correct` compares

The program under test is `spectrogram_tpu_torch`, loaded from the
checkout that holds this folder and from nowhere else, and driven through
its public entry points.  Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import pathlib
import random
import sys
import time

import numpy as np
import torch

from portbench import traffic_gen
from portbench.reference import law, palettes

PKG = pathlib.Path(__file__).resolve().parent
ROOT = PKG.parent
BARRED = ("jax", "jaxlib", "flax", "spectrogram_tpu")


def barred_modules() -> list[str]:
    """Loaded modules whose top-level name is a barred one, compared whole
    (`spectrogram_tpu_torch` is not `spectrogram_tpu`)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in BARRED)


def _json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    limits: dict
    metrics: list           # [(name, unit)] of the end-to-end metrics
    layer_metrics: list     # [(name, unit)] of the per-layer metrics


def cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell `name` of the benchmark in `root`, with its files."""
    bench = _json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")

    def mine(metrics):
        return [(m["name"], m["unit"]) for m in metrics
                if name in m.get("workloads", [name])]

    return Cell(
        name=name,
        config=_json(PKG / "configs" / f"{entry['config']}.json"),
        traffic=_json(PKG / "traffic" / f"{entry['traffic']}.json"),
        chips=int(entry["chips"]),
        limits=_json(PKG / "checks" / f"{name}.json"),
        metrics=mine(bench["end_to_end"]),
        layer_metrics=mine(bench["per_layer"]),
    )


def program():
    """The port, from this checkout: (SpectrogramConfig, SpectrogramPipeline,
    the `ops.cuda._build` module)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import spectrogram_tpu_torch

    where = pathlib.Path(spectrogram_tpu_torch.__file__).resolve()
    if not where.is_relative_to(ROOT):
        raise SystemExit(f"spectrogram_tpu_torch was loaded from {where}, outside "
                         f"the checkout {ROOT}")
    from spectrogram_tpu_torch.config import SpectrogramConfig
    from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline
    from spectrogram_tpu_torch.ops.cuda import _build

    return SpectrogramConfig, SpectrogramPipeline, _build


def _pipeline_kwargs(config: dict) -> dict:
    kw = dict(config["pipeline"])
    if "ring_dtype" in kw:
        kw["ring_dtype"] = getattr(torch, kw["ring_dtype"])
    return kw


def _metric_reader(name: str):
    """metrics/<name>.py, else the reader of the name's part before its
    first dot: `stft_ms.served` is `stft_ms` in the cells that report
    `rows_per_s.served`, one quantity that moves another end-to-end
    metric there."""
    path = PKG / "metrics" / f"{name}.py"
    if not path.exists():
        path = PKG / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _work(layer: str):
    return importlib.import_module(f"portbench.work.{layer}")


class Run:
    """One run of a cell on one device.  `setup()` makes the program, its
    state and the traffic; the loop's `window()` fills the measurements and
    holds a sample of the outputs; `close()` reads the device and takes
    the program's outputs for the check; `judge()` compares them with the
    reference."""

    def __init__(self, c: Cell, seed: int, device, t_process: float | None = None):
        self.cell = c
        self.seed = int(seed)
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.t_process = t_process          # host clock at process start
        self.loop = importlib.import_module(f"portbench.loops.{c.traffic['loop']}")
        self.geometry = law.geometry(c.config["spectrogram"])
        self.k = int(c.config["pipeline"].get("chunk_hops", 8))
        self.streams = int(c.config["streams"])
        self.store_ring = bool(c.config["pipeline"].get("store_ring", True))
        self.wire = c.config["wire"]
        self.rng = random.Random(self.seed)
        # filled by the loop's window
        self.units = 0                      # pushes or ticks of the window
        self.window_s = 0.0
        self.latency_ms = np.zeros(0)
        self.enqueue_ms = np.zeros(0)
        self.held = {}                      # unit index -> program rows
        self.seen = 0
        self.trace = None
        self.t_first = None                 # host clock at the first timed unit
        self.marks = []                     # (set-up stage, host clock at its end)

    # ------------------------------------------------------------- set-up

    def mark(self, name: str) -> None:
        """A set-up stage's end on the host clock (printed apart)."""
        self.marks.append((name, time.perf_counter()))

    def setup(self) -> None:
        config, traffic = self.cell.config, self.cell.traffic
        self.mark("the harness's imports, the card found")
        if self.on_card:
            torch.zeros(1, device=self.device)
            self.mark("card context")
        SpectrogramConfig, SpectrogramPipeline, build = program()
        self.build = build
        self.pipe = SpectrogramPipeline(SpectrogramConfig(**config["spectrogram"]),
                                        device=self.device, **_pipeline_kwargs(config))
        self.mark("pipeline")
        self.ids = traffic_gen.palettes(traffic["palettes"], self.streams,
                                        len(palettes.SCHEMES), self.seed)
        if isinstance(self.ids, int):
            self.state = self.pipe.init_state(self.streams, palette_id=self.ids)
        else:
            self.state = self.pipe.set_palette(self.pipe.init_state(self.streams), self.ids)
        self.mark("state and palette order")
        wire_dtype = getattr(torch, self.wire["dtype"])
        g = self.geometry
        self.pool_ext = traffic_gen.pool(
            traffic["signal"], g.sample_rate, g.hop, self.k, self.streams,
            int(traffic["pool_pushes"]), wire_dtype, self.seed, self.device)
        perm = self.pipe.input_perm(self.state) if config["pipeline"].get("presorted_input") else None
        pool = self.pool_ext
        if perm is not None:
            pool = pool.index_select(1, torch.from_numpy(perm.astype(np.int64)).to(self.device))
        if self.wire["layout"] == "interleaved":
            pool = pool.transpose(2, 3).contiguous()
        self.pool_prog = pool              # [P, S, 2, T] planar or [P, S, T, 2]
        self.mark("traffic")
        self.loop.setup(self)
        self.mark("warm-up")

    def push(self, chunk):
        """One push of the program, by the wire's layout: (state, rows)."""
        if self.wire["layout"] == "interleaved":
            return self.pipe.push(self.state, chunk)
        return self.pipe.push_planar(self.state, chunk)

    def hold(self, unit: int, rows, last: bool = False) -> None:
        """Reservoir-sample the window's outputs from the seed: hold
        `held_units` of them, and always the last."""
        n = int(self.cell.traffic["held_units"])
        self.seen += 1
        if last:
            self.held[unit] = rows
            return
        if len(self.held) < n:
            self.held[unit] = rows
        else:
            j = self.rng.randrange(self.seen)
            if j < n:
                del self.held[sorted(self.held)[j]]
                self.held[unit] = rows

    # -------------------------------------------------------------- close

    def close(self) -> dict:
        """After the window: the device's readings, then the program's state
        that the check reads (next carry, palette order, a sample of ring
        rows), then the program's state freed."""
        info = {}
        if self.on_card:
            torch.cuda.synchronize()
            info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(self.device))
        lib = self.build.library() if self.on_card else None
        if lib is not None:
            info["launches"] = {k: v for k, v in lib.launches.items() if v}
            info["body_launches"] = {k: v for k, v in lib.body_launches.items() if v}
        self.prog_input_perm = self.pipe.input_perm(self.state)
        self.prog_output_perm = self.pipe.output_perm(self.state)
        self.prog_carry = self.state.carry.clone()
        self.ring_streams = None
        if self.store_ring:
            n = min(int(self.cell.traffic["ring_streams"]), self.streams)
            pick = sorted(random.Random(self.seed + 1).sample(range(self.streams), n))
            self.ring_streams = torch.tensor(pick, device=self.device)
            self.prog_ring = self.state.ring.index_select(0, self.ring_streams)
        del self.state
        self.loop.teardown(self)
        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()
        return info

    # -------------------------------------------------------------- check

    def judge(self, precision: str | None = None) -> dict:
        """The numbers `correct` compares, each {"value", "limit"}.

        precision None judges the program's outputs; "bf16" judges the
        control instead: the reference computed with its DFT in bfloat16,
        put in the program's place."""
        g, k, s, dev = self.geometry, self.k, self.streams, self.device
        taps = law.taps(g, dev)
        row_bins = law.tapped_bins(taps)
        luts = torch.from_numpy(palettes.lookup_tables(g.resolution)).to(dev)
        ids = (np.full(s, self.ids, np.int32) if isinstance(self.ids, int) else self.ids)
        pid = torch.from_numpy(ids.astype(np.int64)).to(dev)
        pcfg = self.cell.config["pipeline"]
        order = law.sort_order(ids, k, self.cell.config["palette_order"], self.store_ring) \
            if not isinstance(self.ids, int) else np.arange(s)
        order_t = torch.from_numpy(order.astype(np.int64)).to(dev)
        inverse = torch.empty_like(order_t)
        inverse[order_t] = torch.arange(s, device=dev)
        # where external stream e sits in the program's rows and carry
        row_pos = inverse if pcfg.get("sorted_output") else torch.arange(s, device=dev)
        carry_pos = inverse if (pcfg.get("palette_sort", True) and not self.store_ring) \
            else torch.arange(s, device=dev)
        out = {}
        if precision is None:
            prog = np.arange(s) if self.prog_input_perm is None else self.prog_input_perm
            perm_off = int((prog != order).sum())
            if pcfg.get("sorted_output"):
                back = np.arange(s) if self.prog_output_perm is None else self.prog_output_perm
                perm_off += int((back[order] != np.arange(s)).sum())
            out["perm_off"] = perm_off
            ref = law.next_carry(self.pool_ext, self.next_unit - 1, g, k)
            out["carry_off"] = int((self.prog_carry.index_select(0, carry_pos) != ref).sum())
            out["missing"] = int(getattr(self, "missing", 0))
        worst = off = pixels = 0
        block = 1024 if self.on_card else 64
        for unit in sorted(self.held):
            rows = self.held[unit]
            rows = torch.as_tensor(rows).to(dev) if precision is None else None
            for e0 in range(0, s, block):
                idx = torch.arange(e0, min(e0 + block, s), device=dev)
                win = law.windows(law.history(self.pool_ext, unit, g, k, idx), g, k)
                n = idx.numel()
                ref = self._rows(win, taps, row_bins, luts, pid[idx], "f32")
                if precision is None:
                    mine = rows.index_select(0, row_pos[idx]).contiguous()
                    mine = mine.view(torch.uint8).reshape(n, k, g.height, 4)
                else:
                    mine = self._rows(win, taps, row_bins, luts, pid[idx], precision)
                w, o, p = law.rgba_gap(mine, ref)
                worst, off, pixels = max(worst, w), off + o, pixels + p
        out["rows_u8"] = worst
        out["rows_off_ppm"] = off * 1e6 / max(pixels, 1)
        self.pixels_checked = pixels
        if self.store_ring:
            out["ring_ulp"] = self._ring_ulps(precision)
        return {name: {"value": value, "limit": self.cell.limits[name]["limit"]}
                for name, value in out.items()}

    def _rows(self, win, taps, bins, luts, pid, precision) -> torch.Tensor:
        """[n, k, 2, W] windows -> [n, k, H, 4] u8 rows by the reference."""
        n, k = win.shape[:2]
        mag = law.magnitudes(win, self.geometry, bins, precision)     # [n, k, 2, b]
        rows = law.colormap(mag[:, :, 0].reshape(n * k, -1), mag[:, :, 1].reshape(n * k, -1),
                            bins, taps, luts, pid.repeat_interleave(k), self.geometry)
        return rows.reshape(n, k, self.geometry.height, 4)

    def _ring_ulps(self, precision) -> int:
        """The ring's largest gap in bf16 steps, over the sampled streams'
        every row, where the reference magnitude is at least the dB floor."""
        ref = self._ref_ring("f32")
        judged = self.prog_ring if precision is None else self._ref_ring(precision)
        return law.bf16_ulps(judged, ref, 10.0 ** (self.geometry.min_db / 20.0))[0]

    def _ref_ring(self, precision: str) -> torch.Tensor:
        """The sampled streams' ring as the reference writes it: the rows of
        the last R/k pushes, bins 1..W-1, at their slots, in the ring dtype."""
        g, k, dev = self.geometry, self.k, self.device
        r = self.prog_ring.shape[1]
        bins = torch.arange(1, g.window, device=dev)
        last = self.next_unit - 1
        ring = torch.empty_like(self.prog_ring)
        for i0 in range(last - r // k + 1, last + 1, 32):
            units = range(i0, min(i0 + 32, last + 1))
            win = torch.stack([law.windows(law.history(self.pool_ext, i, g, k, self.ring_streams),
                                           g, k) for i in units], dim=1)   # [n, u, k, 2, W]
            mag = law.magnitudes(win, g, bins, precision)
            slots = torch.tensor([(i * k + j) % r for i in units for j in range(k)], device=dev)
            ring.index_copy_(1, slots, mag.reshape(mag.shape[0], -1, 2, bins.numel())
                             .to(ring.dtype))
        return ring


def correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def setup_seconds(run: Run) -> float:
    return run.t_first - run.t_process


def setup_stages(run: Run) -> dict:
    """Seconds of each set-up stage, from process start."""
    out, t = {}, run.t_process
    for name, at in run.marks:
        out[name] = at - t
        t = at
    return out


def result(run: Run, trace: bool, info: dict, checks: dict) -> dict:
    """The contract's last line."""
    record = Record(run, info)
    names = run.cell.layer_metrics if trace else run.cell.metrics
    metrics = {}
    for name, unit in names if run.on_card else ():     # a CPU run measures no card
        value = _metric_reader(name).read(record)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    device = {"platform": "gpu" if run.on_card else run.device.type,
              "kind": torch.cuda.get_device_name(run.device) if run.on_card else "cpu",
              "count": 1, "memory_peak_bytes": info.get("memory_peak_bytes", 0)}
    line = {"correct": correct(checks), "attempted": run.units,
            "failed": int(checks.get("missing", {}).get("value", 0)),
            "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        line["breakdown"] = run.trace.breakdown()
    line["checks"] = checks
    return line


class Record:
    """What the metric readers read: the run's measurements, its trace and
    the work of its layers."""

    def __init__(self, run: Run, info: dict):
        self.run = run
        self.info = info
        self.trace = run.trace
        self.latency_of = getattr(run, "latency_of", None)
        self.units = run.units
        self.rows_per_unit = run.streams * run.k
        self.window_s = run.window_s
        self.latency_ms = run.latency_ms
        self.enqueue_ms = run.enqueue_ms
        self.untraced = getattr(run, "untraced", None)   # (units, seconds) before the stretch

    def setup_s(self) -> float:
        return setup_seconds(self.run)

    def work(self, layer: str) -> tuple[float, float]:
        """(bytes, f32 operations) of one unit's work in `layer`."""
        return _work(layer).work(self.run)


# the published peaks of one H100 SXM at 700 W (NVIDIA's data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12


def least_seconds(nbytes: float, flops: float) -> tuple[float, str]:
    """The roofline's least time, and which bound binds."""
    tb, tf = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_PER_S
    return (tb, "bytes") if tb >= tf else (tf, "f32 operations")


def tail(values: np.ndarray, q: float = 95.0) -> float:
    return float(np.percentile(values, q)) if values.size else math.nan
