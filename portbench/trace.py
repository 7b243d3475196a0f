"""The traced stretch of a run: `torch.profiler` over a few steady pushes or
ticks, reduced to what the per-layer metrics read.

Every device operation (kernel, copy, set) of the stretch is attributed to
a bucket by the rule files `layers/<bucket>/*.json`.  A rule names a
regular expression on the operation's short name (`kernel`), one on the
ATen operation the program called to launch it (`op`: the outermost
`aten::` span on the launch's chain of host spans, as "aten::stack" for
the concatenation a stack launches), or both; each must match the whole
name.  A rule with only `op` takes kernels, never a copy or a set.  The
rules that name a kernel come first, those that also name an op before
those that do not; the rules that name only an op come last.  An
operation that no rule takes is listed as unattributed, never dropped,
and each bucket's operations are listed by kernel and op.

The traced window runs from the first device operation after the host's
hand-over of the stretch's first unit to the end of the last one; busy
time is the union of the device operations' intervals in it (overlapping
kernels and copies count once), and the idle gaps are what is left, each
named by what the host was doing at its start: the innermost host span
open there.  A gap that the profiler's own buffer requests cause ("Activity
Buffer Request") is taken out of the window and reported apart: untraced
runs do not have it.  A layer's time is the sum of its operations that
start inside the window.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import pathlib
import re

LAYERS_DIR = pathlib.Path(__file__).resolve().parent / "layers"
LABEL_PREFIX = "portbench."
HOST_LABEL = LABEL_PREFIX + "unit"
PROFILER_STALL = "Activity Buffer Request"


def profiler(on_card: bool):
    """A profiler of the host's spans and, on the card, the device's
    operations."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU]
                   + ([ProfilerActivity.CUDA] if on_card else []))


def warm_profiler(run, unit_once) -> None:
    """Profile one unit at set-up, so that the profiler's own start-up
    (CUPTI) is not paid inside the window."""
    import torch

    prof = profiler(run.on_card)
    prof.start()
    unit_once()
    if run.on_card:
        torch.cuda.synchronize()
    prof.stop()


def short_name(name: str) -> str:
    """A kernel's name without return type, namespaces and template
    arguments (the port's `profile_push._short`)."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("<")[0].split("(")[0].split("::")[-1][:60].strip()


COPY_PREFIXES = ("Memcpy", "Memset")


@dataclasses.dataclass(frozen=True)
class Rule:
    bucket: str
    source: str
    kernel: re.Pattern | None
    op: re.Pattern | None

    def takes(self, name: str, op: str) -> bool:
        if self.kernel is None:
            if name.startswith(COPY_PREFIXES):
                return False
        elif not self.kernel.fullmatch(name):
            return False
        return self.op is None or bool(self.op.fullmatch(op))


def rules(layers_dir: pathlib.Path = LAYERS_DIR) -> list[Rule]:
    """Every rule file, in the order they are tried: those that name a
    kernel and an op, a kernel alone, an op alone."""
    out = []
    for path in sorted(layers_dir.glob("*/*.json")):
        spec = json.loads(path.read_text())
        if "kernel" not in spec and "op" not in spec:
            raise ValueError(f"{path}: a rule names a kernel, an op or both")
        out.append(Rule(path.parent.name, f"{path.parent.name}/{path.name}",
                        re.compile(spec["kernel"]) if "kernel" in spec else None,
                        re.compile(spec["op"]) if "op" in spec else None))
    return sorted(out, key=lambda r: (r.kernel is None, r.op is None))


def launching_op(op_path: str) -> str:
    """The ATen operation the program called to launch a device operation:
    the outermost `aten::` span of its chain of host spans, "" if none (a
    kernel the port's library launches itself)."""
    return next((n for n in op_path.split("/") if n.startswith("aten::")), "")


def attribute(name: str, op: str, table: list[Rule]) -> str | None:
    for rule in table:
        if rule.takes(name, op):
            return rule.bucket
    return None


@dataclasses.dataclass
class TraceRecord:
    units: int                       # pushes or ticks in the stretch
    window_s: float
    busy_s: float
    bucket_s: dict                   # bucket -> device seconds of its operations
    op_s: dict                       # short name -> device seconds
    unattributed: dict               # "name @ op path" -> [count, seconds]
    bucket_ops: dict                 # bucket -> {"name @ op": seconds}
    gaps: list                       # [(host label, seconds)], longest first
    profiler_stall_s: float = 0.0    # gaps the profiler's own buffers caused

    def per_unit_ms(self, bucket: str) -> float:
        """A bucket's device ms per unit: 0.0 where the stretch ran none of
        its operations (a layer a program change took off the path)."""
        return self.bucket_s.get(bucket, 0.0) * 1e3 / self.units

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.op_s.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in self.gaps[:top]]}


@dataclasses.dataclass
class Event:
    """One profiled event: a host span (`device` False) or a device
    operation, times in microseconds on the profiler's common clock."""

    name: str
    device: bool
    start: float
    end: float
    id: int = 0              # a host span's correlation id
    link: int = 0            # a device operation's launching span's id
    thread: int = 0
    parent: "Event | None" = None


def events(prof) -> list[Event]:
    """A stopped `torch.profiler.profile`'s raw events, with every host span
    nested in the one that encloses it on its thread."""
    from torch.autograd import DeviceType

    out = []
    for k in prof.profiler.kineto_results.events():
        if k.is_async():
            continue
        start = k.start_ns()
        end = k.end_ns() if hasattr(k, "end_ns") else start + k.duration_ns()
        out.append(Event(k.name(), k.device_type() != DeviceType.CPU, start * 1e-3, end * 1e-3,
                         k.correlation_id(), k.linked_correlation_id(), k.start_thread_id()))
    nest([e for e in out if not e.device])
    return out


def nest(spans: list[Event]) -> None:
    """Set each host span's parent: the innermost span on its thread that
    encloses it."""
    open_ = {}
    for e in sorted(spans, key=lambda e: (e.start, -e.end)):
        stack = open_.setdefault(e.thread, [])
        while stack and stack[-1].end <= e.start:
            stack.pop()
        e.parent = stack[-1] if stack else None
        stack.append(e)


def _op_path(e: Event) -> str:
    names = []
    while e is not None:
        names.append(e.name)
        e = e.parent
    return "/".join(reversed(names))


def reduce(evs: list[Event], units: int, table: list[Rule] | None = None) -> TraceRecord:
    """A stretch's events -> TraceRecord.  The stretch's units each ran
    under a host span named `HOST_LABEL`."""
    table = rules() if table is None else table
    cpu = [e for e in evs if not e.device]
    # the device side of a host annotation (the profiler mirrors each
    # record_function range onto the device timeline) is no operation
    dev = [e for e in evs if e.device and not e.name.startswith(LABEL_PREFIX)]
    by_id = {e.id: e for e in cpu}
    unit_starts = [e.start for e in cpu if e.name == HOST_LABEL]
    if not unit_starts or not dev:
        raise RuntimeError(
            f"the trace holds {len(unit_starts)} traced units and {len(dev)} "
            "device operations: the profiler saw no device activity")
    t0 = min(unit_starts)
    intervals = []
    bucket_s = collections.defaultdict(float)
    op_s = collections.defaultdict(float)
    unattributed = {}
    bucket_ops = {}
    for e in dev:
        start, end = e.start, e.end
        if end <= t0 or end <= start:
            continue
        intervals.append((max(start, t0), end))
        if start < t0:
            continue             # a unit before the stretch: busy, not its work
        name = short_name(e.name)
        seconds = (end - start) * 1e-6
        op_s[name] += seconds
        parent = by_id.get(e.link) if e.link else None
        path = _op_path(parent) if parent is not None else ""
        op = launching_op(path)
        bucket = attribute(name, op, table)
        if bucket is None:
            key = f"{name} @ {path.split('/', 1)[-1] if path else '-'}"
            n, s = unattributed.get(key, (0, 0.0))
            unattributed[key] = (n + 1, s + seconds)
        else:
            bucket_s[bucket] += seconds
            key = f"{name} @ {op or '-'}"
            ops = bucket_ops.setdefault(bucket, {})
            ops[key] = ops.get(key, 0.0) + seconds
    intervals.sort()
    t1 = max(end for _, end in intervals)
    busy = 0.0
    gaps = []
    cursor = intervals[0][0]     # the profiler's start-up before it is no gap
    for start, end in intervals:
        if start > cursor:
            gaps.append((cursor, start))
        if end > cursor:
            busy += end - max(start, cursor)
            cursor = end
    labelled = _label_gaps(gaps, cpu)
    stalls = sum(s for label, s in labelled if PROFILER_STALL in label)
    return TraceRecord(
        units=units, window_s=(t1 - intervals[0][0]) * 1e-6 - stalls, busy_s=busy * 1e-6,
        bucket_s=dict(bucket_s), op_s=dict(op_s), unattributed=unattributed,
        bucket_ops=bucket_ops,
        gaps=[g for g in labelled if PROFILER_STALL not in g[0]], profiler_stall_s=stalls)


def _label_gaps(gaps, cpu) -> list:
    """The gaps, longest first, each with the innermost host span open at
    its start (its chain of names)."""
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])
    spans = sorted(cpu, key=lambda e: (e.start, -e.end))
    starts = [e.start for e in spans]
    out = []
    for g0, g1 in gaps:
        i = bisect.bisect_right(starts, g0)
        label = "host outside the traced spans"
        for j in range(i - 1, max(i - 4000, -1), -1):
            if spans[j].end > g0:
                label = _op_path(spans[j])
                break
        out.append((label[-120:], (g1 - g0) * 1e-6))
    return out
