"""The traced stretch by the program's own stages: the `spk.` host ranges
that `spectrogram_tpu_torch.utils.profiling.span` opens while a profiler
records (`spk.push`, `spk.ring`, `spk.feeder.readback`, ...).

  stage_s(evs)        device seconds of the stretch's operations by the
                      innermost `spk.` span on each one's launch chain,
                      "-" where none is open
  span_host_s(evs)    {span: [host seconds inside it, its self seconds]}:
                      self is the span less its child `spk.` spans
  stage_idle_s(gaps)  idle seconds of a `TraceRecord`'s labelled gaps by
                      the innermost `spk.` span in each label, "-" if none

The events are `trace.events`'s, nested; the operations counted are those
`trace.reduce` gives a layer (from the stretch's first unit on), and a
device-side copy of a host range (`portbench.` or `spk.`) is none.  A
program without spans reads "-" everywhere and no span.
"""

from __future__ import annotations

import collections

from portbench.trace import HOST_LABEL, LABEL_PREFIX, Event

SPAN_PREFIX = "spk."


def innermost(chain: list[str]) -> str:
    """The last `spk.` name of a chain of host span names, "-" if none."""
    return next((n for n in reversed(chain) if n.startswith(SPAN_PREFIX)), "-")


def _chain(e: Event | None) -> list[str]:
    names = []
    while e is not None:
        names.append(e.name)
        e = e.parent
    return names[::-1]


def stage_s(evs: list[Event]) -> dict:
    cpu = [e for e in evs if not e.device]
    by_id = {e.id: e for e in cpu}
    t0 = min(e.start for e in cpu if e.name == HOST_LABEL)
    out = collections.defaultdict(float)
    for e in evs:
        if (not e.device or e.name.startswith((LABEL_PREFIX, SPAN_PREFIX))
                or e.start < t0 or e.end <= e.start):
            continue
        out[innermost(_chain(by_id.get(e.link) if e.link else None))] += (e.end - e.start) * 1e-6
    return dict(out)


def span_host_s(evs: list[Event]) -> dict:
    spans = [e for e in evs if not e.device and e.name.startswith(SPAN_PREFIX)]
    child_s = collections.defaultdict(float)
    for e in spans:
        parent = e.parent
        while parent is not None and not parent.name.startswith(SPAN_PREFIX):
            parent = parent.parent
        if parent is not None:
            child_s[id(parent)] += e.end - e.start
    out = {}
    for e in spans:
        total, own = out.get(e.name, (0.0, 0.0))
        d = e.end - e.start
        out[e.name] = [total + d * 1e-6, own + (d - child_s[id(e)]) * 1e-6]
    return out


def stage_idle_s(gaps: list) -> dict:
    out = collections.defaultdict(float)
    for label, seconds in gaps:
        out[innermost(label.split("/"))] += seconds
    return dict(out)
