"""Invertible log-frequency coordinate + axis ticks.

Closed-form port of the reference's plotters-based log coordinate
(src/log_scaling.rs): `LogCoordf64` maps value -> pixel through a linear map
of ln(value) (:43-51), `unmap` inverts it (:114-119), and `key_points`
generates bold (decade) and light (subdivision) tick values (:53-107).  The
reference needed a patched plotting library for the invertible mapping; here
it is ten lines of math, plus the tick generator for host-side axis drawing.

Used by: the golden model's pixel band edges (models/golden.py), the shader
warp's resample positions (ops/colormap.py), and any host UI that wants
labeled axes.

A copy of `spectrogram_tpu/ops/log_scale.py` (the port cannot import the JAX
package), pinned against it by `tests/test_torch_tables.py`.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class LogScale:
    """Invertible log mapping from [min_value, max_value] onto [0, extent)."""

    min_value: float
    max_value: float
    extent: int           # pixels
    base: float = 10.0    # tick base (the golden path uses 2, :107)

    def position_of(self, value: float) -> float:
        """value -> fractional pixel position (plotters `map`)."""
        lo, hi = math.log(self.min_value), math.log(self.max_value)
        return (math.log(value) - lo) / (hi - lo) * self.extent

    def value_of(self, position: float) -> float:
        """pixel -> value (plotters `unmap`, log_scaling.rs:114-119)."""
        lo, hi = math.log(self.min_value), math.log(self.max_value)
        return math.exp(lo + (position / self.extent) * (hi - lo))

    def key_points(self, max_points: int = 12) -> list[float]:
        """Tick values: powers of `base` within range, with evenly-multiplied
        light subdivisions when the budget allows (log_scaling.rs:53-107).

        Includes the reference's tick-budget escalation: when `max_points`
        cannot fit every power of base, decades are SKIPPED by stepping
        `multiplier = base**cnt` with the smallest cnt satisfying
        bold_count // cnt <= max_points (the `multiplier`/`cnt` loop,
        log_scaling.rs:78-83), and the light-subdivision spacing scales with
        the escalated multiplier (:94-95).  Guarantees len(ticks) <=
        max_points + 1 in the escalation regime (the reference's own bound:
        the loop exits on integer division, so the boundary decade can add
        one extra)."""
        start, end = self.min_value, self.max_value
        base_ln = math.log(self.base)
        bold_count = max(int(abs(math.log(end / start)) / base_ln), 1)
        if max_points < bold_count:
            light_density = 0
        else:
            density = 1 + (max_points - bold_count) // bold_count
            exp = 1
            while exp * 10 <= density:
                exp *= 10
            light_density = exp - 1

        # Escalation: step several decades at a time when the budget is
        # smaller than the decade count (log_scaling.rs:78-83).
        multiplier = self.base
        cnt = 1
        while max_points < bold_count // cnt:
            multiplier *= self.base
            cnt += 1

        ticks: list[float] = []
        val = self.base ** math.ceil(math.log(start) / base_ln)
        while val <= end:
            ticks.append(val)
            for i in range(1, light_density + 1):
                v = val * (1.0 + multiplier / (light_density + 1) * i)
                if v > end:
                    break
                # the last subdivision can land exactly on the next bold tick
                # (val*(1 + mult*ld/(ld+1)) == val*mult when ld+1 | mult*ld);
                # skip duplicates rather than double-labeling a pixel
                # (deviation from the reference, which double-emits: D-ticks
                # in DESIGN.md)
                if v < val * multiplier:
                    ticks.append(v)
            val *= multiplier
        return ticks

    def labeled_ticks(self, max_points: int = 12) -> list[tuple[float, str]]:
        """(pixel position, label) pairs for axis rendering."""
        out = []
        for v in self.key_points(max_points):
            label = f"{v/1000:g}k" if v >= 1000 else f"{v:g}"
            out.append((self.position_of(v), label))
        return out


def display_scale(cfg, height: int | None = None) -> LogScale:
    """The display frequency axis of both reference visualizers
    (32..22030 Hz over the pixel extent; simple_spectrogram.rs:107)."""
    return LogScale(
        min_value=cfg.min_frequency,
        max_value=cfg.max_frequency,
        extent=height or cfg.viewport_height,
        base=2.0,
    )
