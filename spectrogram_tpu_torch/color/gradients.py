"""Continuous color gradients equivalent to the `colorous` crate's.

The reference picks palettes from colorous (reference src/colorscheme.rs:12,
:125-151).  colorous mirrors d3-scale-chromatic, so we reimplement the three
evaluation modes d3 uses:

* 256-entry listed tables with linear interpolation (viridis family, turbo)
* uniform cubic B-spline through ColorBrewer control colors
  (`interpolateRgbBasis`; diverging + single-hue sequential schemes)
* closed-form cubehelix interpolation in cubehelix space
  (`interpolateCubehelixLong`; CUBEHELIX default and COOL)

All evaluators are vectorized numpy: t (any shape, clipped to [0,1]) ->
float rgb in [0,1].  `eval_u8` rounds to u8 like colorous's `Color`.

A copy of `spectrogram_tpu/color/gradients.py` (numpy only), so that the
PyTorch port never imports the JAX package.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np

from spectrogram_tpu_torch.color._data import CONTROL, LISTED

GradientFn = Callable[[np.ndarray], np.ndarray]


def _listed_gradient(table) -> GradientFn:
    tab = np.asarray(table, dtype=np.float64) / 255.0  # [n, 3]
    n = tab.shape[0]

    def eval_(t: np.ndarray) -> np.ndarray:
        t = np.clip(np.asarray(t, dtype=np.float64), 0.0, 1.0)
        x = t * (n - 1)
        i0 = np.floor(x).astype(np.int64)
        i1 = np.minimum(i0 + 1, n - 1)
        frac = (x - i0)[..., None]
        return tab[i0] * (1.0 - frac) + tab[i1] * frac

    return eval_


def _basis_spline_gradient(points) -> GradientFn:
    """d3 `interpolateRgbBasis`: uniform cubic B-spline through the control
    colors, with reflected phantom endpoints."""
    v = np.asarray(points, dtype=np.float64)  # [k, 3] in 0..255
    n = v.shape[0] - 1

    def eval_(t: np.ndarray) -> np.ndarray:
        t = np.clip(np.asarray(t, dtype=np.float64), 0.0, 1.0)
        i = np.clip(np.floor(t * n).astype(np.int64), 0, n - 1)
        v1 = v[i]
        v2 = v[i + 1]
        v0 = np.where((i > 0)[..., None], v[np.maximum(i - 1, 0)], 2 * v1 - v2)
        v3 = np.where((i < n - 1)[..., None], v[np.minimum(i + 2, n)], 2 * v2 - v1)
        t1 = (t - i / n) * n
        t1 = t1[..., None]
        t2 = t1 * t1
        t3 = t2 * t1
        out = (
            (1 - 3 * t1 + 3 * t2 - t3) * v0
            + (4 - 6 * t2 + 3 * t3) * v1
            + (1 + 3 * t1 + 3 * t2 - 3 * t3) * v2
            + t3 * v3
        ) / 6.0
        return np.clip(out / 255.0, 0.0, 1.0)

    return eval_


# -- cubehelix (d3-color / d3-interpolate formulas) ---------------------------

_A, _B, _C, _D = -0.14861, +1.78277, -0.29227, -0.90649
_E = +1.97294
_DEG2RAD = math.pi / 180.0


def _cubehelix_to_rgb(h_deg, s, l):
    h = (h_deg + 120.0) * _DEG2RAD
    a = s * l * (1.0 - l)
    cosh, sinh = np.cos(h), np.sin(h)
    r = l + a * (_A * cosh + _B * sinh)
    g = l + a * (_C * cosh + _D * sinh)
    b = l + a * (_E * cosh)
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0)


def _cubehelix_long_gradient(c0, c1) -> GradientFn:
    """`interpolateCubehelixLong` between two (h, s, l) cubehelix colors."""
    h0, s0, l0 = c0
    h1, s1, l1 = c1

    def eval_(t: np.ndarray) -> np.ndarray:
        t = np.clip(np.asarray(t, dtype=np.float64), 0.0, 1.0)
        return _cubehelix_to_rgb(
            h0 + t * (h1 - h0), s0 + t * (s1 - s0), l0 + t * (l1 - l0)
        )

    return eval_


# -- registry -----------------------------------------------------------------

# Names follow the colorous constants used at colorscheme.rs:125-151.
GRADIENTS: dict[str, GradientFn] = {
    "VIRIDIS": _listed_gradient(LISTED["viridis"]),
    "MAGMA": _listed_gradient(LISTED["magma"]),
    "INFERNO": _listed_gradient(LISTED["inferno"]),
    "PLASMA": _listed_gradient(LISTED["plasma"]),
    "CIVIDIS": _listed_gradient(LISTED["cividis"]),
    "TURBO": _listed_gradient(LISTED["turbo"]),
    "RED_YELLOW_BLUE": _basis_spline_gradient(CONTROL["RdYlBu"]),
    "RED_BLUE": _basis_spline_gradient(CONTROL["RdBu"]),
    "SPECTRAL": _basis_spline_gradient(CONTROL["Spectral"]),
    "RED_YELLOW_GREEN": _basis_spline_gradient(CONTROL["RdYlGn"]),
    "PINK_GREEN": _basis_spline_gradient(CONTROL["PiYG"]),
    "PURPLE_ORANGE": _basis_spline_gradient(CONTROL["PuOr"]),
    "REDS": _basis_spline_gradient(CONTROL["Reds"]),
    "BLUES": _basis_spline_gradient(CONTROL["Blues"]),
    "GREENS": _basis_spline_gradient(CONTROL["Greens"]),
    "GREYS": _basis_spline_gradient(CONTROL["Greys"]),
    "ORANGES": _basis_spline_gradient(CONTROL["Oranges"]),
    # d3.interpolateCubehelixDefault
    "CUBEHELIX": _cubehelix_long_gradient((300.0, 0.5, 0.0), (-240.0, 0.5, 1.0)),
    # d3.interpolateCool
    "COOL": _cubehelix_long_gradient((260.0, 0.75, 0.35), (80.0, 1.50, 0.8)),
}


def eval_u8(gradient: GradientFn, t) -> np.ndarray:
    """Evaluate to rounded u8 rgb, like colorous `Gradient::eval_continuous`."""
    return np.round(gradient(t) * 255.0).astype(np.uint8)
