"""Color schemes: the palette registry the colormap kernel reads.

A numpy-only copy of the part of `spectrogram_tpu/color/colorscheme.py` that
the pipeline, the functional surface and the visualizers need (the JAX
package's module cannot be imported without JAX): `ColorScheme` with its
scalar CPU-path law (`color_for`, `foreground_color`), its LUT and rank-1 LUT
factors, `FactoredScheme` (a palette given as its factors), the 19 named
palettes of the reference (colorscheme.rs:125-151), and the stacked tables
built from them.
The reference quirks are reproduced exactly: channels are divided by **256**
(not 255), and the pan axis is stored reversed (`pan = 1 - j/(res-1)`).
`tests/test_torch_tables.py` pins every table against the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from spectrogram_tpu_torch.color.gradients import GRADIENTS, GradientFn, eval_u8

MIN_DB = -70.0  # colorscheme.rs:16
MAX_DB = -10.0  # colorscheme.rs:17


@dataclasses.dataclass(frozen=True)
class ColorScheme:
    """A named palette: mono (color = gradient(magnitude)) or stereo
    (color = gradient(pan), alpha = magnitude; explicit background).

    Either name a registered gradient, or pass any vectorized `gradient_fn`
    (t in [0,1] -> float rgb in [0,1]) with gradient_name="".
    """

    name: str
    gradient_name: str
    background: Optional[tuple[int, int, int]] = None  # stereo schemes only
    gradient_fn: Optional[GradientFn] = None           # overrides gradient_name

    @property
    def gradient(self) -> GradientFn:
        if self.gradient_fn is not None:
            return self.gradient_fn
        return GRADIENTS[self.gradient_name]

    @property
    def is_stereo(self) -> bool:
        return self.background is not None

    def background_color(self) -> tuple[int, int, int]:
        """colorscheme.rs:41-44: stereo -> explicit background, mono ->
        gradient at 0."""
        if self.background is not None:
            return self.background
        return tuple(int(c) for c in eval_u8(self.gradient, 0.0))

    def foreground_color(self) -> tuple[int, int, int]:
        """colorscheme.rs:46-53."""
        t = 0.5 if self.is_stereo else 1.0
        return tuple(int(c) for c in eval_u8(self.gradient, t))

    def color_for(self, left: float, right: float) -> tuple[np.ndarray, float]:
        """(l, r) magnitude -> (u8 rgb, alpha). colorscheme.rs:55-71.

        Stereo: color from pan = l / (|l| + |r|), alpha = normalized dB.
        Mono:   color from normalized dB, alpha = 1.
        Note this CPU-path pan differs from the GPU shader's r/(l+r)
        (gpu_spectrogram.rs:182) — the framework treats the shader as the
        canonical production law and keeps this one for golden-model parity.
        """
        power = left * left + right * right
        db = 10.0 * np.log10(power + 1e-7)
        bounded = (db - MIN_DB) / (MAX_DB - MIN_DB)
        if self.is_stereo:
            l1 = abs(left) + abs(right)
            pan = left / l1 if l1 != 0.0 else np.nan  # ref divides unguarded
            return eval_u8(self.gradient, pan), float(bounded)
        return eval_u8(self.gradient, bounded), 1.0

    def lookup_table(self, resolution: int = 32) -> np.ndarray:
        """[res, res, 4] f32 LUT; axis 0 = magnitude, axis 1 = pan
        (reversed): rgb divided by 256, stereo alpha = the magnitude
        coordinate (colorscheme.rs:73-91)."""
        i = np.arange(resolution, dtype=np.float64) / (resolution - 1)
        table = np.zeros((resolution, resolution, 4), dtype=np.float32)
        if self.is_stereo:
            rgb = eval_u8(self.gradient, 1.0 - i).astype(np.float32) / 256.0
            table[:, :, :3] = rgb[None, :, :]
            table[:, :, 3] = i.astype(np.float32)[:, None]
        else:
            rgb = eval_u8(self.gradient, i).astype(np.float32) / 256.0
            table[:, :, :3] = rgb[:, None, :]
            table[:, :, 3] = 1.0
        return table

    def factored_tables(self, resolution: int = 32) -> tuple[np.ndarray, np.ndarray]:
        """Rank-1 factorization of the LUT: (U[res,4], V[res,4]) with
        LUT[i, j, c] == U[i, c] * V[j, c] exactly.

        Mono LUTs vary only along the magnitude axis (colorscheme.rs:88-89:
        rgb=f(mag), alpha=1) and stereo LUTs have rgb=f(pan), alpha=mag-ramp
        (:83-87).
        """
        i = np.arange(resolution, dtype=np.float64) / (resolution - 1)
        u = np.ones((resolution, 4), dtype=np.float32)
        v = np.ones((resolution, 4), dtype=np.float32)
        if self.is_stereo:
            u[:, 3] = i.astype(np.float32)                      # alpha = mag ramp
            pan = 1.0 - i                                       # reversed pan axis
            v[:, :3] = eval_u8(self.gradient, pan).astype(np.float32) / 256.0
        else:
            u[:, :3] = eval_u8(self.gradient, i).astype(np.float32) / 256.0
        return u, v


@dataclasses.dataclass(frozen=True)
class FactoredScheme:
    """A palette given directly as rank-1 LUT factors U[res, 4], V[res, 4]
    with LUT[i, j, c] = U[i, c] * V[j, c] (i = magnitude axis, j = pan axis,
    reversed like the reference's table, colorscheme.rs:81).

    Any separable 2D response (e.g. hue from pan and brightness from
    magnitude) expressed exactly.  Schemes that happen to match the built-in
    mono/stereo shape are detected and take the built-in colormap; a
    registry holding any other scheme takes the generic two-table colormap.
    """

    name: str
    u: tuple          # nested tuple [res][4] (hashable; np arrays accepted in ctor)
    v: tuple
    background: tuple[int, int, int] = (0, 0, 0)

    def __init__(self, name, u, v, background=(0, 0, 0)):
        u = np.asarray(u, dtype=np.float32)
        v = np.asarray(v, dtype=np.float32)
        if u.ndim != 2 or u.shape[1] != 4 or u.shape != v.shape:
            raise ValueError(
                f"factored tables must be [res, 4] and same-shape; got "
                f"{u.shape} and {v.shape}"
            )
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "u", tuple(map(tuple, u.tolist())))
        object.__setattr__(self, "v", tuple(map(tuple, v.tolist())))
        object.__setattr__(self, "background", tuple(background))

    @property
    def is_stereo(self) -> bool:
        # pan-sensitive iff V varies along the pan axis
        v = np.asarray(self.v, dtype=np.float32)
        return bool(np.any(v != v[0]))

    def background_color(self) -> tuple[int, int, int]:
        return self.background

    def factored_tables(self, resolution: int = 32) -> tuple[np.ndarray, np.ndarray]:
        u = np.asarray(self.u, dtype=np.float32)
        if u.shape[0] != resolution:
            raise ValueError(
                f"{self.name}: tables have res {u.shape[0]}, pipeline wants "
                f"{resolution}"
            )
        return u, np.asarray(self.v, dtype=np.float32)

    def lookup_table(self, resolution: int = 32) -> np.ndarray:
        u, v = self.factored_tables(resolution)
        return (u[:, None, :] * v[None, :, :]).astype(np.float32)


_BLACK = (0, 0, 0)

# Order matches default_color_schemes() (colorscheme.rs:125-151); index is the
# per-stream palette id.
DEFAULT_COLOR_SCHEMES: tuple[ColorScheme, ...] = (
    ColorScheme("Blue-Yellow-Red (Stereo)", "RED_YELLOW_BLUE", _BLACK),
    ColorScheme("Magma", "MAGMA"),
    ColorScheme("Viridis", "VIRIDIS"),
    ColorScheme("Blue-Red (Stereo)", "RED_BLUE", _BLACK),
    ColorScheme("Spectral (Stereo)", "SPECTRAL", _BLACK),
    ColorScheme("Green-Yellow-Red (Stereo)", "RED_YELLOW_GREEN", _BLACK),
    ColorScheme("Green-Pink (Stereo)", "PINK_GREEN", _BLACK),
    ColorScheme("Orange-Purple (Stereo)", "PURPLE_ORANGE", _BLACK),
    ColorScheme("Inferno", "INFERNO"),
    ColorScheme("Plasma", "PLASMA"),
    ColorScheme("Cividis", "CIVIDIS"),
    ColorScheme("Cube-helix", "CUBEHELIX"),
    ColorScheme("Turbo", "TURBO"),
    ColorScheme("Cool", "COOL"),
    ColorScheme("Reds", "REDS"),
    ColorScheme("Blues", "BLUES"),
    ColorScheme("Greens", "GREENS"),
    ColorScheme("Greys", "GREYS"),
    ColorScheme("Oranges", "ORANGES"),
)

_NAME_TO_INDEX = {s.name: i for i, s in enumerate(DEFAULT_COLOR_SCHEMES)}


def scheme_index(name: str) -> int:
    return _NAME_TO_INDEX[name]


def scheme_by_name(name: str) -> ColorScheme:
    return DEFAULT_COLOR_SCHEMES[_NAME_TO_INDEX[name]]


def stacked_lookup_tables(resolution: int = 32, schemes=None) -> np.ndarray:
    """The palettes as one [P, res, res, 4] f32 array."""
    schemes = DEFAULT_COLOR_SCHEMES if schemes is None else schemes
    return np.stack([s.lookup_table(resolution) for s in schemes], axis=0)


def stacked_factored_tables(
    resolution: int = 32, schemes=None
) -> tuple[np.ndarray, np.ndarray]:
    """The palettes' rank-1 factors: (U[P,res,4], V[P,res,4])."""
    schemes = DEFAULT_COLOR_SCHEMES if schemes is None else schemes
    us, vs = zip(*(s.factored_tables(resolution) for s in schemes))
    return np.stack(us), np.stack(vs)


def stacked_backgrounds(schemes=None) -> np.ndarray:
    """[P, 3] u8 background colors (frame clear color, gpu_spectrogram.rs:293)."""
    schemes = DEFAULT_COLOR_SCHEMES if schemes is None else schemes
    return np.stack(
        [np.array(s.background_color(), dtype=np.uint8) for s in schemes]
    )
