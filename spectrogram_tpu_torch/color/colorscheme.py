"""Color schemes: the palette registry the colormap kernel reads.

A numpy-only copy of the part of `spectrogram_tpu/color/colorscheme.py` that
the streaming push needs (the JAX package's module cannot be imported without
JAX): `ColorScheme` with its rank-1 LUT factors, the 19 named palettes of the
reference (colorscheme.rs:125-151), and the stacked tables built from them.
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
