"""The 19 built-in palettes of spectrogram-rs (src/colorscheme.rs:125-151)
as full [R, R, 4] lookup tables, written out again for the reference.

Axis 0 of a table is the magnitude coordinate, axis 1 the pan coordinate
stored reversed; rgb channels are the gradient's u8 colour divided by 256
(the reference's quirk), alpha is 1 for a mono palette and the magnitude
coordinate for a stereo one (colorscheme.rs:73-91).  Palette id p is the
p-th entry of `SCHEMES`, the order the program's registry uses.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.gradients import GRADIENTS, eval_u8

# (name, gradient, stereo): colorscheme.rs:125-151 in order
SCHEMES = (
    ("Blue-Yellow-Red (Stereo)", "RED_YELLOW_BLUE", True),
    ("Magma", "MAGMA", False),
    ("Viridis", "VIRIDIS", False),
    ("Blue-Red (Stereo)", "RED_BLUE", True),
    ("Spectral (Stereo)", "SPECTRAL", True),
    ("Green-Yellow-Red (Stereo)", "RED_YELLOW_GREEN", True),
    ("Green-Pink (Stereo)", "PINK_GREEN", True),
    ("Orange-Purple (Stereo)", "PURPLE_ORANGE", True),
    ("Inferno", "INFERNO", False),
    ("Plasma", "PLASMA", False),
    ("Cividis", "CIVIDIS", False),
    ("Cube-helix", "CUBEHELIX", False),
    ("Turbo", "TURBO", False),
    ("Cool", "COOL", False),
    ("Reds", "REDS", False),
    ("Blues", "BLUES", False),
    ("Greens", "GREENS", False),
    ("Greys", "GREYS", False),
    ("Oranges", "ORANGES", False),
)


def lookup_table(gradient: str, stereo: bool, resolution: int) -> np.ndarray:
    """One palette's [R, R, 4] f32 table."""
    i = np.arange(resolution, dtype=np.float64) / (resolution - 1)
    table = np.zeros((resolution, resolution, 4), dtype=np.float32)
    if stereo:
        rgb = eval_u8(GRADIENTS[gradient], 1.0 - i).astype(np.float32) / 256.0
        table[:, :, :3] = rgb[None, :, :]
        table[:, :, 3] = i.astype(np.float32)[:, None]
    else:
        rgb = eval_u8(GRADIENTS[gradient], i).astype(np.float32) / 256.0
        table[:, :, :3] = rgb[:, None, :]
        table[:, :, 3] = 1.0
    return table


def lookup_tables(resolution: int) -> np.ndarray:
    """[P, R, R, 4] f32: every built-in palette's table, by palette id."""
    return np.stack([lookup_table(g, st, resolution) for _, g, st in SCHEMES])
