"""Image output helpers: row arrays -> conventional spectrogram images."""

from __future__ import annotations

import numpy as np


def rows_to_image(rows_rgb: np.ndarray) -> np.ndarray:
    """[n_rows(time), H(freq), 3|4] -> [H, n_rows, C] with low frequencies at
    the bottom (the display orientation of both reference widgets)."""
    return np.asarray(rows_rgb).transpose(1, 0, 2)[::-1]


def save_png(path, rows_rgb: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(rows_to_image(rows_rgb)).save(path)
