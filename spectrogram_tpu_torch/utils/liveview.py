"""Live multi-stream view composition: scrolling buffers + tile grid.

The reference's live surface is one GL widget per visualizer (main.rs:62-151)
— one stream, one window.  The framework's live story is BATCHED: a single
device push advances S streams, and this module turns the streamed RGBA row
batches into per-stream scrolling images on the host, then composes them
into one tiled frame for the terminal viewer (utils/terminal.py).

Design: the device already emits every freshly produced row (push's
streaming product).  Keeping a HOST scroll buffer per stream at display
resolution means the live view costs O(S * k * cell_height) per push —
independent of the device-side viewport size — instead of re-rendering and
downloading S full viewports per frame (16 x 2048 x 1024 RGBA per frame
would out-throughput the chip just to draw thumbnails).

Pure numpy; tested without a TTY in tests/test_visualizers.py.
"""

from __future__ import annotations

import numpy as np


class StreamScroller:
    """Per-stream scrolling images built incrementally from row batches.

    Each pushed row is one time column of `height` frequency pixels (row 0 =
    lowest frequency, as emitted by the pipeline); the scroller downsamples
    to the display cell height, flips so high frequencies render on top, and
    scrolls left like the reference's ring texture (gpu_spectrogram.rs:274).
    """

    def __init__(self, n_streams: int, height: int, width: int):
        self.height = int(height)
        self.width = int(width)
        self.buf = np.zeros((n_streams, self.height, self.width, 3), np.uint8)
        # static frequency-axis pick: display row 0 (top) = highest frequency
        self._ys: np.ndarray | None = None

    def push(self, rgb_rows: np.ndarray) -> None:
        """Append a batch of composited rows: [S, k, H, 3] u8 (H = frequency
        pixels, low frequency first)."""
        s, k, h, _ = rgb_rows.shape
        if s != self.buf.shape[0]:
            raise ValueError(f"{s} streams pushed into {self.buf.shape[0]}-wide scroller")
        if self._ys is None or self._ys_src != h:
            self._ys = np.linspace(0, h - 1, self.height).round().astype(int)[::-1]
            self._ys_src = h
        cols = rgb_rows[:, :, self._ys, :]          # [S, k, height, 3]
        k = min(k, self.width)
        self.buf[:, :, : self.width - k] = self.buf[:, :, k:]
        # newest column on the right; time runs left -> right
        self.buf[:, :, self.width - k :] = np.swapaxes(cols[:, -k:], 1, 2)

    def image(self, stream: int) -> np.ndarray:
        """[height, width, 3] u8 scroll image for one stream."""
        return self.buf[stream]


def tile_grid(
    images: list[np.ndarray],
    out_h: int,
    out_w: int,
    highlight: int | None = None,
    border: tuple[int, int, int] = (40, 40, 40),
    highlight_color: tuple[int, int, int] = (255, 255, 255),
) -> np.ndarray:
    """Compose per-stream images into one [out_h, out_w, 3] grid frame.

    Cells are laid out row-major in a near-square grid; each source image is
    nearest-resampled into its cell.  `highlight` draws a 1-px frame around
    the focused cell (the terminal-viewer analog of window focus).
    """
    from spectrogram_tpu_torch.utils.terminal import downsample

    n = len(images)
    if n == 0:
        raise ValueError("tile_grid needs at least one image")
    cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    cell_h, cell_w = out_h // rows, out_w // cols
    if cell_h < 2 or cell_w < 2:
        raise ValueError(
            f"{n} tiles do not fit a {out_h}x{out_w} frame (cells {cell_h}x{cell_w})"
        )
    frame = np.zeros((out_h, out_w, 3), np.uint8)
    frame[:] = border
    for i, img in enumerate(images):
        r, c = divmod(i, cols)
        y0, x0 = r * cell_h, c * cell_w
        inner = downsample(img, cell_h - 1, cell_w - 1)
        frame[y0 : y0 + cell_h - 1, x0 : x0 + cell_w - 1] = inner
        if i == highlight:
            frame[y0, x0 : x0 + cell_w] = highlight_color
            frame[min(y0 + cell_h - 1, out_h - 1), x0 : x0 + cell_w] = highlight_color
            frame[y0 : y0 + cell_h, x0] = highlight_color
            frame[y0 : y0 + cell_h, min(x0 + cell_w - 1, out_w - 1)] = highlight_color
    return frame
