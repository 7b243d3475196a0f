"""spectrogram-tpu on PyTorch and CUDA: the streaming spectrogram pipeline.

A port of `spectrogram_tpu` (JAX/Pallas on TPU) to PyTorch, with its TPU
kernels rewritten by hand in CUDA C++ for Hopper (`csrc/`).  Stereo PCM from
many concurrent streams goes in; log-frequency, colormapped RGBA rows come
out.  This package imports torch and numpy only; the JAX package stays the
reference it is tested against.

The exports are the JAX package's (its `__all__`), on torch tensors: the
stateless functional surface (`stft_rows`, `colormap_rows`, ...) follows
its tensors' device; `SpectrogramPipeline` runs on the card unless given
`device="cpu"`.  The JAX package's host-side serving and session layers
(`LiveSession`, `StreamGroupManager`, `DeviceFeeder`, `ChunkPool`) are not
ported yet (ROADMAP.md).
"""

from spectrogram_tpu_torch.config import BENCH_CONFIG, DEFAULT_CONFIG, SpectrogramConfig
from spectrogram_tpu_torch.color.colorscheme import (
    DEFAULT_COLOR_SCHEMES,
    ColorScheme,
    FactoredScheme,
    scheme_by_name,
    scheme_index,
    stacked_backgrounds,
    stacked_lookup_tables,
)
from spectrogram_tpu_torch.ops.stft import hann_window, stft_frame, stft_rows
from spectrogram_tpu_torch.ops.colormap import (
    colormap_rows,
    composite_over_background,
    resample_matrix,
    rgba_f32_to_u8,
)
from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline, StreamState
from spectrogram_tpu_torch.ops.cuda.colormap_kernel import unpack_rgba

__version__ = "0.1.0"

__all__ = [
    "BENCH_CONFIG",
    "DEFAULT_CONFIG",
    "SpectrogramConfig",
    "DEFAULT_COLOR_SCHEMES",
    "ColorScheme",
    "scheme_by_name",
    "scheme_index",
    "stacked_backgrounds",
    "stacked_lookup_tables",
    "stft_frame",
    "stft_rows",
    "hann_window",
    "colormap_rows",
    "composite_over_background",
    "resample_matrix",
    "rgba_f32_to_u8",
    "SpectrogramPipeline",
    "FactoredScheme",
    "StreamState",
    "unpack_rgba",
    "__version__",
]
