"""spectrogram-tpu on PyTorch and CUDA: the streaming spectrogram pipeline.

A port of `spectrogram_tpu` (JAX/Pallas on TPU) to PyTorch, with its TPU
kernels rewritten by hand in CUDA C++ for Hopper (`csrc/`).  Stereo PCM from
many concurrent streams goes in; log-frequency, colormapped RGBA rows come
out.  This package imports torch and numpy only; the JAX package stays the
reference it is tested against.
"""

from spectrogram_tpu_torch.config import BENCH_CONFIG, DEFAULT_CONFIG, SpectrogramConfig
from spectrogram_tpu_torch.color.colorscheme import (
    DEFAULT_COLOR_SCHEMES,
    ColorScheme,
    FactoredScheme,
    scheme_by_name,
    scheme_index,
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
    "FactoredScheme",
    "scheme_by_name",
    "scheme_index",
    "SpectrogramPipeline",
    "StreamState",
    "unpack_rgba",
    "__version__",
]
