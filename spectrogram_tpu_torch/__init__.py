"""spectrogram-tpu on PyTorch and CUDA: the streaming spectrogram pipeline.

A port of `spectrogram_tpu` (JAX/Pallas on TPU) to PyTorch, with its TPU
kernels rewritten by hand in CUDA C++ for Hopper (`csrc/`).  Stereo PCM from
many concurrent streams goes in; log-frequency, colormapped RGBA rows come
out.  This package imports torch and numpy only; the JAX package stays the
reference it is tested against.

The exports are the JAX package's (its `__all__`), on torch tensors: the
stateless functional surface (`stft_rows`, `colormap_rows`, ...) follows
its tensors' device; `SpectrogramPipeline`, `StreamGroupManager` and
`LiveSession` run on the card unless given `device="cpu"`.  The serving
loop's host side is ported: int16 ingest rings (`io.ring`), the async
device feeder (`DeviceFeeder`, `ChunkPool`), multi-rate geometry groups
(`StreamGroupManager`, `models.multirate`) and npz checkpoints that cross
between the two packages (`utils.checkpoint`); so is the live display
path: `LiveSession` (`session`), the oscilloscope, the spectrum analyzer,
the golden renderer (`models`), the terminal viewer (`utils`) and the CLI
(`python -m spectrogram_tpu_torch.app`).  As in the JAX package, the
serving and session classes are lazy exports.  The stream mesh and
multi-process serving (`parallel/`: the batch split over ranks of a
torch.distributed process group, sharded checkpoints in
`utils.checkpoint`) are ported too, and so is the autotuner
(`utils.autotune`): `SpectrogramPipeline(autotune=True)` on the card
measures the kernels' launch shapes (the STFT rows' launch bounds, the
colormap tile's form) and launches the fastest, cached per card, geometry,
deployment and kernel sources; its cache is its own, apart from the JAX
package's (whose keys name a TPU kind and FFT plans).
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


def __getattr__(name):
    # Lazy exports, as in the JAX package: importing the package does not
    # load the serving loop's modules.
    if name == "DeviceFeeder":
        from spectrogram_tpu_torch.io.feeder import DeviceFeeder

        return DeviceFeeder
    if name == "ChunkPool":
        from spectrogram_tpu_torch.io.feeder import ChunkPool

        return ChunkPool
    if name == "LiveSession":
        from spectrogram_tpu_torch.session import LiveSession

        return LiveSession
    if name == "StreamGroupManager":
        from spectrogram_tpu_torch.models.multirate import StreamGroupManager

        return StreamGroupManager
    raise AttributeError(name)


__version__ = "0.1.0"

# the JAX package's `__all__`, name for name; `StreamState` and
# `unpack_rgba` are importable from here as well
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
    "LiveSession",
    "StreamGroupManager",
    "DeviceFeeder",
    "ChunkPool",
    "FactoredScheme",
    "__version__",
]
