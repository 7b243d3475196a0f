"""Golden-model STFT on `torch.fft`: the numerical contract of the reference.

The PyTorch counterpart of `spectrogram_tpu/ops/stft.py`.  It reproduces
`FastFourierTransform::process` (reference src/fourier/fft.rs:43-99):

  1. take one window of `window_size` stereo samples
  2. pack stereo as complex: z[i] = l[i] + i * r[i]           (fft.rs:57)
  3. periodic Hann window, denominator = window_size          (fft.rs:60-63)
  4. zero-pad to `pad_factor * window_size`                   (fft.rs:65)
  5. complex FFT in complex64                                 (fft.rs:77)
  6. stereo unpack via conjugate symmetry, bins k=1..W-1:
       L_k = |X_k + conj(X_{N-k})| / 2
       R_k = |X_k - conj(X_{N-k})| / 2                        (fft.rs:81-89)
  7. scale by 2 / window_size                                 (fft.rs:92)

and the strided framing of `AudioStreamTransform::process`
(src/fourier/audio_transform.rs:34-42): peek a full window, emit one row,
advance by `hop` samples.  The hand-written STFT kernel
(`ops/cuda/stft_kernel.py`) is held against this module.

These functions are the JAX package's functional surface (`stft_frame`,
`stft_rows` and their planar forms): there they are `jnp.fft` outside any
Pallas kernel, and here `torch.fft` on the tensor's device.
"""

from __future__ import annotations

import numpy as np
import torch

from spectrogram_tpu_torch.config import SpectrogramConfig


def hann_window_np(window_size: int) -> np.ndarray:
    """Periodic Hann as numpy f32 (the kernels' constant)."""
    i = np.arange(window_size, dtype=np.float32)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * i / window_size))).astype(np.float32)


def hann_window(window_size: int, device=None) -> torch.Tensor:
    """Periodic Hann window: 0.5 * (1 - cos(2*pi*i / window_size)).

    Matches fft.rs:60-63: the denominator is the window size itself
    (periodic / "DFT-even" Hann), not `window_size - 1`.  Built in numpy so
    that every device gets the same bits.
    """
    return torch.from_numpy(hann_window_np(window_size)).to(device)


def num_rows(num_samples: int, cfg: SpectrogramConfig) -> int:
    """Rows produced from `num_samples` buffered samples."""
    w, h = cfg.window_size, cfg.hop_size
    return max((num_samples - w) // h + 1, 0) if num_samples >= w else 0


def frame_signal(pcm: torch.Tensor, cfg: SpectrogramConfig) -> torch.Tensor:
    """[..., T, 2] PCM -> [..., n_rows, window_size, 2] overlapped frames.

    Window i covers samples [i*hop, i*hop + window) — the peek-then-skip
    semantics of audio_transform.rs:34-42.  The result is a strided view.
    """
    n = num_rows(pcm.shape[-2], cfg)
    w, h = cfg.window_size, cfg.hop_size
    if n == 0:
        return pcm.new_zeros(pcm.shape[:-2] + (0, w, pcm.shape[-1]))
    frames = pcm.unfold(-2, w, h)               # [..., n', 2, W]
    return frames[..., :n, :, :].transpose(-1, -2)


def _stft_frame_lr(frame: torch.Tensor, cfg: SpectrogramConfig):
    """[..., window_size, 2] -> (left, right) magnitudes, each [..., num_bins]."""
    w = cfg.window_size
    n = cfg.padded_size
    frame = frame.to(torch.float32)
    hann = hann_window(w, frame.device)
    z = torch.complex(frame[..., 0] * hann, frame[..., 1] * hann)
    x = torch.fft.fft(z, n=n)
    # partner of X_k (k = 1..W-1) is X_{N-k}: X_{N-1}, X_{N-2}, ..., X_{N-W+1}
    a = x[..., 1:w]
    b = torch.flip(x[..., n - w + 1 :], dims=(-1,))
    scale = 2.0 / w
    left = torch.abs(a + torch.conj(b)) * (0.5 * scale)
    right = torch.abs(a - torch.conj(b)) * (0.5 * scale)
    return left, right


def stft_frame(frame: torch.Tensor, cfg: SpectrogramConfig) -> torch.Tensor:
    """One window [..., window_size, 2] -> magnitudes [..., num_bins, 2]
    (left, right on the last axis).

    Bin j corresponds to padded-FFT bin k = j + 1 (fft.rs:81 skips DC).
    """
    left, right = _stft_frame_lr(frame, cfg)
    return torch.stack([left, right], dim=-1)


def stft_frame_planar(frame: torch.Tensor, cfg: SpectrogramConfig) -> torch.Tensor:
    """As `stft_frame`, channels-planar: [..., 2, num_bins]."""
    left, right = _stft_frame_lr(frame, cfg)
    return torch.stack([left, right], dim=-2)


def stft_rows(pcm: torch.Tensor, cfg: SpectrogramConfig) -> torch.Tensor:
    """[..., T, 2] PCM -> [..., n_rows, num_bins, 2] spectrogram rows: the
    golden reference of every STFT path, on `torch.fft` on the PCM's
    device, batched over any leading axes."""
    return stft_frame(frame_signal(pcm, cfg), cfg)


def stft_rows_planar(pcm: torch.Tensor, cfg: SpectrogramConfig) -> torch.Tensor:
    """[..., T, 2] PCM -> [..., n_rows, 2, num_bins] (channels-planar)."""
    return stft_frame_planar(frame_signal(pcm, cfg), cfg)


def carry_size(cfg: SpectrogramConfig) -> int:
    """Samples of history a streaming STFT must retain between pushes."""
    return cfg.window_size - cfg.hop_size if cfg.window_size > cfg.hop_size else 0
