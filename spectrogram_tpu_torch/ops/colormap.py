"""Log-frequency warp + dB + pan + palette LUT: the colormap stage.

The PyTorch counterpart of `spectrogram_tpu/ops/colormap.py`, which mirrors
the reference's fragment shader (src/widgets/gpu_spectrogram.rs:150-190).
Per output pixel:

  1. warp the pixel row to a frequency: exp(lerp(ln 32, ln 22030, uv.y))
     (gpu_spectrogram.rs:158-162)
  2. bilinearly sample the magnitude row at that frequency (:174)
  3. convert to dB: 10*log10(l^2 + r^2 + 1e-7), normalized to [-70,-10] (:177-179)
  4. compute pan = r / (l + r)                                    (:182)
  5. sample the 32x32 palette LUT at (pan, dB), clamped bilinear  (:185)

Steps 1+2 are a precomputed `[H, B]` resample matrix with two nonzeros per
row; the numpy functions here are copies of the JAX package's (pinned by
`tests/test_torch_tables.py`).  The torch functions are the plain laws that
the hand-written colormap kernels (`ops/cuda/colormap_kernel.py`) are held
against, and the JAX package's functional surface (`colormap_rows`,
`colormap_resampled`, `sample_lut_bilinear`, `composite_over_background`,
`rgba_f32_to_u8`): plain jnp there, plain torch on the tensors' device here.

Output pixel index 0 = lowest frequency (GL uv.y = 0, bottom of screen).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from spectrogram_tpu_torch.config import SpectrogramConfig


def log_bin_positions(
    cfg: SpectrogramConfig,
    height: int | None = None,
    shader_compat: bool = False,
) -> np.ndarray:
    """Fractional bin-axis sample position per output pixel.

    Pixel y shows frequency f = exp(lerp(ln min_f, ln max_f, (y+0.5)/H));
    output bin j holds frequency (j+1) * fs/N (fft.rs:81 skips DC), so the
    sample position is f/(fs/N) - 1.  shader_compat=True reproduces the
    reference fragment shader's stretched axis instead (DESIGN.md D9).
    """
    h = height or cfg.viewport_height
    b = cfg.num_bins
    if shader_compat:
        mapped = np.asarray(cfg.log_frequency_fracs(h, centers=True))
        return mapped * b - 0.5
    freqs = np.asarray(cfg.log_frequency_fracs(h, centers=True)) * cfg.max_frequency
    return freqs / cfg.bin_hz - 1.0


def resample_matrix(
    cfg: SpectrogramConfig,
    height: int | None = None,
    shader_compat: bool = False,
) -> np.ndarray:
    """[H, B] f32 matrix: rgba_rows = M @ bins implements the bilinear
    log-frequency fetch.  Two nonzeros per output row, clamped at the edges
    (the reference's Repeat wrap is a sampler artifact, DESIGN.md D2)."""
    h = height or cfg.viewport_height
    b = cfg.num_bins
    pos = log_bin_positions(cfg, h, shader_compat=shader_compat)
    base = np.floor(pos)
    w = pos - base
    j0 = np.clip(base, 0, b - 1).astype(np.int64)
    j1 = np.clip(base + 1, 0, b - 1).astype(np.int64)
    m = np.zeros((h, b), dtype=np.float32)
    rows = np.arange(h)
    m[rows, j0] += (1.0 - w).astype(np.float32)
    m[rows, j1] += w.astype(np.float32)
    return m


def resample_matrix_full(cfg: SpectrogramConfig, height: int | None = None) -> np.ndarray:
    """[H, num_bins+1] variant over the half-spectrum INCLUDING the DC column
    (index k = padded-FFT bin k; DC never gets weight since
    min_frequency > bin_hz for every supported geometry), so the STFT
    kernel's [N, N/2] output feeds the colormap with no bin-slicing pass."""
    h = height or cfg.viewport_height
    b = cfg.num_bins + 1
    freqs = np.asarray(cfg.log_frequency_fracs(h, centers=True)) * cfg.max_frequency
    pos = freqs / cfg.bin_hz  # index k = bin k exactly
    base = np.floor(pos)
    w = pos - base
    j0 = np.clip(base, 0, b - 1).astype(np.int64)
    j1 = np.clip(base + 1, 0, b - 1).astype(np.int64)
    m = np.zeros((h, b), dtype=np.float32)
    rows = np.arange(h)
    m[rows, j0] += (1.0 - w).astype(np.float32)
    m[rows, j1] += w.astype(np.float32)
    return m


def resample_matrix_planes(cfg: SpectrogramConfig, height: int | None = None) -> np.ndarray:
    """[H, num_bins+1]: `resample_matrix` over bins 1..W-1 with a zero DC
    column in front, so that column k is padded-FFT bin k, the layout of the
    STFT kernels' planes.  It equals `resample_matrix_full` wherever
    min_frequency > bin_hz (every geometry JAX's fused chain was built for);
    below that, where the full matrix would weight the DC bin, it clamps the
    lowest pixels onto bin 1 as the reference and JAX's XLA path do."""
    return np.pad(resample_matrix(cfg, height), ((0, 0), (1, 0)))


def time_resample_matrix(rows: int, width: int) -> np.ndarray:
    """[rows, width] two-tap bilinear time-resample matrix implementing the
    GL texel sampling law: output column j reads continuous coordinate
    x = (j + 0.5) / width * rows, i.e. lerp(texel floor(x-.5), next, frac)
    with clamp-to-edge taps (gpu_spectrogram.rs:166-174 + DESIGN D2).
    Works for both minification and magnification, like the GL sampler."""
    x = (np.arange(width) + 0.5) / width * rows - 0.5
    i0 = np.floor(x).astype(int)
    w = (x - i0).astype(np.float32)
    cols = np.arange(width)
    m = np.zeros((rows, width), np.float32)
    np.add.at(m, (np.clip(i0, 0, rows - 1), cols), 1.0 - w)
    np.add.at(m, (np.clip(i0 + 1, 0, rows - 1), cols), w)
    return m


@contextlib.contextmanager
def true_f32():
    """Matrix products in full f32 inside, whatever the caller set: TF32
    keeps three decimal digits, as the TPU's default bf16 passes did (the
    JAX package pins `Precision.HIGHEST`)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def resample_rows(rows: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """[..., B, 2] magnitude rows -> [..., H, 2] log-frequency pixels, in
    true f32 (`true_f32`)."""
    with true_f32():
        return torch.einsum("hb,...bc->...hc", matrix, rows)


def db_normalize(left: torch.Tensor, right: torch.Tensor,
                 cfg: SpectrogramConfig) -> torch.Tensor:
    """10*log10(l^2+r^2+eps) normalized to the [min_db, max_db] window
    (gpu_spectrogram.rs:177-179; same law as colorscheme.rs:59-61)."""
    power = left * left + right * right
    db = 10.0 * torch.log10(power + cfg.db_epsilon)
    return (db - cfg.min_db) / (cfg.max_db - cfg.min_db)


def pan_fraction(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Shader pan law r/(l+r) (gpu_spectrogram.rs:182), guarded at l+r=0.

    The guard (-> 0.5, center pan) is a documented deviation: the GLSL path
    divides unguarded and produces NaN that the clamped sampler hides.
    """
    denom = left + right
    nonzero = denom != 0.0
    return torch.where(nonzero, right / torch.where(nonzero, denom, 1.0), 0.5)


def texel_coord(coord: torch.Tensor, resolution: int) -> torch.Tensor:
    """GL clamped-linear texel position: clamp(clamp(c,0,1)*R - 0.5, 0, R-1)."""
    return torch.clamp(
        torch.clamp(coord, 0.0, 1.0) * resolution - 0.5, 0.0, resolution - 1.0
    )


def tent_weights(coord: torch.Tensor, resolution: int) -> torch.Tensor:
    """[...] texture coordinate in [0,1] -> [..., res] tent-basis weights:
    the clamped-bilinear weight vector of the GL sampler, written densely."""
    x = texel_coord(coord, resolution)
    t = torch.arange(resolution, dtype=x.dtype, device=x.device)
    return torch.clamp(1.0 - torch.abs(x[..., None] - t), 0.0, 1.0)


def sample_lut_factored(
    u_table: torch.Tensor, v_table: torch.Tensor,
    pan: torch.Tensor, mag: torch.Tensor,
) -> torch.Tensor:
    """Sample a rank-1-factored LUT (see ColorScheme.factored_tables):
    equal to the clamped bilinear sample of LUT[i,j,c] = U[i,c] * V[j,c].
    u_table/v_table: [R, 4], or [S, R, 4] with pan/mag leading with S."""
    r = u_table.shape[-2]
    wu = tent_weights(mag, r)
    wv = tent_weights(pan, r)
    if u_table.ndim == 2:
        cu = torch.einsum("...t,tc->...c", wu, u_table)
        cv = torch.einsum("...t,tc->...c", wv, v_table)
    else:
        cu = torch.einsum("s...t,stc->s...c", wu, u_table)
        cv = torch.einsum("s...t,stc->s...c", wv, v_table)
    return cu * cv


def sample_lut_bilinear(lut: torch.Tensor, pan: torch.Tensor,
                        mag: torch.Tensor) -> torch.Tensor:
    """Clamped bilinear sample of a [R, R, 4] LUT at (x=pan, y=mag): the GL
    sampler's Clamp + Linear (gpu_spectrogram.rs:284-287), texel position
    clamp(clamp(coord, 0, 1) * R - 0.5, 0, R-1).  LUT axis 0 is magnitude,
    axis 1 pan (`ColorScheme.lookup_table`)."""
    r = lut.shape[-3]
    py, px = texel_coord(mag, r), texel_coord(pan, r)
    y0, x0 = torch.floor(py).long(), torch.floor(px).long()
    y1, x1 = torch.clamp(y0 + 1, max=r - 1), torch.clamp(x0 + 1, max=r - 1)
    wy = (py - y0.to(py.dtype))[..., None]
    wx = (px - x0.to(px.dtype))[..., None]
    top = lut[y0, x0] * (1 - wx) + lut[y0, x1] * wx
    bot = lut[y1, x0] * (1 - wx) + lut[y1, x1] * wx
    return top * (1 - wy) + bot * wy


def colormap_resampled(pixels: torch.Tensor, lut: torch.Tensor,
                       cfg: SpectrogramConfig) -> torch.Tensor:
    """[..., H, 2] log-frequency magnitudes -> [..., H, 4] f32 RGBA."""
    left, right = pixels[..., 0], pixels[..., 1]
    return sample_lut_bilinear(lut, pan_fraction(left, right),
                               db_normalize(left, right, cfg))


def colormap_rows(rows: torch.Tensor, matrix: torch.Tensor, lut: torch.Tensor,
                  cfg: SpectrogramConfig) -> torch.Tensor:
    """The whole colormap stage: [..., B, 2] magnitude rows -> [..., H, 4]
    f32 RGBA, by the [H, B] resample matrix and the [R, R, 4] LUT; the
    reference composition the colormap kernels are held to, on the
    tensors' device."""
    return colormap_resampled(resample_rows(rows, matrix), lut, cfg)


def composite_over_background(rgba: torch.Tensor,
                              background_rgb: torch.Tensor) -> torch.Tensor:
    """Alpha-blend f32 RGBA over an opaque background: the reference's frame
    clear to the palette background plus GL alpha blending
    (gpu_spectrogram.rs:278-293).  background_rgb is u8 [3] or [..., 3];
    returns u8 RGB."""
    a = rgba[..., 3:4]
    bg = background_rgb.to(torch.float32) / 255.0
    rgb = rgba[..., :3] * a + bg * (1.0 - a)
    return rgba_f32_to_u8(rgb)


def rgba_f32_to_u8(rgba: torch.Tensor) -> torch.Tensor:
    """Round half to even (as `jnp.round`), clamp, cast to u8."""
    return torch.clamp(torch.round(rgba * 255.0), 0, 255).to(torch.uint8)
