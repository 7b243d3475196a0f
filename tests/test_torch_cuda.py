"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and `nvcc` (a CUDA kernel has no CPU mode);
without a card they skip.  On the card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Tolerances: kernel A atol 3e-5 / rtol 1e-4 against torch.fft (two f32 FFTs
of different factorizations); kernel B 1 u8 per channel on the same planes
(log10f and the plain path's division may round differently).
"""

import numpy as np
import pytest
import torch

from spectrogram_tpu_torch import testing
from spectrogram_tpu_torch.config import BENCH_CONFIG, SpectrogramConfig
from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline
from spectrogram_tpu_torch.ops import colormap as cmap_ops
from spectrogram_tpu_torch.ops.cuda import _build
from spectrogram_tpu_torch.ops.cuda import colormap_kernel as ck
from spectrogram_tpu_torch.ops.cuda import stft_kernel as sk

pytestmark = pytest.mark.cuda

SMALL = SpectrogramConfig(sample_rate=8000.0, window_period=0.032, hop_period=0.008)
GEOMETRIES = {"small": SMALL, "bench": BENCH_CONFIG}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _windows(cfg, kind, rows, device):
    w = cfg.window_size
    frames = testing.make(kind, rows, w, cfg.sample_rate, seed=2)
    left = torch.from_numpy(np.ascontiguousarray(frames[..., 0])).to(device)
    right = torch.from_numpy(np.ascontiguousarray(frames[..., 1])).to(device)
    return left, right


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("kind", ["chirp_tone", "noise"])
def test_stft_kernel_matches_plain(cuda, geometry, kind):
    cfg = GEOMETRIES[geometry]
    left, right = _windows(cfg, kind, 256, cuda)
    hann = torch.from_numpy(sk.packed_hann(cfg.window_size)).to(cuda)
    tw = torch.from_numpy(sk.twiddle_table(cfg.padded_size)).to(cuda)
    lib = _build.library()
    before = lib.launches[sk.KERNEL]
    got = sk.stft_mag_packed(left, right, hann, tw)
    torch.cuda.synchronize()
    assert lib.launches[sk.KERNEL] == before + 1
    want = sk.stft_mag_packed_plain(left, right, hann, cfg.padded_size)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("layout", ["per_row", "one_table"])
def test_colormap_kernel_matches_plain(cuda, layout):
    cfg = BENCH_CONFIG
    left, right = _windows(cfg, "chirp_tone", 64, cuda)
    hann = torch.from_numpy(sk.packed_hann(cfg.window_size)).to(cuda)
    ml, mr = sk.stft_mag_packed_plain(left, right, hann, cfg.padded_size)
    tables = torch.from_numpy(ck.builtin_color_tables()).to(cuda)
    tables = tables[torch.arange(64, device=cuda) % 19] if layout == "per_row" else tables[3:4]
    taps = ck.resample_taps(cmap_ops.resample_matrix_full(cfg), cuda)
    lib = _build.library()
    before = lib.launches[ck.KERNEL]
    got = ck.colormap_builtin(ml, mr, taps, tables.contiguous(), cfg)
    torch.cuda.synchronize()
    assert lib.launches[ck.KERNEL] == before + 1
    want = ck.colormap_builtin_plain(ml, mr, taps, tables, cfg)
    diff = np.abs(ck.unpack_rgba(got).astype(int) - ck.unpack_rgba(want).astype(int))
    assert diff.max() <= 1


def test_pipeline_on_card_matches_cpu_and_one_shot(cuda):
    cfg = SMALL
    ids = np.array([0, 1, 3, 8, 12])
    gpu = SpectrogramPipeline(cfg, device=cuda)
    cpu = SpectrogramPipeline(cfg)
    sg = gpu.set_palette(gpu.init_state(len(ids)), ids)
    sc = cpu.set_palette(cpu.init_state(len(ids)), ids)
    pcm = testing.chirp_tone(len(ids), 4 * cfg.hop_size, cfg.sample_rate, seed=8)
    rows_g, rows_c = [], []
    for i in range(4):
        chunk = torch.from_numpy(pcm[:, i * cfg.hop_size : (i + 1) * cfg.hop_size])
        sg, rg = gpu.push(sg, chunk.to(cuda))
        sc, rc = cpu.push(sc, chunk)
        torch.testing.assert_close(sg.carry.cpu(), sc.carry, atol=0, rtol=0)
        rows_g.append(rg.cpu())
        rows_c.append(rc)
    streamed = torch.cat(rows_g, dim=1)
    assert testing.rgba_u8_diff(
        ck.unpack_rgba(streamed), ck.unpack_rgba(torch.cat(rows_c, dim=1))
    ) <= 1
    padded = np.concatenate([np.zeros((len(ids), gpu.carry_size, 2), np.float32), pcm], 1)
    for s, pid in enumerate(ids):
        one = gpu.process(torch.from_numpy(padded[s : s + 1]).to(cuda), palette_id=int(pid))
        torch.testing.assert_close(one.cpu()[0], streamed[s], atol=0, rtol=0)


def test_card_refuses_mixed_radix(cuda):
    w = 2400
    x = torch.zeros((2, w), device=cuda)
    hann = torch.zeros(w, device=cuda)
    tw = torch.zeros((2400, 2), device=cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sk.stft_mag_packed(x, x, hann, tw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SpectrogramPipeline(SpectrogramConfig(), device=cuda)
