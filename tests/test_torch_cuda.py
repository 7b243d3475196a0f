"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and `nvcc` (a CUDA kernel has no CPU mode);
without a card they skip.  On the card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Tolerances: the STFT kernels atol 3e-5 / rtol 1e-4 against torch.fft (two
f32 FFTs of different factorizations), and bitwise against each other (they
share their device code); kernel B 1 u8 per channel on the same planes
(log10f and the plain path's division may round differently).
"""

import numpy as np
import pytest
import torch

from spectrogram_tpu_torch import testing
from spectrogram_tpu_torch.config import BENCH_CONFIG, DEFAULT_CONFIG, SpectrogramConfig
from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline
from spectrogram_tpu_torch.ops import colormap as cmap_ops
from spectrogram_tpu_torch.ops.cuda import _build
from spectrogram_tpu_torch.ops.cuda import colormap_kernel as ck
from spectrogram_tpu_torch.ops.cuda import stft_kernel as sk

pytestmark = pytest.mark.cuda

SMALL = SpectrogramConfig(sample_rate=8000.0, window_period=0.032, hop_period=0.008)
GEOMETRIES = {"small": SMALL, "bench": BENCH_CONFIG, "default": DEFAULT_CONFIG}
ATOL, RTOL = 3e-5, 1e-4


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
    name = sk.KERNEL if geometry != "default" else sk.MIXED_KERNEL
    lib = _build.library()
    before = lib.launches[name]
    got = sk.stft_mag_packed(left, right, hann, tw)
    torch.cuda.synchronize()
    assert lib.launches[name] == before + 1
    want = sk.stft_mag_packed_plain(left, right, hann, cfg.padded_size)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("n_fft", [480, 4800, 9600])
@pytest.mark.parametrize("kind", ["chirp_tone", "noise"])
def test_mixed_radix_kernel_matches_plain(cuda, n_fft, kind):
    cfg = SpectrogramConfig(sample_rate=48000.0, window_period=n_fft / 2 / 48000.0)
    assert cfg.padded_size == n_fft
    left, right = _windows(cfg, kind, 256, cuda)
    hann = torch.from_numpy(sk.packed_hann(cfg.window_size)).to(cuda)
    tw = torch.from_numpy(sk.twiddle_table(n_fft)).to(cuda)
    lib = _build.library()
    before = lib.launches[sk.MIXED_KERNEL]
    got = sk.stft_mag_packed(left, right, hann, tw)
    torch.cuda.synchronize()
    assert lib.launches[sk.MIXED_KERNEL] == before + 1
    want = sk.stft_mag_packed_plain(left, right, hann, n_fft)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("geometry", ["bench", "default"])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_allk_kernel_matches_plain_and_kernel_a(cuda, geometry, k):
    cfg = GEOMETRIES[geometry]
    s, w, h = 64, cfg.window_size, cfg.hop_size
    pcm = testing.chirp_tone(s, w + (k - 1) * h, cfg.sample_rate, seed=3)
    buf_l = torch.from_numpy(np.ascontiguousarray(pcm[..., 0])).to(cuda)
    buf_r = torch.from_numpy(np.ascontiguousarray(pcm[..., 1])).to(cuda)
    hann = torch.from_numpy(sk.packed_hann(w)).to(cuda)
    tw = torch.from_numpy(sk.twiddle_table(cfg.padded_size)).to(cuda)
    lib = _build.library()
    before = lib.launches[sk.ALLK_KERNEL]
    got = sk.stft_mag_packed_allk(buf_l, buf_r, hann, tw, k, h)
    torch.cuda.synchronize()
    assert lib.launches[sk.ALLK_KERNEL] == before + 1
    want = sk.stft_mag_packed_allk_plain(buf_l, buf_r, hann, cfg.padded_size, k, h)
    for g, x in zip(got, want):
        assert g.shape == (k * s, cfg.padded_size // 2)
        torch.testing.assert_close(g, x, atol=ATOL, rtol=RTOL)
    # the window-plane kernel gives the same bits for the same windows
    lefts = torch.cat([buf_l[:, r * h : r * h + w] for r in range(k)]).contiguous()
    rights = torch.cat([buf_r[:, r * h : r * h + w] for r in range(k)]).contiguous()
    for g, a in zip(got, sk.stft_mag_packed(lefts, rights, hann, tw)):
        torch.testing.assert_close(g, a, atol=0, rtol=0)


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


def test_rows_per_table_matches_plain(cuda):
    cfg = DEFAULT_CONFIG
    s, rows = 5, 16
    rng = np.random.default_rng(4)
    planes = [torch.from_numpy(np.abs(rng.standard_normal((s * rows, cfg.num_bins)))
                               .astype(np.float32) * 0.05).to(cuda) for _ in range(2)]
    taps = ck.resample_taps(cmap_ops.resample_matrix(cfg), cuda)
    tables = torch.from_numpy(ck.builtin_color_tables()[[2, 9, 0, 18, 5]]).to(cuda)
    got = ck.colormap_builtin(*planes, taps, tables, cfg, rows_per_table=rows)
    want = ck.colormap_builtin_plain(*planes, taps, tables, cfg, rows_per_table=rows)
    diff = np.abs(ck.unpack_rgba(got).astype(int) - ck.unpack_rgba(want).astype(int))
    assert diff.max() <= 1


@pytest.mark.parametrize("k", [1, 8])
def test_pipeline_on_card_matches_cpu_and_one_shot(cuda, k):
    cfg = SMALL
    ids = np.array([0, 1, 3, 8, 12])
    gpu = SpectrogramPipeline(cfg, chunk_hops=k, viewport_rows=16, device=cuda)
    cpu = SpectrogramPipeline(cfg, chunk_hops=k, viewport_rows=16, device="cpu")
    sg = gpu.set_palette(gpu.init_state(len(ids)), ids)
    sc = cpu.set_palette(cpu.init_state(len(ids)), ids)
    t = gpu.chunk_size
    pcm = testing.chirp_tone(len(ids), 4 * t, cfg.sample_rate, seed=8)
    rows_g, rows_c = [], []
    for i in range(4):
        chunk = torch.from_numpy(pcm[:, i * t : (i + 1) * t])
        sg, rg = gpu.push(sg, chunk.to(cuda))
        sc, rc = cpu.push(sc, chunk)
        torch.testing.assert_close(sg.carry.cpu(), sc.carry, atol=0, rtol=0)
        assert testing.bf16_ulps(sg.ring.cpu(), sc.ring, ATOL) <= 1
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
    for width in (None, 24):
        assert testing.rgba_u8_diff(
            ck.unpack_rgba(gpu.render_viewport(sg, width)),
            ck.unpack_rgba(gpu.with_plain_kernels().render_viewport(sg, width))) <= 1


def test_k8_push_equals_eight_k1_pushes_on_card(cuda):
    cfg = BENCH_CONFIG
    p8 = SpectrogramPipeline(cfg, chunk_hops=8, viewport_rows=16, device=cuda)
    p1 = SpectrogramPipeline(cfg, chunk_hops=1, viewport_rows=16, device=cuda)
    a, b = p8.init_state(6), p1.init_state(6)
    pcm = torch.from_numpy(testing.chirp_tone(6, 2 * p8.chunk_size, cfg.sample_rate, seed=5)).to(cuda)
    for i in range(2):
        a, ra = p8.push(a, pcm[:, i * p8.chunk_size : (i + 1) * p8.chunk_size])
        rb = []
        for j in range(8):
            at = i * p8.chunk_size + j * cfg.hop_size
            b, r = p1.push(b, pcm[:, at : at + cfg.hop_size])
            rb.append(r)
        torch.testing.assert_close(ra, torch.cat(rb, dim=1), atol=0, rtol=0)
        torch.testing.assert_close(a.ring, b.ring, atol=0, rtol=0)


def test_card_refuses_other_sizes(cuda):
    w = 2401                                  # N = 4802 = 2 * 7^4
    x = torch.zeros((2, w), device=cuda)
    hann = torch.zeros(w, device=cuda)
    tw = torch.zeros((2 * w, 2), device=cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sk.stft_mag_packed(x, x, hann, tw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sk.stft_mag_packed_allk(x, x, hann, tw, 1, 58)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SpectrogramPipeline(SpectrogramConfig(sample_rate=7000.0, window_period=0.35),
                            device=cuda)
