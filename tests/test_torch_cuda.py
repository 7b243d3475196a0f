"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and `nvcc` (a CUDA kernel has no CPU mode);
without a card they skip.  On the card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Tolerances: the STFT kernels atol 3e-5 / rtol 1e-4 against torch.fft (two
f32 FFTs of different factorizations), and bitwise against each other (they
share their device code); the colormap kernels 1 u8 per channel on the
same planes (log10f and the plain path's division may round differently),
and bitwise against each other where they share a per-pixel body (the
blockwise kernel against kernel B, the static kernel against kernel B and
the generic kernel with one table).  The four split-real STFT kernels share
one row body, so they are held bit for bit against each other on the same
windows, and the tsplit kernel's next carry exactly against the framing's.
The sizes the kernels took last (N = 4410 and 4802 on radix 7; Bluestein
N = 1410, 693, 2204; pad_factor=1) are held to the same bars, kernels and
pipelines; the
carry+chunk kernel bit for bit against the all-windows split kernel on the
concatenated buffers, every next carry exactly, `emit_carry`'s magnitudes
bit for bit those without it, and the fused push bit for bit against the
split-real plane kernel followed by kernel B.  The large-N route (packed:
N = 32,768, 48,000, 35,280, 65,536; split-real: 65,536) is held to the STFT
bar against torch.fft, its int16 rows bit for bit the f32 rows of
x / 32768, every split-real layout bit for bit the others at N = 65,536,
and a k=8 push bit for bit `process()`; the split-real forms over radix 7
(the odd N = 735 row; the 1,024-thread packs of N = 35,280 and of
N = 16,400, Bluestein over M = 7^5) against torch.fft.rfft and their plain
version;
`colormap_rows_fused` bit for bit the generic kernel on two-tap matrices and
within 1 u8 of its plain version on a four-tap one.  Kernel B and the
generic kernel run as a tile (whole rows per CTA, the rows' planes staged
in shared memory) at H = 1024 and 1021, and in their direct form at H = 64
(a span wide beside the row's pixels), plane widths 2048 and 2205 (a left
plane a float off 16 bytes), per-row and stream-major tables, one or 19
tables: within 1 u8 of their plain versions, bit for bit the blockwise
kernel (built-in), `colormap_rows_fused` (generic) and the static kernel;
and in their direct form at N = 48,000.  The blockwise colormap runs kernel
B's code under its own entry: bit for bit kernel B on sorted and scattered
per-row tables at geometries that take both forms.  `StreamGroupManager`'s
groups (N=1410 on Bluestein among them) give their own pipelines' rows bit
for bit, its int16 wire the f32 drain's; the spectrum analyzer's levels stay
within 1e-6 of a float64 band product with TF32 allowed.  The CLI's `live`,
`live --view` and `live --view --multirate` (headless) run on the card,
launch kernels and write the viewport's PNG.  The stream mesh at world size
1 runs under NCCL in a rank process: its rows bit for bit the unsharded
pipeline's.  The ring write (`csrc/ring_write.cu`) is held bit for bit to
its plain version (the ATen cast's rounding) in all four ring dtypes, at
every cursor, at the display geometry, an odd one and on strided planes;
a display pipeline's ring bit for bit that of a twin whose ring write alone
is plain.  At the long-window deployment's geometry (N = 65,536) the packed
int16 large-N route over 4,096 rows, one row group of exactly 2 GiB of
scratch, equals bit for bit the same rows in two groups and the f32 route
on x / 32768, within the STFT bar of the plain version; its serving pushes
count the route and its groups, record them in `last_stft`, and open a
`spk.stft.large` span with no device-side range.
"""

import dataclasses

import numpy as np
import pytest
import torch

from spectrogram_tpu_torch import testing
from spectrogram_tpu_torch.color.colorscheme import stacked_factored_tables
from spectrogram_tpu_torch.config import BENCH_CONFIG, DEFAULT_CONFIG, SpectrogramConfig
from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline
from spectrogram_tpu_torch.ops import colormap as cmap_ops
from spectrogram_tpu_torch.ops import fft_plan
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
    tw = sk.fft_constants(cfg.padded_size, cuda)
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
    tw = sk.fft_constants(n_fft, cuda)
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
    tw = sk.fft_constants(cfg.padded_size, cuda)
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
    gpu = SpectrogramPipeline(cfg, chunk_hops=k, viewport_rows=16, packed_output=True,
                              device=cuda)
    cpu = SpectrogramPipeline(cfg, chunk_hops=k, viewport_rows=16, packed_output=True,
                              device="cpu")
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
    p8 = SpectrogramPipeline(cfg, chunk_hops=8, viewport_rows=16, packed_output=True,
                             device=cuda)
    p1 = SpectrogramPipeline(cfg, chunk_hops=1, viewport_rows=16, packed_output=True,
                             device=cuda)
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
    """N = 4802 = 2 7^4, once refused, runs on the direct mixed-radix body
    (radix 7) and N = 2204 = 2^2 19 29 on Bluestein (M = 4500), each
    matching the plain version; an N whose row buffer passes a block's
    shared memory, once refused too, runs on the large-N route; only N < 2
    raises."""
    lib = _build.library()
    for w, body in ((2401, "mixed"), (1102, "bluestein")):
        left, right = _windows(SpectrogramConfig(sample_rate=48000.0,
                                                 window_period=w / 48000.0),
                               "chirp_tone", 64, cuda)
        assert left.shape == (64, w) and sk.fft_body(2 * w) == body
        hann = torch.from_numpy(sk.packed_hann(w)).to(cuda)
        consts = sk.fft_constants(2 * w, cuda)
        before = lib.body_launches[body]
        got = sk.stft_mag_packed(left, right, hann, consts)
        torch.cuda.synchronize()
        assert lib.body_launches[body] == before + 1
        for g, x in zip(got, sk.stft_mag_packed_plain(left, right, hann, 2 * w)):
            torch.testing.assert_close(g, x, atol=ATOL, rtol=RTOL)
    x = torch.zeros((2, 16384), device=cuda)
    before = lib.body_launches["large"]
    got = sk.stft_mag_packed(x, x, torch.zeros(16384, device=cuda), sk.fft_constants(32768, cuda))
    torch.cuda.synchronize()
    assert lib.body_launches["large"] == before + 1
    assert got[0].shape == (2, 16384) and not got[0].any()
    p = SpectrogramPipeline(SpectrogramConfig(sample_rate=48000.0, window_period=0.35),
                            device=cuda)
    assert p.fft_consts.n_fft == 33600 and sk.is_large(33600)
    with pytest.raises(ValueError, match="at least 2"):
        sk.check_fft_size(1)


@pytest.mark.parametrize("layout", ["uniform", "mixed", "ragged"])
def test_blockwise_kernel_equals_kernel_b(cuda, layout):
    """The blockwise colormap gives kernel B's bits whichever arm a block
    takes: sorted runs (uniform blocks), scattered palettes (mixed blocks),
    and a row count that is no multiple of the block (a short last block)."""
    cfg = BENCH_CONFIG
    rows = 1000 if layout == "ragged" else 1024
    left, right = _windows(cfg, "chirp_tone", rows, cuda)
    hann = torch.from_numpy(sk.packed_hann(cfg.window_size)).to(cuda)
    ml, mr = sk.stft_mag_packed_plain(left, right, hann, cfg.padded_size)
    ids = {"uniform": np.sort(np.arange(rows) % 4), "mixed": np.arange(rows) % 19,
           "ragged": (np.arange(rows) // 100) % 19}[layout]
    tables = torch.from_numpy(ck.builtin_color_tables()[ids]).to(cuda)
    taps = ck.resample_taps(cmap_ops.resample_matrix_full(cfg), cuda)
    lib = _build.library()
    before = lib.launches[ck.BLOCKWISE_KERNEL]
    got = ck.colormap_blockwise(ml, mr, taps, tables, cfg, block_rows=128)
    torch.cuda.synchronize()
    assert lib.launches[ck.BLOCKWISE_KERNEL] == before + 1
    torch.testing.assert_close(got, ck.colormap_builtin(ml, mr, taps, tables, cfg),
                               atol=0, rtol=0)
    want = ck.colormap_blockwise_plain(ml, mr, taps, tables, cfg)
    assert testing.rgba_u8_diff(ck.unpack_rgba_device(got), ck.unpack_rgba_device(want)) <= 1
    # stream-major rows, as a viewport of blockwise-marked streams reads them
    got = ck.colormap_blockwise(ml, mr, taps, tables[::8].contiguous(), cfg,
                                rows_per_table=8, block_rows=128)
    torch.testing.assert_close(
        got, ck.colormap_builtin(ml, mr, taps, tables[::8].contiguous(), cfg,
                                 rows_per_table=8), atol=0, rtol=0)


@pytest.mark.parametrize("geometry", ["bench", "default"])
def test_int16_kernels_equal_f32_kernels(cuda, geometry):
    """Kernel A and the all-windows kernel on int16 planes give the bits of
    the f32 kernels on x / 32768, and match the plain version."""
    cfg = GEOMETRIES[geometry]
    w, h, k = cfg.window_size, cfg.hop_size, 8
    rng = np.random.default_rng(5)
    hann16 = torch.from_numpy(sk.packed_hann_i16(w)).to(cuda)
    hann = torch.from_numpy(sk.packed_hann(w)).to(cuda)
    tw = sk.fft_constants(cfg.padded_size, cuda)
    lib = _build.library()
    for shape, call in (((256, w), lambda a, b, hn: sk.stft_mag_packed(a, b, hn, tw)),
                        ((64, w + (k - 1) * h),
                         lambda a, b, hn: sk.stft_mag_packed_allk(a, b, hn, tw, k, h))):
        words = [torch.from_numpy(rng.integers(-32768, 32768, shape, dtype=np.int16)).to(cuda)
                 for _ in range(2)]
        before = dict(lib.launches)
        got = call(*words, hann16)
        torch.cuda.synchronize()
        i16 = [n for n in lib.launches if lib.launches[n] != before[n]]
        assert len(i16) == 1 and i16[0].endswith("_i16")
        scaled = [x.to(torch.float32) / 32768.0 for x in words]
        for g, x in zip(got, call(*scaled, hann)):
            torch.testing.assert_close(g, x, atol=0, rtol=0)
        plain = (sk.stft_mag_packed_plain(*words, hann16, cfg.padded_size) if shape[0] == 256
                 else sk.stft_mag_packed_allk_plain(*words, hann16, cfg.padded_size, k, h))
        for g, x in zip(got, plain):
            torch.testing.assert_close(g, x, atol=ATOL, rtol=RTOL)
    doubles = torch.zeros((4, w), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="float32 or int16"):
        sk.stft_mag_packed(doubles, doubles, hann, tw)


def test_serving_pipeline_on_card(cuda):
    """The full serving mode on the card: sorted rows equal per-row rows,
    and match the CPU run of the same pushes."""
    cfg, s = SMALL, 256
    ids = np.arange(s) % 2
    kw = dict(chunk_hops=1, store_ring=False, packed_output=True)
    full = SpectrogramPipeline(cfg, i16_planes=True, presorted_input=True,
                               sorted_output=True, device=cuda, **kw)
    per_row = SpectrogramPipeline(cfg, palette_sort=False, device=cuda, **kw)
    cpu = SpectrogramPipeline(cfg, i16_planes=True, presorted_input=True,
                              sorted_output=True, device="cpu", **kw)
    fs, ps = full.set_palette(full.init_state(s), ids), per_row.set_palette(per_row.init_state(s), ids)
    cs = cpu.set_palette(cpu.init_state(s), ids)
    perm, out = full.input_perm(fs), torch.from_numpy(full.output_perm(fs)).long()
    rng = np.random.default_rng(9)
    lib = _build.library()
    before = dict(lib.launches)
    for _ in range(3):
        words = torch.from_numpy(rng.integers(-32768, 32768, (s, full.chunk_size, 2),
                                              dtype=np.int16))
        fs, fr = full.push(fs, words[perm].to(cuda))
        ps, pr = per_row.push(ps, words.to(cuda))
        cs, cr = cpu.push(cs, words[perm])
        torch.testing.assert_close(fr[out.to(cuda)], pr, atol=0, rtol=0)
        assert testing.rgba_u8_diff(ck.unpack_rgba(fr), ck.unpack_rgba(cr)) <= 1
        torch.testing.assert_close(fs.carry.cpu(), cs.carry, atol=0, rtol=0)
    torch.cuda.synchronize()
    for name in (sk.KERNEL_I16, ck.BLOCKWISE_KERNEL):
        assert lib.launches[name] > before[name], name


def _custom_factors():
    """`testing.custom_factors` as [1, R*4] tables."""
    return tuple(t.reshape(1, -1) for t in testing.custom_factors())


@pytest.mark.parametrize("layout", ["per_row", "one_table", "rows_per_table"])
def test_generic_kernel_matches_plain(cuda, layout):
    cfg = BENCH_CONFIG
    rows = 256
    left, right = _windows(cfg, "chirp_tone", rows, cuda)
    hann = torch.from_numpy(sk.packed_hann(cfg.window_size)).to(cuda)
    ml, mr = sk.stft_mag_packed_plain(left, right, hann, cfg.padded_size)
    gu, gv = ck.generic_color_tables()
    cu, cv = _custom_factors()
    u = torch.from_numpy(np.concatenate([cu, gu])).to(cuda)
    v = torch.from_numpy(np.concatenate([cv, gv])).to(cuda)
    rpt = 1
    if layout == "per_row":
        idx = torch.arange(rows, device=cuda) % 20
    elif layout == "one_table":
        idx = torch.tensor([0], device=cuda)
    else:
        idx, rpt = torch.arange(8, device=cuda) % 20, rows // 8
    u, v = u[idx].contiguous(), v[idx].contiguous()
    taps = ck.resample_taps(cmap_ops.resample_matrix_full(cfg), cuda)
    lib = _build.library()
    before = lib.launches[ck.GENERIC_KERNEL]
    got = ck.colormap_generic(ml, mr, taps, u, v, cfg, rows_per_table=rpt)
    torch.cuda.synchronize()
    assert lib.launches[ck.GENERIC_KERNEL] == before + 1
    want = ck.colormap_generic_plain(ml, mr, taps, u, v, cfg, rows_per_table=rpt)
    assert testing.rgba_u8_diff(ck.unpack_rgba_device(got), ck.unpack_rgba_device(want)) <= 1
    diff = (ck.unpack_rgba_device(got).int() - ck.unpack_rgba_device(want).int()).abs()
    assert int(diff.max()) <= 1


@pytest.mark.parametrize("palette", ["Magma", "Blue-Yellow-Red (Stereo)", "generic"])
def test_static_kernel_equals_one_table_kernels(cuda, palette):
    """The static kernel gives, bit for bit, kernel B's output with that one
    table (built-in palettes) or the generic kernel's (a generic palette),
    and stays within 1 u8 of its plain version."""
    from spectrogram_tpu_torch.color.colorscheme import scheme_index

    cfg = BENCH_CONFIG
    left, right = _windows(cfg, "chirp_tone", 300, cuda)
    hann = torch.from_numpy(sk.packed_hann(cfg.window_size)).to(cuda)
    ml, mr = sk.stft_mag_packed_plain(left, right, hann, cfg.padded_size)
    taps = ck.resample_taps(cmap_ops.resample_matrix_full(cfg), cuda)
    if palette == "generic":
        u, v = _custom_factors()
        table = (u[0], v[0])
        one = ck.colormap_generic(ml, mr, taps, torch.from_numpy(u).to(cuda),
                                  torch.from_numpy(v).to(cuda), cfg)
    else:
        table = ck.builtin_color_tables()[scheme_index(palette)]
        one = ck.colormap_builtin(ml, mr, taps, torch.from_numpy(table[None]).to(cuda), cfg)
    lib = _build.library()
    before = lib.launches[ck.STATIC_KERNEL]
    got = ck.colormap_static(ml, mr, taps, table, cfg)
    torch.cuda.synchronize()
    assert lib.launches[ck.STATIC_KERNEL] == before + 1
    torch.testing.assert_close(got, one, atol=0, rtol=0)
    want = ck.colormap_static_plain(ml, mr, taps, table, cfg)
    diff = (ck.unpack_rgba_device(got).int() - ck.unpack_rgba_device(want).int()).abs()
    assert int(diff.max()) <= 1
    with pytest.raises(ValueError, match="R <= 64"):
        ck.colormap_static(ml, mr, taps, np.zeros(65 * 4, np.float32), cfg)


@pytest.mark.parametrize("k", [1, 8])
def test_generic_and_static_pipelines_on_card(cuda, k):
    """A generic registry (per-row, then one palette) and a static pipeline
    on the card: rows match the CPU run within 1 u8, streamed rows equal
    process(), and the blockwise kernel never launches."""
    from spectrogram_tpu_torch.color.colorscheme import DEFAULT_COLOR_SCHEMES

    cfg = SMALL
    schemes = (testing.custom_scheme(),) + DEFAULT_COLOR_SCHEMES[:3]
    s = 4
    t_pcm = testing.chirp_tone(s, 4 * k * cfg.hop_size, cfg.sample_rate, seed=8)
    lib = _build.library()
    for kw, ids in ((dict(schemes=schemes), np.arange(s)), (dict(schemes=schemes), 2),
                    (dict(static_palette="Magma"), None),
                    (dict(schemes=schemes, static_palette=0), None)):
        args = dict(chunk_hops=k, viewport_rows=16, packed_output=True, **kw)
        gpu = SpectrogramPipeline(cfg, device=cuda, **args)
        cpu = SpectrogramPipeline(cfg, device="cpu", **args)
        sg, sc = gpu.init_state(s), cpu.init_state(s)
        if ids is not None:
            sg, sc = gpu.set_palette(sg, ids), cpu.set_palette(sc, ids)
        before = dict(lib.launches)
        t = gpu.chunk_size
        rows = []
        for i in range(4):
            chunk = torch.from_numpy(t_pcm[:, i * t : (i + 1) * t])
            sg, rg = gpu.push(sg, chunk.to(cuda))
            sc, rc = cpu.push(sc, chunk)
            torch.testing.assert_close(sg.carry.cpu(), sc.carry, atol=0, rtol=0)
            assert testing.rgba_u8_diff(ck.unpack_rgba(rg), ck.unpack_rgba(rc)) <= 1
            rows.append(rg)
        torch.cuda.synchronize()
        name = ck.STATIC_KERNEL if gpu.static_table is not None else ck.GENERIC_KERNEL
        assert lib.launches[name] > before[name]
        assert lib.launches[ck.BLOCKWISE_KERNEL] == before[ck.BLOCKWISE_KERNEL]
        padded = np.concatenate([np.zeros((s, gpu.carry_size, 2), np.float32), t_pcm], 1)
        pid = int(sg.palette_id[0])
        one = gpu.process(torch.from_numpy(padded).to(cuda), palette_id=pid)
        streamed = torch.cat(rows, dim=1)
        same = torch.from_numpy(np.flatnonzero(sg.palette_id.cpu().numpy() == pid)).to(cuda)
        torch.testing.assert_close(one.index_select(0, same), streamed.index_select(0, same),
                                   atol=0, rtol=0)
        for width in (None, 24):
            assert testing.rgba_u8_diff(
                ck.unpack_rgba(gpu.render_viewport(sg, width)),
                ck.unpack_rgba(gpu.with_plain_kernels().render_viewport(sg, width))) <= 1


# ------------------------------------------------------------- split-real

@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("kind", ["chirp_tone", "noise"])
def test_split_kernels_match_plain_and_each_other(cuda, geometry, kind):
    """The four split-real kernels, each launched once, against their plain
    versions; transposed, tsplit and all-windows bit for bit the window
    planes' rows; tsplit's next carry exactly the framing's."""
    cfg = GEOMETRIES[geometry]
    w, n, rows = cfg.window_size, cfg.padded_size, 64
    n1 = fft_plan.make_plan(cfg).n1
    m = w // n1
    left, right = _windows(cfg, kind, rows, cuda)
    hann = torch.from_numpy(sk.split_hann(w)).to(cuda)
    tw = sk.fft_constants(n, cuda)
    lib = _build.library()
    names = (sk.SPLIT_KERNEL, sk.SPLIT_ALLK_KERNEL, sk.SPLIT_T_KERNEL, sk.SPLIT_TSPLIT_KERNEL)
    before = {name: lib.launches[name] for name in names}
    planes = sk.stft_mag_split(left, right, hann, tw)
    x = torch.stack([left, right], 1).reshape(rows, 2, m, n1).transpose(2, 3).contiguous()
    t = sk.stft_mag_split_t(x, hann, tw)
    t_cols = m // 3
    carry, chunk = x[..., : m - t_cols].contiguous(), x[..., m - t_cols :].contiguous()
    ts = sk.stft_mag_split_tsplit(carry, chunk, hann, tw)
    k, hop, s = 3, w // 4, rows // 4
    buf = torch.cat([left[:s], right[:s, : (k - 1) * hop]], dim=1).contiguous()
    buf_r = torch.cat([right[s : 2 * s], left[s : 2 * s, : (k - 1) * hop]], dim=1).contiguous()
    allk = sk.stft_mag_split_allk(buf, buf_r, hann, tw, k, hop)
    torch.cuda.synchronize()
    assert all(lib.launches[name] == before[name] + 1 for name in names)
    for g, x_ in zip(planes, sk.stft_mag_split_plain(left, right, hann, n)):
        torch.testing.assert_close(g, x_, atol=ATOL, rtol=RTOL)
    for got in (t, ts[:2]):
        for g, a in zip(got, planes):
            torch.testing.assert_close(g, a, atol=0, rtol=0)
    torch.testing.assert_close(ts[2], torch.cat([carry, chunk], 3)[..., t_cols:], atol=0, rtol=0)
    wl = torch.cat([buf[:, r * hop : r * hop + w] for r in range(k)]).contiguous()
    wr = torch.cat([buf_r[:, r * hop : r * hop + w] for r in range(k)]).contiguous()
    for g, a, x_ in zip(allk, sk.stft_mag_split(wl, wr, hann, tw),
                        sk.stft_mag_split_allk_plain(buf, buf_r, hann, n, k, hop)):
        torch.testing.assert_close(g, a, atol=0, rtol=0)
        torch.testing.assert_close(g, x_, atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError, match="float32"):
        sk.stft_mag_split(left.to(torch.int16), right.to(torch.int16), hann, tw)


LAYOUTS = {
    "split_real_k1": dict(chunk_hops=1, stft_packed=False),
    "split_real_k8": dict(chunk_hops=8, stft_packed=False),
    "transposed_k1": dict(chunk_hops=1, transposed_carry=True),
    "transposed_k8": dict(chunk_hops=8, transposed_carry=True),
    "tsplit": dict(chunk_hops=1, framing="tsplit"),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_split_real_pipelines_on_card(cuda, layout):
    """Each split-real push on the card against the same push on the CPU
    (1 u8 over what the image shows, carry and ring as the other pushes),
    streamed == process() bit for bit, and the launches of its kernel."""
    cfg = BENCH_CONFIG
    kw = dict(LAYOUTS[layout], viewport_rows=16, packed_output=True)
    gpu = SpectrogramPipeline(cfg, device=cuda, **kw)
    cpu = SpectrogramPipeline(cfg, device="cpu", **kw)
    ids = np.array([0, 1, 3, 8, 12])
    sg = gpu.set_palette(gpu.init_state(len(ids)), ids)
    sc = cpu.set_palette(cpu.init_state(len(ids)), ids)
    name = (sk.SPLIT_TSPLIT_KERNEL if gpu.tsplit_framing else sk.SPLIT_T_KERNEL
            if gpu.carry_transposed else sk.SPLIT_KERNEL if gpu.chunk_hops == 1
            else sk.SPLIT_ALLK_KERNEL)
    lib = _build.library()
    before = lib.launches[name]
    t = gpu.chunk_size
    pcm = testing.chirp_tone(len(ids), 3 * t, cfg.sample_rate, seed=8)
    rows_g, rows_c = [], []
    for i in range(3):
        chunk = torch.from_numpy(pcm[:, i * t : (i + 1) * t])
        sg, rg = gpu.push(sg, chunk.to(cuda))
        sc, rc = cpu.push(sc, chunk)
        torch.testing.assert_close(sg.carry.cpu(), sc.carry, atol=0, rtol=0)
        assert testing.bf16_ulps(sg.ring.cpu(), sc.ring, ATOL) <= 1
        rows_g.append(rg.cpu())
        rows_c.append(rc)
    torch.cuda.synchronize()
    assert lib.launches[name] == before + 3
    streamed = torch.cat(rows_g, dim=1)
    assert testing.rgba_u8_diff(
        ck.unpack_rgba(streamed), ck.unpack_rgba(torch.cat(rows_c, dim=1))) <= 1
    padded = np.concatenate([np.zeros((len(ids), gpu.carry_size, 2), np.float32), pcm], 1)
    for s, pid in enumerate(ids):
        one = gpu.process(torch.from_numpy(padded[s : s + 1]).to(cuda), palette_id=int(pid))
        torch.testing.assert_close(one.cpu()[0], streamed[s], atol=0, rtol=0)


# ------------------------------------------- every FFT size, the carry pair

# (config, kind): 44.1 kHz (N = 4410, radix 7), Bluestein sizes (N = 1410,
# odd 693), pad_factor 1
SIZES = {
    "n4410": SpectrogramConfig(sample_rate=44100.0),
    "n1410": SpectrogramConfig(sample_rate=44100.0, window_period=0.016, hop_period=0.006),
    "odd_n693": SpectrogramConfig(sample_rate=8000.0, window_period=231 / 8000.0,
                                  hop_period=64 / 8000.0, pad_factor=3),
    "pad1_n2048": SpectrogramConfig(sample_rate=48000.0, window_period=2048 / 48000.0,
                                    hop_period=800 / 48000.0, pad_factor=1),
}


@pytest.mark.parametrize("size", sorted(SIZES))
def test_every_size_kernels_match_plain(cuda, size):
    """Kernel A, the all-windows kernel and the split-real plane kernel at
    the sizes the FFT bodies newly take, against their plain versions; the
    all-windows rows bit for bit kernel A's."""
    cfg = SIZES[size]
    w, n, h, k, s = cfg.window_size, cfg.padded_size, cfg.hop_size, 4, 32
    consts = sk.fft_constants(n, cuda)
    left, right = _windows(cfg, "chirp_tone", 64, cuda)
    hann = torch.from_numpy(sk.packed_hann(w)).to(cuda)
    split_hann = torch.from_numpy(sk.split_hann(w)).to(cuda)
    lib = _build.library()
    before = dict(lib.body_launches)
    packed = sk.stft_mag_packed(left, right, hann, consts)
    split = sk.stft_mag_split(left, right, split_hann, consts)
    pcm = testing.chirp_tone(s, w + (k - 1) * h, cfg.sample_rate, seed=3)
    buf_l, buf_r = (torch.from_numpy(np.ascontiguousarray(pcm[..., c])).to(cuda)
                    for c in range(2))
    allk = sk.stft_mag_packed_allk(buf_l, buf_r, hann, consts, k, h)
    torch.cuda.synchronize()
    # the packed kernels count under N's body, the split-real one under N/2's
    want = {b: 0 for b in before}
    want[sk.fft_body(n)] += 2
    want[sk.split_route(n)] += 1
    assert {b: lib.body_launches[b] - before[b] for b in before} == want
    for got, want in ((packed, sk.stft_mag_packed_plain(left, right, hann, n)),
                      (split, sk.stft_mag_split_plain(left, right, split_hann, n)),
                      (allk, sk.stft_mag_packed_allk_plain(buf_l, buf_r, hann, n, k, h))):
        for g, x in zip(got, want):
            assert g.shape == (g.shape[0], sk.stft_bins(n, w))
            torch.testing.assert_close(g, x, atol=ATOL, rtol=RTOL)
    wl, wr = (torch.cat([b[:, r * h : r * h + w] for r in range(k)]).contiguous()
              for b in (buf_l, buf_r))
    for g, a in zip(allk, sk.stft_mag_packed(wl, wr, hann, consts)):
        torch.testing.assert_close(g, a, atol=0, rtol=0)


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("k", [1, 8])
def test_every_size_pipeline_on_card(cuda, size, k):
    """The pipeline at those sizes on the card against the same pushes on the
    CPU (1 u8 over what the image shows, carry exact, ring within 1 bf16 ulp
    beyond the STFT bar), streamed == process() bit for bit."""
    cfg = SIZES[size]
    kw = dict(chunk_hops=k, viewport_rows=16, packed_output=True)
    gpu = SpectrogramPipeline(cfg, device=cuda, **kw)
    cpu = SpectrogramPipeline(cfg, device="cpu", **kw)
    ids = np.array([0, 1, 3, 8])
    sg = gpu.set_palette(gpu.init_state(len(ids)), ids)
    sc = cpu.set_palette(cpu.init_state(len(ids)), ids)
    t = gpu.chunk_size
    pcm = testing.chirp_tone(len(ids), 3 * t, cfg.sample_rate, seed=8)
    rows = []
    for i in range(3):
        chunk = torch.from_numpy(pcm[:, i * t : (i + 1) * t])
        sg, rg = gpu.push(sg, chunk.to(cuda))
        sc, rc = cpu.push(sc, chunk)
        torch.testing.assert_close(sg.carry.cpu(), sc.carry, atol=0, rtol=0)
        assert testing.bf16_ulps(sg.ring.cpu(), sc.ring, ATOL) <= 1
        assert testing.rgba_u8_diff(ck.unpack_rgba(rg), ck.unpack_rgba(rc)) <= 1
        rows.append(rg.cpu())
    streamed = torch.cat(rows, dim=1)
    padded = np.concatenate([np.zeros((len(ids), gpu.carry_size, 2), np.float32), pcm], 1)
    for s, pid in enumerate(ids):
        one = gpu.process(torch.from_numpy(padded[s : s + 1]).to(cuda), palette_id=int(pid))
        torch.testing.assert_close(one.cpu()[0], streamed[s], atol=0, rtol=0)


@pytest.mark.parametrize("form", ["packed", "packed_i16", "split"])
def test_emit_carry_kernels(cuda, form):
    """`emit_carry` on the all-windows kernels: the next carry exactly the
    buffers' tail in their dtype, the magnitudes the same bits as without
    the flag and within the bar of the plain version."""
    cfg = BENCH_CONFIG
    w, h, k, s = cfg.window_size, cfg.hop_size, 8, 64
    rng = np.random.default_rng(11)
    shape = (s, w + (k - 1) * h)
    if form == "packed_i16":
        bufs = [torch.from_numpy(rng.integers(-32768, 32768, shape, dtype=np.int16)).to(cuda)
                for _ in range(2)]
        hann = sk.packed_hann_i16(w)
    else:
        bufs = [torch.from_numpy((rng.standard_normal(shape) * 0.3).astype(np.float32)).to(cuda)
                for _ in range(2)]
        hann = sk.packed_hann(w) if form == "packed" else sk.split_hann(w)
    hann = torch.from_numpy(hann).to(cuda)
    wrapper = sk.stft_mag_split_allk if form == "split" else sk.stft_mag_packed_allk
    name = {"packed": sk.ALLK_CARRY_KERNEL, "packed_i16": sk.ALLK_CARRY_KERNEL_I16,
            "split": sk.SPLIT_ALLK_CARRY_KERNEL}[form]
    args = (*bufs, hann, sk.fft_constants(cfg.padded_size, cuda), k, h)
    lib = _build.library()
    before = lib.launches[name]
    got = wrapper(*args, emit_carry=True)
    torch.cuda.synchronize()
    assert lib.launches[name] == before + 1
    assert got[2].dtype == bufs[0].dtype
    torch.testing.assert_close(got[2], sk.buffer_tails(*bufs, w - h), atol=0, rtol=0)
    plain = (sk.stft_mag_split_allk_plain if form == "split"
             else sk.stft_mag_packed_allk_plain)(*bufs, hann, cfg.padded_size, k, h)
    for g, same, x in zip(got, wrapper(*args), plain):
        torch.testing.assert_close(g, same, atol=0, rtol=0)
        torch.testing.assert_close(g, x, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("k", [1, 8])
def test_split_carry_kernel(cuda, k):
    """The planar carry + chunk kernel: rows bit for bit the all-windows
    split kernel's on the concatenated buffers, within the bar of its plain
    version; the next carry exactly the buffers' tail."""
    cfg = BENCH_CONFIG
    w, h, s = cfg.window_size, cfg.hop_size, 64
    c = w - h
    rng = np.random.default_rng(k)
    carry, chunk = (torch.from_numpy((rng.standard_normal((s, 2, n)) * 0.3)
                                     .astype(np.float32)).to(cuda) for n in (c, k * h))
    lib = _build.library()
    before = lib.launches[sk.SPLIT_CARRY_KERNEL]
    got = sk.stft_mag_fused2_split(carry, chunk, cfg, k=k)
    torch.cuda.synchronize()
    assert lib.launches[sk.SPLIT_CARRY_KERNEL] == before + 1
    buf = torch.cat([carry, chunk], dim=2)
    hann = torch.from_numpy(sk.split_hann(w)).to(cuda)
    allk = sk.stft_mag_split_allk(buf[:, 0].contiguous(), buf[:, 1].contiguous(), hann,
                                  sk.fft_constants(cfg.padded_size, cuda), k, h)
    for g, a, x in zip(got, allk, sk.stft_mag_split_carry_plain(carry, chunk, hann,
                                                               cfg.padded_size, k, h)):
        torch.testing.assert_close(g, a, atol=0, rtol=0)
        torch.testing.assert_close(g, x, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(got[2], buf[:, :, buf.shape[2] - c :], atol=0, rtol=0)


@pytest.mark.parametrize("emit_mags", [False, True])
def test_push_fused_equals_chain(cuda, emit_mags):
    """The fused push: rows bit for bit the split-real plane kernel followed
    by kernel B, planes bit for bit the plane kernel's, rows within 1 u8 of
    the plain version."""
    from spectrogram_tpu_torch.ops.cuda import push_kernel as pk

    cfg = BENCH_CONFIG
    rows = 256
    left, right = _windows(cfg, "chirp_tone", rows, cuda)
    tables = torch.from_numpy(ck.builtin_color_tables()[np.arange(rows) % 19]).to(cuda)
    mt = cmap_ops.resample_matrix_full(cfg).T
    lib = _build.library()
    before = lib.launches[pk.KERNEL]
    got = pk.push_fused_single(left, right, tables, mt, cfg, emit_mags=emit_mags)
    torch.cuda.synchronize()
    assert lib.launches[pk.KERNEL] == before + 1
    hann = torch.from_numpy(sk.split_hann(cfg.window_size)).to(cuda)
    planes = sk.stft_mag_split(left, right, hann, sk.fft_constants(cfg.padded_size, cuda))
    taps = ck.resample_taps(mt.T, cuda)
    chain = ck.colormap_builtin(*planes, taps, tables, cfg)
    words = got[0] if emit_mags else got
    torch.testing.assert_close(words, chain, atol=0, rtol=0)
    if emit_mags:
        for g, a in zip(got[1:], planes):
            torch.testing.assert_close(g, a, atol=0, rtol=0)
    plain = pk.push_fused_plain(left, right, hann, cfg.padded_size, tables, taps, cfg)
    assert testing.rgba_u8_diff(ck.unpack_rgba_device(words), ck.unpack_rgba_device(plain)) <= 1


def test_xla_backends_run_the_plain_versions_on_card(cuda):
    """stft_backend="xla" and colormap_backend="xla" (JAX's golden path)
    are the only way a CUDA tensor reaches a plain STFT or colormap: no
    STFT or colormap kernel launches, and the rows equal
    `with_plain_kernels()`'s exactly.  No backend selects the ring write
    (JAX writes its ring with XLA under every backend), so its kernel
    launches once, and the ring equals the plain twin's bit for bit."""
    from spectrogram_tpu_torch.ops.cuda import ring_kernel

    cfg = SMALL
    kw = dict(chunk_hops=2, viewport_rows=16, packed_output=True, device=cuda)
    xla = SpectrogramPipeline(cfg, stft_backend="xla", colormap_backend="xla", **kw)
    plain = SpectrogramPipeline(cfg, **kw).with_plain_kernels()
    ids = np.array([0, 1, 3, 8])
    sx, sp = (q.set_palette(q.init_state(len(ids)), ids) for q in (xla, plain))
    chunk = torch.from_numpy(testing.chirp_tone(len(ids), xla.chunk_size, cfg.sample_rate,
                                                seed=8)).to(cuda)
    lib = _build.library()
    torch.cuda.synchronize()
    before = dict(lib.launches)
    sx, rx = xla.push(sx, chunk)
    torch.cuda.synchronize()
    assert lib.launches == {**before, ring_kernel.KERNEL: before[ring_kernel.KERNEL] + 1}
    sp, rp = plain.push(sp, chunk)
    torch.testing.assert_close(rx, rp, atol=0, rtol=0)
    torch.testing.assert_close(sx.carry, sp.carry, atol=0, rtol=0)
    assert torch.equal(sx.ring.view(torch.int16), sp.ring.view(torch.int16))


# ------------------------------------------------------ the large-N route

# N = 2^15 (radix 4^7 2), 48,000 (mixed), 35,280 (mixed with radix 7) on the
# packed kernels' route, their split-real rows (the N/2 pack) in shared
# memory; N = 2^16, where the split-real rows take the route too
LARGE = {
    "n32768": SpectrogramConfig(sample_rate=48000.0, window_period=16384 / 48000.0,
                                hop_period=4096 / 48000.0),
    "n48000": SpectrogramConfig(sample_rate=48000.0, window_period=0.5),
    "n35280": SpectrogramConfig(sample_rate=44100.0, window_period=0.4),
    "n65536": SpectrogramConfig(sample_rate=48000.0, window_period=32768 / 48000.0,
                                hop_period=4096 / 48000.0),
}


@pytest.mark.parametrize("size", sorted(LARGE))
def test_large_route_matches_plain(cuda, size):
    """The large-N route's packed (f32, int16) kernel and the split-real
    rows (the route's split kernel at N = 65,536, the shared-memory split
    kernel on the N/2 pack below it) against torch.fft at the STFT bar,
    counted under their body labels; int16 rows equal the f32 rows of
    x / 32768 bit for bit."""
    cfg = LARGE[size]
    n, w = cfg.padded_size, cfg.window_size
    assert sk.is_large(n)
    split_kernel = sk.LARGE_SPLIT_KERNEL if sk.is_large_split(n) else sk.SPLIT_KERNEL
    consts = sk.fft_constants(n, cuda)
    left, right = _windows(cfg, "chirp_tone", 24, cuda)
    hann = torch.from_numpy(sk.packed_hann(w)).to(cuda)
    shann = torch.from_numpy(sk.split_hann(w)).to(cuda)
    lib = _build.library()
    before = dict(lib.body_launches), dict(lib.launches)
    packed = sk.stft_mag_packed(left, right, hann, consts)
    split = sk.stft_mag_split(left, right, shann, consts)
    torch.cuda.synchronize()
    assert lib.launches[sk.LARGE_KERNEL] == before[1][sk.LARGE_KERNEL] + 1
    assert lib.launches[split_kernel] == before[1][split_kernel] + 1
    want = {b: 0 for b in before[0]}
    want["large"] += 1
    want[sk.split_route(n)] += 1
    assert {b: lib.body_launches[b] - before[0][b] for b in before[0]} == want
    for got, want in ((packed, sk.stft_mag_packed_plain(left, right, hann, n)),
                      (split, sk.stft_mag_split_plain(left, right, shann, n))):
        for g, x in zip(got, want):
            assert g.shape == (24, sk.stft_bins(n, w))
            torch.testing.assert_close(g, x, atol=ATOL, rtol=RTOL)
    words = [torch.round(x * 32767.0).to(torch.int16) for x in (left, right)]
    i16 = sk.stft_mag_packed(*words, torch.from_numpy(sk.packed_hann_i16(w)).to(cuda),
                             consts)
    f32 = sk.stft_mag_packed(*(x.to(torch.float32) / 32768.0 for x in words), hann, consts)
    for g, x in zip(i16, f32):
        torch.testing.assert_close(g, x, atol=0, rtol=0)


# the split-real forms over radix 7 no other card test reaches: the odd
# N = 735 = 3 5 7 7 (the N-point row over MixedRadixT<7>), and the N/2 packs
# at 1,024 threads of N = 35,280 (17,640 = 4 2 3 3 5 7 7) and N = 16,400
# (8200 = 2^3 5^2 41: Bluestein over M = 16,807 = 7^5)
@pytest.mark.parametrize("n_fft,w", [(735, 367), (35280, 17640), (16400, 8200)])
def test_split_real_radix7_forms_match_rfft(cuda, n_fft, w):
    """The split-real plane kernel at those forms against torch.fft.rfft and
    its plain version at the STFT bar, counted under N/2's body label."""
    m = sk.split_buf_size(n_fft)
    assert not sk.is_large_split(n_fft) and 7 in sk.mixed_radix_plan(m)
    assert (m >= sk.WIDE_ROW) == (n_fft != 735)
    consts = sk.fft_constants(n_fft, cuda)
    pcm = testing.chirp_tone(16, w, 44100.0, seed=n_fft)
    left, right = (torch.from_numpy(np.ascontiguousarray(pcm[..., c])).to(cuda)
                   for c in range(2))
    hann = torch.from_numpy(sk.split_hann(w)).to(cuda)
    lib = _build.library()
    before = dict(lib.body_launches)
    got = sk.stft_mag_split(left, right, hann, consts)
    torch.cuda.synchronize()
    assert lib.body_launches[sk.split_route(n_fft)] == before[sk.split_route(n_fft)] + 1
    bins = sk.stft_bins(n_fft, w)
    plain = sk.stft_mag_split_plain(left, right, hann, n_fft)
    for g, x, q in zip(got, (left, right), plain):
        want = torch.fft.rfft(x * hann, n=n_fft).abs()[:, :bins]
        torch.testing.assert_close(g, want, atol=ATOL, rtol=RTOL)
        torch.testing.assert_close(g, q, atol=ATOL, rtol=RTOL)


def test_large_split_layouts_equal_bit_for_bit(cuda):
    """At N = 65,536 (N/2 = 32,768 past a block) every split-real layout
    takes the one large split kernel: planes, all-windows (with its next
    carry), the planar carry + chunk, the transposed operand and tsplit
    give the same bits for the same windows, and the fused push equals
    split -> kernel B."""
    from spectrogram_tpu_torch.ops.cuda import push_kernel as pk

    cfg = LARGE["n65536"]
    assert sk.is_large_split(cfg.padded_size)
    n, w, h, k, s = cfg.padded_size, cfg.window_size, cfg.hop_size, 3, 4
    n1 = fft_plan.make_plan(cfg).n1
    consts = sk.fft_constants(n, cuda)
    shann = torch.from_numpy(sk.split_hann(w)).to(cuda)
    c = w - h
    pcm = testing.chirp_tone(s, c + k * h, cfg.sample_rate, seed=12)
    buf = torch.from_numpy(np.ascontiguousarray(pcm.transpose(0, 2, 1))).to(cuda)  # [S, 2, L]
    carry, chunk = buf[..., :c].contiguous(), buf[..., c:].contiguous()
    bl, br = buf[:, 0].contiguous(), buf[:, 1].contiguous()
    wl, wr = (torch.cat([b[:, r * h : r * h + w] for r in range(k)]) for b in (bl, br))
    planes = sk.stft_mag_split(wl, wr, shann, consts)
    allk = sk.stft_mag_split_allk(bl, br, shann, consts, k, h, emit_carry=True)
    pair = sk.stft_mag_split_carry(carry, chunk, shann, consts, k, h)
    tail = buf[..., buf.shape[2] - c :]
    for got in (allk, pair):
        for g, x in zip(got[:2], planes):
            torch.testing.assert_close(g, x, atol=0, rtol=0)
        torch.testing.assert_close(got[2], tail, atol=0, rtol=0)
    # the transposed operand and tsplit, on the first window of each stream
    x = buf[..., :w].reshape(s, 2, w // n1, n1).transpose(2, 3).contiguous()
    t = sk.stft_mag_split_t(x, shann, consts)
    cols = c // n1
    ts = sk.stft_mag_split_tsplit(x[..., :cols].contiguous(), x[..., cols:].contiguous(),
                                  shann, consts)
    for got in (t, ts[:2]):
        for g, want in zip(got, planes):
            torch.testing.assert_close(g, want[:s], atol=0, rtol=0)
    torch.testing.assert_close(ts[2], sk.split_next_carry(x[..., :cols], x[..., cols:]),
                               atol=0, rtol=0)
    tables = torch.from_numpy(ck.builtin_color_tables()[np.arange(k * s) % 19]).to(cuda)
    mt = cmap_ops.resample_matrix_full(cfg).T
    pushed = pk.push_fused_single(wl, wr, tables, mt, cfg, emit_mags=True)
    chain = ck.colormap_builtin(*planes, ck.resample_taps(mt.T, cuda), tables, cfg)
    for g, x in zip(pushed, (chain, *planes)):
        torch.testing.assert_close(g, x, atol=0, rtol=0)


def test_large_k8_push_equals_process(cuda):
    """At N = 35,280 (44.1 kHz, 0.4 s window) the k=8 push with its ring
    equals process() bit for bit, and the k=1 push on the card matches the
    CPU's within 1 u8, carry exact."""
    cfg = LARGE["n35280"]
    ids = np.array([0, 1, 3])
    p = SpectrogramPipeline(cfg, chunk_hops=8, viewport_rows=16, packed_output=True,
                            device=cuda)
    state = p.set_palette(p.init_state(len(ids)), ids)
    t = p.chunk_size
    pcm = testing.chirp_tone(len(ids), 3 * t, cfg.sample_rate, seed=13)
    lib = _build.library()
    before = lib.body_launches["large"]
    rows = []
    for i in range(3):
        state, r = p.push(state, torch.from_numpy(pcm[:, i * t : (i + 1) * t]).to(cuda))
        rows.append(r)
    torch.cuda.synchronize()
    assert lib.body_launches["large"] == before + 3
    streamed = torch.cat(rows, dim=1)
    padded = np.concatenate([np.zeros((len(ids), p.carry_size, 2), np.float32), pcm], 1)
    for s, pid in enumerate(ids):
        one = p.process(torch.from_numpy(padded[s : s + 1]).to(cuda), palette_id=int(pid))
        torch.testing.assert_close(one[0], streamed[s], atol=0, rtol=0)
    kw = dict(chunk_hops=1, store_ring=False, packed_output=True)
    gpu, cpu = (SpectrogramPipeline(cfg, device=d, **kw) for d in (cuda, "cpu"))
    sg, sc = (q.set_palette(q.init_state(len(ids)), ids) for q in (gpu, cpu))
    chunk = torch.from_numpy(pcm[:, : gpu.chunk_size])
    sg, rg = gpu.push(sg, chunk.to(cuda))
    sc, rc = cpu.push(sc, chunk)
    torch.testing.assert_close(sg.carry.cpu(), sc.carry, atol=0, rtol=0)
    assert testing.rgba_u8_diff(ck.unpack_rgba(rg), ck.unpack_rgba(rc)) <= 1


# ------------------------------------------------- colormap_rows_fused

def _fused_operands(cfg, n, device, seed=14):
    rng = np.random.default_rng(seed)
    u, v = stacked_factored_tables(32)
    pid = np.arange(n) % 19
    u, v = u[pid].copy(), v[pid].copy()
    cu, cv = _custom_factors()
    u[::5], v[::5] = cu.reshape(32, 4), cv.reshape(32, 4)
    rows = np.abs(rng.standard_normal((n, 2, cfg.num_bins))).astype(np.float32) * 0.01
    return tuple(torch.from_numpy(a).to(device) for a in (rows, u, v))


def test_colormap_rows_fused_equals_generic(cuda):
    """spk_colormap_rows on planar rows equals the generic kernel on
    contiguous copies of the planes with the two-tap taps, bit for bit; its
    u8 form is the packed words' bytes; within 1 u8 of the plain version."""
    cfg = BENCH_CONFIG
    rows, u, v = _fused_operands(cfg, 256, cuda)
    m = cmap_ops.resample_matrix(cfg)
    lib = _build.library()
    before = lib.launches[ck.ROWS_KERNEL]
    packed = ck.colormap_rows_fused(rows, u, v, m.T, cfg, packed=True)
    u8 = ck.colormap_rows_fused(rows, u, v, m.T, cfg)
    torch.cuda.synchronize()
    assert lib.launches[ck.ROWS_KERNEL] == before + 2
    generic = ck.colormap_generic(rows[:, 0].contiguous(), rows[:, 1].contiguous(),
                                  ck.resample_taps(m, cuda), u.reshape(256, -1),
                                  v.reshape(256, -1), cfg)
    torch.testing.assert_close(packed, generic, atol=0, rtol=0)
    torch.testing.assert_close(u8, ck.unpack_rgba_device(packed), atol=0, rtol=0)
    plain = ck.colormap_rows_fused_plain(rows, u, v, torch.from_numpy(m.T).to(cuda), cfg)
    assert testing.rgba_u8_diff(u8, plain) <= 1


def test_colormap_rows_fused_four_taps(cuda):
    """A matrix with four taps per pixel: within 1 u8 of the plain version."""
    cfg = SMALL
    rows, u, v = _fused_operands(cfg, 64, cuda, seed=15)
    m = cmap_ops.resample_matrix(cfg)
    m4 = np.ascontiguousarray((0.5 * (m + np.roll(m, 2, axis=1))).T)
    taps = ck.resample_taps_k(m4, cuda)
    assert taps.j.shape[1] == 4
    got = ck.colormap_rows_fused(rows, u, v, taps, cfg)
    plain = ck.colormap_rows_fused_plain(rows, u, v, torch.from_numpy(m4).to(cuda), cfg)
    assert testing.rgba_u8_diff(got, plain) <= 1
    torch.testing.assert_close(got, ck.colormap_rows_fused(rows, u, v, m4, cfg), atol=0, rtol=0)


# ------------------------------------------- kernel B and the generic tile

TILE_WIDTHS = {2048: BENCH_CONFIG,                                       # N=4096
               2205: SpectrogramConfig(sample_rate=44100.0, window_period=0.05)}  # 4410


def _tile_tables(word, n_tables, device):
    """Built-in tables, or (custom, 18 built-in) factors U and V: the first
    n_tables of 19."""
    if word == "builtin":
        t = ck.builtin_color_tables()
        return (torch.from_numpy(t if n_tables == 19 else t[3:4].copy()).to(device), None)
    gu, gv = ck.generic_color_tables()
    cu, cv = _custom_factors()
    u, v = np.concatenate([cu, gu[:18]])[:n_tables], np.concatenate([cv, gv[:18]])[:n_tables]
    return torch.from_numpy(u.copy()).to(device), torch.from_numpy(v.copy()).to(device)


def _u8_diff_max(got, want) -> int:
    return int((ck.unpack_rgba_device(got).int() - ck.unpack_rgba_device(want).int())
               .abs().max())


@pytest.mark.parametrize("word", ["builtin", "generic"])
@pytest.mark.parametrize("n_tables", [1, 19])
@pytest.mark.parametrize("rows_per_table", [1, 8])
@pytest.mark.parametrize("bins", sorted(TILE_WIDTHS))
@pytest.mark.parametrize("h", [64, 1024, 1021])
def test_tile_kernels_match_plain_and_twins(cuda, h, bins, rows_per_table, n_tables, word):
    """Kernel B and the generic kernel on 1,000 rows (no multiple of a
    CTA's rows), the left plane a float past a 16-byte boundary, staged at
    H = 1024 and 1021 and direct at H = 64: within 1 u8 of the plain version; kernel B bit for bit the blockwise kernel, the
    generic kernel bit for bit `colormap_rows_fused` on the same two taps
    and each row's tables, and with one table both bit for bit the static
    kernel."""
    cfg = dataclasses.replace(TILE_WIDTHS[bins], viewport_height=h)
    rows = 1000
    left, right = _windows(cfg, "chirp_tone", rows, cuda)
    hann = torch.from_numpy(sk.packed_hann(cfg.window_size)).to(cuda)
    ml, mr = sk.stft_mag_packed(left, right, hann, sk.fft_constants(cfg.padded_size, cuda))
    assert ml.shape == (rows, bins)
    buf = torch.zeros(rows * bins + 8, device=cuda)
    buf[1 : 1 + rows * bins] = ml.reshape(-1)
    ml = buf[1 : 1 + rows * bins].view(rows, bins)
    matrix = cmap_ops.resample_matrix_full(cfg)
    taps = ck.resample_taps(matrix, cuda)
    u, v = _tile_tables(word, n_tables, cuda)
    name = ck.KERNEL if v is None else ck.GENERIC_KERNEL
    assert ck.tile_form(taps, 32, v is not None) == ("staged" if h > 1000 else "direct")
    lib = _build.library()
    before = lib.launches[name]
    if v is None:
        got = ck.colormap_builtin(ml, mr, taps, u, cfg, rows_per_table)
        want = ck.colormap_builtin_plain(ml, mr, taps, u, cfg, rows_per_table)
        twin = ck.colormap_blockwise(ml, mr, taps, u, cfg, rows_per_table, block_rows=128)
        one = u[0].cpu().numpy()
    else:
        got = ck.colormap_generic(ml, mr, taps, u, v, cfg, rows_per_table)
        want = ck.colormap_generic_plain(ml, mr, taps, u, v, cfg, rows_per_table)
        pick = (torch.arange(rows, device=cuda) // rows_per_table) % n_tables
        twin = ck.colormap_rows_fused(
            torch.stack([ml, mr], 1), *(t[pick].view(rows, -1, 4) for t in (u, v)),
            ck.resample_taps_k(matrix.T, cuda), cfg, packed=True)
        one = (u[0].cpu().numpy(), v[0].cpu().numpy())
    torch.cuda.synchronize()
    assert lib.launches[name] == before + 1
    assert _u8_diff_max(got, want) <= 1
    torch.testing.assert_close(got, twin, atol=0, rtol=0)
    if n_tables == 1:
        torch.testing.assert_close(got, ck.colormap_static(ml, mr, taps, one, cfg),
                                   atol=0, rtol=0)


@pytest.mark.parametrize("word", ["builtin", "generic"])
def test_tile_direct_form_matches_plain(cuda, word):
    """At N = 48,000 (planes of 24,000 bins) the tile reads the planes in
    place: within 1 u8 of the plain version, per-row and stream-major."""
    cfg = SpectrogramConfig(window_period=0.5)
    rows = 300
    rng = np.random.default_rng(5)
    m = cmap_ops.resample_matrix_full(cfg)                  # [H, 24,000]
    ml, mr = (torch.from_numpy(np.abs(rng.standard_normal((rows, m.shape[1])))
                               .astype(np.float32) * 0.02).to(cuda) for _ in range(2))
    taps = ck.resample_taps(m, cuda)
    u, v = _tile_tables(word, 19, cuda)
    assert ck.tile_form(taps, 32, v is not None) == "direct"
    for rpt in (1, 8):
        if v is None:
            got = ck.colormap_builtin(ml, mr, taps, u, cfg, rpt)
            want = ck.colormap_builtin_plain(ml, mr, taps, u, cfg, rpt)
        else:
            got = ck.colormap_generic(ml, mr, taps, u, v, cfg, rpt)
            want = ck.colormap_generic_plain(ml, mr, taps, u, v, cfg, rpt)
        assert _u8_diff_max(got, want) <= 1


# ------------------------------------------- the blockwise colormap's forms

FORM_GEOMETRIES = (  # (config, H): kernel B's staged and direct forms
    (BENCH_CONFIG, 1024), (BENCH_CONFIG, 64),
    (SpectrogramConfig(window_period=1200 / 48000.0), 512),
    (SpectrogramConfig(window_period=0.5), 1024),
)


@pytest.mark.parametrize("layout", ["sorted", "scattered"])
def test_blockwise_forms_equal_kernel_b(cuda, layout):
    """The blockwise colormap bit for bit kernel B on sorted (uniform
    blocks) and scattered per-row table copies, within 1 u8 of its plain
    version, on 1,000 rows (no multiple of block_rows; a left plane a float
    past 16 bytes) at geometries that take both of kernel B's forms, with
    its own launch count."""
    lib = _build.library()
    rows = 1000
    ids = np.arange(rows) % 19
    ids = np.sort(ids) if layout == "sorted" else ids
    forms = set()
    for base, h in FORM_GEOMETRIES:
        cfg = dataclasses.replace(base, viewport_height=h)
        left, right = _windows(cfg, "chirp_tone", rows, cuda)
        hann = torch.from_numpy(sk.packed_hann(cfg.window_size)).to(cuda)
        ml, mr = sk.stft_mag_packed_plain(left, right, hann, cfg.padded_size)
        bins = ml.shape[1]
        buf = torch.zeros(rows * bins + 8, device=cuda)
        buf[1 : 1 + rows * bins] = ml.reshape(-1)
        ml = buf[1 : 1 + rows * bins].view(rows, bins)
        taps = ck.resample_taps(cmap_ops.resample_matrix_full(cfg), cuda)
        tables = torch.from_numpy(ck.builtin_color_tables()[ids]).to(cuda)
        before = (lib.launches[ck.BLOCKWISE_KERNEL], lib.launches[ck.KERNEL])
        got = ck.colormap_blockwise(ml, mr, taps, tables, cfg, block_rows=128)
        torch.cuda.synchronize()
        assert (lib.launches[ck.BLOCKWISE_KERNEL], lib.launches[ck.KERNEL]) == (
            before[0] + 1, before[1])
        torch.testing.assert_close(got, ck.colormap_builtin(ml, mr, taps, tables, cfg),
                                   atol=0, rtol=0)
        want = ck.colormap_blockwise_plain(ml, mr, taps, tables, cfg)
        assert _u8_diff_max(got, want) <= 1
        forms.add(ck.tile_form(taps, 32))
    assert forms == {"staged", "direct"}


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("wire", ["int16_presorted", "f32_probe"])
def test_feeder_on_the_card_equals_pushes(cuda, depth, wire):
    """The serving loop's feeder on the card: a RingBank16 drained into a
    pinned ChunkPool (every slot `is_pinned()`), copied on the feeder's side
    stream, pushed at depth 1 and 2: rows bit for bit the same pipeline's
    sequential pushes of the same chunks sent straight to the card, carries
    exact, every copy and push timed, and the kernels launched (int16
    kernel A and the blockwise colormap on the sorted int16 state; f32
    kernel A and kernel B on the per-row one)."""
    from spectrogram_tpu_torch.io.feeder import ChunkPool, DeviceFeeder
    from spectrogram_tpu_torch.io.ring import RingBank16

    s, ticks = 1024, 6
    i16 = wire == "int16_presorted"
    kw = dict(chunk_hops=1, store_ring=False, packed_output=True, device=cuda)
    if i16:
        kw.update(i16_planes=True, presorted_input=True, sorted_output=True)
    p = SpectrogramPipeline(BENCH_CONFIG, **kw)
    ids = np.arange(s) % (2 if i16 else 19)
    state = p.set_palette(p.init_state(s), ids)
    dest = p.input_dest(state)
    assert (dest is not None) == i16
    n = p.chunk_size
    words = np.round(testing.chirp_tone(s, ticks * n, BENCH_CONFIG.sample_rate, seed=31)
                     * 32767.0).astype(np.int16)

    want, ref = [], state
    for t in range(ticks):
        planar = np.ascontiguousarray(words[:, t * n : (t + 1) * n].transpose(0, 2, 1))
        chunk = torch.from_numpy(planar).to(cuda)
        if i16:
            chunk = chunk.index_select(0, torch.from_numpy(p.input_perm(state)).to(cuda))
        else:
            chunk = chunk.to(torch.float32) / 32768.0
        ref, r = p.push_planar(ref, chunk)
        want.append(r)

    lib = _build.library()
    kernels = ((sk.KERNEL_I16, ck.BLOCKWISE_KERNEL) if i16 else (sk.KERNEL, ck.KERNEL))
    before = [lib.launches[k] for k in kernels]
    bank = RingBank16(s, 8192)
    bank.push_matrix(words)
    feeder = DeviceFeeder(p, state, depth=depth, planar=True, copy_chunks=False,
                          readback="full" if i16 else "probe")
    pool = ChunkPool.for_feeder(feeder, s, dtype=np.int16 if i16 else np.float32)
    assert pool.pinned and len(pool) == depth + 1
    got = []
    for _ in range(ticks):
        buf = pool.next()
        assert torch.from_numpy(buf).is_pinned()
        if i16:
            chunk, _ = bank.pop_matrix_i16_planar(n, buf, dest=dest)
        else:
            chunk, _ = bank.pop_matrix_f32_planar(n, buf)
        done = feeder.push(chunk)
        if done is not None:
            got.append(done)
    got.extend(feeder.flush())
    assert bank.dropped_total == 0 and bank.min_size() == 0
    assert [lib.launches[k] - b for k, b in zip(kernels, before)] == [ticks, ticks]
    assert len(got) == ticks
    for g, w in zip(got, want):
        if i16:
            np.testing.assert_array_equal(g, w.cpu().numpy())
        else:
            assert g.is_cuda
            torch.testing.assert_close(g, w, atol=0, rtol=0)
    torch.testing.assert_close(feeder.state.carry, ref.carry, atol=0, rtol=0)
    assert len(feeder.h2d.samples) == len(feeder.device_time.samples) == ticks
    assert all(x > 0 for x in feeder.h2d.samples + feeder.device_time.samples)



def test_feeder_spans_on_the_card(cuda):
    """The feeder's spans on the card under a CPU+CUDA profiler: the
    copy-event wait and the pinned staging of the readback (which a CPU
    pipeline has not) inside the tick, the kernels launched under the
    pipeline's stage spans, and no `spk.` range mirrored onto the device's
    timeline (the profiler keeps none for these ranges)."""
    from torch.profiler import ProfilerActivity, profile

    from spectrogram_tpu_torch.io.feeder import ChunkPool, DeviceFeeder

    s = 512
    p = SpectrogramPipeline(BENCH_CONFIG, device=cuda, chunk_hops=1, store_ring=False,
                            packed_output=True, i16_planes=True, presorted_input=True,
                            sorted_output=True, stream_blocks=256)
    state = p.set_palette(p.init_state(s), (np.arange(s) // 64) % 2)
    feeder = DeviceFeeder(p, state, depth=2, planar=True, copy_chunks=False)
    pool = ChunkPool.for_feeder(feeder, s, dtype=np.int16)
    for _ in range(len(pool)):
        pool.next()[...] = 7
    feeder.push(pool.next())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            feeder.push(pool.next())
        torch.cuda.synchronize()
    feeder.flush()
    spans = {}
    for e in prof.events():
        if e.name.startswith("spk.") and e.device_type == torch.autograd.DeviceType.CPU:
            parent = e.cpu_parent
            while parent is not None and not parent.name.startswith("spk."):
                parent = parent.cpu_parent
            spans[e.name] = parent.name if parent is not None else None
    assert spans["spk.feeder.upload_wait"] == "spk.feeder.tick"
    assert spans["spk.feeder.readback"] == "spk.feeder.tick"
    assert spans["spk.feeder.readback.stage"] == "spk.feeder.readback"
    assert spans["spk.stft"] == spans["spk.colormap"] == "spk.push"
    kineto = prof.profiler.kineto_results.events()
    assert not [k.name() for k in kineto
                if k.device_type() != torch.autograd.DeviceType.CPU
                and k.name().startswith("spk.")]
    assert [k for k in kineto if k.device_type() == torch.autograd.DeviceType.CUDA
            and "stft" in k.name()]


# ------------------------------------- the multi-rate manager and the analyzer

def test_manager_groups_equal_their_pipelines(cuda):
    """Two geometry groups (8 kHz, and 44.1 kHz with N=1410 on the
    Bluestein body) of 64 streams: push_group rows bit for bit each
    geometry's own pipeline, and an int16-wire ingest group's blocks bit for
    bit the f32 drain's."""
    from spectrogram_tpu_torch.models.multirate import StreamGroupManager

    g44 = SpectrogramConfig(sample_rate=44100.0, window_period=0.016, hop_period=0.006)
    assert sk.fft_body(g44.padded_size) == "bluestein"
    ids = np.arange(64) % 19
    mgr = StreamGroupManager(group_capacity=64, chunk_hops=2, device=cuda)
    for cfg in (SMALL, g44):
        for p in ids:
            mgr.add_stream(cfg, palette_id=int(p))
        ref = SpectrogramPipeline(cfg, chunk_hops=2, device=cuda)
        rs = ref.set_palette(ref.init_state(64), ids)
        for seed in range(3):
            chunk = torch.from_numpy(testing.make(
                "chirp_tone", 64, ref.chunk_size, cfg.sample_rate, seed=seed)).to(cuda)
            rs, want = ref.push(rs, chunk)
            assert torch.equal(mgr.push_group(cfg, chunk), want)
    words = np.random.default_rng(4).integers(-32768, 32768, (64, 4000, 2)).astype(np.int16)
    blocks = {}
    for wire in (False, True):
        m = StreamGroupManager(group_capacity=64, chunk_hops=2, ingest=True,
                               wire_int16=wire, store_ring=False, device=cuda)
        sids = [m.add_stream(SMALL, palette_id=int(p)) for p in ids]
        for sid, w in zip(sids, words):
            m.push_pcm(sid, w)
        blocks[wire] = [b for now in (1.0, 2.0, 3.0, 4.0) for b in m.tick(now).values()]
        assert not any(m.metrics()["dropped"].values())
    assert len(blocks[False]) == len(blocks[True]) == 3
    for a, b in zip(blocks[False], blocks[True]):
        np.testing.assert_array_equal(a, b)


def test_analyzer_band_product_is_true_f32(cuda):
    """The analyzer's band product ignores TF32 switches: with TF32 allowed
    its levels stay within 1e-6 of a float64 band product followed by the
    same f32 law."""
    from spectrogram_tpu_torch.models.spectrum_analyzer import SpectrumAnalyzer

    ana = SpectrumAnalyzer(DEFAULT_CONFIG, device=cuda)
    rng = np.random.default_rng(7)
    rows = (10.0 ** rng.uniform(-5, -0.5, (4, 8, DEFAULT_CONFIG.num_bins, 2))).astype(np.float32)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = ana.push_rows(ana.init_levels(4), torch.from_numpy(rows).to(cuda)).cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    m = ana.band_matrix.cpu().numpy().astype(np.float64)
    bands = np.einsum("gb,skbc->kgsc", m, rows.astype(np.float64)).astype(np.float32)
    norm = np.sqrt(bands[..., 0] ** 2 + bands[..., 1] ** 2)
    new = np.clip((np.float32(10.0) * np.log10(norm + np.float32(1e-7)) + np.float32(70.0))
                  / np.float32(60.0), 0.0, 1.0)
    want = np.full((4, ana.n_bands), 0.3, np.float32)
    for v in new:
        want = np.maximum(v.T, want * np.float32(0.99))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


LIVE_VIEWS = {"plain": [], "view": ["--view", "--fps", "100"],
              "multirate": ["--view", "--multirate", "--fps", "50", "--chunk-hops", "2"]}


@pytest.mark.parametrize("view", sorted(LIVE_VIEWS))
def test_cli_live_runs_on_the_card(cuda, tmp_path, view):
    """`app live` headless with `--device cuda`: the multi-rate view
    composites the host blocks `tick` returns on the card; each form exits
    0, launches kernels and writes the viewport, 2,048 rows of 64 pixels."""
    from PIL import Image

    from spectrogram_tpu_torch import app

    out = tmp_path / "live.png"
    lib = _build.library()
    before = sum(lib.launches.values())
    rc = app.main(["live", str(out), "--seconds", "0.5", "--streams", "4",
                   "--sample-rate", "9000", "--window", "0.032", "--hop", "0.008",
                   "--height", "64", *LIVE_VIEWS[view], "--device", "cuda"])
    assert rc == 0 and np.asarray(Image.open(out)).shape == (64, 2048, 3)
    assert sum(lib.launches.values()) > before


def test_mesh_world_one_under_nccl(cuda, tmp_path):
    """One rank under NCCL (`tests/torch_ranks.py`, group "card"): the
    mesh's shard_map_step rows bit for bit the unsharded pipeline's, the
    row count summed by NCCL on the card, a DCP save and restore."""
    import torch_ranks as tr

    run = tr.spawn("card", tmp_path, world=1)
    got = tr.result(run, "card_world1")
    assert str(got["backend"]) == "nccl" and str(got["sum_device"]) == "cuda"
    assert bool(got["same"]) and int(got["total"]) == 3 * 1024
    assert bool(got["restored"])


@pytest.mark.parametrize("stft_packed", [True, False])
def test_every_launch_candidate_gives_equal_rows(cuda, stft_packed):
    """BENCH_CONFIG at k=1, 256 streams: the push under every launch shape
    of its families (`launch_families`: the STFT rows' bounds, the tile's
    form) gives the table's rows and next carry bit for bit, and the
    candidate's kernels launch."""
    kw = dict(chunk_hops=1, store_ring=False, packed_output=True,
              stft_packed=stft_packed)
    p = SpectrogramPipeline(BENCH_CONFIG, device=cuda, **kw)
    s = 256
    ids = np.arange(s) % len(p.schemes)
    pcm = torch.from_numpy(testing.chirp_tone(s, 2 * p.chunk_size,
                                              BENCH_CONFIG.sample_rate, seed=29)).to(cuda)
    chunks = (pcm[:, : p.chunk_size], pcm[:, p.chunk_size :])

    def run(launch):
        p.override_launch(launch)
        state = p.set_palette(p.init_state(s), ids)
        rows = []
        for chunk in chunks:
            state, r = p.push(state, chunk)
            rows.append(r)
        return torch.cat(rows, dim=1), state.carry

    want_rows, want_carry = run({})
    lib = _build.library()
    families = p.launch_families()
    assert ("packed" if stft_packed else "split") in families and "tile" in families
    for family, choices in families.items():
        for choice in choices:
            before = dict(lib.launches)
            rows, carry = run({family: choice})
            assert torch.equal(rows, want_rows), (family, choice)
            assert torch.equal(carry, want_carry), (family, choice)
            assert sum(lib.launches.values()) > sum(before.values())


RING_SHAPES = {
    # streams, k, W, P (plane width), plane row stride (None: P)
    "display": (300, 8, DEFAULT_CONFIG.window_size, DEFAULT_CONFIG.padded_size // 2, None),
    "odd": (37, 1, 202, 256, None),
    "odd_strided": (37, 1, 202, 256, 263),
}


@pytest.mark.parametrize("ring_dtype", [torch.bfloat16, torch.float16, torch.float32,
                                        torch.float64])
@pytest.mark.parametrize("shape", sorted(RING_SHAPES))
def test_ring_write_equals_plain(cuda, shape, ring_dtype):
    """The ring kernel writes the plain version's bits (the ATen cast's
    rounding, NaN, inf, overflow and subnormals included) at every cursor of
    a 16-row ring, and leaves every other row as it was."""
    from spectrogram_tpu_torch.ops.cuda import ring_kernel

    s, k, w, p, stride = RING_SHAPES[shape]
    g = torch.Generator().manual_seed(22)
    planes = []
    for _ in range(2):
        base = torch.rand((k * s, stride or p), generator=g) * 40
        for step, col, value in ((97, 5, float("nan")), (89, 7, float("inf")),
                                 (83, 9, 3.0e38), (79, 11, 1.0e-40)):
            base[::step, col] = value
        planes.append(base.to(cuda)[:, :p])
    assert (stride is not None) == (not planes[0].is_contiguous())
    r = 16
    bits = {torch.float64: torch.int64, torch.float32: torch.int32}.get(ring_dtype, torch.int16)
    lib = _build.library()
    for cursor in range(0, r, k):
        assert cursor + k <= r           # the pipeline's rows never wrap
        ring = torch.full((s, r, 2, w - 1), 7.0, dtype=ring_dtype, device=cuda)
        twin = ring.clone()
        c = torch.tensor(cursor, dtype=torch.int32, device=cuda)
        before = lib.launches[ring_kernel.KERNEL]
        ring_kernel.ring_write(ring, c, *planes, k)
        torch.cuda.synchronize()
        assert lib.launches[ring_kernel.KERNEL] == before + 1
        ring_kernel.ring_write_plain(twin, c, *planes, k)
        torch.cuda.synchronize()
        assert torch.equal(ring.view(bits), twin.view(bits)), cursor


def test_pipeline_ring_equals_plain_twin(cuda):
    """Display pushes (DEFAULT_CONFIG, k=8, 256 streams) past the ring's
    wrap, one ring launch a push: the ring equals bit for bit that of a twin
    whose ring write alone is plain (the same planes), and lies within one
    bf16 step of the `with_plain_kernels()` twin's (whose planes come from
    the plain STFT)."""
    import copy

    from spectrogram_tpu_torch.ops.cuda import ring_kernel

    p = SpectrogramPipeline(DEFAULT_CONFIG, chunk_hops=8, viewport_rows=16,
                            packed_output=True, device=cuda)
    ring_plain = copy.copy(p)
    ring_plain._use_plain_ring()
    twins = (ring_plain, p.with_plain_kernels())
    s = 256
    ids = np.arange(s) % len(p.schemes)
    states = [q.set_palette(q.init_state(s), ids) for q in (p, *twins)]
    pushes = 3
    pcm = torch.from_numpy(testing.chirp_tone(
        s, pushes * p.chunk_size, DEFAULT_CONFIG.sample_rate, seed=22)).to(cuda)
    lib = _build.library()
    for i in range(pushes):
        chunk = pcm[:, i * p.chunk_size:(i + 1) * p.chunk_size]
        before = lib.launches[ring_kernel.KERNEL]
        for j, q in enumerate((p, *twins)):
            states[j], _ = q.push(states[j], chunk)
            torch.cuda.synchronize()
        assert lib.launches[ring_kernel.KERNEL] == before + 1
        got, same, plain = (st.ring for st in states)
        assert torch.equal(got.view(torch.int16), same.view(torch.int16)), i
        assert testing.bf16_ulps(got.cpu(), plain.cpu(), ATOL) <= 1
        assert {int(st.cursor) for st in states} == {((i + 1) * 8) % 16}


# ------------------------------------- the long-window serving deployment

# serve-long48k's geometry (portbench/configs/serve-long48k.json): 48 kHz,
# W = 32,768, N = 65,536, hop 800, H = 1,024
LONG = SpectrogramConfig(sample_rate=48000.0, window_period=32768 / 48000,
                         hop_period=800 / 48000, viewport_height=1024)


def _long_words(rows: int, device) -> tuple:
    """[rows, W] int16 window planes of the long window: a tone a row and
    noise, seeded, made on the card."""
    g = torch.Generator(device=device).manual_seed(23)
    w = LONG.window_size
    t = torch.arange(w, device=device, dtype=torch.float32) / LONG.sample_rate
    out = []
    for c in range(2):
        f = 40.0 + 20000.0 * torch.rand((rows, 1), generator=g, device=device)
        x = 0.5 * torch.sin(2 * np.pi * f * t + c) + 0.01 * torch.randn(
            (rows, w), generator=g, device=device)
        out.append(torch.round(torch.clamp(x, -1, 1) * 32767).to(torch.int16))
    return tuple(out)


def test_long_window_route_at_one_2gib_group(cuda, monkeypatch):
    """The packed int16 large-N route at N = 65,536 over 4,096 rows, the
    long-window cell's push: one row group whose scratch is exactly
    LARGE_SCRATCH_BYTES (2 GiB).  Its rows equal bit for bit the same rows
    launched as two groups of 2,048 and the f32 route's on x / 32768, and
    lie within the STFT bar of the plain version."""
    n, w, rows = LONG.padded_size, LONG.window_size, 4096
    assert sk.is_large(n)
    assert sk.large_grouping(n, rows) == (rows, 1, sk.LARGE_SCRATCH_BYTES)
    consts = sk.fft_constants(n, cuda)
    left, right = _long_words(rows, cuda)
    hann16 = torch.from_numpy(sk.packed_hann_i16(w)).to(cuda)
    lib = _build.library()
    before = lib.launches[sk.LARGE_KERNEL_I16]
    one = sk.stft_mag_packed(left, right, hann16, consts)
    torch.cuda.synchronize()
    assert lib.launches[sk.LARGE_KERNEL_I16] == before + 1
    monkeypatch.setattr(sk, "LARGE_SCRATCH_BYTES", sk.LARGE_SCRATCH_BYTES // 2)
    assert sk.large_grouping(n, rows) == (rows // 2, 2, sk.LARGE_SCRATCH_BYTES)
    two = sk.stft_mag_packed(left, right, hann16, consts)
    torch.cuda.synchronize()
    assert lib.launches[sk.LARGE_KERNEL_I16] == before + 3
    monkeypatch.undo()
    for a, b in zip(one, two):
        assert a.shape == (rows, n // 2) and torch.equal(a, b)
    hann = torch.from_numpy(sk.packed_hann(w)).to(cuda)
    f32 = [x.to(torch.float32) / 32768.0 for x in (left, right)]
    for a, b in zip(one, sk.stft_mag_packed(*f32, hann, consts)):
        assert torch.equal(a, b)
    del two
    for r0 in range(0, rows, 1024):       # the plain version a block at a time
        plain = sk.stft_mag_packed_plain(f32[0][r0:r0 + 1024], f32[1][r0:r0 + 1024], hann, n)
        for a, b in zip(one, plain):
            torch.testing.assert_close(a[r0:r0 + 1024], b, atol=ATOL, rtol=RTOL)


def _long_serving_pipeline(device, s: int):
    p = SpectrogramPipeline(LONG, device=device, chunk_hops=1, store_ring=False,
                            packed_output=True, i16_planes=True, presorted_input=True,
                            sorted_output=True)
    return p, p.set_palette(p.init_state(s), np.arange(s) % 2)


def test_long_window_serving_push_counts_the_route(cuda):
    """Serving pushes at the long window (64 streams, sorted into two
    palettes) on the card: one "push.stft_large" and one row group a push,
    `last_stft` as `large_grouping` gives it, the `spk.stft.large` span
    inside `spk.stft` with no range mirrored onto the device's timeline, and
    rows within 1 u8 of the plain twin's, the next carry exact."""
    from torch.profiler import ProfilerActivity, profile

    s = 64
    p, state = _long_serving_pipeline(cuda, s)
    twin = p.with_plain_kernels()
    assert p._state_perm(state) is not None
    left, right = _long_words(s, cuda)
    chunks = [torch.stack([left, right], 1)[..., i * 800:(i + 1) * 800].contiguous()
              for i in range(3)]
    st_k, st_p = state, state
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for c in chunks:
            st_k, rows = p.push_planar(st_k, c)
            st_p, plain = twin.push_planar(st_p, c)
        torch.cuda.synchronize()
    assert p.counters["push.stft_large"] == 3 and p.counters["stft.large_groups"] == 3
    assert p.last_stft == {"route": "large", "n_fft": 65536, "rows": s, "groups": 1,
                           "scratch_bytes": sk.large_grouping(65536, s)[2]}
    assert twin.last_stft["route"] == "plain" and "push.stft_large" not in twin.counters
    assert testing.rgba_u8_diff(ck.unpack_rgba(rows), ck.unpack_rgba(plain)) <= 1
    torch.testing.assert_close(st_k.carry, st_p.carry, atol=0, rtol=0)
    spans = [e for e in prof.events() if e.name == "spk.stft.large"]
    assert len(spans) == 3
    for e in spans:
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith("spk."):
            parent = parent.cpu_parent
        assert parent is not None and parent.name == "spk.stft"
    kineto = prof.profiler.kineto_results.events()
    assert not [k.name() for k in kineto
                if k.device_type() != torch.autograd.DeviceType.CPU
                and k.name().startswith("spk.")]
    assert [k for k in kineto if k.device_type() == torch.autograd.DeviceType.CUDA
            and "large_load_local_kernel" in k.name()]
