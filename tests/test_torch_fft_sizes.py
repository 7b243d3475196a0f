"""Every FFT size, pad_factor=1 and JAX's backend arguments, on the CPU.

The port's pipeline against the JAX package's default pipeline (its CPU
backends: the matrix-unit FFT where a usable plan exists, else `jnp.fft`,
and the XLA colormap) at the geometries the port used to refuse: 44.1 kHz
at the reference's 0.05 s window (W=2205, N=4410 = 2 3^2 5 7^2), 22.05 kHz
(N=2204 = 2^2 19 29), the multirate test's 44.1 kHz group (N=1410 = 2 3 5
47), an odd N (W=231, pad 3: N=693), pad_factor=1 at BENCH_CONFIG's window
(N=2048) and at W=256, and the ten seeds of
tests/test_fuzz_geometries.py's `_random_cfg` (odd N, N under 256, prime
factors above 5, pad 1 to 3).  Each case starts both pipelines from one JAX
state (`convert.state_from_jax`) and pushes the same chunks.  The bars: the
next carry exactly equal; rows within 1 u8 over what the image shows
(`testing.rgba_u8_diff`); the ring within 1 bf16 ulp beyond 3e-5; the port's
streamed rows equal to its `process()` exactly; and the port's state, carried
back into JAX, pushes on to the port's rows within 1 u8.

Then the four constructor arguments JAX has (`stft_backend`,
`colormap_backend`, `kernel_interpret`, `autotune`): accepted, and
validated as JAX validates them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectrogram_tpu.config as jcfg
from spectrogram_tpu.models.spectrogram import SpectrogramPipeline as JaxPipeline
from spectrogram_tpu.models.spectrogram import StreamState as JaxState

from spectrogram_tpu_torch import testing
from spectrogram_tpu_torch.config import SpectrogramConfig
from spectrogram_tpu_torch.models.convert import state_from_jax, state_to_numpy
from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline
from spectrogram_tpu_torch.ops.cuda import stft_kernel as tsk

torch.set_num_threads(2)

RING_ATOL = 3e-5
SMALL = dict(sample_rate=8000.0, window_period=0.032, hop_period=0.008,
             viewport_height=64, viewport_rows=16, max_frequency=3600.0)
BENCH_WIDTH = dict(sample_rate=48000.0, window_period=2048 / 48000.0,
                   hop_period=800 / 48000.0)
# name: (config, chunk_hops, streams, pushes)
GEOMETRIES = {
    "44k1_n4410": (dict(sample_rate=44100.0, viewport_rows=16), 8, 2, 2),
    "22k05_n2204": (dict(sample_rate=22050.0, viewport_rows=16), 1, 3, 3),
    "44k1_n1410": (dict(sample_rate=44100.0, window_period=0.016, hop_period=0.006,
                        viewport_rows=16), 2, 3, 2),
    "odd_n693": (dict(sample_rate=8000.0, window_period=231 / 8000.0,
                      hop_period=64 / 8000.0, pad_factor=3, viewport_height=100,
                      viewport_rows=16, max_frequency=3600.0), 3, 3, 2),
    "pad1_bench_width": (dict(BENCH_WIDTH, pad_factor=1, viewport_rows=8), 1, 3, 2),
    "pad1_small": (dict(SMALL, pad_factor=1), 2, 4, 3),
}
IDS = np.array([0, 1, 3, 8])            # stereo, mono, stereo, mono


def _np_state(state) -> dict:
    d = {k: np.asarray(v) for k, v in state._asdict().items() if k != "tables"}
    d["tables"] = tuple(np.asarray(t) for t in state.tables)
    return d


def _jax_state(d: dict) -> JaxState:
    return JaxState(
        carry=jnp.asarray(d["carry"]),
        ring=jnp.asarray(d["ring"]).astype(jnp.bfloat16),
        cursor=jnp.asarray(d["cursor"]), palette_id=jnp.asarray(d["palette_id"]),
        row_count=jnp.asarray(d["row_count"]),
        tables=tuple(jnp.asarray(t) for t in d["tables"]),
    )


def _check_against_jax(kw: dict, k: int, pcm: np.ndarray, carry: np.ndarray):
    """Push pcm [S, T, 2] through both pipelines from the JAX state with
    this [S, 2, C] carry; the bars of the module docstring."""
    tc, jc = SpectrogramConfig(**kw), jcfg.SpectrogramConfig(**kw)
    jp = JaxPipeline(jc, chunk_hops=k)
    tp = SpectrogramPipeline(tc, chunk_hops=k, device="cpu")
    s = pcm.shape[0]
    ids = IDS[np.arange(s) % len(IDS)]
    js = jp.set_palette(jp.init_state(s), ids)
    js = js._replace(carry=jnp.asarray(carry))
    ts = state_from_jax(_np_state(js), device="cpu")
    t = tp.chunk_size
    n = pcm.shape[1] // t - 1            # the last chunk goes to the carried-back state
    trows = []
    for i in range(n):
        chunk = pcm[:, i * t : (i + 1) * t]
        js, jr = jp.push(js, jnp.asarray(chunk))
        ts, tr = tp.push(ts, torch.from_numpy(chunk))
        np.testing.assert_array_equal(ts.carry.numpy(), np.asarray(js.carry))
        assert tr.shape == (s, k, tc.viewport_height, 4)
        assert testing.rgba_u8_diff(tr.numpy(), np.asarray(jr)) <= 1
        trows.append(tr)
    assert testing.bf16_ulps(ts.ring, np.asarray(js.ring.astype(jnp.float32)),
                             RING_ATOL) <= 1
    # streamed == process() on the same samples (the carry, then the pushes)
    streamed = torch.cat(trows, dim=1)
    padded = np.concatenate([carry.transpose(0, 2, 1), pcm[:, : n * t]], axis=1)
    for pid in np.unique(ids):
        sel = np.flatnonzero(ids == pid)
        one = tp.process(torch.from_numpy(np.ascontiguousarray(padded[sel])),
                         palette_id=int(pid))
        torch.testing.assert_close(one, streamed[sel], atol=0, rtol=0)
    # the port's state carried back into JAX pushes on as the port does
    chunk = pcm[:, n * t :]
    js_back = _jax_state(state_to_numpy(ts))
    _, jr = jp.push(js_back, jnp.asarray(chunk))
    ts, tr = tp.push(ts, torch.from_numpy(chunk))
    assert testing.rgba_u8_diff(tr.numpy(), np.asarray(jr)) <= 1
    assert tp.render_viewport(ts).shape == (s, tp.viewport_rows, tc.viewport_height, 4)
    return tp


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_geometry_matches_jax(name):
    kw, k, s, pushes = GEOMETRIES[name]
    cfg = SpectrogramConfig(**kw)
    c = tsk.carry_len(cfg.window_size, cfg.hop_size)
    pcm = testing.chirp_tone(s, (pushes + 1) * k * cfg.hop_size, cfg.sample_rate, seed=4)
    carry = testing.make("noise", s, c, cfg.sample_rate, seed=5).transpose(0, 2, 1)
    tp = _check_against_jax(kw, k, pcm, np.ascontiguousarray(carry))
    if cfg.pad_factor == 1:
        # the planes hold bins 0 .. W-1: the colormap's taps and the ring's
        # bins 1 .. W-1 pass N/2 there
        assert tsk.stft_bins(cfg.padded_size, cfg.window_size) == cfg.window_size
        assert tp.taps.bins == cfg.window_size > cfg.padded_size // 2


def _random_cfg(rng) -> dict:
    """tests/test_fuzz_geometries.py's `_random_cfg`, as keyword arguments."""
    fs = float(rng.choice([8000, 11025, 16000, 22050, 44100, 48000]))
    # window 96..~700 samples (CPU-testable), any parity/factorization
    window = int(rng.integers(96, 700))
    hop = int(rng.integers(16, max(window // 2, 17)))
    return dict(
        sample_rate=fs,
        window_period=window / fs,
        hop_period=hop / fs,
        pad_factor=int(rng.choice([1, 2, 3])),
        viewport_height=int(rng.choice([64, 100, 128])),
        viewport_rows=16,
        max_frequency=min(fs / 2 - 50.0, 22030.0),
    )


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_geometry_matches_jax(seed):
    """The JAX fuzz's draws (config, chunk_hops, PCM), on the port and on
    JAX, from JAX's fresh state."""
    rng = np.random.default_rng(1000 + seed)
    kw = _random_cfg(rng)
    cfg = SpectrogramConfig(**kw)
    cfg.validate()
    k = int(rng.choice([1, 2, 3]))
    chunk = k * cfg.hop_size
    pcm = rng.standard_normal((2, chunk * 3, 2)).astype(np.float32) * 0.3
    carry = np.zeros((2, 2, tsk.carry_len(cfg.window_size, cfg.hop_size)), np.float32)
    _check_against_jax(kw, k, pcm, carry)


# ------------------------------------------------- JAX's backend arguments

def test_backend_arguments_take_jax_defaults_and_values():
    """Every value JAX takes is accepted; "xla" (JAX's golden path) runs the
    plain versions, which on the CPU are what every backend runs, and
    `kernel_interpret` and `autotune` change nothing."""
    cfg = SpectrogramConfig(**SMALL)
    pcm = testing.chirp_tone(2, 2 * cfg.hop_size, cfg.sample_rate, seed=6)
    base = SpectrogramPipeline(cfg, chunk_hops=2, device="cpu")
    _, want = base.push(base.init_state(2), torch.from_numpy(pcm))
    for stft_backend in ("auto", "mxu", "xla", "pallas"):
        for colormap_backend in ("auto", "pallas", "xla"):
            p = SpectrogramPipeline(cfg, chunk_hops=2, stft_backend=stft_backend,
                                    colormap_backend=colormap_backend,
                                    kernel_interpret=True, autotune=True, device="cpu")
            assert (p.stft_backend, p.colormap_backend) == (stft_backend, colormap_backend)
            _, got = p.push(p.init_state(2), torch.from_numpy(pcm))
            torch.testing.assert_close(got, want, atol=0, rtol=0)
    jax_p = JaxPipeline(jcfg.SpectrogramConfig(**SMALL), chunk_hops=2)
    assert not base.kernel_interpret and not base.autotune
    assert not jax_p.kernel_interpret


@pytest.mark.parametrize("kw,match", [
    (dict(stft_backend="cuda"), "unknown stft_backend"),
    (dict(colormap_backend="triton"), "unknown colormap_backend"),
    # an unusable plan for the matrix-unit backends: pad_factor 1, odd n1
    (dict(stft_backend="mxu", pad_factor=1), "stft_backend"),
    (dict(stft_backend="pallas", pad_factor=1), "stft_backend"),
    (dict(stft_backend="mxu", sample_rate=9000.0, window_period=0.025,
          hop_period=0.0125), "stft_backend"),
    (dict(stft_backend="pallas", sample_rate=9000.0, window_period=0.025,
          hop_period=0.0125), "stft_backend"),
    # the layout knobs need the Pallas chain: not under "xla" or "mxu"
    (dict(stft_backend="xla", transposed_carry=True), "transposed_carry"),
    (dict(stft_backend="mxu", transposed_carry=True), "transposed_carry"),
    (dict(stft_backend="xla", stft_packed=True), "stft_packed"),
    (dict(stft_backend="mxu", chunk_hops=1, framing="tsplit"), "tsplit"),
])
def test_backend_arguments_refused_as_in_jax(kw, match):
    kw = dict(kw)
    geo = {name: kw.pop(name) for name in ("pad_factor", "sample_rate", "window_period",
                                           "hop_period") if name in kw}
    cfg_kw = dict(SMALL, **geo)
    with pytest.raises(ValueError, match=match):
        JaxPipeline(jcfg.SpectrogramConfig(**cfg_kw), **kw)
    with pytest.raises(ValueError, match=match):
        SpectrogramPipeline(SpectrogramConfig(**cfg_kw), device="cpu", **kw)


def test_knobs_accepted_on_the_pallas_backend():
    """Under "pallas" (and "auto") the knobs keep the Pallas chain's gates,
    as the port's default always had."""
    cfg = SpectrogramConfig(**SMALL)
    jc = jcfg.SpectrogramConfig(**SMALL)
    for kw in (dict(transposed_carry=True), dict(stft_packed=False)):
        JaxPipeline(jc, stft_backend="pallas", kernel_interpret=True, **kw)
        for backend in ("pallas", "auto"):
            SpectrogramPipeline(cfg, stft_backend=backend, device="cpu", **kw)
