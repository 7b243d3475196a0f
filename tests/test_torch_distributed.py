"""The port's multi-process serving (`parallel/distributed.py`), on the CPU.

Ports `tests/test_distributed.py`.  Its two-process test runs here as two
gloo ranks on `device="cpu"` (`tests/torch_ranks.py`, group "distributed",
started once for this file over a `file://` rendezvous): each rank feeds
its own streams' tones into its `HostShardIngest`, pushes its slice and
all-reduces the row count.  The single-process tests run in this process
on a world-size-1 mesh.  The bars: the ranks' rows equal the port's
unsharded pipeline's on the same samples bit for bit and lie within 1 u8
of the JAX pipeline's; row counts, stream ranges and drop counts exact.
Then `initialize`'s idempotence and backend check, and the dry run
(`python -m spectrogram_tpu_torch.parallel.dryrun --ranks 2 --device cpu`).
"""

import json
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectrogram_tpu.config as jcfg
from spectrogram_tpu.models.spectrogram import SpectrogramPipeline as JaxPipeline

import torch_ranks as tr
from spectrogram_tpu_torch import testing
from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline
from spectrogram_tpu_torch.ops.cuda.colormap_kernel import unpack_rgba
from spectrogram_tpu_torch.parallel import distributed as pdist

REPO = pathlib.Path(__file__).resolve().parents[1]
DRYRUN_TIMEOUT_S = 240

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return tr.spawn("distributed", tmp_path_factory.mktemp("distributed_ranks"))


@pytest.fixture(scope="module")
def mesh():
    """A world-size-1 mesh in this process, on the CPU."""
    return pdist.global_mesh(device="cpu")


def test_two_ranks_end_to_end_with_host_shard_ingest(ranks):
    s_n = 8 * tr.WORLD
    p = SpectrogramPipeline(tr.DIST_CFG, chunk_hops=2, packed_output=True, device="cpu")
    pcm = tr.tones(0, s_n, p.chunk_size, tr.DIST_CFG.sample_rate).astype(np.float32) / 32768.0
    _, want = p.push(p.init_state(s_n), torch.from_numpy(pcm))
    jp = JaxPipeline(jcfg.SpectrogramConfig(**tr.DIST_KW), chunk_hops=2, packed_output=True)
    _, jrows = jp.push(jp.init_state(s_n), jnp.asarray(pcm))
    for r in range(tr.WORLD):
        got = tr.result(ranks, "end_to_end", r)
        assert int(got["global_rows"]) == s_n * 2
        # each rank holds exactly its own streams' rows, and they show tones
        assert tuple(got["range"]) == (8 * r, 8 * (r + 1))
        np.testing.assert_array_equal(got["local_rows"], want[8 * r : 8 * (r + 1)].numpy())
        assert int(got["unique"]) > 4
        m = json.loads(str(got["metrics"]))
        assert m["process"] == r and m["dropped"] == 0 and tuple(m["streams"]) == (8 * r, 8 * (r + 1))
        np.testing.assert_array_equal(got["rows"], want.numpy())
    assert testing.rgba_u8_diff(unpack_rgba(got["rows"]), unpack_rgba(np.asarray(jrows))) <= 1


def test_initialize_is_idempotent(ranks):
    """A second initialize is a no-op whatever it asks; a backend that
    cannot serve the device raises, and is never swapped for another."""
    for r in range(tr.WORLD):
        got = tr.result(ranks, "initialize_again", r)
        assert int(got["world"]) == tr.WORLD and bool(got["same_group"])
        assert "cannot serve device cpu" in str(got["nccl"])


def test_local_stream_range_single_process(mesh, ranks):
    """In a single-process session the local range is the whole batch; over
    two ranks a stream count they cannot split evenly is rejected loudly."""
    n_dev = mesh.size()
    assert pdist.local_stream_range(mesh, 2 * n_dev) == (0, 2 * n_dev)
    for r in range(tr.WORLD):
        got = tr.result(ranks, "end_to_end", r)
        assert "17 streams not divisible by 2 devices" in str(got["not_divisible"])


def test_make_global_chunk_single_process(mesh):
    n = 2 * mesh.size()
    local = np.arange(n * 3 * 2, dtype=np.float32).reshape(n, 3, 2)
    got = pdist.make_global_chunk(mesh, local, n)
    assert got.device == torch.device("cpu") and tuple(got.shape) == (n, 3, 2)
    np.testing.assert_array_equal(got.numpy(), local)
    view = pdist.make_global_chunk(mesh, local, n, global_view=True)
    assert tuple(view.shape) == (n, 3, 2)
    np.testing.assert_array_equal(view.full_tensor().numpy(), local)
    with pytest.raises(ValueError, match="owns"):
        pdist.make_global_chunk(mesh, local[:1], n)


def test_host_shard_ingest_single_process(mesh):
    """HostShardIngest drains the rank's bank into its chunk (single
    process: the rank's slice is the whole batch), as f32 frames and as
    int16 planes, presorted by `dest`."""
    n = 2 * mesh.size()
    rng = np.random.default_rng(0)
    ingest = pdist.HostShardIngest(mesh, n, chunk_size=64, capacity=256)
    assert ingest.local_streams == n
    pcm = rng.integers(-20000, 20000, (n, 64, 2)).astype(np.int16)
    for s in range(n):
        ingest.bank.push(s, pcm[s])
    chunk = ingest.drain()
    assert tuple(chunk.shape) == (n, 64, 2)
    np.testing.assert_allclose(chunk.numpy(), pcm.astype(np.float32) / 32768.0)
    # underrun after drain: zero-fill, no crash
    np.testing.assert_array_equal(ingest.drain().numpy(), 0.0)
    m = ingest.metrics()
    assert m["streams"] == (0, n) and m["dropped"] == 0 and m["process"] == 0

    words = pdist.HostShardIngest(mesh, n, chunk_size=64, capacity=256, wire_int16=True)
    for s in range(n):
        words.bank.push(s, pcm[s])
    dest = np.arange(n, dtype=np.uint64)[::-1].copy()
    planes = words.drain(dest=dest)
    assert planes.dtype == torch.int16
    np.testing.assert_array_equal(planes.numpy(), pcm[::-1].transpose(0, 2, 1))


def test_dryrun_two_ranks():
    out = subprocess.run(
        [sys.executable, "-m", "spectrogram_tpu_torch.parallel.dryrun", "--ranks", "2",
         "--device", "cpu", "--timeout", str(DRYRUN_TIMEOUT_S - 20)],
        capture_output=True, text=True, timeout=DRYRUN_TIMEOUT_S, cwd=REPO,
    )
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    assert "dryrun OK: 2 ranks (gloo, cpu)" in out.stdout, out.stdout
