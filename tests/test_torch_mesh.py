"""The port's stream mesh (`parallel/mesh.py`) against the JAX package's, on the CPU.

Ports `tests/test_sharding.py`.  The port side runs in two gloo ranks on
`device="cpu"` (`tests/torch_ranks.py`, group "mesh", started once for
this file); each rank holds its slice of the batch and gathers what the
checks read.  The JAX side runs here, on the virtual CPU devices of
`tests/conftest.py`: a 4-device mesh where the shard count changes nothing,
and a 2-device mesh (the port's rank count) wherever the per-shard palette
sort is decided, with its Pallas chain in interpret mode there, as its own
tests run it.  The inputs are the same numpy seeds (`torch_ranks.pcm`).
The bars:

  * the port's sharded rows, ring and carry equal the port's unsharded
    pipeline's bit for bit (on the CPU both run the plain versions at the
    same batch per call, so nothing changes their bits);
  * rows within 1 u8 of JAX's sharded rows (`testing.rgba_u8_diff`), rings
    within 1 bf16 ulp; cursors, carries' order and global row counts exact;
  * the per-shard sort is taken exactly where JAX takes it, and its perm
    and inv equal JAX's less the shard offset.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectrogram_tpu.config as jcfg
from spectrogram_tpu.models.spectrogram import SpectrogramPipeline as JaxPipeline
from spectrogram_tpu.parallel import mesh as jmesh

import torch_ranks as tr
from spectrogram_tpu_torch import testing
from spectrogram_tpu_torch.models.spectrogram import SpectrogramPipeline
from spectrogram_tpu_torch.ops.cuda.colormap_kernel import unpack_rgba

torch.set_num_threads(2)

JCFG = jcfg.SpectrogramConfig(**tr.CFG_KW)
JAX_KERNELS = dict(stft_backend="pallas", colormap_backend="pallas", kernel_interpret=True)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return tr.spawn("mesh", tmp_path_factory.mktemp("mesh_ranks"))


def _port(**kw):
    return SpectrogramPipeline(tr.CFG, device="cpu", **kw)


def _t(x):
    return torch.from_numpy(x)


def _close(port_rows, jax_rows, packed=False):
    jax_rows = np.asarray(jax_rows)
    if packed:
        port_rows, jax_rows = unpack_rgba(port_rows), unpack_rgba(jax_rows)
    assert port_rows.shape == jax_rows.shape
    assert testing.rgba_u8_diff(port_rows, jax_rows) <= 1


def _jax_put(m, x):
    return jax.device_put(jnp.asarray(x), jmesh.chunk_sharding(m))


def test_mesh_is_one_dimensional_over_the_ranks(ranks):
    for r in range(tr.WORLD):
        got = tr.result(ranks, "mesh_info", r)
        assert int(got["size"]) == tr.WORLD and str(got["names"]) == "streams"
        assert tuple(got["range"]) == (8 * r, 8 * (r + 1))
        assert str(got["device"]) == "cpu"


def test_sharded_push_matches_single_device(ranks):
    got = tr.result(ranks, "sharded_vs_single")
    p = _port(chunk_hops=4)
    pcm = tr.pcm(1, 16, p.chunk_size)
    s0, want = p.push(p.init_state(16), _t(pcm))
    np.testing.assert_array_equal(got["rows"], want.numpy())
    np.testing.assert_array_equal(got["carry"], s0.carry.numpy())
    assert int(got["cursor"]) == int(s0.cursor)
    # the ring stays split over streams: 8 a rank
    assert tuple(got["ring_shape"]) == (8, p.viewport_rows, 2, tr.CFG.num_bins)

    jp = JaxPipeline(JCFG, chunk_hops=4)
    m = jmesh.make_mesh(4)
    js, jrows = jmesh.sharded_push(jp, m)(jmesh.shard_state(jp.init_state(16), m),
                                          _jax_put(m, pcm))
    _close(got["rows"], jrows)
    np.testing.assert_array_equal(got["carry"], np.asarray(js.carry))
    assert int(got["cursor"]) == int(js.cursor)


def test_shard_map_step_global_rows(ranks):
    got = tr.result(ranks, "global_rows")
    # 8 streams over 2 ranks, 4 hops each
    assert int(got["global_rows"]) == 8 * 4
    assert tuple(got["rows_shape"]) == (4, 4, tr.CFG.viewport_height, 4)
    assert json.loads(str(got["metrics"])) == {"streams": 8, "rows_produced": 4, "cursor": 4}
    jp = JaxPipeline(JCFG, chunk_hops=4)
    m = jmesh.make_mesh(4)
    js, _, jrows = jmesh.shard_map_step(jp, m)(
        jmesh.shard_state(jp.init_state(8), m), _jax_put(m, tr.pcm(2, 8, jp.chunk_size)))
    assert int(jrows) == int(got["global_rows"])
    assert jmesh.global_metrics(js) == json.loads(str(got["metrics"]))


def test_multi_push_sharded_ring_render(ranks):
    got = tr.result(ranks, "ring_render")
    p = _port(chunk_hops=4)
    s = p.init_state(8)
    chunks = [tr.pcm(10 + i, 8, p.chunk_size) for i in range(3)]
    for c in chunks:
        s, _ = p.push(s, _t(c))
    np.testing.assert_array_equal(got["viewport"], p.render_viewport(s).numpy())
    np.testing.assert_array_equal(got["ring"], s.ring.float().numpy())

    jp = JaxPipeline(JCFG, chunk_hops=4)
    m = jmesh.make_mesh(4)
    step = jmesh.sharded_push(jp, m)
    js = jmesh.shard_state(jp.init_state(8), m)
    for c in chunks:
        js, _ = step(js, _jax_put(m, c))
    assert got["viewport"].shape == (8, p.viewport_rows, tr.CFG.viewport_height, 4)
    _close(got["viewport"], jp.render_viewport(js))
    assert testing.bf16_ulps(got["ring"], np.asarray(js.ring.astype(jnp.float32)), 3e-5) <= 1
    assert int(got["cursor"]) == int(js.cursor)


def test_sharded_push_packed_output(ranks):
    got = tr.result(ranks, "packed")
    p = _port(chunk_hops=4, store_ring=False, packed_output=True)
    pcm = tr.pcm(3, 8, p.chunk_size)
    _, want = p.push(p.init_state(8), _t(pcm))
    assert str(got["dtype"]) == "torch.int32"
    assert got["rows"].shape == (8, 4, tr.CFG.viewport_height)
    np.testing.assert_array_equal(got["rows"], want.numpy())
    np.testing.assert_array_equal(got["rows2"], want.numpy())
    assert int(got["global_rows"]) == 8 * 4
    jp = JaxPipeline(JCFG, chunk_hops=4, store_ring=False, packed_output=True)
    m = jmesh.make_mesh(4)
    _, jrows = jmesh.sharded_push(jp, m)(jmesh.shard_state(jp.init_state(8), m),
                                         _jax_put(m, pcm))
    _close(got["rows"], jrows, packed=True)


def test_kernel_chain_under_the_mesh(ranks):
    """JAX's fused Pallas chain (interpret) under shard_map beside the
    port's kernel chain (its plain versions on the CPU) over two ranks."""
    got = tr.result(ranks, "chain")
    p = _port(chunk_hops=4, packed_output=True)
    pcm = tr.pcm(4, 16, p.chunk_size, 0.3)
    s0, want = p.push(p.init_state(16), _t(pcm))
    np.testing.assert_array_equal(got["rows"], want.numpy())
    np.testing.assert_array_equal(got["ring"], s0.ring.float().numpy())
    assert int(got["global_rows"]) == 16 * 4

    jp = JaxPipeline(JCFG, chunk_hops=4, packed_output=True, **JAX_KERNELS)
    m = jmesh.make_mesh(4)
    js, jrows, jg = jmesh.shard_map_step(jp, m)(jmesh.sharded_init(jp, 16, m), _jax_put(m, pcm))
    assert int(jg) == int(got["global_rows"])
    _close(got["rows"], jrows, packed=True)
    assert testing.bf16_ulps(got["ring"], np.asarray(js.ring.astype(jnp.float32)), 3e-5) <= 1


def test_shard_state_unsorts_palette_sorted_states(ranks):
    """A block-relative sorted state: refused without the pipeline, unsorted
    with it; at 128 streams a shard the per-shard sort is refused as in
    JAX, and stays refused after set_palette on the sharded state."""
    got = tr.result(ranks, "unsorts")
    assert bool(got["whole_sorted"])
    assert "palette-sorted" in str(got["refused"])
    p_pr = _port(palette_sort=False, blockwise_palettes=False, **tr.STREAM_KW)
    ids = tr.alternating(256)
    pcm = tr.pcm(5, 256, p_pr.chunk_size)
    _, want = p_pr.push(p_pr.set_palette(p_pr.init_state(256), ids), _t(pcm))
    np.testing.assert_array_equal(got["rows"], want.numpy())

    jp = JaxPipeline(JCFG, **tr.STREAM_KW, **JAX_KERNELS)
    m = jmesh.make_mesh(2)
    js = jp.set_palette(jp.init_state(256), ids)
    with pytest.raises(ValueError, match="palette-sorted"):
        jmesh.shard_state(js, m)
    jsh = jmesh.shard_state(js, m, jp)
    assert bool(got["sharded_sorted"]) == (jp._state_perm(jsh) is not None)
    _, jrows = jax.jit(jp.push_impl)(js, jnp.asarray(pcm))
    _close(got["rows"], jrows, packed=True)
    jsh2 = jp.set_palette(jsh, jnp.asarray(ids))
    assert bool(got["resorted"]) == (jp._state_perm(jsh2) is not None)


def test_shard_state_resorts_per_shard(ranks):
    """The per-shard sort at 256 streams a shard: taken as in JAX, perm and
    inv JAX's less the shard offset, the carry at rest in each slice's
    sorted order; pushes, a per-stream and a scalar set_palette and
    unsort_state equal the per-row pipeline bit for bit."""
    s_n = tr.SORT_STREAMS
    ids, ids2 = tr.alternating(s_n), tr.alternating(s_n, 1)
    p_pr = _port(palette_sort=False, blockwise_palettes=False, **tr.STREAM_KW)
    pcm, pcm2 = tr.pcm(6, s_n, p_pr.chunk_size), tr.pcm(7, s_n, p_pr.chunk_size)
    s_pr = p_pr.set_palette(p_pr.init_state(s_n), ids)
    _, want = p_pr.push(s_pr, _t(pcm))

    jp = JaxPipeline(JCFG, **tr.STREAM_KW, **JAX_KERNELS)
    m = jmesh.make_mesh(2)
    jsh = jmesh.shard_state(jp.set_palette(jp.init_state(s_n), ids), m, jp)
    jperm, jinv = np.asarray(jsh.tables[1]), np.asarray(jsh.tables[2])
    per = s_n // tr.WORLD
    for r in range(tr.WORLD):
        got = tr.result(ranks, "resorts", r)
        assert bool(got["is_global"]) and jp._tables_perm_global(jsh.tables)
        lo = r * per
        np.testing.assert_array_equal(got["perm"], jperm[lo:lo + per] - lo)
        np.testing.assert_array_equal(got["inv"], jinv[lo:lo + per] - lo)
        np.testing.assert_array_equal(got["carry_at_rest"][got["inv"]],
                                      s_pr.carry[lo:lo + per].numpy())
    got = tr.result(ranks, "resorts")
    assert int(got["global_rows"]) == s_n
    np.testing.assert_array_equal(got["rows"], want.numpy())
    _, jrows, _ = jmesh.shard_map_step(jp, m, state=jsh)(jsh, _jax_put(m, pcm))
    _close(got["rows"], jrows, packed=True)

    # a per-stream set_palette on the sharded state sorts per shard again
    assert bool(got["resorted"])
    s_pr_adv, _ = p_pr.push(s_pr, _t(pcm))
    s_pr2 = p_pr.set_palette(s_pr_adv, ids2)
    _, want2 = p_pr.push(s_pr2, _t(pcm2))
    np.testing.assert_array_equal(got["rows4"], want2.numpy())
    # to one palette: unsorted, the carry back in external order
    assert not bool(got["uniform_sorted"])
    s_pr3 = p_pr.set_palette(s_pr2, np.full(s_n, 3, np.int32))
    np.testing.assert_array_equal(got["uniform_carry"], s_pr3.carry.numpy())
    assert bool(got["unsort_is_plain"])
    np.testing.assert_array_equal(got["unsorted_carry"], s_pr2.carry.numpy())


def test_whole_state_global_sort_refuses_shard_specs(ranks):
    got = tr.result(ranks, "global_sort_refuses")
    jp = JaxPipeline(JCFG, stream_blocks=128, **tr.STREAM_KW, **JAX_KERNELS)
    s_n = tr.SORT_STREAMS
    js = jp.set_palette(jp.init_state(s_n), tr.alternating(s_n))
    assert bool(got["whole_global"]) and jp._tables_perm_global(js.tables)
    np.testing.assert_array_equal(got["whole_perm"], np.asarray(js.tables[1]))
    assert got["whole_perm"][: s_n // 2].max() >= s_n // 2   # crosses the slices
    assert not bool(got["whole_confined"])
    assert "palette-sorted" in str(got["specs_refused"])
    assert "palette-sorted" in str(got["shard_refused"])
    assert bool(got["sharded_global"]) and bool(got["confined"])
    m = jmesh.make_mesh(2)
    with pytest.raises(ValueError, match="palette-sorted"):
        jmesh.shard_map_step(jp, m, state=js)
    jsh = jmesh.shard_state(js, m, jp)
    assert jmesh._perm_shard_confined(jsh.tables[1], 2)


def test_per_shard_sorted_checkpoint_roundtrip(ranks, tmp_path):
    """npz of a per-shard sorted state (gathered to rank 0 in external
    order): restored in one process it takes the single-process sorted
    class, re-sharded the per-shard form, and the JAX package reads the
    file too; pushes equal the per-row pipeline's."""
    from spectrogram_tpu.utils.checkpoint import load_state as jax_load
    from spectrogram_tpu_torch.utils.checkpoint import load_state

    got = tr.result(ranks, "sorted_npz_roundtrip")
    s_n = tr.SORT_STREAMS
    p = _port(**tr.STREAM_KW)
    p_pr = _port(palette_sort=False, blockwise_palettes=False, **tr.STREAM_KW)
    pcm = tr.pcm(8, s_n, p.chunk_size)
    _, want = p_pr.push(p_pr.set_palette(p_pr.init_state(s_n), tr.alternating(s_n)), _t(pcm))
    assert bool(got["restored_sorted"]) and bool(got["confined"])
    np.testing.assert_array_equal(got["rows"], want.numpy())
    path = ranks["out"] / "sorted_ck.npz"
    r = load_state(path, p)
    assert p.palette_layout.read(r.tables).sorted
    np.testing.assert_array_equal(p.push(r, _t(pcm))[1].numpy(), want.numpy())
    jp = JaxPipeline(JCFG, **tr.STREAM_KW, **JAX_KERNELS)
    jr = jax_load(path, jp)
    _, jrows = jax.jit(jp.push_impl)(jr, jnp.asarray(pcm))
    _close(got["rows"], jrows, packed=True)


def test_one_rank_mesh_takes_no_per_shard_sort():
    """On a one-device mesh JAX's shard_state unsorts a sorted state and
    its per-shard sort declines (one shard): the port's one-rank mesh
    does the same, in shard_state and in sharded_set_palette, and its
    rows equal the sorted whole state's."""
    from spectrogram_tpu_torch.parallel import mesh as pmesh

    s_n = tr.SORT_STREAMS
    ids = tr.alternating(s_n)
    jp = JaxPipeline(JCFG, **tr.STREAM_KW, **JAX_KERNELS)
    jsh = jmesh.shard_state(jp.set_palette(jp.init_state(s_n), ids), jmesh.make_mesh(1), jp)
    p = _port(**tr.STREAM_KW)
    m = pmesh.make_mesh(device="cpu")
    whole = p.set_palette(p.init_state(s_n), ids)
    sh = pmesh.shard_state(whole, m, p)
    assert not p.palette_layout.read(sh.tables).sorted and jp._state_perm(jsh) is None
    assert not p.palette_layout.read(pmesh.sharded_set_palette(p, sh, ids, m).tables).sorted
    pcm = _t(tr.pcm(9, s_n, p.chunk_size))
    np.testing.assert_array_equal(pmesh.sharded_push(p, m)(sh, pcm)[1].numpy(),
                                  p.push(whole, pcm)[1].numpy())
