"""The port's ``parallel`` package (mesh, placements, collectives, the
world of spawned ranks) against the JAX package's on a CPU mesh.

A world here is ``parallel.world.World``: CPU ranks in spawned processes
over gloo, a ``file://`` rendezvous in a fresh directory (no port is ever
fixed, so the suite's parallel workers never collide), shared by the
module's tests because each spawn costs seconds.  The functions the ranks
run live at module level and the module imports no jax at its top: a rank
imports this module by name to find them.  The JAX side runs on the
conftest's 8 virtual CPU devices.

- Mesh formation: the same shapes and the same errors as the reference's
  ``make_mesh`` for the same axes and device count.
- Collectives at world 4 against ``jax.shard_map`` on a 4-device mesh:
  ``shard_batch`` + ``psum``, ``pmax``, ``pmean``, the ``ppermute`` ring,
  ``all_gather``, ``shard_mapped``, and ``histogram_psum`` bit for bit on
  the same int32 inputs below and above its packed 14-bit gate.
- Groups: a 2 x 2 mesh sums over each axis's own ranks.
- ``ops.histogram.global_row_ids`` / ``quant_mix`` across ranks.
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu_torch import parallel as TP
from mmlspark_tpu_torch.parallel import collectives as TC
from mmlspark_tpu_torch.parallel.sharding import PartitionSpec
from mmlspark_tpu_torch.parallel.world import World

WIDTH = 4


@pytest.fixture(scope="module")
def world4():
    with World(WIDTH, threads=1) as w:
        yield w


# ---------------------------------------------------------------------------
# functions the ranks run
# ---------------------------------------------------------------------------

def _rank_batch_psum(x):
    local, n = TP.shard_batch(x)
    total = TP.psum(local.sum())
    return n, tuple(local.shape), float(total), TP.axis_index()


def _rank_reductions():
    r = TP.axis_index()
    v = torch.tensor([float(r), -float(r), 2.0 ** r])
    return (TP.pmax(v).tolist(), TP.pmean(v).tolist(),
            TP.psum(torch.tensor([r], dtype=torch.int64)).tolist())


def _rank_ring(x, shift):
    mesh = TP.get_active_mesh()
    block = TP.batch_sharded(mesh).place(x)
    return TP.ppermute(block, TP.ring_perm(mesh.shape["data"], shift)).numpy()


def _rank_histogram_psum(h_global, row_bound, quant_bins):
    local = TP.batch_sharded().place(h_global)
    return TC.histogram_psum(local, "data", row_bound=row_bound,
                             quant_bins=quant_bins).numpy()


def _rank_gather_and_map(x):
    def local_fn(xs):
        return xs * (TP.axis_index() + 1), TP.psum(xs.sum())
    scaled, total = TP.shard_mapped(
        local_fn, in_specs=PartitionSpec("data"),
        out_specs=(PartitionSpec("data"), PartitionSpec()))(
            torch.from_numpy(x))
    g_tiled = TP.all_gather(torch.tensor([TP.axis_index()]))
    g_stack = TP.all_gather(torch.tensor([TP.axis_index()]), tiled=False)
    return (scaled.numpy(), float(total), g_tiled.tolist(),
            tuple(g_stack.shape))


def _rank_groups():
    mesh = TP.make_mesh({"data": -1, "model": 2})
    from mmlspark_tpu_torch.parallel.mesh import world_rank
    r = torch.tensor([world_rank()])
    return (mesh.shape, mesh.axis_index("data"), mesh.axis_index("model"),
            int(TP.psum(r, "data", mesh)), int(TP.psum(r, "model", mesh)),
            mesh.devices.tolist())


def _rank_row_ids(g, h, n_local):
    from mmlspark_tpu_torch.ops import histogram as TH
    blk = TP.batch_sharded().block(g.shape[0])
    ids = TH.global_row_ids("data", n_local)
    mix = TH.quant_mix(torch.from_numpy(g[blk]), torch.from_numpy(h[blk]),
                       "data")
    return ids.tolist(), mix


def _rank_raise_on_1():
    if TP.axis_index() == 1:
        raise ValueError("rank one fails")
    return "ok"


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jax_mesh(n):
    import jax
    from mmlspark_tpu.parallel import make_mesh
    return make_mesh({"data": n}, jax.devices()[:n])


def _jax_shard_map(fn, mesh, in_specs, out_specs):
    import jax
    from mmlspark_tpu.parallel import shard_mapped
    return jax.jit(shard_mapped(fn, mesh, in_specs=in_specs,
                                out_specs=out_specs))


# ---------------------------------------------------------------------------
# mesh formation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axes", [
    {"data": -1, "model": 2}, {"data": 8}, None, {"data": 2, "seq": -1},
    {"data": -1, "model": -1}, {"data": -1, "model": 3}, {"data": 3}],
    ids=["infer", "data8", "default", "infer_last", "two_minus_one",
         "not_divisible", "too_few"])
def test_make_mesh_matches_the_reference(axes):
    import jax
    from mmlspark_tpu.parallel import make_mesh as jax_make_mesh
    try:
        ref = jax_make_mesh(axes, jax.devices()[:8])
        ref_err = None
    except ValueError as e:
        ref, ref_err = None, str(e)
    if ref_err is not None:
        with pytest.raises(ValueError) as exc:
            TP.make_mesh(axes, list(range(8)))
        assert str(exc.value) == ref_err
        return
    mesh = TP.make_mesh(axes, list(range(8)))
    assert mesh.shape == dict(ref.shape)
    assert mesh.axis_names == ref.axis_names
    assert mesh.devices.shape == ref.devices.shape
    assert mesh.devices.size == 8


def test_without_a_group_the_mesh_is_this_process():
    mesh = TP.get_active_mesh()
    assert mesh.shape == {"data": 1} and mesh.axis_index("data") == 0
    assert TP.data_parallel_mesh().shape == {"data": 1}
    x = torch.arange(6.0)
    for op in (TP.psum, TP.pmax, TP.pmean):
        torch.testing.assert_close(op(x), x, rtol=0, atol=0)
    block, n = TP.shard_batch(np.ones((5, 2), np.float32))
    assert n == 5 and tuple(block.shape) == (5, 2)
    assert TP.replicate(np.ones(3)).shape == (3,)
    assert TP.ring_perm(3) == [(0, 1), (1, 2), (2, 0)]
    other = TP.make_mesh({"data": 1, "model": 1})
    with TP.active_mesh(other):
        assert TP.get_active_mesh() is other
    assert TP.get_active_mesh() is not other
    TP.set_active_mesh(other)
    try:
        assert TP.get_active_mesh() is other
    finally:
        TP.set_active_mesh(None)
    # a mesh wider than the world cannot sum without a process group
    with pytest.raises(RuntimeError, match="process group"):
        TP.psum(x, "data", TP.make_mesh({"data": 4}, list(range(4))))


def test_pad_to_multiple_is_the_reference():
    from mmlspark_tpu.parallel import pad_to_multiple as jax_pad
    x = np.arange(14, dtype=np.float32).reshape(7, 2)
    for mult, fill, axis in ((4, None, 0), (3, 0.0, 0), (7, None, 0),
                             (4, -1.0, 1)):
        a, na = TP.pad_to_multiple(x, mult, axis=axis, fill=fill)
        b, nb = jax_pad(x, mult, axis=axis, fill=fill)
        np.testing.assert_array_equal(a, b)
        assert na == nb


def test_placements_cut_contiguous_blocks():
    mesh = TP.make_mesh({"data": 4}, list(range(4)))
    s = TP.batch_sharded(mesh)
    assert s.block(8) == slice(0, 2)        # this process is position 0
    assert TP.replicated(mesh).block(8) == slice(0, 8)
    assert TP.named_sharding(mesh, "data").axis == "data"
    with pytest.raises(ValueError, match="divisible"):
        s.block(7)


# ---------------------------------------------------------------------------
# collectives at world 4 against the reference's on a 4-device mesh
# ---------------------------------------------------------------------------

def test_shard_batch_and_psum(world4):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from mmlspark_tpu.parallel import active_mesh, psum, shard_batch
    x = np.ones((13, 4), dtype=np.float32)
    mesh = _jax_mesh(WIDTH)
    with active_mesh(mesh):
        xs, n = shard_batch(x)
        ref = float(_jax_shard_map(lambda a: psum(jnp.sum(a), "data"), mesh,
                                   P("data"), P())(xs))
    got = world4.run(_rank_batch_psum, x)
    assert ref == 16 * 4
    for r, (n_r, shape, total, idx) in enumerate(got):
        assert (n_r, shape, total, idx) == (n, (4, 4), ref, r)


def test_pmax_pmean_and_integer_psum(world4):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from mmlspark_tpu.parallel import axis_index, pmax, pmean
    mesh = _jax_mesh(WIDTH)

    def ref_fn(_):
        r = axis_index("data").astype(jnp.float32)
        v = jnp.stack([r, -r, 2.0 ** r])
        return pmax(v, "data"), pmean(v, "data")
    rmax, rmean = _jax_shard_map(ref_fn, mesh, P("data"), (P(), P()))(
        np.zeros((WIDTH,), np.float32))
    for got_max, got_mean, got_sum in world4.run(_rank_reductions):
        np.testing.assert_array_equal(np.float32(got_max), np.asarray(rmax))
        np.testing.assert_allclose(got_mean, np.asarray(rmean), rtol=1e-7)
        assert got_sum == [0 + 1 + 2 + 3]


@pytest.mark.parametrize("shift", [1, 3])
def test_ppermute_ring(world4, shift):
    from jax.sharding import PartitionSpec as P
    from mmlspark_tpu.parallel import ppermute, ring_perm
    mesh = _jax_mesh(WIDTH)
    x = np.arange(WIDTH * 2, dtype=np.float32).reshape(WIDTH * 2, 1)
    ref = np.asarray(_jax_shard_map(
        lambda a: ppermute(a, ring_perm(WIDTH, shift), "data"), mesh,
        P("data"), P("data"))(x))
    got = np.concatenate(world4.run(_rank_ring, x, shift))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        got.reshape(WIDTH, 2), np.roll(x.reshape(WIDTH, 2), shift, axis=0))


@pytest.mark.parametrize("row_bound,scale", [(100, 40), (10_000, 4_000)],
                         ids=["packed", "unpacked"])
def test_histogram_psum_bit_identical_to_the_reference(world4, row_bound,
                                                       scale):
    """The same int32 ``(..., 3)`` histograms, summed over 4 ranks: below
    the 14-bit gate (``row_bound * 15 < 2**14``) both packages move the
    packed two-channel form, above it the plain tensor; either way every
    cell is the reference's."""
    from jax.sharding import PartitionSpec as P
    from mmlspark_tpu.parallel.collectives import histogram_psum
    rng = np.random.default_rng(row_bound)
    shape = (WIDTH * 2, 3, 5)
    h = np.stack([rng.integers(-scale, scale + 1, shape),
                  rng.integers(0, 2 * scale + 1, shape),
                  rng.integers(0, scale // 4 + 1, shape)],
                 axis=-1).astype(np.int32)
    assert (row_bound * 15 < (1 << 14)) == (row_bound == 100)
    mesh = _jax_mesh(WIDTH)
    ref = np.asarray(_jax_shard_map(
        lambda a: histogram_psum(a, "data", row_bound=row_bound,
                                 quant_bins=16),
        mesh, P("data"), P())(h))
    np.testing.assert_array_equal(ref, h.reshape(WIDTH, 2, 3, 5, 3).sum(0))
    for got in world4.run(_rank_histogram_psum, h, row_bound, 16):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, ref)


def test_all_gather_and_shard_mapped(world4):
    x = np.arange(WIDTH * 3, dtype=np.float32).reshape(WIDTH * 3, 1)
    want = x * np.repeat(np.arange(1, WIDTH + 1), 3)[:, None]
    for scaled, total, tiled, stacked in world4.run(_rank_gather_and_map, x):
        np.testing.assert_array_equal(scaled, want)
        assert total == float(x.sum())
        assert tiled == list(range(WIDTH)) and stacked == (WIDTH, 1)


def test_a_mesh_of_two_axes_sums_over_each_axis_group(world4):
    got = world4.run(_rank_groups)
    for r, (shape, di, mi, s_data, s_model, devices) in enumerate(got):
        assert shape == {"data": 2, "model": 2}
        assert (di, mi) == divmod(r, 2)
        assert devices == [[0, 1], [2, 3]]
        assert s_data == mi + (mi + 2)          # ranks {mi, 2 + mi}
        assert s_model == 2 * di + (2 * di + 1)  # ranks {2di, 2di + 1}


def test_global_row_ids_and_the_mix_are_width_free(world4):
    """Each rank's rows keep their global ids, and the quantizer's integer
    mix over the ranks is the JAX package's host formula over all rows."""
    from mmlspark_tpu.lightgbm.core import _quant_mix
    rng = np.random.default_rng(7)
    n = WIDTH * 50
    g = rng.normal(size=n).astype(np.float32)
    g[::17] = -0.0
    h = rng.random(n).astype(np.float32)
    want_mix = int(_quant_mix(g, h))
    for r, (ids, mix) in enumerate(world4.run(_rank_row_ids, g, h, 50)):
        assert ids == list(range(r * 50, (r + 1) * 50))
        assert mix == want_mix
    from mmlspark_tpu_torch.ops import histogram as TH
    assert TH.global_row_ids(None, 5) is None
    assert TH.quant_mix(torch.from_numpy(g), torch.from_numpy(h)) == want_mix


def test_a_failing_rank_fails_the_call_and_the_world_restarts():
    w = World(2, threads=1, timeout_s=60)
    try:
        with pytest.raises(RuntimeError, match="rank one fails"):
            w.run(_rank_raise_on_1)
        assert w.run(TP.axis_index) == [0, 1]
    finally:
        w.close()
