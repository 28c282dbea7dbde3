"""The sharded GBDT on ``torch.distributed`` against the JAX package's on a
CPU mesh, and the port's own width invariants.

Worlds are ``parallel.world.World``: CPU ranks in spawned processes over
gloo (``file://`` rendezvous, no fixed port), one world of 2 and one of 4
shared by the module's tests.  Every rank is handed the same full inputs,
as the reference's ``train(shard_rows=True)`` is, and keeps its contiguous
block of rows.  The functions the ranks run live at module level, and the
module imports no jax at its top (a rank imports it by name).

- Growers: both growers (and their voting-parallel forms) at world 2
  against the reference's ``jax.shard_map`` growers on a 2-wide mesh, fed
  the reference's own sharded quantizer uniforms (``fold_in(key, global
  row)`` under the psum'd integer mix, rebuilt here with ``jax.random``).
  The trees must be the same, except at an f32 near-tie (best gains within
  1e-6 relative: the port sums the integer histograms over bins before it
  rescales, the reference after), where the subtrees part.
- Whole fits: unquantized ``train(shard_rows=True)`` at world 2 against the
  reference's on a 2-wide mesh: the f32 histograms are summed in other
  orders, so integer arrays are identical unless a near-tie parts them,
  scores within rtol 1e-5.
- Width: quantized fits at widths 1, 2 and 4 bit for bit, and a run
  preempted at width 4, resumed at 2 and finished at 4 (the reshard
  counter booked both ways) = the uninterrupted run, bit for bit.
- Voting: with 2k >= F it grows the full psum's trees; with a small k it
  still learns (the twins of ``tests/test_parallel.py``); on one device it
  grows the reference's full-histogram trees (fault 3.15).
- Estimators in a world of 2; the elastic drill's legs inline (tier-1)
  and with SIGKILL (``slow``, ``chaos``).
"""
import numpy as np
import pytest

from mmlspark_tpu_torch.lightgbm import GBDTParams, train
from mmlspark_tpu_torch.lightgbm import core as port_core
from mmlspark_tpu_torch.parallel.world import World

BOOSTER_ARRAYS = ("split_feature", "threshold", "threshold_bin",
                  "split_gain", "internal_value", "internal_count",
                  "leaf_value", "leaf_count", "tree_weight", "left_child",
                  "right_child")


@pytest.fixture(scope="module")
def world2():
    with World(2, threads=1) as w:
        yield w


@pytest.fixture(scope="module")
def world4():
    with World(4, threads=1) as w:
        yield w


def _data(n=1500, f=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] * 2 - X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
         + rng.normal(scale=0.5, size=n) > 0).astype(np.float32)
    return X, y


def _drill_data():
    """``tests/test_elastic_resume.py``'s recipe: 801 rows pad at every
    width, and 804 x 15 < 2**14 keeps the packed allreduce engaged."""
    from mmlspark_tpu_torch.testing.chaos import ElasticTopologyDrill
    return ElasticTopologyDrill("", "").make_data()


def _drill_params(iters=3, **kw):
    base = dict(num_iterations=iters, objective="binary", max_depth=3,
                growth="level", seed=3, use_quantized_grad=True,
                bagging_fraction=0.7, bagging_freq=2, feature_fraction=0.8)
    base.update(kw)
    return base


def _arrays(booster):
    return {k: np.asarray(getattr(booster, k)) for k in BOOSTER_ARRAYS}


def _assert_identical(a, b, what=""):
    for k in BOOSTER_ARRAYS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


# ---------------------------------------------------------------------------
# functions the ranks run
# ---------------------------------------------------------------------------

def _rank_grow(pkw, binned, g, h, mask, edges, u):
    """One tree of the sharded grower on this rank's block."""
    import torch
    from mmlspark_tpu_torch.parallel import batch_sharded
    p = GBDTParams(**pkw).resolve()
    n, F = binned.shape
    grow = port_core._make_grower(p, F, edges.shape[1] + 1,
                                  axis_name="data", psum_row_bound=n)
    blk = batch_sharded().block(n)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))
    tree = grow(t(binned[blk]), t(g[blk]), t(h[blk]), t(mask[blk]),
                torch.ones(F, dtype=torch.bool), t(edges),
                noise=t(u[:, blk]))
    return {k: (v.numpy() if v is not None else None)
            for k, v in tree._asdict().items()}


def _rank_fit(X, y, pkw, tkw=None):
    r = train(X, y, GBDTParams(**pkw), device="cpu", shard_rows=True,
              **(tkw or {}))
    return _arrays(r.booster), r.extras


def _rank_fit_preempted(X, y, pkw, ckpt, stop_at, resume):
    from mmlspark_tpu_torch.observability import get_registry
    from mmlspark_tpu_torch.testing.chaos import PreemptionSimulator
    cbs = [PreemptionSimulator(seed=1, lo=stop_at, hi=stop_at + 1)] \
        if stop_at is not None else None
    r = train(X, y, GBDTParams(**pkw), device="cpu", shard_rows=True,
              checkpoint_dir=ckpt, checkpoint_every=1, callbacks=cbs,
              resume=resume)
    fam = get_registry().family("mmlspark_reshard_total")
    booked = {d: fam.labels(driver="lightgbm.train", direction=d).value
              for d in ("shrink", "grow")} if fam is not None else {}
    return _arrays(r.booster), r.extras, booked


def _rank_estimator(X, y, kw):
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.lightgbm import LightGBMClassifier
    df = DataFrame.from_dict({"features": X, "label": y})
    model = LightGBMClassifier().set_params(device="cpu", **kw).fit(df)
    pred = np.asarray(model.transform(df).collect()["prediction"])
    return _arrays(model.booster), pred


# ---------------------------------------------------------------------------
# growers against the reference's shard_map growers
# ---------------------------------------------------------------------------

def _jax_sharded_uniforms(g, h, seed):
    """The reference's sharded quantizer uniforms (``ops/histogram.py``
    ``quantize_gradients`` with ``row_ids``): the key folds the integer
    psum of the bitcast |g| and h, each row folds its global id in."""
    import jax
    import jax.numpy as jnp
    import jax.random as jrandom
    gj, hj = jnp.asarray(g, jnp.float32), jnp.asarray(h, jnp.float32)
    mix = (jnp.sum(jax.lax.bitcast_convert_type(jnp.abs(gj), jnp.int32))
           + 3 * jnp.sum(jax.lax.bitcast_convert_type(hj, jnp.int32)))
    key = jrandom.fold_in(jrandom.PRNGKey(seed), jnp.asarray(mix, jnp.int32))
    keys = jax.vmap(lambda i: jrandom.fold_in(key, i))(
        jnp.arange(g.shape[0], dtype=jnp.int32))
    return np.asarray(jnp.moveaxis(
        jax.vmap(lambda k: jrandom.uniform(k, (2,)))(keys), -1, 0))


def _jax_sharded_grow(pkw, binned, g, h, mask, edges, width):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from mmlspark_tpu.lightgbm import GBDTParams as JaxParams
    from mmlspark_tpu.lightgbm import core as jax_core
    from mmlspark_tpu.parallel import make_mesh
    n, F = binned.shape
    mesh = make_mesh({"data": width}, jax.devices()[:width])
    grow = jax_core._make_grower(JaxParams(**pkw).resolve(), F,
                                 edges.shape[1] + 1, axis_name="data",
                                 psum_row_bound=n)
    fn = jax.jit(jax.shard_map(
        grow, mesh=mesh, in_specs=(P("data"),) * 4 + (P(), P()),
        out_specs=(P(),) * 11 + (P("data"),), check_vma=False))
    out = fn(jnp.asarray(binned), jnp.asarray(g), jnp.asarray(h),
             jnp.asarray(mask), jnp.ones((F,), bool), jnp.asarray(edges))
    return [np.asarray(a) for a in out]


def _assert_same_tree(ref, port):
    """Node for node (BFS order level-wise, split order leaf-wise): the same
    splits up to the first one that differs, which must be an f32
    near-tie; returns whether the whole trees agree (then every row's leaf,
    the thresholds and counts too, the floats within the scan's rounding)."""
    (j_lc, j_rc, j_sf, j_thr, j_tb, j_gain, j_iv, j_ic, j_lv, j_lcnt, _,
     j_leaf) = ref
    diff = np.nonzero((port["split_feature"] != j_sf)
                      | (port["threshold_bin"] != j_tb))[0]
    if len(diff):
        m = diff[0]
        assert abs(port["split_gain"][m] - j_gain[m]) <= \
            1e-6 * abs(j_gain[m]), (m, j_sf, port["split_feature"])
        return False
    np.testing.assert_array_equal(port["left_child"], j_lc)
    np.testing.assert_array_equal(port["right_child"], j_rc)
    np.testing.assert_array_equal(port["threshold"], j_thr)
    np.testing.assert_array_equal(port["internal_count"], j_ic)
    np.testing.assert_array_equal(port["leaf_count"], j_lcnt)
    np.testing.assert_allclose(port["split_gain"], j_gain, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(port["internal_value"], j_iv, rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(port["leaf_value"], j_lv, rtol=1e-5,
                               atol=1e-7)
    return True


GROWERS = {"level": dict(max_depth=4), "leaf": dict(num_leaves=12),
           "level_voting": dict(max_depth=4, voting_k=2),
           "leaf_voting": dict(num_leaves=12, voting_k=2)}


@pytest.mark.parametrize("growth", list(GROWERS))
def test_growers_at_world_2_match_the_reference_shard_map(world2, growth):
    from mmlspark_tpu.lightgbm.binning import BinMapper as JaxBinMapper
    X, y = _data(seed=1)
    n = X.shape[0]
    mapper = JaxBinMapper(63).fit(X)
    binned = mapper.transform(X)
    rng = np.random.default_rng(2)
    p = 1 / (1 + np.exp(-rng.normal(scale=0.5, size=n)))
    g = (p - y).astype(np.float32)
    h = np.maximum(p * (1 - p), 1e-16).astype(np.float32)
    mask = rng.random(n) > 0.1
    pkw = dict(objective="binary", seed=5, use_quantized_grad=True,
               lambda_l2=0.5, min_data_in_leaf=10, **GROWERS[growth])
    ref = _jax_sharded_grow(pkw, binned, g, h, mask, mapper.edges, 2)
    u = _jax_sharded_uniforms(g, h, 5).astype(np.float32)
    trees = world2.run(_rank_grow, pkw, binned, g, h, mask, mapper.edges, u)
    for k in trees[0]:
        if k != "leaf_of_row" and trees[0][k] is not None:
            np.testing.assert_array_equal(trees[0][k], trees[1][k])
    port = dict(trees[0], leaf_of_row=np.concatenate(
        [t["leaf_of_row"] for t in trees]))
    assert _assert_same_tree(ref, port)
    np.testing.assert_array_equal(port["leaf_of_row"], ref[-1])
    assert (port["split_feature"] >= 0).sum() > 7       # real splits


# ---------------------------------------------------------------------------
# whole fits
# ---------------------------------------------------------------------------

def _assert_same_booster(jb, tb, X):
    """How many leading trees are identical (a part must be a near-tie),
    and the scores within rtol 1e-5 when none parts."""
    T = jb.num_trees
    same = T
    for t in range(T):
        diff = np.nonzero((tb["split_feature"][t] != jb.split_feature[t])
                          | (tb["threshold_bin"][t] != jb.threshold_bin[t]))
        if len(diff[0]):
            m = diff[0][0]
            assert abs(tb["split_gain"][t, m] - jb.split_gain[t, m]) <= \
                1e-6 * abs(jb.split_gain[t, m]), (t, m)
            same = t
            break
    for k in ("split_feature", "threshold_bin", "left_child", "right_child",
              "threshold", "internal_count", "leaf_count"):
        np.testing.assert_array_equal(tb[k][:same],
                                      np.asarray(getattr(jb, k))[:same],
                                      err_msg=k)
    np.testing.assert_allclose(tb["leaf_value"][:same],
                               jb.leaf_value[:same], rtol=1e-5, atol=1e-6)
    return same


@pytest.mark.parametrize("growth", [dict(max_depth=3), dict(num_leaves=7)],
                         ids=["level", "leaf"])
def test_unquantized_fits_at_world_2_match_the_reference(world2, growth):
    from mmlspark_tpu.lightgbm import GBDTParams as JaxParams
    from mmlspark_tpu.lightgbm import train as jax_train
    from mmlspark_tpu.parallel import active_mesh
    X, y = _data(n=1203, seed=3)
    pkw = dict(num_iterations=4, objective="binary", seed=2,
               use_quantized_grad=False, bagging_fraction=0.8,
               bagging_freq=1, feature_fraction=0.9, **growth)
    with active_mesh(_jax_mesh(2)):
        jb = jax_train(X, y, JaxParams(**pkw), shard_rows=True).booster
    (a0, ex0), (a1, _) = world2.run(_rank_fit, X, y, pkw)
    _assert_identical(a0, a1, "rank 0 vs rank 1")
    assert ex0["shard_count"] == 2.0 and ex0["shard_rows"] == 602.0
    assert _assert_same_booster(jb, a0, X) == jb.num_trees


def _jax_mesh(n):
    import jax
    from mmlspark_tpu.parallel import make_mesh
    return make_mesh({"data": n}, jax.devices()[:n])


@pytest.mark.parametrize("growth", [dict(), dict(growth="leaf",
                                                 num_leaves=7)],
                         ids=["level", "leaf"])
def test_quantized_fits_are_bit_identical_at_widths_1_2_4(world2, world4,
                                                         growth):
    """The twin of ``test_sharded_widths_train_bit_identical_uninterrupted``:
    global-row-keyed rounding, the exact integer psum and width-free host
    draws make the booster the same at every width."""
    X, y = _drill_data()
    pkw = _drill_params(**growth)
    one = _arrays(train(X, y, GBDTParams(**pkw), device="cpu",
                        shard_rows=True).booster)
    for w in (world2, world4):
        for a, _ in w.run(_rank_fit, X, y, pkw):
            _assert_identical(one, a, f"width {w.width}")


def test_resume_shrink_then_grow_is_bit_identical(world2, world4, tmp_path):
    """The twin of ``test_sharded_resume_shrink_then_grow_bit_identical``:
    preempted at width 4, resumed (and preempted again) at width 2, finished
    at width 4, the booster is the uninterrupted 4-wide one, bit for bit,
    and the reshard counter booked both directions."""
    X, y = _drill_data()
    pkw = _drill_params(iters=6)
    ref, _ = world4.run(_rank_fit, X, y, pkw)[0]
    d = str(tmp_path / "ck")
    r1 = world4.run(_rank_fit_preempted, X, y, pkw, d, 1, "auto")
    assert all(r[1]["preempted"] == 1.0 and r[1]["resharded"] == 0.0
               for r in r1)
    r2 = world2.run(_rank_fit_preempted, X, y, pkw, d, 3, "auto")
    assert all(r[1]["preempted"] == 1.0 and r[1]["resharded"] == 1.0
               for r in r2)
    assert r2[0][1]["resumed_from_iteration"] == 2.0
    r3 = world4.run(_rank_fit_preempted, X, y, pkw, d, None, "must")
    for arrays, extras, booked in r3:
        assert extras["resharded"] == 1.0 and extras["preempted"] == 0.0
        _assert_identical(ref, arrays, "resumed")
        assert booked["grow"] >= 1
    assert r2[0][2]["shrink"] >= 1


# ---------------------------------------------------------------------------
# voting-parallel
# ---------------------------------------------------------------------------

def test_voting_with_2k_covering_the_features_equals_the_full_psum(world4):
    """The twin of ``test_voting_parallel_matches_full_psum_when_k_covers_
    features``: with 2k >= F every feature wins the vote, so the trees are
    the full psum's (summed in another order: the first tree's structure
    equal, the scores within 5e-3)."""
    from mmlspark_tpu_torch.models.gbdt import GBDTBooster
    rng = np.random.default_rng(0)
    X = rng.normal(size=(512, 10)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 3] > 0).astype(np.float32)
    base = dict(num_iterations=3, objective="binary", max_depth=3,
                min_data_in_leaf=2)
    full = world4.run(_rank_fit, X, y, base)[0][0]
    vote = world4.run(_rank_fit, X, y, dict(base, voting_k=5))[0][0]
    np.testing.assert_array_equal(vote["split_feature"][0],
                                  full["split_feature"][0])
    np.testing.assert_array_equal(vote["threshold_bin"][0],
                                  full["threshold_bin"][0])
    fb, vb = (_as_booster(a, 10) for a in (full, vote))
    np.testing.assert_allclose(vb.raw_scores(X, device="cpu"),
                               fb.raw_scores(X, device="cpu"), atol=5e-3)
    agree = float(((vb.predict(X, device="cpu") > 0.5)
                   == (fb.predict(X, device="cpu") > 0.5)).mean())
    assert agree > 0.999, agree
    assert isinstance(fb, GBDTBooster)


def _as_booster(a, F, objective="binary"):
    from mmlspark_tpu_torch.models.gbdt import (GBDTBooster,
                                                children_depth_bound)
    return GBDTBooster(
        a["split_feature"], a["threshold"], a["threshold_bin"],
        a["split_gain"], a["internal_value"], a["internal_count"],
        a["leaf_value"], a["leaf_count"], a["tree_weight"],
        left_child=a["left_child"], right_child=a["right_child"],
        max_depth=children_depth_bound(a["left_child"], a["right_child"]),
        num_features=F, objective=objective)


def test_voting_with_a_small_k_still_learns(world4):
    """The twin of ``test_voting_parallel_small_k_still_learns``: k = 3 of
    40 features, the informative ones win the vote."""
    rng = np.random.default_rng(1)
    X = rng.normal(size=(1024, 40)).astype(np.float32)
    y = (X[:, 7] + 0.7 * X[:, 23] > 0).astype(np.float32)
    a = world4.run(_rank_fit, X, y, dict(
        num_iterations=10, objective="binary", max_depth=4,
        min_data_in_leaf=2, voting_k=3))[0][0]
    b = _as_booster(a, 40)
    acc = float(((b.predict(X, device="cpu") > 0.5) == y).mean())
    assert acc > 0.93, acc
    used = set(a["split_feature"][a["split_feature"] >= 0].tolist())
    assert 7 in used and 23 in used


@pytest.mark.parametrize("growth", [dict(num_leaves=7),
                                    dict(max_depth=3)],
                         ids=["leaf", "level"])
def test_voting_parallel_on_one_device_grows_the_reference_tree(growth):
    """Fault 3.15: ``parallelism="voting_parallel"`` on one device raised in
    the port; the reference trains there and grows the full-histogram tree
    (voting engages only under a mesh axis).  Now the port does too: its
    booster is its own data-parallel booster bit for bit and the
    reference's voting booster tree for tree."""
    from mmlspark_tpu.core import DataFrame as JaxDataFrame
    from mmlspark_tpu.lightgbm import LightGBMClassifier as JaxClassifier
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.lightgbm import LightGBMClassifier
    X, y = _data(n=1000, seed=4)
    kw = dict(num_iterations=4, parallelism="voting_parallel", top_k=2,
              **growth)
    cols = {"features": X, "label": y}
    tb = LightGBMClassifier().set_params(device="cpu", **kw).fit(
        DataFrame.from_dict(cols)).booster
    plain = LightGBMClassifier().set_params(
        device="cpu", **dict(kw, parallelism="data_parallel")).fit(
        DataFrame.from_dict(cols)).booster
    _assert_identical(_arrays(tb), _arrays(plain), "voting vs data")
    jb = JaxClassifier().set_params(**kw).fit(
        JaxDataFrame.from_dict(cols)).booster
    assert _assert_same_booster(jb, _arrays(tb), X) == jb.num_trees


# ---------------------------------------------------------------------------
# estimators and the elastic drill
# ---------------------------------------------------------------------------

def test_estimators_fit_in_a_world_of_2(world2):
    """``LightGBMClassifier(shard_rows=True)`` (and voting) fitted by every
    rank on the same frame: the same booster on both ranks, the width-1
    booster, and predictions over the whole frame."""
    X, y = _data(n=900, seed=6)
    for kw in (dict(shard_rows=True, num_iterations=3,
                    use_quantized_grad=True),
               dict(shard_rows=True, num_iterations=3, max_depth=3,
                    use_quantized_grad=True, parallelism="voting_parallel",
                    top_k=2)):
        (a0, p0), (a1, p1) = world2.run(_rank_estimator, X, y, kw)
        one, p_one = _rank_estimator(X, y, kw)
        _assert_identical(a0, a1, "rank 0 vs 1")
        _assert_identical(one, a0, "width 1 vs 2")
        np.testing.assert_array_equal(p0, p_one)
        assert (p0 == y).mean() > 0.8


def test_elastic_drill_inline_legs_resume_across_widths(tmp_path):
    """The drill's legs inline: the baseline at width 4; a leg preempted at
    iteration 2 at width 4, one resumed at width 2 and preempted at 4, the
    last finished at width 4 from the snapshot it must find: the
    uninterrupted booster, bit for bit."""
    from mmlspark_tpu_torch.testing.chaos import ElasticTopologyDrill
    drill = ElasticTopologyDrill(str(tmp_path / "ck"),
                                 str(tmp_path / "iters.log"),
                                 num_iterations=6)
    src = drill.child_program(4)
    assert "World(4" in src and "jax" not in src
    baseline = drill.train_inline(4, checkpoint=False)
    r1 = drill.train_inline(4, stop_at=2)
    assert r1.extras["preempted"] == 1.0
    r2 = drill.train_inline(2, stop_at=4)
    assert r2.extras["resharded"] == 1.0 and r2.extras["preempted"] == 1.0
    final = drill.train_inline(4, resume="must")
    assert final.extras["resumed_from_iteration"] >= 3
    assert final.extras["resharded"] == 1.0
    _assert_identical(_arrays(baseline.booster), _arrays(final.booster))


@pytest.mark.slow
@pytest.mark.chaos
def test_sigkill_elastic_shrink_grow_bit_identical(tmp_path):
    """The twin of ``tests/test_elastic_resume.py``'s drill: a world of 4
    training ``shard_rows=True`` is SIGKILLed mid-run, the resume runs (and
    is SIGKILLed again) in a world of 2, and a last world of 4 completes —
    bit-identical to an uninterrupted 4-wide run."""
    from mmlspark_tpu_torch.io.checkpoint import snapshot_steps
    from mmlspark_tpu_torch.testing.chaos import ElasticTopologyDrill
    drill = ElasticTopologyDrill(str(tmp_path / "ck"),
                                 str(tmp_path / "iters.log"))
    baseline = drill.train_inline(4, checkpoint=False)
    seen = drill.run_child(4, min_new_iterations=2)
    assert snapshot_steps(drill.ckpt_dir), \
        "the leg died before any checkpoint landed"
    assert seen >= 1
    drill.run_child(2, min_new_iterations=2)     # shrink leg, killed too
    final = drill.train_inline(4, resume="must")  # grow back, finish
    assert final.extras["resumed_from_iteration"] >= 1
    _assert_identical(_arrays(baseline.booster), _arrays(final.booster))
