"""Port parity for leaf-wise growth: the port's ``make_leafwise_grower``
and ``leafwise_store_dtype`` against the JAX package's, and the leaf-wise
booster on both sides.

- Grower parity: the same binned data, gradients and quantizer uniforms go
  to both growers (JAX on its fused Pallas path in interpret mode).  Integer
  arrays (children, split features and bins) and every row's leaf must be
  identical, except that a split may differ at an f32 near-tie (best gains
  within 1e-6 relative: both packages scan bins in f32, in different
  orders); then the trees part there and the rest is not compared.  Gains
  agree within rtol 1e-4 as in the level-wise grower's test (see there).
  Internal and leaf values agree within rtol 1e-5 plus an absolute 1e-5 of
  the tree's largest value: a right child's stats are its parent's f32
  totals minus the left child's, so their rounding is that of the
  parent's sums, not of the child's.
- Booster: the port's leaf-wise booster walks at ``children_depth_bound``;
  a JAX leaf-wise booster crosses unchanged through ``from_string`` and
  ``booster_from_arrays``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu.lightgbm import GBDTParams as JaxParams
from mmlspark_tpu.lightgbm import core as jax_core
from mmlspark_tpu.lightgbm import train as jax_train
from mmlspark_tpu.lightgbm.binning import BinMapper as JaxBinMapper
from mmlspark_tpu_torch import convert
from mmlspark_tpu_torch.core import DataFrame
from mmlspark_tpu_torch.lightgbm import (GBDTParams, LightGBMClassifier,
                                         LightGBMRegressor, train)
from mmlspark_tpu_torch.lightgbm import core as port_core
from mmlspark_tpu_torch.models.gbdt import GBDTBooster, children_depth_bound

from tests.test_torch_histogram import _jax_uniforms
from tests.test_torch_lightgbm import _data


@pytest.mark.parametrize("quant_bins", [4, 16, 128])
@pytest.mark.parametrize("use_quant", [True, False])
@pytest.mark.parametrize("enabled", [True, False])
def test_leafwise_store_dtype_matches_jax(quant_bins, use_quant, enabled):
    for bound in (None, 1, 257, 1500, 2184, 2185, 10922, 10923, 32767,
                  10 ** 6):
        j = jax_core.leafwise_store_dtype(bound, use_quant, quant_bins,
                                          enabled)
        t = port_core.leafwise_store_dtype(bound, use_quant, quant_bins,
                                           enabled)
        assert str(t) == f"torch.{np.dtype(j).name}", (bound, j, t)


def _grow_both(num_leaves, max_depth=0, max_bin=63, seed=0, quant=True,
               store16=True, backend="pallas", **kw):
    X, y = _data(seed=seed)
    n, F = X.shape
    mapper = JaxBinMapper(max_bin).fit(X)
    binned = mapper.transform(X)
    rng = np.random.default_rng(seed + 1)
    p = 1 / (1 + np.exp(-rng.normal(scale=0.5, size=n)))
    g = (p - y).astype(np.float32)
    h = np.maximum(p * (1 - p), 1e-16).astype(np.float32)
    mask = rng.random(n) > 0.1
    fmask = np.ones(F, bool)
    fmask[4] = False
    params = dict(num_leaves=num_leaves, max_depth=max_depth,
                  objective="binary", seed=seed, use_quantized_grad=quant,
                  lambda_l2=0.5, min_data_in_leaf=10, **kw)
    jgrow = jax_core.make_leafwise_grower(
        num_leaves, max_depth, F, max_bin, JaxParams(**params).resolve(),
        backend=backend)
    jout = jgrow(jnp.asarray(binned), jnp.asarray(g), jnp.asarray(h),
                 jnp.asarray(mask), jnp.asarray(fmask),
                 jnp.asarray(mapper.edges))
    pgrow = port_core.make_leafwise_grower(
        num_leaves, max_depth, F, max_bin, GBDTParams(**params).resolve(),
        store16=store16)
    tout = pgrow(torch.from_numpy(binned), torch.from_numpy(g),
                 torch.from_numpy(h), torch.from_numpy(mask),
                 torch.from_numpy(fmask), torch.from_numpy(mapper.edges),
                 noise=torch.from_numpy(np.array(_jax_uniforms(g, h, seed))))
    return [np.asarray(a) for a in jout], tout


def _assert_same_leafwise_tree(jout, tout):
    """True when the trees are identical; False when a near-tie flipped a
    split (asserted to be one), after which the trees part."""
    (j_lc, j_rc, j_sf, j_thr, j_tb, j_gain, j_iv, j_ic, j_lv, j_lcnt, _,
     j_leaf) = jout
    t_sf, t_tb = tout.split_feature.numpy(), tout.threshold_bin.numpy()
    t_gain = tout.split_gain.numpy()
    diff = np.nonzero((t_sf != j_sf) | (t_tb != j_tb))[0]
    if diff.size:
        s = diff[0]     # the steps before it are identical, checked below
        assert abs(t_gain[s] - j_gain[s]) <= 1e-6 * abs(j_gain[s]), \
            (s, j_sf, t_sf, j_gain, t_gain)
        return False
    for name, a in (("left_child", j_lc), ("right_child", j_rc),
                    ("leaf_of_row", j_leaf)):
        np.testing.assert_array_equal(getattr(tout, name).numpy(), a,
                                      err_msg=name)
    np.testing.assert_array_equal(tout.threshold.numpy(), j_thr)
    np.testing.assert_array_equal(tout.internal_count.numpy(), j_ic)
    np.testing.assert_array_equal(tout.leaf_count.numpy(), j_lcnt)
    # a gain is score(L) + score(R) - score(parent): the f32 rounding of the
    # scores, far larger than the gain itself, sets its error (the rule of
    # the level-wise grower's parity test)
    np.testing.assert_allclose(t_gain, j_gain, rtol=1e-4, atol=1e-5)
    for name, a in (("internal_value", j_iv), ("leaf_value", j_lv)):
        np.testing.assert_allclose(getattr(tout, name).numpy(), a,
                                   rtol=1e-5, atol=1e-5 * np.abs(a).max(),
                                   err_msg=name)
    return True


@pytest.mark.parametrize("case", [
    dict(num_leaves=7, seed=0), dict(num_leaves=7, seed=1),
    dict(num_leaves=31, seed=0), dict(num_leaves=31, seed=1),
    dict(num_leaves=15, max_depth=3, seed=2)],
    ids=["L7-s0", "L7-s1", "L31-s0", "L31-s1", "L15-depth3"])
def test_leafwise_grower_matches_jax_fused_path(case):
    """n = 1,500 rows at 16 quant bins: 1,500 x 15 < 2^15, so both growers
    keep the int16 histogram carry."""
    assert port_core.leafwise_store_dtype(1500, True, 16) == torch.int16
    jout, tout = _grow_both(**case)
    assert _assert_same_leafwise_tree(jout, tout)
    splits = int((tout.split_feature.numpy() >= 0).sum())
    if case.get("max_depth"):
        # the depth cap stops the tree at a perfect depth-3 tree
        assert splits == 7
        assert children_depth_bound(tout.left_child.numpy(),
                                    tout.right_child.numpy()) == 3
    else:
        assert splits == case["num_leaves"] - 1


def test_leafwise_grower_int32_carry_matches_jax(monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_HIST_STORE16", "0")
    jout, tout = _grow_both(31, seed=3, store16=False)
    assert _assert_same_leafwise_tree(jout, tout)


def test_leafwise_grower_early_stop_matches_jax():
    """A large min_gain_to_split stops the tree early: the later steps run
    and write nothing, uncreated leaves keep value and count zero."""
    jout, tout = _grow_both(31, seed=0, min_gain_to_split=5.0)
    assert _assert_same_leafwise_tree(jout, tout)
    splits = int((tout.split_feature.numpy() >= 0).sum())
    assert 1 < splits < 30
    lv, lc = tout.leaf_value.numpy(), tout.leaf_count.numpy()
    assert (lv[splits + 1:] == 0).all() and (lc[splits + 1:] == 0).all()
    assert (lc[:splits + 1] > 0).all()


def test_leafwise_float_path_matches_jax():
    """Float histograms: the plain build and the torch per-leaf gain scan
    against the JAX package's non-fused path."""
    jout, tout = _grow_both(31, seed=4, quant=False, backend="auto")
    assert _assert_same_leafwise_tree(jout, tout)


def test_leafwise_booster_walks_at_children_depth_bound():
    X, y = _data(n=1200, seed=5)
    r = train(X, y, GBDTParams(num_iterations=4, num_leaves=15,
                               use_quantized_grad=True, seed=1),
              device="cpu")
    b = r.booster
    assert b.num_leaves == 15 and b.num_trees == 4
    assert b.max_depth == children_depth_bound(b.left_child, b.right_child)
    assert b.max_depth < 14       # far below the 14-deep chain bound
    # the raw-feature walk at that bound lands where the binned walk at the
    # training bound does
    binned = torch.from_numpy(r.bin_mapper.transform(X))
    walk = port_core.make_binned_walker(14)
    leaves = b.predict_leaf(X, device="cpu")
    for t in range(b.num_trees):
        ref = walk(binned, *(torch.from_numpy(getattr(b, k)[t]) for k in (
            "split_feature", "threshold_bin", "left_child", "right_child")))
        np.testing.assert_array_equal(leaves[:, t], ref.numpy())


@pytest.fixture(scope="module")
def jax_leafwise_booster():
    X, y = _data(n=1500, seed=6)
    return jax_train(X, y, JaxParams(num_iterations=5, num_leaves=15,
                                     objective="binary", seed=2)).booster


@pytest.mark.parametrize("route", ["from_string", "booster_from_arrays"])
def test_jax_leafwise_booster_crosses_unchanged(jax_leafwise_booster, route):
    jb = jax_leafwise_booster
    # uneven trees: their shapes differ, and the walk bound is theirs
    assert len({tuple(row) for row in jb.left_child}) > 1
    assert jb.max_depth == children_depth_bound(jb.left_child,
                                                jb.right_child)
    if route == "from_string":
        port = GBDTBooster.from_string(jb.to_string())
    else:
        port = convert.booster_from_arrays(
            {k: getattr(jb, k) for k in jb._ARRAYS},
            {k: getattr(jb, k) for k in jb._META})
    for k in ("left_child", "right_child", "split_feature", "leaf_value"):
        np.testing.assert_array_equal(getattr(port, k), getattr(jb, k))
    assert port.max_depth == jb.max_depth
    X = np.random.default_rng(9).normal(size=(800, 6)).astype(np.float32)
    np.testing.assert_array_equal(port.predict_leaf(X, device="cpu"),
                                  jb.predict_leaf(X))
    np.testing.assert_allclose(port.predict(X, device="cpu"),
                               jb.predict(X), rtol=0, atol=1e-6)


def test_default_estimators_fit_and_transform_leafwise():
    """LightGBMClassifier() / LightGBMRegressor() with their defaults
    (num_leaves = 31, leaf-wise) fit and transform in the port."""
    X, y = _data(n=1200, f=5, seed=6)
    df = DataFrame.from_dict({"features": X, "label": y}, 2)
    model = LightGBMClassifier().set_params(num_iterations=5,
                                            device="cpu").fit(df)
    assert model.booster.num_leaves == 31
    out = model.transform(df).collect()
    assert (out["prediction"] == y).mean() > 0.8
    reg = LightGBMRegressor().set_params(num_iterations=3,
                                         device="cpu").fit(df)
    assert reg.booster.num_leaves == 31
    assert reg.transform(df).collect()["prediction"].shape == (1200,)
