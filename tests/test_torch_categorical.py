"""Port parity for categorical splits: the one-vs-rest and sorted-subset
split search in both of the port's growers, ``train()``'s cardinality
split (``max_cat_to_onehot``), the booster's categorical walk and its
category sets, against the JAX package on the same seeded inputs.

- Grower parity: the same binned data, gradients and quantizer uniforms go
  to both growers (categorical features keep both packages off the fused
  step).  Split features, bins, category sets, children and every row's
  leaf must be identical, except that a split may differ at an f32
  near-tie (best gains within 1e-6 relative).  The port sums the
  quantized histograms over bins in int32 before rescaling, the reference
  rescales first and sums in f32 (in ratio order for a subset), so the
  floats differ by the reference's rounding: values within rtol 1e-5 as in
  the numerical growers' tests, gains within rtol 1e-4 plus an absolute
  1e-6 of the tree's largest gain (a gain is a difference of leaf scores,
  each rounded at f32, and the scores run to the size of the root's
  gain).
- ``train()`` parity: with float histograms (the CPU default of both
  packages) the two boosters agree in every integer array and category
  set, and in their scores within rtol 1e-5.
- The single-shard scenarios of ``tests/test_cat_subset.py``: a planted
  subset recovered by one split, NaN and unseen codes routing right,
  category sets through serde and warm start.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu.lightgbm import GBDTParams as JaxParams
from mmlspark_tpu.lightgbm import core as jax_core
from mmlspark_tpu.lightgbm import train as jax_train
from mmlspark_tpu.lightgbm.binning import BinMapper as JaxBinMapper
from mmlspark_tpu.models.gbdt import GBDTBooster as JaxBooster
from mmlspark_tpu_torch import convert
from mmlspark_tpu_torch.core import DataFrame
from mmlspark_tpu_torch.lightgbm import (GBDTParams, LightGBMClassifier,
                                         train)
from mmlspark_tpu_torch.lightgbm import core as port_core
from mmlspark_tpu_torch.models.gbdt import GBDTBooster

from tests.test_torch_histogram import _jax_uniforms


def _cat_data(n=1500, n_codes=48, seed=0, nan_rate=0.05):
    """Column 0: ``n_codes`` codes, the label following a planted half of
    them (a sorted-subset split); column 1: 3 codes (one-vs-rest); columns
    2-4 numerical; some codes NaN."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, n_codes, n)
    in_set = np.zeros(n_codes, bool)
    in_set[rng.choice(n_codes, n_codes // 2, replace=False)] = True
    few = rng.integers(0, 3, n)
    num = rng.normal(size=(n, 3))
    logit = 2.0 * in_set[codes] - 1.0 + 0.8 * (few == 1) + 0.7 * num[:, 0]
    y = (logit + rng.normal(scale=0.5, size=n) > 0).astype(np.float32)
    X = np.column_stack([codes, few, num]).astype(np.float32)
    X[rng.random(n) < nan_rate, 0] = np.nan
    X[rng.random(n) < nan_rate, 1] = np.nan
    return X, y, in_set


CATS = (0, 1)


def _grow_both(growth, seed=0, quant=True, cat_subset=(0,), max_bin=63,
               **kw):
    X, y, _ = _cat_data(seed=seed)
    n, F = X.shape
    mapper = JaxBinMapper(max_bin, categorical_features=CATS).fit(X)
    binned = mapper.transform(X)
    rng = np.random.default_rng(seed + 1)
    p = 1 / (1 + np.exp(-rng.normal(scale=0.5, size=n)))
    g = (p - y).astype(np.float32)
    h = np.maximum(p * (1 - p), 1e-16).astype(np.float32)
    mask = rng.random(n) > 0.1
    fmask = np.ones(F, bool)
    params = dict(objective="binary", seed=seed, use_quantized_grad=quant,
                  lambda_l2=0.5, min_data_in_leaf=10,
                  categorical_features=CATS, cat_subset=cat_subset, **kw)
    jp, tp = JaxParams(**params).resolve(), GBDTParams(**params).resolve()
    if growth == "level":
        jgrow = jax_core.make_tree_grower(jp.max_depth, F, max_bin, jp)
        pgrow = port_core.make_tree_grower(tp.max_depth, F, max_bin, tp)
    else:
        jgrow = jax_core.make_leafwise_grower(jp.num_leaves, jp.max_depth,
                                              F, max_bin, jp)
        pgrow = port_core.make_leafwise_grower(tp.num_leaves, tp.max_depth,
                                               F, max_bin, tp)
    jout = jgrow(jnp.asarray(binned), jnp.asarray(g), jnp.asarray(h),
                 jnp.asarray(mask), jnp.asarray(fmask),
                 jnp.asarray(mapper.edges))
    noise = torch.from_numpy(np.array(_jax_uniforms(g, h, seed))) \
        if quant else None
    tout = pgrow(torch.from_numpy(binned), torch.from_numpy(g),
                 torch.from_numpy(h), torch.from_numpy(mask),
                 torch.from_numpy(fmask), torch.from_numpy(mapper.edges),
                 noise=noise, generator=None)
    return [np.asarray(a) for a in jout], tout


def _assert_same_cat_tree(jout, tout):
    """True when the trees are identical; False when a near-tie flipped a
    split (asserted to be one), after which the trees part."""
    (j_lc, j_rc, j_sf, j_thr, j_tb, j_gain, j_iv, j_ic, j_lv, j_lcnt, j_cbs,
     j_leaf) = jout
    t_sf, t_tb = tout.split_feature.numpy(), tout.threshold_bin.numpy()
    t_gain = tout.split_gain.numpy()
    diff = np.nonzero((t_sf != j_sf) | (t_tb != j_tb)
                      | (tout.cat_bitset.numpy() != j_cbs).any(axis=1))[0]
    if diff.size:
        s = diff[0]
        assert abs(t_gain[s] - j_gain[s]) <= 1e-6 * abs(j_gain[s]), \
            (s, j_sf, t_sf, j_gain, t_gain)
        return False
    for name, a in (("left_child", j_lc), ("right_child", j_rc),
                    ("leaf_of_row", j_leaf), ("cat_bitset", j_cbs),
                    ("threshold", j_thr), ("internal_count", j_ic),
                    ("leaf_count", j_lcnt)):
        np.testing.assert_array_equal(getattr(tout, name).numpy(), a,
                                      err_msg=name)
    np.testing.assert_allclose(t_gain, j_gain, rtol=1e-4,
                               atol=1e-6 * np.abs(j_gain).max())
    for name, a in (("internal_value", j_iv), ("leaf_value", j_lv)):
        np.testing.assert_allclose(getattr(tout, name).numpy(), a,
                                   rtol=1e-5, atol=1e-5 * np.abs(a).max(),
                                   err_msg=name)
    return True


def _cat_splits(tout):
    sf = tout.split_feature.numpy()
    return sorted(set(int(f) for f in sf[sf >= 0]) & set(CATS))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cat_subset", [(0,), ()],
                         ids=["subset+onehot", "onehot"])
def test_level_grower_categorical_matches_jax(seed, cat_subset):
    jout, tout = _grow_both("level", seed=seed, cat_subset=cat_subset,
                            max_depth=4)
    assert _assert_same_cat_tree(jout, tout)
    assert _cat_splits(tout)                        # categorical splits ran


@pytest.mark.parametrize("case", [
    dict(num_leaves=15, seed=0), dict(num_leaves=31, seed=1),
    dict(num_leaves=15, max_depth=3, seed=2),
    dict(num_leaves=15, seed=3, cat_subset=()),
    dict(num_leaves=15, seed=4, quant=False)],
    ids=["L15", "L31", "L15-depth3", "L15-onehot", "L15-float"])
def test_leafwise_grower_categorical_matches_jax(case):
    jout, tout = _grow_both("leaf", **case)
    assert _assert_same_cat_tree(jout, tout)
    assert _cat_splits(tout)


def _both_train(X, y, valid=None, **kw):
    base = dict(objective="binary", categorical_features=CATS, seed=0)
    base.update(kw)
    jr = jax_train(X, y, JaxParams(**base), valid=valid)
    tr = train(X, y, GBDTParams(**base), valid=valid, device="cpu")
    return jr, tr


def _assert_same_booster(jb, tb, X, score_atol=1e-6):
    """Returns how many leading trees are identical: every tree, unless the
    float histograms' summation order flips a split at an f32 near-tie
    (asserted to be one), after which the boosters part.  The identical
    trees must agree in every integer array, category set and threshold,
    and route every row alike; the whole boosters' scores within rtol 1e-5
    (and ``score_atol``) when no tree parts."""
    T = jb.num_trees
    same = T
    for t in range(T):
        diff = (tb.split_feature[t] != jb.split_feature[t]) | \
            (tb.threshold_bin[t] != jb.threshold_bin[t])
        if jb.cat_bitset is not None and tb.cat_bitset is not None:
            diff |= (tb.cat_bitset[t] != jb.cat_bitset[t]).any(axis=-1)
        if diff.any():
            m = np.nonzero(diff)[0][0]
            assert abs(tb.split_gain[t, m] - jb.split_gain[t, m]) <= \
                1e-6 * abs(jb.split_gain[t, m]), (t, m)
            same = t
            break
    for k in ("split_feature", "threshold_bin", "left_child", "right_child",
              "threshold"):
        np.testing.assert_array_equal(getattr(tb, k)[:same],
                                      getattr(jb, k)[:same], err_msg=k)
    assert (tb.cat_bitset is None) == (jb.cat_bitset is None)
    if jb.cat_bitset is not None:
        np.testing.assert_array_equal(tb.cat_bitset[:same],
                                      jb.cat_bitset[:same])
    assert tb.categorical_features == jb.categorical_features
    np.testing.assert_array_equal(
        tb.predict_leaf(X, device="cpu")[:, :same],
        jb.predict_leaf(X)[:, :same])
    if same == T:
        np.testing.assert_allclose(tb.raw_scores(X, device="cpu"),
                                   jb.raw_scores(X), rtol=1e-5,
                                   atol=score_atol)
    return same


@pytest.mark.parametrize("growth", [dict(num_leaves=8),
                                    dict(max_depth=3)],
                         ids=["leaf", "level"])
@pytest.mark.parametrize("max_cat_to_onehot", [4, 10_000])
def test_train_matches_jax(growth, max_cat_to_onehot):
    """Column 0 (48 codes) takes the sorted-subset search and column 1 (3
    codes) one-vs-rest; forcing one-vs-rest leaves no category sets."""
    X, y, _ = _cat_data(n=2000, seed=5)
    jr, tr = _both_train(X, y, num_iterations=4, learning_rate=0.3,
                         min_data_in_leaf=5,
                         max_cat_to_onehot=max_cat_to_onehot, **growth)
    assert _assert_same_booster(jr.booster, tr.booster, X) == 4
    assert (tr.booster.cat_bitset is None) == (max_cat_to_onehot > 48)


def test_single_split_recovers_planted_subset():
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 32, 6000)
    in_set = np.zeros(32, bool)
    in_set[rng.choice(32, 16, replace=False)] = True
    X = np.column_stack([codes, rng.normal(size=6000)]).astype(np.float32)
    y = in_set[codes].astype(np.float32)
    kw = dict(objective="binary", categorical_features=(0,),
              num_iterations=1, num_leaves=2, learning_rate=1.0,
              min_data_in_leaf=5)
    b = train(X, y, GBDTParams(**kw), device="cpu").booster
    jb = jax_train(X, y, JaxParams(**kw)).booster
    assert b.split_feature[0, 0] == 0
    member = b.cat_bitset[0, 0, :32]
    assert (member == in_set).all() or (member == ~in_set).all()
    np.testing.assert_array_equal(b.cat_bitset, jb.cat_bitset)


@pytest.mark.parametrize("max_cat_to_onehot", [4, 10_000],
                         ids=["bitset", "onehot"])
def test_nan_and_unseen_codes_route_right(max_cat_to_onehot):
    X, y, _ = _cat_data(n=2000, seed=2)
    jr, tr = _both_train(X, y, num_iterations=6, num_leaves=8,
                         min_data_in_leaf=5,
                         max_cat_to_onehot=max_cat_to_onehot)
    b = tr.booster
    probe = np.array([[np.nan, 0, 0, 0, 0], [200.0, 0, 0, 0, 0],
                      [-3.0, 0, 0, 0, 0], [np.inf, 0, 0, 0, 0],
                      [np.nan, np.nan, 0, 0, 0], [60.0, 9.0, 0, 0, 0]],
                     np.float32)
    leaves = b.predict_leaf(probe, device="cpu")
    np.testing.assert_array_equal(leaves, jr.booster.predict_leaf(probe))
    # NaN, out-of-range, negative and infinite codes take the same path
    for r in (1, 2, 3):
        np.testing.assert_array_equal(leaves[0], leaves[r])
    np.testing.assert_array_equal(leaves[4], leaves[5])


def test_category_sets_through_serde_and_across_packages(tmp_path):
    X, y, _ = _cat_data(n=1500, seed=1)
    jr, tr = _both_train(X, y, num_iterations=4, num_leaves=8,
                         min_data_in_leaf=5)
    b = tr.booster
    assert b.cat_bitset is not None
    b2 = GBDTBooster.from_string(b.to_string())
    b.save(str(tmp_path / "m"))
    b3 = GBDTBooster.load(str(tmp_path / "m"))
    jb = jr.booster
    b4 = GBDTBooster.from_string(jb.to_string())
    b5 = convert.booster_from_arrays(
        {k: getattr(jb, k) for k in jb._ARRAYS + jb._OPT_ARRAYS},
        {k: getattr(jb, k) for k in jb._META})
    j2 = JaxBooster.from_string(b.to_string())
    for other in (b2, b3, b4, b5, j2):
        np.testing.assert_array_equal(other.cat_bitset, b.cat_bitset)
        assert other.categorical_features == list(CATS)
    for other in (b2, b3, b4, b5):
        np.testing.assert_array_equal(other.predict_leaf(X, device="cpu"),
                                      jb.predict_leaf(X))
    np.testing.assert_array_equal(j2.predict_leaf(X),
                                  b.predict_leaf(X, device="cpu"))


@pytest.mark.parametrize("B", [63, 255, 16])
def test_resolve_cat_bitset_equals_the_reference(B):
    X, y, _ = _cat_data(n=1500, seed=3)
    for mc in (4, 10_000):
        jb, tb = (r.booster for r in _both_train(
            X, y, num_iterations=3, num_leaves=8, min_data_in_leaf=5,
            max_cat_to_onehot=mc))
        np.testing.assert_array_equal(tb.resolve_cat_bitset(B),
                                      jb.resolve_cat_bitset(B))


@pytest.mark.parametrize("first_onehot", [False, True])
def test_warm_start_preserves_category_sets(first_onehot):
    """A warm start continues the reference's way: the first booster's
    trees and sets are kept (one-vs-rest trees turn into one-bit sets),
    and the continued scores follow the reference's."""
    X, y, _ = _cat_data(n=1500, seed=6)
    kw = dict(num_leaves=8, learning_rate=0.3, min_data_in_leaf=5)
    j1, t1 = _both_train(X, y, num_iterations=3, max_cat_to_onehot=(
        10_000 if first_onehot else 4), **kw)
    base = dict(objective="binary", categorical_features=CATS, seed=0,
                num_iterations=3, **kw)
    jb = jax_train(X, y, JaxParams(**base),
                   init_booster=j1.booster).booster
    tb = train(X, y, GBDTParams(**base), init_booster=t1.booster,
               device="cpu").booster
    assert tb.num_trees == 6 and tb.cat_bitset.shape[0] == 6
    np.testing.assert_array_equal(tb.cat_bitset[:3],
                                  t1.booster.resolve_cat_bitset(255))
    assert _assert_same_booster(jb, tb, X) >= 3


def test_valid_set_and_dart_walk_categorical_trees():
    """The binned walker routes categories on the valid set and in DART's
    re-scoring of dropped trees, as the reference's does."""
    X, y, _ = _cat_data(n=2400, seed=7)
    jr, tr = _both_train(X[:2000], y[:2000], valid=(X[2000:], y[2000:]),
                         num_iterations=6, num_leaves=8,
                         min_data_in_leaf=5, boosting_type="dart",
                         skip_drop=0.0, metric="auc")
    assert _assert_same_booster(jr.booster, tr.booster, X) == 6
    np.testing.assert_allclose([e["auc"] for e in tr.evals],
                               [e["auc"] for e in jr.evals], rtol=1e-6)


def test_categorical_index_range_is_checked():
    X, y, _ = _cat_data(n=300)
    for bad in ((5,), (-1,)):
        for fn, P in ((train, GBDTParams), (jax_train, JaxParams)):
            kw = dict(device="cpu") if fn is train else {}
            with pytest.raises(ValueError, match="out of range"):
                fn(X, y, P(num_leaves=4, categorical_features=bad), **kw)


def test_estimator_cardinality_split_and_params():
    rng = np.random.default_rng(11)
    n = 1200
    hi = rng.integers(0, 40, n)
    lo = rng.integers(0, 3, n)
    y = ((hi % 3 == 0) ^ (lo == 1)).astype(np.float64)
    X = np.column_stack([hi, lo]).astype(np.float64)
    df = DataFrame.from_dict({"features": X, "label": y})
    est = LightGBMClassifier().set_params(
        num_iterations=6, num_leaves=8, categorical_features=[0, 1],
        min_data_in_leaf=5, device="cpu")
    b = est.fit(df).booster
    assert b.cat_bitset is not None and b.categorical_features == [0, 1]
    out = est.fit(df).transform(df).collect()
    assert (np.asarray(out["prediction"]) == y).mean() > 0.85
    p = est.set_params(max_cat_to_onehot=50, cat_smooth=5.0, cat_l2=1.0,
                       max_cat_threshold=8)._gbdt_params()
    assert (p.max_cat_to_onehot, p.cat_smooth, p.cat_l2,
            p.max_cat_threshold) == (50, 5.0, 1.0, 8)
    assert est.fit(df).booster.cat_bitset is None   # 40 codes <= 50
