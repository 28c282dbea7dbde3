"""Feature contributions and booster merging in the port
(``mmlspark_tpu_torch/models/gbdt.py``: ``predict_contrib`` with
``tree_shap`` and ``saabas``, ``tree_shap``, ``GBDTBooster.merge``; the
models' ``predict_contrib``) against the JAX package on the CPU.

The boosters are fitted by the port on the CPU and carried to the JAX
package by ``to_string``/``from_string``, so both sides hold the same
trees.  Contributions must equal the JAX package's within 1e-9 (both sum
float64 values in the same order; TreeSHAP is the same host recursion)
and each row must sum to ``raw_scores`` within 1e-5 — for Saabas, each
row whose path crosses no node that does not split (the reference's walk
drops that step; ROADMAP.md §3.11).  A merged booster must equal the JAX
package's merge in every array.
"""
import numpy as np
import pytest

from mmlspark_tpu.core import DataFrame as JaxDataFrame
from mmlspark_tpu.lightgbm import estimators as jax_est
from mmlspark_tpu.models.gbdt import GBDTBooster as JaxBooster
from mmlspark_tpu_torch.core import DataFrame
from mmlspark_tpu_torch.lightgbm import GBDTParams, estimators as port_est
from mmlspark_tpu_torch.lightgbm import train
from mmlspark_tpu_torch.models.gbdt import GBDTBooster, tree_shap

ARRAYS = GBDTBooster._ARRAYS


def _data(n=800, f=6, seed=0, cat=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    if cat:
        X[:, 4] = rng.integers(0, 3, n)
        X[:, 5] = rng.integers(0, 40, n)
    X[rng.random((n, f)) < 0.02] = np.nan
    y = (np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 1])
         + (np.nan_to_num(X[:, 5]) % 3 == 0 if cat else 0)
         + rng.normal(scale=0.3, size=n) > 0.3).astype(np.float32)
    return X, y


FITS = {
    "leafwise": dict(num_iterations=5, num_leaves=8),
    "levelwise": dict(num_iterations=4, max_depth=3),
    "dart": dict(num_iterations=6, num_leaves=6, boosting_type="dart",
                 drop_rate=0.5, skip_drop=0.0),
    "regression": dict(num_iterations=4, num_leaves=8,
                       objective="regression"),
    "categorical": dict(num_iterations=4, num_leaves=8,
                        categorical_features=[4, 5]),
}


def _fit(kind, seed=0):
    X, y = _data(seed=seed, cat=kind == "categorical")
    kw = dict(FITS[kind])
    kw.setdefault("objective", "binary")
    booster = train(X, y, GBDTParams(**kw), device="cpu").booster
    return X, booster, JaxBooster.from_string(booster.to_string())


@pytest.mark.parametrize("method", ["tree_shap", "saabas"])
@pytest.mark.parametrize("kind", sorted(FITS))
def test_contributions_equal_the_reference_and_sum_to_the_raw_score(kind,
                                                                    method):
    X, booster, ref = _fit(kind)
    rows = X[:60]
    got = booster.predict_contrib(rows, method=method, device="cpu")
    want = ref.predict_contrib(rows, method=method)
    assert got.shape == (60, X.shape[1] + 1) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    raw = booster.raw_scores(rows, device="cpu")[:, 0]
    if method == "saabas":
        # the reference's Saabas walk attributes nothing at a node that does
        # not split (a level-wise tree's pass-through node), so a row whose
        # path crosses one loses that step's delta in both packages
        # (ROADMAP.md §3.11); every other row sums to its raw score
        exact = ~_crosses_a_pass_through(booster, rows)
        assert exact.sum() >= 40
        got, raw = got[exact], raw[exact]
    np.testing.assert_allclose(got.sum(axis=1), raw, rtol=0, atol=1e-5)
    if method == "tree_shap":
        np.testing.assert_array_equal(tree_shap(booster, rows), got)


def _crosses_a_pass_through(booster, X):
    """(n,) whether a row's path meets an internal node that does not
    split, in any tree (numerical splits: NaN goes left)."""
    out = np.zeros(len(X), bool)
    for i, x in enumerate(X):
        for t in range(booster.num_trees):
            j = 0
            while j >= 0:
                f = booster.split_feature[t, j]
                if f < 0:
                    out[i] = True
                    j = booster.left_child[t, j]
                    continue
                right = x[f] > booster.threshold[t, j]
                j = (booster.right_child if right else booster.left_child)[
                    t, j]
    return out


@pytest.mark.parametrize("method", ["tree_shap", "saabas"])
def test_multiclass_contributions_refuse_alike(method):
    rng = np.random.default_rng(1)
    X = rng.normal(size=(300, 4)).astype(np.float32)
    y = np.argmax(X[:, :3], axis=1).astype(np.float32)
    booster = train(X, y, GBDTParams(num_iterations=2, num_leaves=4,
                                     objective="multiclass", num_class=3),
                    device="cpu").booster
    ref = JaxBooster.from_string(booster.to_string())
    with pytest.raises(ValueError, match="multiclass"):
        ref.predict_contrib(X[:4], method=method)
    with pytest.raises(ValueError, match="multiclass"):
        booster.predict_contrib(X[:4], method=method, device="cpu")


@pytest.mark.parametrize("pair", [("leafwise", "levelwise"),
                                  ("leafwise", "dart"),
                                  ("categorical", "categorical")],
                         ids=["leaf+level", "leaf+dart", "cat+cat"])
def test_merge_equals_the_reference_merge(pair):
    X, a, ra = _fit(pair[0], seed=0)
    _, b, rb = _fit(pair[1], seed=3)
    if pair[0] != pair[1]:
        # merge needs one leaf width: pad the narrower booster's leaves
        L = max(a.num_leaves, b.num_leaves)
        a, b = (GBDTBooster.from_string(_pad_leaves(x, L).to_string())
                for x in (a, b))
        ra, rb = (JaxBooster.from_string(x.to_string()) for x in (a, b))
    got, want = a.merge(b), ra.merge(rb)
    for k in ARRAYS:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    assert (got.cat_bitset is None) == (want.cat_bitset is None)
    if got.cat_bitset is not None:
        np.testing.assert_array_equal(got.cat_bitset, want.cat_bitset)
    assert (got.max_depth, got.num_trees) == (want.max_depth, want.num_trees)
    np.testing.assert_allclose(
        got.raw_scores(X[:50], device="cpu")[:, 0],
        a.raw_scores(X[:50], device="cpu")[:, 0]
        + b.raw_scores(X[:50], device="cpu")[:, 0] - b.init_score,
        rtol=0, atol=1e-5)


def _pad_leaves(booster, L):
    """The same trees with ``L`` leaf and ``L - 1`` node slots (unused
    slots are unreachable), so boosters of different widths merge."""
    def pad(a, width, fill):
        out = np.full((a.shape[0], width) + a.shape[2:], fill, a.dtype)
        out[:, :a.shape[1]] = a
        return out
    M = L - 1
    kw = {k: pad(getattr(booster, k), M, 0) for k in (
        "threshold", "threshold_bin", "split_gain", "internal_value",
        "internal_count", "left_child", "right_child")}
    kw["split_feature"] = pad(booster.split_feature, M, -1)
    return GBDTBooster(
        leaf_value=pad(booster.leaf_value, L, 0),
        leaf_count=pad(booster.leaf_count, L, 0),
        tree_weight=booster.tree_weight, max_depth=booster.max_depth,
        num_features=booster.num_features, objective=booster.objective,
        init_score=booster.init_score, sigmoid=booster.sigmoid,
        categorical_features=booster.categorical_features, **kw)


def test_the_model_writes_the_reference_contribution_column():
    X, y = _data()
    cols = {"features": X, "label": y}
    kw = dict(num_iterations=3, num_leaves=6)
    model = port_est.LightGBMClassifier().set_params(device="cpu", **kw).fit(
        DataFrame.from_dict(cols))
    jmodel = jax_est.LightGBMClassificationModel()
    jmodel.set("booster", JaxBooster.from_string(model.booster.to_string()))
    jmodel.set("classes", [0.0, 1.0])
    got = model.predict_contrib(DataFrame.from_dict(cols)).collect()
    want = jmodel.predict_contrib(JaxDataFrame.from_dict(cols)).collect()
    np.testing.assert_allclose(np.stack(got["features_shap"]),
                               np.stack(want["features_shap"]), rtol=0,
                               atol=1e-9)
    saabas = model.predict_contrib(DataFrame.from_dict(cols),
                                   method="saabas").collect()
    np.testing.assert_allclose(
        np.stack(saabas["features_shap"]),
        model.booster.predict_contrib(X, method="saabas", device="cpu"),
        rtol=0, atol=0)
