"""Port parity for GBDT training: the port's level-wise grower, ``train()``
and estimators against the JAX package.

- Grower parity: the same binned data, gradients and quantizer uniforms go
  to both growers (JAX forced onto its fused Pallas path, interpret mode,
  run eagerly so its uniforms are the ones this test rebuilds).  Tree
  structure and every row's leaf must be identical, except that a split may
  differ at an f32 near-tie (best gains within 1e-6 relative: both packages
  scan bins in f32, in different orders); leaf values agree within rtol
  1e-5 for the same reason.
- ``train()`` parity: each package draws its own quantizer noise, so the
  boosters are held by quality: accuracy within 0.02, logloss within 2%.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu.lightgbm import GBDTParams as JaxParams
from mmlspark_tpu.lightgbm import core as jax_core
from mmlspark_tpu.lightgbm import train as jax_train
from mmlspark_tpu.lightgbm.binning import BinMapper as JaxBinMapper
from mmlspark_tpu.ops import pallas_histogram as JP
from mmlspark_tpu_torch.core import DataFrame
from mmlspark_tpu_torch.lightgbm import (GBDTParams, LightGBMClassifier,
                                         LightGBMRegressor, train)
from mmlspark_tpu_torch.lightgbm import core as port_core
from mmlspark_tpu_torch.ops import cuda_histogram as TP

from tests.test_torch_histogram import _jax_uniforms


def _data(n=1500, f=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] * 2 - X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
         + rng.normal(scale=0.5, size=n) > 0).astype(np.float32)
    return X, y


def _grow_both(depth, max_bin=63, seed=0, **kw):
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
    params = dict(max_depth=depth, objective="binary", seed=seed,
                  use_quantized_grad=True, lambda_l2=0.5,
                  min_data_in_leaf=10, **kw)
    jgrow = jax_core.make_tree_grower(
        depth, F, max_bin, JaxParams(**params).resolve(), backend="pallas")
    jout = jgrow(jnp.asarray(binned), jnp.asarray(g), jnp.asarray(h),
                 jnp.asarray(mask), jnp.asarray(fmask),
                 jnp.asarray(mapper.edges))
    u = _jax_uniforms(g, h, seed)
    pgrow = port_core.make_tree_grower(depth, F, max_bin,
                                       GBDTParams(**params).resolve())
    tout = pgrow(torch.from_numpy(binned), torch.from_numpy(g),
                 torch.from_numpy(h), torch.from_numpy(mask),
                 torch.from_numpy(fmask), torch.from_numpy(mapper.edges),
                 noise=torch.from_numpy(np.array(u)))
    return [np.asarray(a) for a in jout], tout


def _assert_same_tree(jout, tout):
    (_, _, j_sf, j_thr, j_tb, j_gain, j_iv, j_ic, j_lv, j_lc, _,
     j_leaf) = jout
    same = (tout.split_feature.numpy() == j_sf) & \
        (tout.threshold_bin.numpy() == j_tb)
    t_gain = tout.split_gain.numpy()
    tie = np.abs(t_gain - j_gain) <= 1e-6 * np.abs(j_gain)
    assert np.all(same | tie), (j_sf, tout.split_feature, j_gain, t_gain)
    if not same.all():
        return False        # a near-tie flipped a split: subtrees differ
    np.testing.assert_array_equal(tout.leaf_of_row.numpy(), j_leaf)
    np.testing.assert_array_equal(tout.threshold.numpy(), j_thr)
    np.testing.assert_array_equal(tout.internal_count.numpy(), j_ic)
    np.testing.assert_array_equal(tout.leaf_count.numpy(), j_lc)
    # a gain is score(L) + score(R) - score(parent): the f32 rounding of
    # the scores, far larger than the gain itself, sets its error
    np.testing.assert_allclose(t_gain, j_gain, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tout.internal_value.numpy(), j_iv, rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(tout.leaf_value.numpy(), j_lv, rtol=1e-5,
                               atol=1e-7)
    return True


@pytest.mark.parametrize("seed", [0, 1])
def test_level_grower_matches_jax_fused_path(seed):
    jout, tout = _grow_both(4, seed=seed)
    assert _assert_same_tree(jout, tout)
    assert (tout.split_feature.numpy() >= 0).sum() > 7   # real splits


def test_fused_to_plain_handoff_matches_jax(monkeypatch):
    """FUSED_MAX_NODES lowered to 2 on both sides: levels 0-2 take the fused
    step, level 3 (4 parents) the histogram build + torch gain scan, which
    consumes the fused level's parent histograms and small_left."""
    monkeypatch.setattr(JP, "FUSED_MAX_NODES", 2)
    monkeypatch.setattr(TP, "FUSED_MAX_NODES", 2)
    assert 2 ** (4 - 1) // 2 > TP.FUSED_MAX_NODES
    jout, tout = _grow_both(4, seed=2)
    assert _assert_same_tree(jout, tout)


def test_unquantized_grower_runs_float_path():
    X, y = _data(n=800)
    r = train(X, y, GBDTParams(num_iterations=3, max_depth=3,
                               objective="binary"), device="cpu")
    assert r.booster.num_trees == 3      # CPU default: float histograms
    acc = ((r.booster.predict(X, device="cpu") > 0.5) == (y > 0)).mean()
    assert acc > 0.75


def _logloss(y, p):
    p = np.clip(p, 1e-15, 1 - 1e-15)
    return float(-(y * np.log(p) + (1 - y) * np.log(1 - p)).mean())


def test_train_matches_jax_quality(monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_HIST_BACKEND", "pallas")
    X, y = _data(n=2500, f=10, seed=7)
    Xtr, ytr, Xte, yte = X[:2000], y[:2000], X[2000:], y[2000:]
    kw = dict(num_iterations=8, max_depth=4, objective="binary", seed=3,
              use_quantized_grad=True)
    jb = jax_train(Xtr, ytr, JaxParams(**kw)).booster
    tb = train(Xtr, ytr, GBDTParams(**kw), device="cpu").booster
    jp, tp = jb.predict(Xte), tb.predict(Xte, device="cpu")
    j_acc = float(((jp > 0.5) == (yte > 0)).mean())
    t_acc = float(((tp > 0.5) == (yte > 0)).mean())
    assert abs(t_acc - j_acc) <= 0.02, (t_acc, j_acc)
    j_ll, t_ll = _logloss(yte, jp), _logloss(yte, tp)
    assert abs(t_ll - j_ll) <= 0.02 * j_ll, (t_ll, j_ll)
    assert tb.num_trees == 8 and tb.max_depth == 4


def test_train_valid_early_stopping_and_warm_start():
    X, y = _data(n=1200, seed=4)
    kw = dict(max_depth=3, objective="binary", use_quantized_grad=True)
    r = train(X[:900], y[:900], GBDTParams(num_iterations=60,
                                           early_stopping_round=3,
                                           learning_rate=0.5, **kw),
              valid=(X[900:], y[900:]), device="cpu")
    assert len(r.evals) < 60 and r.booster.num_trees == len(r.evals)
    assert r.booster.best_iteration == len(r.evals) - 4
    base = train(X, y, GBDTParams(num_iterations=3, **kw), device="cpu")
    more = train(X, y, GBDTParams(num_iterations=2, **kw), device="cpu",
                 init_booster=base.booster)
    assert more.booster.num_trees == 5
    np.testing.assert_array_equal(more.booster.split_feature[:3],
                                  base.booster.split_feature)
    ll = [_logloss(y, b.predict(X, device="cpu"))
          for b in (base.booster, more.booster)]
    assert ll[1] < ll[0]


def test_regression_objective_trains():
    X, _ = _data(n=1000, seed=5)
    y = (2 * X[:, 0] - X[:, 1]).astype(np.float32)
    r = train(X, y, GBDTParams(num_iterations=10, max_depth=3,
                               objective="regression", learning_rate=0.3),
              device="cpu")
    mse = float(np.mean((r.booster.predict(X, device="cpu") - y) ** 2))
    assert mse < 0.5 * float(np.var(y))


def test_estimator_fit_transform_on_the_ports_dataframe():
    X, y = _data(n=1200, f=5, seed=6)
    df = DataFrame.from_dict({"features": X, "label": y}, 2)
    model = LightGBMClassifier().set_params(
        max_depth=4, num_iterations=6, device="cpu",
        use_quantized_grad=True).fit(df)
    out = model.transform(df).collect()
    assert (out["prediction"] == y).mean() > 0.8
    assert out["probability"][0].shape == (2,)
    reg = LightGBMRegressor().set_params(max_depth=3, num_iterations=3,
                                         device="cpu").fit(df)
    assert reg.transform(df).collect()["prediction"].shape == (1200,)


def test_not_ported_paths_raise_with_their_roadmap_entry():
    X, y = _data(n=300)
    for params, entry in (
            (GBDTParams(num_leaves=31, categorical_features=(0,)),
             "categorical"),
            (GBDTParams(num_leaves=31, objective="multiclass", num_class=3),
             "multiclass"),
            (GBDTParams(num_leaves=31, objective="huber"), "multiclass")):
        with pytest.raises(NotImplementedError, match=entry):
            train(X, y, params, device="cpu")
    with pytest.raises(NotImplementedError, match="NCCL"):
        train(X, y, GBDTParams(max_depth=2), shard_rows=True, device="cpu")
    df = DataFrame.from_dict({"features": X, "label": y})
    with pytest.raises(NotImplementedError, match="categorical"):
        LightGBMClassifier().set_params(categorical_features=[0],
                                        device="cpu").fit(df)
