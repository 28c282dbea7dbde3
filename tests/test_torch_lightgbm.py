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
                                       GBDTParams(**params).resolve(),
                                       backend="pallas")
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
    """Every path these raised for is ported: row sharding on a mesh of one
    position grows the unsharded booster (nothing to sum), and multiclass,
    lambdarank and ``group_ptr`` train."""
    X, y = _data(n=300)
    sharded = train(X, y, GBDTParams(max_depth=2), device="cpu",
                    shard_rows=True)
    plain = train(X, y, GBDTParams(max_depth=2), device="cpu")
    assert sharded.extras["shard_count"] == 1.0
    for k in ("split_feature", "threshold_bin", "leaf_value"):
        np.testing.assert_array_equal(getattr(sharded.booster, k),
                                      getattr(plain.booster, k))
    y3 = (np.arange(300) % 3).astype(np.float32)
    gp = np.array([0, 150, 300])
    for params, yy, kw, trees in (
            (GBDTParams(num_leaves=31, objective="multiclass", num_class=3,
                        num_iterations=2), y3, {}, 6),
            (GBDTParams(num_leaves=31, objective="lambdarank",
                        num_iterations=2), y3, dict(group_ptr=gp), 2),
            (GBDTParams(num_leaves=31, objective="regression",
                        num_iterations=2), y, dict(group_ptr=gp), 2)):
        b = train(X, yy, params, device="cpu", **kw).booster
        assert b.num_trees == trees and b.objective == params.objective
    df = DataFrame.from_dict({"features": X, "label": y3.astype(float)})
    model = LightGBMClassifier().set_params(device="cpu",
                                            num_iterations=2).fit(df)
    assert model.booster.num_class == 3
    assert np.stack(model.transform(df).collect()["probability"]).shape \
        == (300, 3)


# ---------------------------------------------------------------------------
# metrics and the regression objectives
# ---------------------------------------------------------------------------

METRIC_NAMES = sorted(jax_core.METRICS) + ["pinball", "tweedie_nll"]
REG_OBJECTIVES = ("regression_l1", "huber", "quantile", "poisson",
                  "tweedie", "gamma")


def _counts(n=2000, f=5, seed=0):
    """Poisson counts with a log-linear mean: a label every objective and
    metric accepts (gamma and tweedie take them shifted by 0.5)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = rng.poisson(np.exp(0.6 * X[:, 0] - 0.4 * X[:, 1] + 0.3)) \
        .astype(np.float32)
    return X, y


@pytest.mark.parametrize("name", METRIC_NAMES)
@pytest.mark.parametrize("weighted", [False, True])
def test_metric_functions_equal_the_reference(name, weighted):
    rng = np.random.default_rng(1)
    n = 300
    K = 3 if name == "multi_logloss" else 1
    raw = rng.normal(size=(n, K))
    y = rng.integers(0, K, n).astype(np.float32) if K > 1 else \
        rng.poisson(1.5, n).astype(np.float32)
    w = rng.random(n) if weighted else None
    for alpha, rho in ((0.9, 1.5), (0.3, 1.2)):
        kw = dict(alpha=alpha, tweedie_variance_power=rho)
        jfn, jlb = jax_core.resolve_metric(name, JaxParams(**kw))
        tfn, tlb = port_core.resolve_metric(name, GBDTParams(**kw))
        assert tlb == jlb
        assert tfn(y, raw, w) == jfn(y, raw, w)


@pytest.mark.parametrize("objective", list(REG_OBJECTIVES) + [
    "binary", "regression", "multiclass", "lambdarank", "no_such"])
def test_default_metric_and_fallback_equal_the_reference(objective):
    assert port_core.default_metric(objective) == \
        jax_core.default_metric(objective)
    X, y = _counts(n=200)
    raw = np.log(y.mean() + 0.5) + np.zeros((200, 1))
    if objective == "multiclass":
        raw, y = np.random.default_rng(0).normal(size=(200, 3)), y % 3
    for name in ("", "no_such_metric"):      # unknown -> the default
        jfn, jlb = jax_core.resolve_metric(name, JaxParams(
            objective=objective, alpha=0.4))
        tfn, tlb = port_core.resolve_metric(name, GBDTParams(
            objective=objective, alpha=0.4))
        assert (tlb, tfn(y, raw)) == (jlb, jfn(y, raw))


@pytest.mark.parametrize("name", [m for m in METRIC_NAMES
                                  if m != "multi_logloss"])
def test_train_evals_equal_the_reference(name):
    """``TrainResult.evals`` for every single-output metric name, on a
    regression fit with a valid set (float histograms, the CPU default of
    both packages): the same name booked, values within rtol 1e-6."""
    X, y = _counts(seed=2)
    kw = dict(objective="regression", metric=name, num_leaves=7,
              num_iterations=3)
    jr = jax_train(X[:1500], y[:1500], JaxParams(**kw),
                   valid=(X[1500:], y[1500:]))
    tr = train(X[:1500], y[:1500], GBDTParams(**kw),
               valid=(X[1500:], y[1500:]), device="cpu")
    assert [set(e) for e in tr.evals] == [set(e) for e in jr.evals]
    np.testing.assert_allclose([e[name] for e in tr.evals],
                               [e[name] for e in jr.evals], rtol=1e-6)


def test_poisson_nll_on_a_regression_fit_is_scored_as_poisson_nll():
    """ROADMAP fault 3.1: ``metric="poisson_nll"`` on a regression fit was
    scored with l2 (0.0555 against the reference's 1.7320 on a 2,000 x 5
    input the repo does not hold).  The same call on a seeded 2,000 x 5
    input: the reference's value within rtol 1e-6, far from the l2 value
    the port used to book."""
    X, y = _data(n=2500, f=5, seed=0)
    kw = dict(objective="regression", metric="poisson_nll", num_leaves=7,
              num_iterations=3)
    jr = jax_train(X[:2000], y[:2000], JaxParams(**kw),
                   valid=(X[2000:], y[2000:]))
    tr = train(X[:2000], y[:2000], GBDTParams(**kw),
               valid=(X[2000:], y[2000:]), device="cpu")
    want = jr.evals[-1]["poisson_nll"]
    np.testing.assert_allclose(tr.evals[-1]["poisson_nll"], want, rtol=1e-6)
    raw = tr.booster.raw_scores(X[2000:], device="cpu")
    l2 = port_core._metric_l2(y[2000:], raw)
    assert abs(want - l2) > 0.5


def _objective_labels(objective, y):
    return y + 0.5 if objective in ("gamma", "tweedie") else y


@pytest.mark.parametrize("objective", REG_OBJECTIVES)
def test_objective_gradients_equal_the_reference(objective):
    """Gradients within 1e-6 of ``|grad| + |hess|``: a log-link gradient is
    a difference of exponentials (each within an ulp or two of the
    reference's), which the hessian's magnitude bounds; hessians within
    rtol 1e-6.  Scores run past the clips at ±30."""
    X, y = _counts(n=500, seed=3)
    y = _objective_labels(objective, y)
    rng = np.random.default_rng(4)
    s = np.concatenate([rng.normal(size=480) * 2, [-40, 40, -30, 30, 0] * 4])
    w = rng.random(500).astype(np.float32) + 0.5
    kw = dict(objective=objective, alpha=0.7, tweedie_variance_power=1.3)
    jg, jh = jax_core.make_objective(JaxParams(**kw))(
        jnp.asarray(s[:, None], jnp.float32), jnp.asarray(y),
        jnp.asarray(w))
    tg, th = port_core.make_objective(GBDTParams(**kw))(
        torch.from_numpy(s[:, None].astype(np.float32)), torch.from_numpy(y),
        torch.from_numpy(w))
    jg, jh = np.asarray(jg, np.float64), np.asarray(jh, np.float64)
    assert (np.abs(tg.numpy() - jg) <= 1e-6 * (np.abs(jg) + jh)).all()
    np.testing.assert_allclose(th.numpy(), jh, rtol=1e-6)


@pytest.mark.parametrize("growth", [dict(num_leaves=7), dict(max_depth=3)],
                         ids=["leaf", "level"])
@pytest.mark.parametrize("objective", REG_OBJECTIVES)
def test_objective_trains_as_the_reference(objective, growth):
    """Each objective's starting score, trees and scores against the
    reference's ``train()`` (float histograms on both sides): integer
    arrays identical unless an f32 near-tie parts the boosters, raw scores
    within rtol 1e-5 when none does, and the default metric booked and
    falling."""
    from tests.test_torch_categorical import _assert_same_booster
    X, y = _counts(seed=5)
    y = _objective_labels(objective, y)
    kw = dict(objective=objective, num_iterations=5, learning_rate=0.3,
              alpha=0.7, tweedie_variance_power=1.3, **growth)
    valid = (X[1600:], y[1600:])
    jr = jax_train(X[:1600], y[:1600], JaxParams(**kw), valid=valid)
    tr = train(X[:1600], y[:1600], GBDTParams(**kw), valid=valid,
               device="cpu")
    jb, tb = jr.booster, tr.booster
    np.testing.assert_allclose(tb.init_score, jb.init_score, rtol=1e-7)
    assert tb.objective == objective
    assert _assert_same_booster(jb, tb, X) == 5
    np.testing.assert_allclose(tb.predict(X, device="cpu"), jb.predict(X),
                               rtol=1e-5, atol=1e-6)
    name = jax_core.default_metric(objective)
    got = [e[name] for e in tr.evals]
    np.testing.assert_allclose(got, [e[name] for e in jr.evals], rtol=1e-6)
    assert np.isfinite(got).all() and got[-1] < got[0]


def test_objective_label_and_power_errors_equal_the_reference():
    X, y = _counts(n=300)
    for objective, labels, kw, msg in (
            ("poisson", y - 1, {}, "non-negative"),
            ("tweedie", y - 1, {}, "non-negative"),
            ("gamma", y, {}, "strictly positive"),
            ("tweedie", y + 1, dict(tweedie_variance_power=2.0),
             "tweedie_variance_power"),
            ("tweedie", y + 1, dict(tweedie_variance_power=1.0),
             "tweedie_variance_power")):
        for fn, P, extra in ((train, GBDTParams, dict(device="cpu")),
                             (jax_train, JaxParams, {})):
            with pytest.raises(ValueError, match=msg):
                fn(X, labels, P(objective=objective, num_leaves=4, **kw),
                   **extra)
    with pytest.raises(ValueError, match="unknown objective"):
        train(X, y, GBDTParams(objective="no_such", num_leaves=4),
              device="cpu")


def test_regressor_carries_objective_alpha_and_power():
    X, y = _counts(n=1200, seed=6)
    df = DataFrame.from_dict({"features": X, "label": y + 0.5})
    for obj, kw in (("quantile", dict(alpha=0.2)),
                    ("tweedie", dict(tweedie_variance_power=1.7)),
                    ("gamma", {})):
        est = LightGBMRegressor().set_params(objective=obj, num_iterations=3,
                                             device="cpu", **kw)
        model = est.fit(df)
        assert model.booster.objective == obj
        pred = model.transform(df).collect()["prediction"]
        assert pred.shape == (1200,) and np.isfinite(pred).all()
    # alpha reaches train(): a low quantile predicts below a high one
    lo, hi = (LightGBMRegressor().set_params(
        objective="quantile", alpha=a, num_iterations=20, learning_rate=0.3,
        device="cpu").fit(df).transform(df).collect()["prediction"]
        for a in (0.1, 0.9))
    assert (lo < hi).mean() > 0.9
