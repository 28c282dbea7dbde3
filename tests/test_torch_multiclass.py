"""Port parity for multiclass: the softmax objective, ``train()`` with one
tree per class per iteration in both growers and every boosting mode, the
classifier with more than two labels, and multiclass boosters carried
across from the JAX package.

- Gradients: the same seeded scores, labels and weights through both
  packages' objectives: within rtol 1e-6 and atol 1e-6 (the values are
  probabilities in [-1, 1]; XLA's CPU ``exp`` and torch's differ by a few
  f32 ulps, up to 4.3e-7 absolute at K = 7).
- ``train()``: float histograms, the CPU default of both packages.  The
  boosters agree in every integer array (``same_booster``, the
  categorical tests' ``_assert_same_booster``: unless an f32 near-tie
  parts them, asserted to be one), raw scores within rtol 1e-5
  and an absolute 1e-5 of the largest score (a class's score near zero is
  a sum of leaf values each rounded at f32 in a different summation
  order), ``multi_logloss`` evals within rtol 1e-6.  DART, RF and bagging draw
  on the host in the JAX package's order, so they are held the same way.
  GOSS samples with each package's own generator, so it is held by the
  rows it keeps (the same count at every tree) and by quality.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu.lightgbm import GBDTParams as JaxParams
from mmlspark_tpu.lightgbm import LightGBMClassifier as JaxClassifier
from mmlspark_tpu.lightgbm import core as jax_core
from mmlspark_tpu.lightgbm import train as jax_train
from mmlspark_tpu.core import DataFrame as JaxDataFrame
from mmlspark_tpu_torch import convert
from mmlspark_tpu_torch.core import DataFrame
from mmlspark_tpu_torch.lightgbm import (GBDTParams, LightGBMClassifier,
                                         train)
from mmlspark_tpu_torch.lightgbm import core as port_core
from mmlspark_tpu_torch.lightgbm.binning import BinMapper
from mmlspark_tpu_torch.models.gbdt import GBDTBooster

from tests.test_torch_categorical import _assert_same_booster


def _mc_data(n=2000, f=6, K=3, seed=0, noise=0.5):
    """The argmax of K fixed linear projections of the features plus
    noise: K classes, each a linear region."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    W = np.random.default_rng(100 + K).normal(size=(K, f))
    y = np.argmax(X @ W.T + rng.normal(scale=noise, size=(n, K)), axis=1)
    return X, y.astype(np.float32)


def same_booster(jb, tb, X):
    """``_assert_same_booster`` with the scores held within rtol 1e-5 and
    1e-5 of the largest score: how many leading trees are identical."""
    assert tb.num_class == jb.num_class
    return _assert_same_booster(
        jb, tb, X, score_atol=1e-5 * float(np.abs(jb.raw_scores(X)).max()))


def _multi_logloss(y, prob):
    return float(-np.log(np.clip(prob[np.arange(len(y)), y.astype(int)],
                                 1e-15, None)).mean())


@pytest.mark.parametrize("K", [3, 7])
@pytest.mark.parametrize("weighted", [False, True])
def test_multiclass_gradients_equal_the_reference(K, weighted):
    rng = np.random.default_rng(K)
    n = 4000
    s = rng.normal(scale=2.0, size=(n, K)).astype(np.float32)
    y = rng.integers(0, K, n).astype(np.float32)
    w = (rng.random(n) + 0.5 if weighted else np.ones(n)).astype(np.float32)
    jg, jh = jax_core.make_objective(JaxParams(
        objective="multiclass", num_class=K))(jnp.asarray(s), jnp.asarray(y),
                                              jnp.asarray(w))
    tg, th = port_core.make_objective(GBDTParams(
        objective="multiclass", num_class=K))(torch.from_numpy(s),
                                              torch.from_numpy(y),
                                              torch.from_numpy(w))
    assert tg.shape == th.shape == (n, K)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6,
                               atol=1e-6)
    assert float(th.min()) >= 1e-16 * float(w.min())


GROWTH = {"leaf": dict(num_leaves=7), "level": dict(max_depth=3)}


def _both(X, y, valid=None, **kw):
    jr = jax_train(X, y, JaxParams(**kw), valid=valid)
    tr = train(X, y, GBDTParams(**kw), valid=valid, device="cpu")
    return jr, tr


@pytest.mark.parametrize("growth", sorted(GROWTH))
def test_multiclass_train_matches_jax(growth):
    X, y = _mc_data(n=2500, seed=1)
    jr, tr = _both(X[:2000], y[:2000], valid=(X[2000:], y[2000:]),
                   objective="multiclass", num_class=3, num_iterations=4,
                   **GROWTH[growth])
    jb, tb = jr.booster, tr.booster
    assert tb.num_trees == 12 and tb.num_class == 3 and tb.num_iterations == 4
    assert same_booster(jb, tb, X) == 12
    # round-robin: tree t scores class t % 3
    np.testing.assert_allclose(tb.raw_scores(X, num_iteration=2,
                                             device="cpu"),
                               jb.raw_scores(X, num_iteration=2), rtol=1e-5,
                               atol=1e-6)
    assert [set(e) for e in tr.evals] == [set(e) for e in jr.evals]
    t_ll = [e["multi_logloss"] for e in tr.evals]
    np.testing.assert_allclose(t_ll, [e["multi_logloss"] for e in jr.evals],
                               rtol=1e-6)
    assert t_ll[-1] < t_ll[0]
    np.testing.assert_allclose(tb.predict(X, device="cpu"), jb.predict(X),
                               rtol=1e-5, atol=1e-6)


MODES = {"dart": dict(boosting_type="dart", drop_rate=0.3, skip_drop=0.2,
                      learning_rate=0.3),
         "rf": dict(boosting_type="rf", feature_fraction=0.7),
         "bagging": dict(bagging_fraction=0.7, bagging_freq=2,
                         feature_fraction=0.8)}


@pytest.mark.parametrize("growth", sorted(GROWTH))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_multiclass_boosting_mode_matches_jax(mode, growth):
    """K = 3 with the host-drawn modes: the iteration's feature and bag
    draws are shared by its three trees, DART drops any of the earlier
    trees whatever their class and renormalises them on their own class."""
    X, y = _mc_data(n=2000, seed=2)
    jr, tr = _both(X, y, objective="multiclass", num_class=3,
                   num_iterations=5, seed=3, **GROWTH[growth], **MODES[mode])
    jb, tb = jr.booster, tr.booster
    assert tb.num_trees == 15 and tb.average_output == (mode == "rf")
    np.testing.assert_array_equal(tb.tree_weight, jb.tree_weight)
    np.testing.assert_array_equal(tb.internal_count[:, 0],
                                  jb.internal_count[:, 0])
    # a class's three trees of one iteration see the same bag
    roots = tb.internal_count[:, 0].reshape(5, 3)
    assert (roots == roots[:, :1]).all()
    if mode == "dart":
        assert (tb.tree_weight < 1).any()
    else:
        assert (roots < 2000).all()
    assert same_booster(jb, tb, X) == 15


@pytest.mark.parametrize("growth", sorted(GROWTH))
def test_multiclass_goss_keeps_the_reference_rows(growth):
    X, y = _mc_data(n=2500, seed=4)
    kw = dict(objective="multiclass", num_class=3, num_iterations=6,
              boosting_type="goss", seed=3, **GROWTH[growth])
    jr, tr = _both(X[:2000], y[:2000], **kw)
    jb, tb = jr.booster, tr.booster
    # GOSS over |g| summed across classes: top_rate + other_rate of the
    # rows at every tree (the first iteration samples too)
    want = int(0.2 * 2000) + int(0.1 * 2000)
    assert (tb.internal_count[:, 0] == want).all()
    np.testing.assert_array_equal(tb.internal_count[:, 0],
                                  jb.internal_count[:, 0])
    jp, tp = jb.predict(X[2000:]), tb.predict(X[2000:], device="cpu")
    yt = y[2000:]
    j_acc = float((jp.argmax(1) == yt).mean())
    t_acc = float((tp.argmax(1) == yt).mean())
    assert abs(t_acc - j_acc) <= 0.03, (t_acc, j_acc)
    j_ll, t_ll = _multi_logloss(yt, jp), _multi_logloss(yt, tp)
    assert abs(t_ll - j_ll) <= 0.03 * j_ll, (t_ll, j_ll)


@pytest.mark.parametrize("growth", sorted(GROWTH))
def test_class_columns_grow_the_trees_of_contiguous_copies(growth):
    """``train()`` hands each grower the class's gradient column, a view
    with stride K: the quantizer and the histogram build must read that
    class and no other.  Each column's tree (quantized, the card's path on
    the CPU) equals the tree grown from a contiguous copy."""
    X, y = _mc_data(n=3000, seed=5)
    K = 3
    mapper = BinMapper(63).fit(X)
    binned = torch.from_numpy(mapper.transform(X)).t().contiguous().t()
    p = GBDTParams(objective="multiclass", num_class=K,
                   use_quantized_grad=True, **GROWTH[growth]).resolve()
    s = torch.from_numpy(np.random.default_rng(6).normal(
        size=(3000, K)).astype(np.float32))
    g, h = port_core.make_objective(p)(s, torch.from_numpy(y),
                                       torch.ones(3000))
    assert g.stride() == (K, 1)
    grow = port_core._make_grower(p, X.shape[1], 63)
    args = (torch.ones(3000, dtype=torch.bool),
            torch.ones(X.shape[1], dtype=torch.bool),
            torch.from_numpy(mapper.edges))
    u = torch.from_numpy(np.random.default_rng(7).random(
        (2, 3000), dtype=np.float32))
    splits = set()
    for c in range(K):
        a = grow(binned, g[:, c], h[:, c], *args, noise=u)
        b = grow(binned, g[:, c].contiguous(), h[:, c].contiguous(), *args,
                 noise=u)
        for name, x, z in zip(a._fields, a, b):
            if x is not None:
                assert torch.equal(x, z), (c, name)
        splits.add(tuple(a.split_feature.tolist()))
    assert len(splits) == K           # each class grew its own tree


@pytest.mark.parametrize("K", [3, 7])
def test_classifier_fits_more_than_two_labels_as_the_reference(K):
    X, y = _mc_data(n=2400, K=K, seed=8)
    labels = np.array([-3.0, 0.5, 2.0, 4.0, 7.0, 11.0, 20.0])[:K]
    lab = labels[y.astype(int)]
    lab[:40] = labels[0]                  # unbalance the classes a little
    kw = dict(num_iterations=4, num_leaves=7, is_unbalance=True)
    cols = {"features": X, "label": lab}
    tm = LightGBMClassifier().set_params(device="cpu", **kw).fit(
        DataFrame.from_dict(cols))
    jm = JaxClassifier().set_params(**kw).fit(JaxDataFrame.from_dict(cols))
    assert tm.booster.objective == "multiclass"
    assert tm.booster.num_class == K and tm.booster.num_trees == 4 * K
    assert tm.get("classes") == jm.get("classes") == labels.tolist()
    # the first iteration at least: its K trees come from the same
    # class-weighted gradients
    same = same_booster(jm.booster, tm.booster, X)
    assert same >= K
    t_out = tm.transform(DataFrame.from_dict(cols)).collect()
    j_out = jm.transform(JaxDataFrame.from_dict(cols)).collect()
    t_prob = np.stack(t_out["probability"])
    np.testing.assert_allclose(t_prob, tm.booster.predict(X, device="cpu"),
                               rtol=1e-6)
    np.testing.assert_array_equal(t_out["prediction"],
                                  labels[t_prob.argmax(axis=1)])
    assert np.stack(t_out["raw_prediction"]).shape == (2400, K)
    if same == 4 * K:
        np.testing.assert_array_equal(t_out["prediction"],
                                      j_out["prediction"])
        np.testing.assert_allclose(t_prob, np.stack(j_out["probability"]),
                                   rtol=1e-5, atol=1e-6)
    t_acc = float((t_out["prediction"] == lab).mean())
    assert abs(t_acc - float((j_out["prediction"] == lab).mean())) <= 0.01
    assert t_acc > 0.6


def test_multiclass_warm_start_continues_as_the_reference():
    X, y = _mc_data(n=2000, seed=9)
    kw = dict(objective="multiclass", num_class=3, num_leaves=7,
              num_iterations=2)
    j1, t1 = _both(X, y, **kw)
    jb = jax_train(X, y, JaxParams(**kw), init_booster=j1.booster).booster
    tb = train(X, y, GBDTParams(**kw), init_booster=t1.booster,
               device="cpu").booster
    assert tb.num_trees == 12 and tb.num_iterations == 4
    assert same_booster(jb, tb, X) == 12


def test_jax_multiclass_booster_crosses_and_scores_the_same(tmp_path):
    X, y = _mc_data(n=1500, K=4, seed=10)
    jb = jax_train(X, y, JaxParams(objective="multiclass", num_class=4,
                                   num_leaves=7, num_iterations=3)).booster
    crossed = (
        convert.booster_from_arrays(
            {k: getattr(jb, k) for k in jb._ARRAYS},
            {k: getattr(jb, k) for k in jb._META}),
        GBDTBooster.from_string(jb.to_string()))
    for b in crossed:
        assert b.num_class == 4 and b.num_trees == 12
        np.testing.assert_array_equal(b.predict_leaf(X, device="cpu"),
                                      jb.predict_leaf(X))
        for it in (-1, 2):
            np.testing.assert_allclose(
                b.raw_scores(X, num_iteration=it, device="cpu"),
                jb.raw_scores(X, num_iteration=it), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(b.predict(X, device="cpu"),
                                   jb.predict(X), rtol=1e-6, atol=1e-7)
