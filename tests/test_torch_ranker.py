"""Port parity for LambdaRank: the pairwise |ΔNDCG| lambdas, ``train()``'s
ranking branch, the ranker estimator and lambdarank boosters carried across
from the JAX package.

- Lambdas: the same seeded scores, relevances and query bounds through both
  packages: within rtol 1e-5 and atol 1e-6 (each lambda is a sum of up to
  Gmax pairwise terms; the two packages' f32 ``exp``, ``log2`` and
  summation orders differ by a few ulps, up to 3.6e-7 absolute on these
  inputs).  The rank sort is stable in both, so the all-tied first
  iteration ranks by the tie order alike.
- ``train()``: float histograms on both sides.  The boosters agree in every
  integer array unless an f32 near-tie parts them (asserted to be one),
  their scores within rtol 1e-5 and 1e-5 of the largest score
  (``test_torch_multiclass.same_booster``).  The reference's ranking rules
  hold in every boosting type: no GOSS sample, no DART drop nor its draw,
  no RF gradient scale, no sample weights on the lambdas.
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu.core import DataFrame as JaxDataFrame
from mmlspark_tpu.lightgbm import GBDTParams as JaxParams
from mmlspark_tpu.lightgbm import LightGBMRanker as JaxRanker
from mmlspark_tpu.lightgbm import core as jax_core
from mmlspark_tpu.lightgbm import train as jax_train
from mmlspark_tpu_torch import convert
from mmlspark_tpu_torch.core import DataFrame
from mmlspark_tpu_torch.lightgbm import GBDTParams, LightGBMRanker, train
from mmlspark_tpu_torch.lightgbm import core as port_core
from mmlspark_tpu_torch.models.gbdt import GBDTBooster

from tests.test_torch_multiclass import same_booster


def _ndcg_at_k(scores, rel, group_ptr, k=10):
    """Independent NDCG@k (a copy of ``tests/test_ranker_ndcg_gate.py``'s):
    gain 2^rel - 1, log2 discount, ideal DCG by brute-force
    descending-relevance sort per query."""
    vals = []
    for i in range(len(group_ptr) - 1):
        a, b = group_ptr[i], group_ptr[i + 1]
        order = np.argsort(-scores[a:b], kind="stable")
        g = (2.0 ** rel[a:b] - 1.0)
        disc = 1.0 / np.log2(np.arange(b - a) + 2.0)
        dcg = float((g[order][:k] * disc[:k]).sum())
        ideal = float((np.sort(g)[::-1][:k] * disc[:k]).sum())
        if ideal > 0:
            vals.append(dcg / ideal)
    return float(np.mean(vals))


def _make_ranking_problem(seed, n_q=120, per_q=20, f=8):
    """The JAX package's pinned NDCG-gate problem
    (``tests/test_ranker_ndcg_gate.py``)."""
    rng = np.random.default_rng(seed)
    n = n_q * per_q
    X = rng.normal(size=(n, f)).astype(np.float32)
    raw = 1.2 * X[:, 0] - 0.8 * X[:, 1] + 0.3 * rng.normal(size=n)
    rel = np.digitize(raw, [-0.8, 0.4, 1.4]).astype(np.float32)  # 0..3
    gp = np.arange(0, n + 1, per_q)
    return X, rel, gp


def _ragged(seed, n_q=40, lo=2, hi=48, f=6, lead=0, tail=0):
    """Ragged queries of ``lo``..``hi - 1`` rows, relevance 0-4 planted from
    two features; ``lead`` and ``tail`` rows lie outside every query."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(lo, hi, n_q)
    gp = lead + np.concatenate([[0], np.cumsum(sizes)])
    n = int(gp[-1]) + tail
    X = rng.normal(size=(n, f)).astype(np.float32)
    raw = X[:, 0] - 0.7 * X[:, 1] + 0.4 * rng.normal(size=n)
    rel = np.digitize(raw, [-1.0, 0.0, 0.8, 1.6]).astype(np.float32)
    return X, rel, gp


def _lambda_case(case):
    rng = np.random.default_rng(3)
    X, rel, gp = _ragged(4, lead=7 if case == "uncovered" else 0,
                         tail=11 if case == "uncovered" else 0)
    n = len(rel)
    scores = rng.normal(size=n).astype(np.float32)
    if case == "tied":
        scores[:] = 0.0
    elif case == "equal_labels":
        # every row of the first half of the queries holds one label
        mid = gp[len(gp) // 2]
        rel[:mid] = 2.0
    return scores, rel, gp


@pytest.mark.parametrize("case", ["ragged", "tied", "equal_labels",
                                  "uncovered"])
def test_lambdarank_grads_equal_the_reference(case):
    scores, rel, gp = _lambda_case(case)
    jg, jh = jax_core.lambdarank_grads(scores, rel, gp)
    tg, th = port_core.lambdarank_grads(scores, rel, gp, device="cpu")
    assert tg.shape == th.shape == (len(rel), 1)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(th, jh, rtol=1e-5, atol=1e-6)
    covered = np.zeros(len(rel), bool)
    covered[gp[0]:gp[-1]] = True
    assert (tg[~covered] == 0).all() and (th[~covered] == 1e-16).all()
    assert (th[covered] >= 1e-16).all() and np.abs(tg[covered]).max() > 0
    if case == "equal_labels":
        # a query whose rows all share a label has no ordered pair
        assert (tg[:gp[len(gp) // 2]] == 0).all()


def test_lambdas_do_not_depend_on_the_chunking(monkeypatch):
    """``_LAMBDA_PAIR_BYTES`` bounds the pairwise temporaries (a module
    constant, not a knob): one query a chunk, a few, and all at once give
    the same lambdas bit for bit."""
    scores, rel, gp = _lambda_case("ragged")
    gmax = int(np.diff(gp).max())
    one = port_core._LAMBDA_PAIR_TEMPS * gmax * gmax * 4
    got = []
    for budget in (1, one, 7 * one, port_core._LAMBDA_PAIR_BYTES):
        monkeypatch.setattr(port_core, "_LAMBDA_PAIR_BYTES", budget)
        got.append(port_core.lambdarank_grads(scores, rel, gp,
                                              device="cpu"))
    for g, h in got[1:]:
        np.testing.assert_array_equal(g, got[0][0])
        np.testing.assert_array_equal(h, got[0][1])


def test_lambda_fn_stays_on_its_device_and_needs_no_host_copy():
    scores, rel, gp = _lambda_case("ragged")
    fn = port_core.make_lambdarank_grad_fn(rel, gp, 1.0, device="cpu")
    s = torch.from_numpy(scores)[:, None]
    g, h = fn(s)
    assert g.shape == (len(rel), 1) and g.dtype == torch.float32
    g2, _ = fn(s)                      # the gathers are built once, reused
    assert torch.equal(g, g2)


MODES = {"gbdt": {}, "goss": dict(boosting_type="goss"),
         "dart": dict(boosting_type="dart", skip_drop=0.0, drop_rate=0.5,
                      feature_fraction=0.8),
         "rf": dict(boosting_type="rf", feature_fraction=0.8)}
GROWTH = {"leaf": dict(num_leaves=7), "level": dict(max_depth=3)}


@pytest.mark.parametrize("growth", sorted(GROWTH))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_lambdarank_train_matches_jax(mode, growth):
    """The same lambdas give the same trees, in every boosting type: the
    reference computes ranking gradients before the grow, so GOSS keeps
    every row, DART drops nothing (and draws nothing: the feature and bag
    draws after it stay in step), RF does not scale them."""
    X, rel, gp = _ragged(5, n_q=50)
    kw = dict(objective="lambdarank", num_iterations=4, seed=2,
              min_data_in_leaf=5, **GROWTH[growth], **MODES[mode])
    jb = jax_train(X, rel, JaxParams(**kw), group_ptr=gp).booster
    tb = train(X, rel, GBDTParams(**kw), group_ptr=gp, device="cpu").booster
    assert tb.num_trees == 4 and tb.objective == "lambdarank"
    assert same_booster(jb, tb, X) == 4
    np.testing.assert_array_equal(tb.tree_weight, jb.tree_weight)
    np.testing.assert_array_equal(tb.internal_count[:, 0],
                                  jb.internal_count[:, 0])
    if mode != "rf":
        assert (tb.tree_weight == 1).all()
        assert (tb.internal_count[:, 0] == len(rel)).all()


def test_lambdarank_ignores_weights_and_other_objectives_ignore_groups():
    X, rel, gp = _ragged(6)
    kw = dict(num_iterations=3, num_leaves=7, min_data_in_leaf=5)
    w = np.random.default_rng(0).random(len(rel)) + 0.5
    base = train(X, rel, GBDTParams(objective="lambdarank", **kw),
                 group_ptr=gp, device="cpu").booster
    weighted = train(X, rel, GBDTParams(objective="lambdarank", **kw),
                     group_ptr=gp, sample_weight=w, device="cpu").booster
    for k in GBDTBooster._ARRAYS:
        np.testing.assert_array_equal(getattr(weighted, k), getattr(base, k))
    with pytest.raises(ValueError, match="group_ptr"):
        train(X, rel, GBDTParams(objective="lambdarank", **kw), device="cpu")
    reg = train(X, rel, GBDTParams(objective="regression", **kw),
                device="cpu").booster
    reg_g = train(X, rel, GBDTParams(objective="regression", **kw),
                  group_ptr=gp, device="cpu").booster
    for k in GBDTBooster._ARRAYS:
        np.testing.assert_array_equal(getattr(reg_g, k), getattr(reg, k))


def test_lambdarank_ndcg_at_10_meets_pinned_floor():
    """The JAX package's NDCG@10 gate on the port: the same pinned problem,
    params and floor (0.962; the reference measured 0.9828)."""
    X, rel, gp = _make_ranking_problem(seed=7)
    Xv, relv, gpv = _make_ranking_problem(seed=8)  # held-out queries
    r = train(X, rel, GBDTParams(
        num_iterations=40, num_leaves=15, learning_rate=0.1,
        objective="lambdarank", min_data_in_leaf=5), group_ptr=gp,
        device="cpu")
    scores = r.booster.raw_scores(Xv, device="cpu")[:, 0]
    ndcg = _ndcg_at_k(scores, relv, gpv)
    rng = np.random.default_rng(0)
    ndcg_rand = _ndcg_at_k(rng.normal(size=len(relv)), relv, gpv)
    ndcg_anti = _ndcg_at_k(-scores, relv, gpv)
    assert ndcg_rand < 0.75 and ndcg_anti < ndcg_rand
    assert ndcg > 0.962, f"NDCG@10 {ndcg:.4f} fell below pinned floor"


def test_ranker_estimator_equals_the_reference():
    """Groups given unsorted: both estimators sort rows stably by group,
    build ``group_ptr`` from the changes, and score ``raw_scores[:, 0]``."""
    X, rel, gp = _ragged(7, n_q=30)
    sizes = np.diff(gp)
    groups = np.repeat(np.random.default_rng(1).permutation(30) * 3 + 10,
                       sizes)
    perm = np.random.default_rng(2).permutation(len(rel))
    cols = {"features": X[perm], "label": rel[perm].astype(np.float64),
            "group": groups[perm]}
    kw = dict(num_iterations=4, num_leaves=7, min_data_in_leaf=5,
              max_position=5)
    tm = LightGBMRanker().set_params(device="cpu", **kw).fit(
        DataFrame.from_dict(cols))
    jm = JaxRanker().set_params(**kw).fit(JaxDataFrame.from_dict(cols))
    assert tm.booster.objective == "lambdarank"
    assert same_booster(jm.booster, tm.booster, X) == 4
    t_pred = tm.transform(DataFrame.from_dict(cols)).collect()["prediction"]
    j_pred = jm.transform(JaxDataFrame.from_dict(cols)).collect()[
        "prediction"]
    assert t_pred.shape == (len(rel),)
    np.testing.assert_allclose(t_pred, j_pred, rtol=1e-5,
                               atol=1e-5 * np.abs(j_pred).max())


def test_jax_lambdarank_booster_crosses_and_scores_the_same():
    X, rel, gp = _ragged(8)
    jb = jax_train(X, rel, JaxParams(objective="lambdarank", num_leaves=7,
                                     num_iterations=3, min_data_in_leaf=5),
                   group_ptr=gp).booster
    for b in (convert.booster_from_arrays(
                  {k: getattr(jb, k) for k in jb._ARRAYS},
                  {k: getattr(jb, k) for k in jb._META}),
              GBDTBooster.from_string(jb.to_string())):
        assert b.objective == "lambdarank" and b.num_trees == 3
        np.testing.assert_array_equal(b.predict_leaf(X, device="cpu"),
                                      jb.predict_leaf(X))
        np.testing.assert_allclose(b.raw_scores(X, device="cpu"),
                                   jb.raw_scores(X), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(b.predict(X, device="cpu"),
                                   jb.predict(X), rtol=1e-6, atol=1e-7)
