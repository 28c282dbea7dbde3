"""Recommendation in the port (``mmlspark_tpu_torch.recommendation``)
against the JAX package on the same seeded ratings, on the CPU: SAR's
co-occurrence and similarity bit for bit (jaccard, lift, co-occurrence;
with and without time decay), scores within 1e-6 relative, equal top-k
lists on untied data; the indexer, the ranking adapter, evaluator and
train/validation split equal; a SAR model the JAX package saved loads and
scores in the port."""
import numpy as np
import pytest
import torch

import mmlspark_tpu.core as jcore
import mmlspark_tpu.recommendation as jrec
import mmlspark_tpu_torch.core as tcore
import mmlspark_tpu_torch.recommendation as trec

PKGS = {"jax": (jcore, jrec), "port": (tcore, trec)}
RTOL = 1e-6


def _ratings(n_users=60, n_items=45, per_user=(4, 20), seed=0,
             with_time=True):
    rng = np.random.default_rng(seed)
    pop = np.arange(1, n_items + 1, dtype=np.float64) ** -0.8
    pop /= pop.sum()
    users, items, ratings, times = [], [], [], []
    for u in range(n_users):
        k = min(int(rng.integers(*per_user)), n_items)
        for it in rng.choice(n_items, k, replace=False, p=pop):
            users.append(f"u{u}")
            items.append(f"i{it}")
            ratings.append(float(rng.integers(1, 6)))
            times.append(1.6e9 + float(rng.integers(0, 3 * 365 * 86400)))
    cols = {"user": np.array(users, dtype=object),
            "item": np.array(items, dtype=object),
            "rating": np.array(ratings)}
    if with_time:
        cols["t"] = np.array(times)
    return cols


def _sar(pkg, cols, **kw):
    core, rec = PKGS[pkg]
    est = rec.SAR().set_params(**kw)
    if pkg == "port":
        est.set_params(device="cpu")
    return est.fit(core.DataFrame.from_dict(cols))


@pytest.mark.parametrize("sim", ["jaccard", "lift", "cooccurrence"])
@pytest.mark.parametrize("with_time", [True, False])
def test_sar_equals_jax(sim, with_time):
    cols = _ratings(with_time=with_time)
    kw = dict(similarity_function=sim, support_threshold=2)
    if with_time:
        kw.update(time_col="t", time_decay_coeff=30.0)
    jm, tm = _sar("jax", cols, **kw), _sar("port", cols, **kw)
    for name in ("affinity", "similarity", "seen"):
        a, b = np.asarray(tm.get(name)), np.asarray(jm.get(name))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert tm.get("user_ids") == jm.get("user_ids")
    assert tm.get("item_ids") == jm.get("item_ids")
    np.testing.assert_allclose(tm._scores(), jm._scores(), rtol=RTOL,
                               atol=0)
    for remove_seen in (True, False):
        rj = jm.recommend_for_all_users(7, remove_seen=remove_seen).collect()
        rt = tm.recommend_for_all_users(7, remove_seen=remove_seen).collect()
        assert list(rt["user"]) == list(rj["user"])
        assert [list(r) for r in rt["recommendations"]] == \
            [list(r) for r in rj["recommendations"]]
        for a, b in zip(rt["ratings"], rj["ratings"]):
            np.testing.assert_allclose(a, b, rtol=RTOL)
    pj = jm.transform(jcore.DataFrame.from_dict(cols)).collect()["prediction"]
    pt = tm.transform(tcore.DataFrame.from_dict(cols)).collect()["prediction"]
    np.testing.assert_allclose(pt, pj, rtol=RTOL)


def test_cooccurrence_counts_are_exact_on_the_port():
    cols = _ratings(n_users=300, n_items=30, per_user=(10, 25), seed=3,
                    with_time=False)
    tm = _sar("port", cols, similarity_function="cooccurrence",
              support_threshold=1)
    seen = np.asarray(tm.get("seen"), np.float64)
    np.testing.assert_array_equal(np.asarray(tm.get("similarity")),
                                  (seen.T @ seen).astype(np.float32))


def test_indexer_equals_jax():
    cols = _ratings(n_users=20, n_items=12, seed=4)
    out = {}
    for pkg, (core, rec) in PKGS.items():
        df = core.DataFrame.from_dict(cols)
        m = rec.RecommendationIndexer().fit(df)
        other = core.DataFrame.from_dict({
            "user": np.array(["u3", "nobody"], dtype=object),
            "item": np.array(["zzz", "i2"], dtype=object)})
        out[pkg] = (m.transform(df).collect(), m.transform(other).collect(),
                    m.recover_user(3), m.recover_item(2))
    for c in ("user_idx", "item_idx"):
        np.testing.assert_array_equal(out["port"][0][c], out["jax"][0][c])
        np.testing.assert_array_equal(out["port"][1][c], out["jax"][1][c])
    assert out["port"][2:] == out["jax"][2:]


@pytest.mark.parametrize("metric", ["ndcgAt", "map", "precisionAtk",
                                    "recallAtK"])
def test_ranking_metrics_equal_jax(metric):
    cols = _ratings(n_users=40, n_items=30, seed=5)
    vals = {}
    for pkg, (core, rec) in PKGS.items():
        df = core.DataFrame.from_dict(cols)
        sar = rec.SAR().set_params(support_threshold=1, time_col="t")
        if pkg == "port":
            sar.set_params(device="cpu")
        ev = rec.RankingEvaluator().set_params(k=5, metric_name=metric)
        adapter = rec.RankingAdapter(sar, k=5)
        out = adapter.fit(df).transform(df)
        split = rec.RankingTrainValidationSplit().set_params(
            train_ratio=0.75, seed=2)
        split.set("estimator", rec.RankingAdapter(sar, k=5))
        split.set("evaluator", ev)
        split.fit(df)
        vals[pkg] = (ev.evaluate(out), split.validation_metrics,
                     [list(p) for p in out.collect()["prediction"]])
    assert vals["port"][2] == vals["jax"][2]
    assert vals["port"][0] == vals["jax"][0]
    assert vals["port"][1] == vals["jax"][1]
    assert 0.0 <= vals["port"][0] <= 1.0


def test_jax_saved_sar_model_loads_in_the_port(tmp_path):
    cols = _ratings(seed=6)
    jm = _sar("jax", cols, support_threshold=2, time_col="t")
    jcore.save(jm, str(tmp_path / "sar"))
    back = tcore.load(str(tmp_path / "sar"))
    assert isinstance(back, trec.SARModel)
    back.set_params(device="cpu")
    for name in ("affinity", "similarity", "seen"):
        np.testing.assert_array_equal(np.asarray(back.get(name)),
                                      np.asarray(jm.get(name)))
    np.testing.assert_allclose(back._scores(), jm._scores(), rtol=RTOL)
    assert tcore.load(str(tmp_path / "sar"), safe=True).get("user_ids") == \
        jm.get("user_ids")


def test_matmuls_need_the_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cols = _ratings(n_users=10, n_items=8, seed=7)
    df = tcore.DataFrame.from_dict(cols)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trec.SAR().fit(df)
    m = trec.SAR().set_params(device="cpu").fit(df)
    m.set("device", None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        m.recommend_for_all_users(3)
