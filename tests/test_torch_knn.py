"""Nearest neighbours in the port (``mmlspark_tpu_torch.nn``) against the
JAX package on the same seeded items, on the CPU: the matmul query's
scores within 1e-5 relative with equal indices apart from float32
near-ties (two scores within 1e-5 relative, which the two matmuls round
apart; over more than one 1,024-row chunk), and exactly tied items in
index order as ``lax.top_k`` orders them; the ball trees and ``ConditionalKNN`` bit for bit; models
the JAX package saved (pickled ball trees) load and query in a child
process with ``jax`` and the JAX package blocked."""
import numpy as np
import pytest
import torch

import mmlspark_tpu.core as jcore
import mmlspark_tpu.nn as jnn
import mmlspark_tpu_torch.core as tcore
import mmlspark_tpu_torch.nn as tnn
from tests.test_torch_isolation import run_blocked

RTOL = 1e-5


def _items(n=600, d=16, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(8, d)) * 3
    X = centers[rng.integers(0, 8, n)] + rng.normal(size=(n, d))
    return X


def _frame(core, X, **extra):
    return core.DataFrame.from_dict({"features": core.vector_column(list(X)),
                                     **extra})


def _knn(pkg, X, values, **kw):
    core, nn = (jcore, jnn) if pkg == "jax" else (tcore, tnn)
    est = nn.KNN().set_params(output_col="m", **kw)
    if pkg == "port":
        est.set_params(device="cpu")
    return est.fit(_frame(core, X, values=values))


def _matches(model, core, Q):
    return model.transform(_frame(core, Q)).collect()["m"]


def _near_tie_groups(scores):
    """Runs of consecutive positions whose scores are within RTOL x |score|
    of the previous one (float32 near-ties, which two matmuls may order
    either way)."""
    groups, start = [], 0
    for i in range(1, len(scores) + 1):
        if i == len(scores) or abs(scores[i] - scores[i - 1]) > \
                RTOL * abs(scores[i - 1]):
            groups.append((start, i))
            start = i
    return groups


def _same_but_near_ties(a, b) -> int:
    """``a``, ``b``: one query's matches from each package.  Scores agree
    within RTOL position by position; values are equal outside near-tie
    runs, and as sets inside one but the last (whose members can differ at
    the k-th place).  Returns the number of positions that differ."""
    sa = [r["distance"] for r in a]
    np.testing.assert_allclose([r["distance"] for r in b], sa, rtol=RTOL)
    va, vb = [r["value"] for r in a], [r["value"] for r in b]
    groups = _near_tie_groups(sa)
    for lo, hi in groups[:-1]:
        assert set(va[lo:hi]) == set(vb[lo:hi]), (va, vb, sa)
    lo, hi = groups[-1]
    assert hi - lo > 1 or va[lo] == vb[lo], (va, vb, sa)
    assert va[:lo] == vb[:lo] or any(h - l > 1 for l, h in groups[:-1])
    return sum(x != y for x, y in zip(va, vb))


@pytest.mark.parametrize("k", [1, 5, 40])
def test_device_query_equals_jax(k):
    X = _items()
    values = np.array([f"v{i}" for i in range(len(X))], dtype=object)
    Q = np.concatenate([_items(1500, seed=1), X[:300]])   # 2 chunks
    jm, tm = _knn("jax", X, values, k=k), _knn("port", X, values, k=k)
    mj, mt = _matches(jm, jcore, Q), _matches(tm, tcore, Q)
    moved = sum(_same_but_near_ties(a, b) for a, b in zip(mj, mt))
    assert moved <= 0.001 * len(Q) * k, moved


def test_tied_items_come_in_index_order():
    """Duplicate items score alike: ``lax.top_k`` gives the lower index
    first, and so does the port."""
    rng = np.random.default_rng(2)
    base = rng.normal(size=(40, 8))
    X = np.concatenate([base, base, base])          # every item thrice
    values = np.arange(len(X))
    Q = rng.normal(size=(50, 8))
    jm, tm = _knn("jax", X, values, k=6), _knn("port", X, values, k=6)
    mj, mt = _matches(jm, jcore, Q), _matches(tm, tcore, Q)
    for a, b in zip(mj, mt):
        vb = [r["value"] for r in b]
        assert vb == [r["value"] for r in a]
        assert vb[0] < vb[1] < vb[2] and vb[3] < vb[4] < vb[5]


def test_ball_tree_queries_equal_jax():
    X = _items(500, 12, seed=3)
    Q = _items(40, 12, seed=4)
    jt, tt = jnn.BallTree(X, leaf_size=20), tnn.BallTree(X, leaf_size=20)
    for q in Q:
        got = tt.find_maximum_inner_products(q, k=7)
        assert got == jt.find_maximum_inner_products(q, k=7)
        assert [i for i, _ in got] == np.argsort(-(X @ q))[:7].tolist()
    values = list(range(len(X)))
    jm = _knn("jax", X, values, k=4)
    tm = _knn("port", X, values, k=4).set_params(use_ball_tree=True)
    jm.set_params(use_ball_tree=True)
    assert list(_matches(tm, tcore, Q)) == list(_matches(jm, jcore, Q))


def test_conditional_knn_equals_jax():
    X = _items(300, 8, seed=5)
    labels = np.array(["even" if i % 2 == 0 else "odd" if i % 3 else "three"
                       for i in range(300)], dtype=object)
    Q = _items(30, 8, seed=6)
    cond = np.empty(30, dtype=object)
    for i in range(30):
        cond[i] = [["even"], ["odd", "three"], ["three"]][i % 3]
    out = {}
    for name, core, nn in (("jax", jcore, jnn), ("port", tcore, tnn)):
        m = nn.ConditionalKNN().set_params(output_col="m", k=3,
                                           leaf_size=10).fit(
            _frame(core, X, values=np.arange(300), labels=labels))
        out[name] = m.transform(_frame(core, Q, conditioner=cond)) \
            .collect()["m"]
    assert list(out["port"]) == list(out["jax"])
    for i, rows in enumerate(out["port"]):
        assert {r["label"] for r in rows} <= set(cond[i])


_LOAD_AND_QUERY = r"""
import json
import numpy as np
from mmlspark_tpu_torch.core import DataFrame, load, vector_column
Q = np.load({q!r})
m = load({path!r})
if "device" in type(m)._params:
    m.set_params(device="cpu")
assert type(m).__module__ == "mmlspark_tpu_torch.nn.knn", type(m)
cols = {{"features": vector_column(list(Q))}}
if {cond}:
    c = np.empty(len(Q), dtype=object)
    for i in range(len(Q)):
        c[i] = ["a"]
    cols["conditioner"] = c
out = m.transform(DataFrame.from_dict(cols)).collect()["m"]
print(json.dumps([[[int(r["value"]), float(r["distance"])] for r in row]
                  for row in out]))
"""


@pytest.mark.parametrize("conditional", [False, True])
def test_jax_saved_model_loads_with_jax_blocked(tmp_path, conditional):
    X = _items(200, 6, seed=7)
    Q = _items(20, 6, seed=8)
    labels = np.array(["a" if i % 4 else "b" for i in range(200)],
                      dtype=object)
    df = _frame(jcore, X, values=np.arange(200), labels=labels)
    est = jnn.ConditionalKNN() if conditional else jnn.KNN()
    jm = est.set_params(output_col="m", k=3).fit(df)
    path = str(tmp_path / "knn")
    jcore.save(jm, path)
    np.save(tmp_path / "q.npy", Q)
    import json
    got = json.loads(run_blocked(_LOAD_AND_QUERY.format(
        q=str(tmp_path / "q.npy"), path=path, cond=conditional)))
    qcols = {"features": jcore.vector_column(list(Q))}
    if conditional:
        c = np.empty(20, dtype=object)
        for i in range(20):
            c[i] = ["a"]
        qcols["conditioner"] = c
    want = jm.transform(jcore.DataFrame.from_dict(qcols)).collect()["m"]
    for a, b in zip(want, got):
        assert [r["value"] for r in a] == [v for v, _ in b]
        np.testing.assert_allclose([d for _, d in b],
                                   [r["distance"] for r in a], rtol=RTOL)
    with pytest.raises(PermissionError, match="pickle"):
        tcore.load(path, safe=True)


def test_query_needs_the_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = _items(100, 4, seed=9)
    m = tnn.KNN().set_params(output_col="m", k=2).fit(
        _frame(tcore, X, values=np.arange(100)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _matches(m, tcore, X[:3])
    out = _matches(m.set_params(device="cpu"), tcore, X[:3])
    assert len(out) == 3 and all(len(r) == 2 for r in out)
