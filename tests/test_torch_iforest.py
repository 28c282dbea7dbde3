"""The isolation forest in the port (``mmlspark_tpu_torch.isolationforest``)
against the JAX package on the same seeded rows, on the CPU: equal trees
(growing is the reference's, call for call on numpy's generator), the
flattened walk's scores within 1e-12 of the reference's recursive walk
(they are equal bit for bit here: path lengths summed in tree order, the
power taken on the host), equal labels and threshold; a model the JAX
package saved (a pickled forest) loads and scores in a child process with
``jax`` and the JAX package blocked, and ``safe=True`` refuses it."""
import os

import numpy as np
import pytest
import torch

import mmlspark_tpu.core as jcore
import mmlspark_tpu.isolationforest as jif
import mmlspark_tpu_torch.core as tcore
import mmlspark_tpu_torch.isolationforest as tif
from mmlspark_tpu_torch.isolationforest.iforest import _Forest, _flatten
from mmlspark_tpu_torch.utils import pickling
from tests.test_torch_isolation import run_blocked

TOL = 1e-12


def _rows(n=2000, F=5, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F))
    X[: n // 100] += 6.0
    X[:, 1] = np.round(X[:, 1], 1)      # ties at the thresholds' values
    return X


def _frames(X):
    return (jcore.DataFrame.from_dict({"features": jcore.vector_column(
                list(X))}),
            tcore.DataFrame.from_dict({"features": tcore.vector_column(
                list(X))}))


def _tree_tuple(t):
    if t.feature < 0 or t.left is None:
        return ("leaf", t.size)
    return (t.feature, t.threshold, t.size, _tree_tuple(t.left),
            _tree_tuple(t.right))


PARAMS = [dict(num_estimators=40, contamination=0.02),
          dict(num_estimators=25, max_samples=100, max_features=0.6,
               random_seed=7),
          dict(num_estimators=10, max_samples=5000),    # whole data, deep
          dict(num_estimators=30)]                     # threshold 0.5


@pytest.mark.parametrize("params", PARAMS,
                         ids=["contamination", "features", "all_rows",
                              "defaults"])
def test_forest_equals_jax(params):
    X = _rows()
    dj, dt = _frames(X)
    jm = jif.IsolationForest().set_params(**params).fit(dj)
    tm = tif.IsolationForest().set_params(device="cpu", **params).fit(dt)
    jt, tt = jm.get("forest"), tm.get("forest")
    assert jt.sub_size == tt.sub_size
    assert [_tree_tuple(a) for a in jt.trees] == \
        [_tree_tuple(b) for b in tt.trees]
    assert tm.get("threshold") == jm.get("threshold")
    Xq = np.concatenate([X, _rows(500, seed=1)])
    qj, qt = _frames(Xq)
    oj, ot = jm.transform(qj).collect(), tm.transform(qt).collect()
    np.testing.assert_allclose(ot["outlier_score"], oj["outlier_score"],
                               rtol=0, atol=TOL)
    np.testing.assert_array_equal(ot["predicted_label"],
                                  oj["predicted_label"])
    # the flattened walk = the reference's recursive walk, per tree
    depths = np.stack([t.path_length(Xq) for t in tt.trees])
    np.testing.assert_array_equal(
        tt.mean_path_length(Xq, "cpu"), np.mean(depths, axis=0))


def test_flatten_layout_and_walk_edges():
    X = _rows(300, seed=2)
    m = tif.IsolationForest().set_params(num_estimators=3, max_samples=64,
                                         device="cpu").fit(
        tcore.DataFrame.from_dict({"features": tcore.vector_column(
            list(X))}))
    forest = m.get("forest")
    for tree in forest.trees:
        feature, thr, left, right, value, depth = _flatten(tree)
        assert feature[0] == tree.feature and thr[0] == tree.threshold
        inner = [i for i, f in enumerate(feature) if f >= 0]
        assert all(left[i] > i and right[i] == left[i] + 1 for i in inner)
        assert depth <= 6
    # NaN goes right, as ``X[:, f] < thr`` sends it; rows far outside
    Xe = np.array([[np.nan] * 5, [1e300] * 5, [-1e300] * 5])
    depths = np.stack([t.path_length(Xe) for t in forest.trees])
    np.testing.assert_array_equal(forest.mean_path_length(Xe, "cpu"),
                                  np.mean(depths, axis=0))
    # the flat tables are never pickled, and are rebuilt after a load
    forest.scores(X[:4], "cpu")
    back = pickling.loads(pickling.dumps(forest))
    assert "_flat_cache" not in back.__dict__
    np.testing.assert_array_equal(back.scores(X, "cpu"),
                                  forest.scores(X, "cpu"))


def test_walk_batches_rows(monkeypatch):
    from mmlspark_tpu_torch.isolationforest import iforest
    X = _rows(700, seed=3)
    forest = tif.IsolationForest().set_params(
        num_estimators=8, device="cpu").fit(tcore.DataFrame.from_dict(
            {"features": tcore.vector_column(list(X))})).get("forest")
    whole = forest.scores(X, "cpu")
    monkeypatch.setattr(iforest, "_WALK_ROWS", 97)
    np.testing.assert_array_equal(forest.scores(X, "cpu"), whole)


_LOAD_AND_SCORE = r"""
import numpy as np
from mmlspark_tpu_torch.core import DataFrame, load, vector_column
X = np.load({x!r})
m = load({path!r}).set_params(device="cpu")
assert type(m).__module__.startswith("mmlspark_tpu_torch."), type(m)
out = m.transform(DataFrame.from_dict({{"features": vector_column(list(X))}}))
np.save({out!r}, np.asarray(out.collect()["{col}"], np.float64))
assert not [k for k in sys.modules if blocked(k)]
"""


def test_jax_saved_model_loads_with_jax_blocked(tmp_path):
    X = _rows(400, seed=4)
    dj, dt = _frames(X)
    jm = jif.IsolationForest().set_params(num_estimators=12,
                                          contamination=0.05).fit(dj)
    path = str(tmp_path / "iforest")
    jcore.save(jm, path)
    assert os.path.exists(os.path.join(path, "complex", "forest", "payload",
                                       "forest.pkl"))
    np.save(tmp_path / "x.npy", X)
    for col in ("outlier_score", "predicted_label"):
        run_blocked(_LOAD_AND_SCORE.format(
            x=str(tmp_path / "x.npy"), path=path, col=col,
            out=str(tmp_path / f"{col}.npy")))
        np.testing.assert_array_equal(np.load(tmp_path / f"{col}.npy"),
                                      jm.transform(dj).collect()[col])
    back = tcore.load(path)
    assert isinstance(back.get("forest"), _Forest)
    with pytest.raises(PermissionError, match="pickle"):
        tcore.load(path, safe=True)


def test_port_saved_model_round_trips(tmp_path):
    X = _rows(300, seed=5)
    _, dt = _frames(X)
    m = tif.IsolationForest().set_params(num_estimators=6,
                                         device="cpu").fit(dt)
    tcore.save(m, str(tmp_path / "m"))
    back = tcore.load(str(tmp_path / "m"))
    assert back.get("device") == "cpu"
    np.testing.assert_array_equal(
        back.transform(dt).collect()["outlier_score"],
        m.transform(dt).collect()["outlier_score"])


def test_scoring_needs_the_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = _rows(200, seed=6)
    _, dt = _frames(X)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tif.IsolationForest().set_params(num_estimators=3,
                                         contamination=0.1).fit(dt)
    m = tif.IsolationForest().set_params(num_estimators=3).fit(dt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        m.transform(dt).collect()
    assert len(m.set_params(device="cpu").transform(dt).collect()[
        "outlier_score"]) == 200
