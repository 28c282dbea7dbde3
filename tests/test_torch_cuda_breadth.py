"""Word2Vec, KNN, SAR and the isolation forest's walk on the card against
the port on the CPU.  Marked ``cuda``: without a CUDA device every test
skips (the CPU tier-1 run holds the same modules against the JAX package
in ``test_torch_word2vec.py``, ``test_torch_knn.py``,
``test_torch_recommendation.py`` and ``test_torch_iforest.py``).  On the
card:

    python -m pytest tests/test_torch_cuda_breadth.py -q -m cuda --noconftest

Tolerances: Word2Vec card = CPU on the same given uniforms within 1e-4 x
max|v| (``index_add_`` on the card adds in atomic order); KNN scores
within 1e-5 relative with equal indices apart from near-ties (two scores
within 1e-5 relative); SAR co-occurrence and similarity bit for bit,
scores within 1e-5 relative; the forest's scores within 1e-12 and equal
labels.  A Word2Vec epoch runs under ``torch.cuda.set_sync_debug_mode
("error")``: nothing in it waits for the card.
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.core import DataFrame, vector_column
from mmlspark_tpu_torch.featurize import Word2Vec
from mmlspark_tpu_torch.isolationforest import IsolationForest
from mmlspark_tpu_torch.nn import KNN
from mmlspark_tpu_torch.recommendation import SAR

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _docs(n=600, vocab=300, seed=0):
    rng = np.random.default_rng(seed)
    p = np.arange(1, vocab + 1, dtype=np.float64) ** -1.1
    p /= p.sum()
    docs = np.empty(n, dtype=object)
    for i in range(n):
        docs[i] = " ".join(f"w{t}" for t in rng.choice(
            vocab, int(rng.integers(3, 25)), p=p))
    return DataFrame.from_dict({"text": docs})


class _SyncChecked(Word2Vec):
    """Each epoch under sync debug mode "error"."""

    def _epoch(self, *args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            super()._epoch(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)


def test_word2vec_card_equals_cpu_on_given_uniforms(dev):
    df = _docs()
    kw = dict(input_col="text", output_col="v", vector_size=32, max_iter=2,
              batch_size=128, seed=3)
    probe = Word2Vec(device="cpu", **{**kw, "max_iter": 0}).fit(df)
    S, B = probe.fit_stats["steps"], probe.fit_stats["pairs"] // \
        probe.fit_stats["steps"]
    rng = np.random.default_rng(9)
    us = [rng.random((S, B, 5), dtype=np.float32) for _ in range(2)]
    card = _SyncChecked(negative_uniforms=us, **kw).fit(df)
    cpu = Word2Vec(negative_uniforms=us, device="cpu", **kw).fit(df)
    a = np.asarray(card.get("vectors"))
    b = np.asarray(cpu.get("vectors"))
    assert card.get("vocab") == cpu.get("vocab")
    assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()
    # the card's own draws run sync-free too
    _SyncChecked(**kw).fit(df)


def test_knn_card_equals_cpu(dev):
    rng = np.random.default_rng(1)
    X = rng.normal(size=(3000, 64)).astype(np.float32)
    Q = rng.normal(size=(2500, 64)).astype(np.float32)
    df = DataFrame.from_dict({"features": vector_column(list(X)),
                              "values": np.arange(3000)})
    qdf = DataFrame.from_dict({"features": vector_column(list(Q))})
    model = KNN().set_params(output_col="m", k=10).fit(df)
    card = model.transform(qdf).collect()["m"]
    cpu = model.copy().set_params(device="cpu").transform(qdf).collect()["m"]
    moved = 0
    for a, b in zip(card, cpu):
        sa = np.array([r["distance"] for r in a])
        sb = np.array([r["distance"] for r in b])
        np.testing.assert_allclose(sa, sb, rtol=1e-5)
        for i, (x, y) in enumerate(zip(a, b)):
            if x["value"] != y["value"]:
                moved += 1
                gaps = np.abs(sb - sb[i])
                gaps[i] = np.inf
                assert gaps.min() <= 1e-5 * abs(sb[i]) or i == len(sb) - 1
    assert moved <= 10


def test_sar_card_equals_cpu(dev):
    rng = np.random.default_rng(2)
    n = 20_000
    cols = {"user": np.array([f"u{v}" for v in rng.integers(0, 500, n)],
                             dtype=object),
            "item": np.array([f"i{v}" for v in rng.zipf(1.3, n) % 400],
                             dtype=object),
            "rating": rng.integers(1, 6, n).astype(float),
            "t": 1.6e9 + rng.integers(0, 10 ** 8, n).astype(float)}
    df = DataFrame.from_dict(cols)
    card = SAR().set_params(time_col="t").fit(df)
    cpu = SAR().set_params(time_col="t", device="cpu").fit(df)
    np.testing.assert_array_equal(card.get("similarity"),
                                  cpu.get("similarity"))
    np.testing.assert_allclose(card._scores(), cpu._scores(), rtol=1e-5)


def test_forest_walk_card_equals_cpu(dev):
    rng = np.random.default_rng(3)
    X = rng.normal(size=(50_000, 12))
    X[:500] += 5
    df = DataFrame.from_dict({"features": vector_column(list(X))})
    card = IsolationForest().set_params(contamination=0.01).fit(df)
    cpu = IsolationForest().set_params(contamination=0.01,
                                       device="cpu").fit(df)
    assert card.get("threshold") == cpu.get("threshold")
    oc, oh = card.transform(df).collect(), cpu.transform(df).collect()
    np.testing.assert_allclose(oc["outlier_score"], oh["outlier_score"],
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(oc["predicted_label"],
                                  oh["predicted_label"])
