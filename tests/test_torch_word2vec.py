"""Word2Vec in the port (``mmlspark_tpu_torch.featurize.word2vec``) against
the JAX package on the same seeded corpora, on the CPU.

The host part is the JAX package's call for call: the vocabulary, the
(center, context) pairs of each epoch and the initial table are equal.
The negatives are drawn as ``jax.random.choice`` draws them: on JAX's own
uniforms (``jax.random.uniform(PRNGKey(seed + epoch), (S, B, K))``, the
draw ``choice`` makes) the port's indices equal JAX's.  Trained on those
uniforms, the vectors agree within 1e-5 x max|v| (the two sum the step's
dot products and scatter-adds in other orders).  Transform and synonyms
are the JAX package's on the same table; the JAX package's topic test
passes on the port.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mmlspark_tpu.core as jcore
import mmlspark_tpu.featurize as jfeat
import mmlspark_tpu.observability.compute as jcompute
import mmlspark_tpu_torch.core as tcore
import mmlspark_tpu_torch.featurize as tfeat
from mmlspark_tpu_torch.featurize import word2vec as tw2v

TOL = 1e-5       # x max|v|


def _topics(n=400, seed=0):
    rng = np.random.default_rng(seed)
    food = ["pizza", "pasta", "cheese", "tomato", "basil", "oven"]
    tech = ["cpu", "gpu", "memory", "compiler", "kernel", "cache"]
    docs = np.empty(n, dtype=object)
    for i in range(n):
        pool = food if i % 2 == 0 else tech
        docs[i] = " ".join(rng.choice(pool, 8))
    return docs


def _zipf(n=300, vocab=400, seed=5):
    """Ragged documents over a Zipf vocabulary: many repeated words per
    batch, a long tail under ``min_count``."""
    rng = np.random.default_rng(seed)
    p = np.arange(1, vocab + 1, dtype=np.float64) ** -1.1
    p /= p.sum()
    docs = np.empty(n, dtype=object)
    for i in range(n):
        docs[i] = " ".join(f"w{t}" for t in rng.choice(
            vocab, int(rng.integers(1, 25)), p=p))
    return docs


class _RecordingWord2Vec(tfeat.Word2Vec):
    """The port's estimator, keeping each epoch's permuted pairs."""

    def _epoch(self, ep, W_in, W_out, centers, contexts, *rest):
        self.epochs_seen.append((centers.copy(), contexts.copy()))
        super()._epoch(ep, W_in, W_out, centers, contexts, *rest)


def _jax_fit(monkeypatch, docs, **kw):
    """The JAX package's fit, keeping each epoch's permuted pairs."""
    seen = []
    real = jcompute.instrumented_jit

    def recording(fn, name=None, **k):
        jitted = real(fn, name=name, **k)

        def call(params, key, cen, ctx):
            seen.append((np.asarray(cen), np.asarray(ctx)))
            return jitted(params, key, cen, ctx)
        return call

    monkeypatch.setattr(jcompute, "instrumented_jit", recording)
    m = jfeat.Word2Vec(**kw).fit(jcore.DataFrame.from_dict({"text": docs}))
    return m, seen


def _jax_uniforms(seed, epochs, S, B, K):
    return [np.asarray(jax.random.uniform(jax.random.PRNGKey(seed + ep),
                                          (S, B, K), dtype=jnp.float32))
            for ep in range(epochs)]


def _port_fit(docs, uniforms=None, **kw):
    est = _RecordingWord2Vec(negative_uniforms=uniforms, device="cpu", **kw)
    est.epochs_seen = []
    m = est.fit(tcore.DataFrame.from_dict({"text": docs}))
    return m, est.epochs_seen


CASES = {
    "topics": (_topics, dict(vector_size=16, max_iter=3, min_count=1,
                             seed=1)),
    "zipf": (_zipf, dict(vector_size=8, max_iter=2, min_count=2, seed=3,
                         batch_size=64, window_size=3, num_negatives=4)),
    "tiny": (lambda: np.array(["a b a b c", "c a"], dtype=object),
             dict(vector_size=4, max_iter=2, min_count=1, seed=0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pairs_vocab_initial_table_and_vectors_equal_jax(monkeypatch, case):
    make, kw = CASES[case]
    docs = make()
    kw = dict(input_col="text", output_col="v", **kw)
    jm, jpairs = _jax_fit(monkeypatch, docs, **kw)
    # the initial table: no epoch
    jm0, _ = _jax_fit(monkeypatch, docs, **{**kw, "max_iter": 0})
    pm0, _ = _port_fit(docs, **{**kw, "max_iter": 0})
    assert pm0.get("vocab") == jm0.get("vocab")
    np.testing.assert_array_equal(np.asarray(pm0.get("vectors"), np.float32),
                                  np.asarray(jm0.get("vectors"), np.float32))

    S = pm0.fit_stats["steps"]
    B = pm0.fit_stats["pairs"] // S
    K = kw.get("num_negatives", 5)
    us = _jax_uniforms(kw["seed"], kw["max_iter"], S, B, K)
    pm, ppairs = _port_fit(docs, us, **kw)
    assert pm.get("vocab") == jm.get("vocab")
    assert len(ppairs) == len(jpairs) == kw["max_iter"]
    for (pc, po), (jc, jo) in zip(ppairs, jpairs):
        np.testing.assert_array_equal(pc.reshape(-1), jc[:S * B])
        np.testing.assert_array_equal(po.reshape(-1), jo[:S * B])
    a = np.asarray(pm.get("vectors"), np.float32)
    b = np.asarray(jm.get("vectors"), np.float32)
    assert np.isfinite(a).all()
    assert np.abs(a - b).max() <= TOL * np.abs(b).max(), \
        (np.abs(a - b).max(), np.abs(b).max())


@pytest.mark.parametrize("V", [12, 1000, 65536])
def test_negative_draws_equal_jax_choice(V):
    """``cumsum_blocked`` is XLA's blocked prefix sum bit for bit, so every
    index drawn from JAX's uniforms is the one ``jax.random.choice`` draws
    (a plain sequential float32 sum moves 70% of them at 65,536 words)."""
    counts = np.maximum(np.round(
        np.arange(1, V + 1, dtype=np.float64) ** -1.1 * 1e6), 2)
    freq = counts ** 0.75
    p = (freq / freq.sum()).astype(np.float32)
    key = jax.random.PRNGKey(7)
    shape = (40, 512, 5)
    ref = np.asarray(jax.random.choice(key, V, shape, p=jnp.asarray(p)))
    u = np.array(jax.random.uniform(key, shape, dtype=jnp.float32))
    cum = tw2v.cumsum_blocked(p)
    np.testing.assert_array_equal(cum, np.asarray(jnp.cumsum(jnp.asarray(p))))
    got = tw2v.draw_negatives(torch.from_numpy(cum),
                              torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_transform_and_synonyms_equal_jax_on_the_same_table():
    rng = np.random.default_rng(4)
    vocab = [f"t{i}" for i in range(30)]
    vectors = rng.normal(size=(30, 6)).astype(np.float32).tolist()
    docs = np.empty(4, dtype=object)
    docs[0] = "t1 t2 T3 zz"
    docs[1] = "nothing known"
    docs[2] = ["t4", "t4", "t29"]
    docs[3] = ""
    out = {}
    for name, core, feat in (("jax", jcore, jfeat), ("port", tcore, tfeat)):
        m = feat.Word2VecModel(input_col="text", output_col="v",
                               vocab=vocab, vectors=vectors)
        col = m.transform(core.DataFrame.from_dict({"text": docs})) \
            .collect()["v"]
        out[name] = (np.stack(col), m.find_synonyms("t7", num=6))
    np.testing.assert_array_equal(out["port"][0], out["jax"][0])
    assert out["port"][1] == out["jax"][1]


def test_word2vec_separates_topics_and_averages_docs():
    """The JAX package's ``test_word2vec.py`` topic test, on the port."""
    m = tfeat.Word2Vec(input_col="text", output_col="features",
                       vector_size=16, max_iter=3, min_count=1, seed=1,
                       device="cpu").fit(
        tcore.DataFrame.from_dict({"text": _topics()}))
    vec = np.asarray(m.get("vectors"), np.float32)
    idx = {w: i for i, w in enumerate(m.get("vocab"))}

    def cos(a, b):
        va, vb = vec[idx[a]], vec[idx[b]]
        return float(va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb)))

    in_topic = np.mean([cos("pizza", "pasta"), cos("cpu", "gpu"),
                        cos("cheese", "tomato"), cos("memory", "cache")])
    cross = np.mean([cos("pizza", "cpu"), cos("pasta", "gpu"),
                     cos("basil", "compiler")])
    assert in_topic > cross + 0.2, (in_topic, cross)
    out = m.transform(tcore.DataFrame.from_dict(
        {"text": np.asarray(["pizza cheese", "zzz-unknown"], dtype=object)}))
    feats = out.collect()["features"]
    want = (vec[idx["pizza"]] + vec[idx["cheese"]]) / 2
    np.testing.assert_allclose(np.asarray(feats[0]), want, rtol=1e-5)
    assert np.allclose(np.asarray(feats[1]), 0.0)
    syn = m.find_synonyms("pizza", num=3)
    assert {w for w, _ in syn} <= {"pasta", "cheese", "tomato", "basil",
                                   "oven"}, syn


def test_validation_persistence_and_jax_saved_model(tmp_path):
    docs = np.empty(2, dtype=object)
    docs[0] = ["a", "b", "a", "b", "a", "b"]
    docs[1] = ["b", "a", "b", "a", "b", "a"]
    df = tcore.DataFrame.from_dict({"toks": docs})
    m = tfeat.Word2Vec(input_col="toks", output_col="v", vector_size=4,
                       min_count=1, max_iter=1, device="cpu").fit(df)
    assert sorted(m.get("vocab")) == ["a", "b"]
    with pytest.raises(ValueError, match="vocabulary"):
        tfeat.Word2Vec(input_col="toks", output_col="v", min_count=99,
                       device="cpu").fit(df)
    with pytest.raises(ValueError, match="pairs"):
        tfeat.Word2Vec(input_col="toks", output_col="v", min_count=1,
                       device="cpu").fit(tcore.DataFrame.from_dict(
                           {"toks": np.array(["a", "b"], dtype=object)}))
    tcore.save(m, str(tmp_path / "port"))
    back = tcore.load(str(tmp_path / "port"))
    np.testing.assert_array_equal(np.asarray(back.get("vectors")),
                                  np.asarray(m.get("vectors")))
    # a model the JAX package saved loads in the port, vectors unchanged
    jm = jfeat.Word2Vec(input_col="text", output_col="v", vector_size=8,
                        min_count=1, seed=2).fit(
        jcore.DataFrame.from_dict({"text": _topics(60, seed=3)}))
    jcore.save(jm, str(tmp_path / "jax"))
    pm = tcore.load(str(tmp_path / "jax"))
    assert isinstance(pm, tfeat.Word2VecModel)
    assert pm.get("vocab") == jm.get("vocab")
    np.testing.assert_array_equal(np.asarray(pm.get("vectors")),
                                  np.asarray(jm.get("vectors")))
    assert pm.find_synonyms("pizza", 3) == jm.find_synonyms("pizza", 3)


def test_fit_needs_the_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    df = tcore.DataFrame.from_dict({"text": _topics(20)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfeat.Word2Vec(input_col="text", output_col="v",
                       min_count=1).fit(df)
