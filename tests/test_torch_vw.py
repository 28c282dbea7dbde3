"""VowpalWabbit in the port (``mmlspark_tpu_torch.vw``, ``train.metrics``)
against the JAX package on the same seeded inputs, on the CPU.

Twins of ``tests/test_vw.py``'s tests (each runs both packages; the
native data plane and the CSV reader on the port's host library
``csrc/csv.cpp``), then the learners held to the JAX
package's weights (rtol 1e-5, atol 1e-6) in every variant: l1, l2, the
non-adaptive rate with ``initial_t``, ``-q``, hinge and quantile losses,
partitions of different widths with l2 (the padding semantics), the
bandit with ips and mtr; ``--bfgs`` (on smooth objectives the objective
within 1e-5 relative and the weights within 1e-4; with l1, whose
iterates part at a weight crossing 0, the objective within 1e-3) and the
copy of
``optax.lbfgs`` against optax itself; params, stats, interchange and the
evaluation transformers.
"""
import json
import os

import numpy as np
import pytest
import torch

import mmlspark_tpu.core as jcore
import mmlspark_tpu.train as jtrain
import mmlspark_tpu.vw as jvw
import mmlspark_tpu_torch.core as tcore
import mmlspark_tpu_torch.train as ttrain
import mmlspark_tpu_torch.vw as tvw
from mmlspark_tpu_torch.vw import learners as tlearners

PKGS = {"jax": (jcore, jvw), "port": (tcore, tvw)}
RTOL, ATOL = 1e-5, 1e-6


def _est(pkg, cls, **kw):
    est = getattr(PKGS[pkg][1], cls)()
    if pkg == "port":
        kw = {"device": "cpu", **kw}
    return est.set_params(**kw)


# ---------------------------------------------------------------------------
# hashing and features
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_murmur_reference_vectors(pkg):
    murmur3_bytes = PKGS[pkg][1].murmur3_bytes
    # canonical MurmurHash3_x86_32 test vectors
    assert murmur3_bytes(b"", 0) == 0
    assert murmur3_bytes(b"", 1) == 0x514E28B7
    assert murmur3_bytes(b"hello", 0) == 0x248BFA47
    assert murmur3_bytes(b"hello, world", 0) == 0x149BBB7F
    assert murmur3_bytes(b"The quick brown fox jumps over the lazy dog",
                         0) == 0x2E4FF723
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 2 ** 32, size=64, dtype=np.uint64) \
        .astype(np.uint32)
    np.testing.assert_array_equal(PKGS[pkg][1].murmur3_ints(vals, 5),
                                  jvw.murmur3_ints(vals, 5))


def test_murmur3_batch_native_equals_the_scalar_hash():
    """The port's C++ batch (``csrc/murmur.cpp``) equals the scalar Python
    hash of both packages bit for bit; the cache batches > 32 cold
    strings through it."""
    from mmlspark_tpu_torch.utils.native_loader import murmur3_batch_native
    rng = np.random.default_rng(1)
    words = ["", "a", "ab", "abc", "abcd", "héllo wörld", "a" * 100] + [
        "".join(chr(97 + c) for c in rng.integers(0, 26, rng.integers(1, 12)))
        for _ in range(200)]
    for seed in (0, 7, 0xFFFFFFFF):
        got = murmur3_batch_native(words, seed)
        assert got.dtype == np.uint32
        assert got.tolist() == [jvw.murmur3_bytes(w.encode(), seed)
                                for w in words]
        assert got.tolist() == [tvw.murmur3_bytes(w.encode(), seed)
                                for w in words]
    assert murmur3_batch_native([], 3).shape == (0,)
    arr = np.asarray(words * 2, dtype=object)
    np.testing.assert_array_equal(tvw.StringHashCache(7).hash_array(arr),
                                  jvw.StringHashCache(7).hash_array(arr))


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_native_data_plane(pkg):
    """The C++ data plane: batch murmur = the scalar hash, the CSV parser
    (NaN for an empty or unparsable cell) and the chunked array.  The
    port's binds ``csrc/murmur.cpp`` and ``csrc/csv.cpp`` (raising if they
    cannot build); the JAX package's builds ``native/`` and skips without
    a toolchain."""
    if pkg == "jax":
        from mmlspark_tpu.utils import native_loader as nl
        if nl.load_native() is None:
            pytest.skip("no C++ toolchain available")
    else:
        from mmlspark_tpu_torch.utils import native_loader as nl
    strings = ["hello", "world", "", "The quick brown fox", "a" * 100]
    got = nl.murmur3_batch_native(strings, seed=7)
    assert got.tolist() == [jvw.murmur3_bytes(w.encode(), 7)
                            for w in strings]
    csv_text = b"a,b,c\n1,2.5,3\n4,,6\n7,8,bad\n"
    mat = nl.csv_to_matrix_native(csv_text)
    assert mat.dtype == np.float32 and mat.shape == (3, 3)
    assert mat[0, 1] == 2.5 and np.isnan(mat[1, 1]) and np.isnan(mat[2, 2])
    ca = nl.ChunkedArray(initial_cap=4)
    ca.add([1.0, 2.0, 3.0])
    ca.add(np.arange(100, dtype=np.float32))
    assert ca.size == 103
    out = ca.coalesce()
    assert out[2] == 3.0 and out[-1] == 99.0
    ca.close()


def test_native_csv_parser_equals_jax():
    from mmlspark_tpu.utils import native_loader as jnl
    from mmlspark_tpu_torch.utils import native_loader as tnl
    if jnl.load_native() is None:
        pytest.skip("no C++ toolchain available")
    rng = np.random.default_rng(4)
    X = rng.normal(size=(500, 7)) * 10.0 ** rng.integers(-3, 4, (500, 7))
    lines = [",".join("" if rng.random() < 0.02 else repr(v) for v in row)
             for row in X]
    text = ("h0,h1,h2,h3,h4,h5,h6\r\n" + "\r\n".join(lines)).encode()
    for header in (True, False):
        np.testing.assert_array_equal(
            tnl.csv_to_matrix_native(text, skip_header=header),
            jnl.csv_to_matrix_native(text, skip_header=header))


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_csv_reader(pkg, tmp_path):
    read_csv = (__import__("mmlspark_tpu.io.csv", fromlist=["read_csv"])
                if pkg == "jax" else __import__(
                    "mmlspark_tpu_torch.io.csv", fromlist=["read_csv"])
                ).read_csv
    p = tmp_path / "data.csv"
    p.write_text("x,y,name\n1,2.5,alpha\n3,4.5,beta\n")
    got = read_csv(str(p)).collect()
    assert got["x"].tolist() == [1.0, 3.0]
    assert got["name"][1] == "beta"
    p2 = tmp_path / "num.csv"
    p2.write_text("a,b\n1,2\n3,4\n")
    df2 = read_csv(str(p2), numeric_only=True)
    assert df2.collect()["b"].tolist() == [2.0, 4.0]


def _feature_frame(core):
    return core.DataFrame.from_dict({
        "num": np.array([1.5, 2.0, 0.0]),
        "cat": np.array(["a", "b", "a"], dtype=object),
        "txt": np.array(["red green", "green", ""], dtype=object),
        "vec": np.array([[1.0, 0.0, 2.0], [0.0, 0.0, 0.0],
                         [3.0, 1.0, 0.0]]),
        "mp": np.array([{"k": 1.0, "s": "x"}, {"k": 2.5}, {}], dtype=object),
    })


def test_featurizer_types_and_merge():
    outs = {}
    for pkg, (core, vw) in PKGS.items():
        feat = vw.VowpalWabbitFeaturizer(
            input_cols=["num", "cat", "txt", "vec", "mp"],
            output_col="features", num_bits=16, string_split_cols=["txt"])
        outs[pkg] = out = feat.transform(_feature_frame(core)) \
            .collect()["features"]
        # row 0: 1 numeric + 1 categorical + 2 tokens + 2 nonzero vec
        # + 2 map entries = 8 entries
        assert len(out[0]["indices"]) == 8
        assert (out[0]["indices"] < 2 ** 16).all()
        assert np.argsort(out[0]["indices"]).tolist() == list(range(8))
        assert len(out[2]["indices"]) == 4  # num=0 hashed, "" no tokens
    for a, b in zip(outs["jax"], outs["port"]):
        np.testing.assert_array_equal(a["indices"], b["indices"])
        np.testing.assert_array_equal(a["values"], b["values"])
        assert a["indices"].dtype == b["indices"].dtype
        assert a["values"].dtype == b["values"].dtype


@pytest.mark.parametrize("kind", ["split", "string", "map", "vector",
                                  "numeric"])
def test_featurizer_column_kinds_equal_jax(kind):
    """Every column kind alone, with and without column-name prefixes,
    colliding hashes summed: equal indices and values."""
    rng = np.random.default_rng(4)
    n = 40
    vocab = [f"w{i}" for i in range(30)]
    col = {
        "split": np.array([" ".join(rng.choice(vocab, rng.integers(0, 6)))
                           for _ in range(n)], dtype=object),
        "string": np.array([str(rng.choice(vocab)) for _ in range(n)],
                           dtype=object),
        "map": np.array([{str(rng.choice(vocab)): float(rng.normal()),
                          "tag": str(rng.choice(vocab))} for _ in range(n)],
                        dtype=object),
        "vector": rng.normal(size=(n, 12)) * (rng.random((n, 12)) < 0.4),
        "numeric": rng.normal(size=n),
    }[kind]
    for prefix in (True, False):
        outs = []
        for core, vw in PKGS.values():
            df = core.DataFrame.from_dict({"c": col}, 2)
            outs.append(vw.VowpalWabbitFeaturizer(
                input_cols=["c"], output_col="f", num_bits=6,
                string_split_cols=["c"] if kind == "split" else [],
                prefix_strings_with_column_name=prefix).transform(df)
                .collect()["f"])
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a["indices"], b["indices"])
            np.testing.assert_array_equal(a["values"], b["values"])


def test_interactions_quadratic():
    outs = []
    for core, vw in PKGS.values():
        df = core.DataFrame.from_dict({
            "a": np.array([1.0, 2.0]),
            "b": np.array(["x", "y"], dtype=object),
            "c": np.array(["p q", "r"], dtype=object),
        })
        f1 = vw.VowpalWabbitFeaturizer(input_cols=["a"], output_col="fa",
                                       num_bits=15)
        f2 = vw.VowpalWabbitFeaturizer(input_cols=["b", "c"], output_col="fb",
                                       num_bits=15, string_split_cols=["c"])
        inter = vw.VowpalWabbitInteractions(input_cols=["fa", "fb"],
                                            output_col="fq", num_bits=15)
        out = inter.transform(f2.transform(f1.transform(df))).collect()["fq"]
        assert len(out[1]["indices"]) == 2    # 1 x 2 cross
        outs.append(out)
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a["indices"], b["indices"])
        np.testing.assert_array_equal(a["values"], b["values"])


# ---------------------------------------------------------------------------
# learners against the JAX package
# ---------------------------------------------------------------------------

def _sparse_frame(core, n=800, d=30, seed=0, classify=True, parts=2,
                  density=1.0, extra=None):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    if density < 1.0:
        X[rng.random((n, d)) > density] = 0.0
    w_true = rng.normal(size=d)
    logit = X @ w_true
    y = (logit > 0).astype(float) if classify \
        else logit + rng.normal(scale=0.1, size=n)
    col = np.empty(n, dtype=object)
    for i in range(n):
        nz = np.nonzero(X[i])[0]
        # a hash-like spread with collisions
        col[i] = {"indices": (nz * 7919 % 701).astype(np.int32),
                  "values": X[i, nz].astype(np.float32)}
    data = {"features": col, "label": y, **(extra or {})}
    return core.DataFrame.from_dict(data, parts), X, y


def _fit_both(cls, frame_kw=None, **params):
    models = {}
    for pkg, (core, _) in PKGS.items():
        df = _sparse_frame(core, **(frame_kw or {}))[0]
        models[pkg] = _est(pkg, cls, **params).fit(df)
    return models


def _weights_close(models, rtol=RTOL, atol=ATOL):
    wj, wt = models["jax"].weights, models["port"].weights
    assert wt.dtype == np.float32 and wt.shape == wj.shape
    np.testing.assert_allclose(wt, wj, rtol=rtol, atol=atol)


_VARIANTS = {
    "defaults": ("VowpalWabbitClassifier", {}, {}),
    "l1_l2": ("VowpalWabbitClassifier", {"l1": 1e-4, "l2": 1e-3}, {}),
    "noadaptive_initial_t": ("VowpalWabbitClassifier",
                             {"adaptive": False, "initial_t": 3.0,
                              "learning_rate": 0.1}, {}),
    "nonormalized": ("VowpalWabbitClassifier", {"normalized": False}, {}),
    "hinge_3_passes": ("VowpalWabbitClassifier",
                       {"loss_function": "hinge", "num_passes": 3}, {}),
    "regressor": ("VowpalWabbitRegressor",
                  {"num_passes": 2, "learning_rate": 0.1},
                  {"classify": False}),
    "quantile_noadaptive": ("VowpalWabbitRegressor",
                            {"args": "--loss_function quantile "
                                     "--noadaptive --power_t 0.3"},
                            {"classify": False}),
    "batch_64_sparse": ("VowpalWabbitClassifier", {"batch_size": 64},
                        {"density": 0.3, "parts": 3}),
}


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_learner_weights_match_jax(variant):
    cls, params, frame_kw = _VARIANTS[variant]
    models = _fit_both(cls, frame_kw, num_bits=10, **params)
    _weights_close(models)
    assert np.abs(models["port"].weights).max() > 0.05


def test_padding_semantics_with_l2():
    """Partitions of different ``max_nnz`` with l2 > 0 and a short last
    batch: every padded slot (index 0, value 0) adds ``lr*l2*w[0]`` to
    index 0's delta and L1 shrinks index 0, so the port must pad each
    partition to its own width and each short batch to ``batch_size``."""
    rng = np.random.default_rng(8)
    n = 300
    widths = np.where(np.arange(n) < 150, 3, 12)
    col = np.empty(n, dtype=object)
    for i in range(n):
        k = int(widths[i] - rng.integers(0, 3))
        col[i] = {"indices": np.concatenate(
                      [[0], rng.integers(1, 64, k)]).astype(np.int32),
                  "values": rng.normal(size=k + 1).astype(np.float32)}
    y = (rng.random(n) > 0.5).astype(float)
    models = {}
    for pkg, (core, _) in PKGS.items():
        df = core.DataFrame.from_dict({"features": col, "label": y}, 2)
        assert [len(p["label"]) for p in df.partitions] == [150, 150]
        models[pkg] = _est(pkg, "VowpalWabbitClassifier", num_bits=6,
                           l2=0.05, l1=1e-3, batch_size=64).fit(df)
    _weights_close(models)
    assert abs(models["port"].weights[0]) > 0    # index 0 is live too


@pytest.mark.parametrize("initial_t", [0.0, 5.0])
def test_interactions_q_match_jax(initial_t):
    """``-q ab`` crosses the namespace columns at fit and at scoring."""
    rng = np.random.default_rng(12)
    n = 400

    def ns(k):
        c = np.empty(n, dtype=object)
        for i in range(n):
            c[i] = {"indices": rng.integers(0, 50, k).astype(np.int32),
                    "values": rng.normal(size=k).astype(np.float32)}
        return c

    a_col, b_col, base = ns(2), ns(3), ns(4)
    y = rng.normal(size=n)
    models, preds = {}, {}
    for pkg, (core, _) in PKGS.items():
        df = core.DataFrame.from_dict({"features": base, "a_ns": a_col,
                                       "b_ns": b_col, "label": y}, 2)
        m = _est(pkg, "VowpalWabbitRegressor", num_bits=12,
                 args="-q ab", initial_t=initial_t, adaptive=False,
                 learning_rate=0.05).fit(df)
        models[pkg] = m
        preds[pkg] = m.transform(df).collect()["prediction"]
    assert models["port"].get("interactions") == ["ab"]
    _weights_close(models)
    np.testing.assert_allclose(preds["port"], preds["jax"], rtol=1e-5,
                               atol=1e-5)


def _bandit_frame(core, n=400, n_actions=3, d=8, seed=3, shared=False):
    rng = np.random.default_rng(seed)
    act_col = np.empty(n, dtype=object)
    sh_col = np.empty(n, dtype=object)
    chosen = np.zeros(n)
    cost = np.zeros(n)
    prob = np.full(n, 1.0 / n_actions)
    best = np.zeros(n, dtype=int)
    for i in range(n):
        acts, costs_i = [], []
        for a in range(n_actions):
            x = rng.normal(size=d).astype(np.float32)
            acts.append({"indices": np.arange(d, dtype=np.int32) + a * d,
                         "values": x})
            costs_i.append(float(x[0]))  # cost driven by feature 0
        act_col[i] = acts
        sh_col[i] = {"indices": np.array([100, 101], np.int32),
                     "values": rng.normal(size=2).astype(np.float32)}
        best[i] = int(np.argmin(costs_i))
        c = rng.integers(0, n_actions)
        chosen[i] = c + 1
        cost[i] = costs_i[c]
        prob[i] = rng.uniform(0.2, 0.6)
    data = {"action_features": act_col, "chosen_action": chosen,
            "cost": cost, "probability": prob, "label": cost}
    if shared:
        data["shared_features"] = sh_col
    return core.DataFrame.from_dict(data, 2), best


def test_contextual_bandit():
    for pkg in PKGS:
        df, best = _bandit_frame(PKGS[pkg][0])
        model = _est(pkg, "VowpalWabbitContextualBandit", num_bits=12,
                     num_passes=10, learning_rate=0.5).fit(df)
        scores = model.transform(df).collect()["prediction"]
        picked = np.asarray([np.argmin(s) for s in scores])
        assert (picked == best).mean() > 0.6


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("cb_type", ["ips", "mtr"])
def test_bandit_matches_jax(cb_type, shared):
    models, scores = {}, {}
    for pkg, (core, _) in PKGS.items():
        df, _ = _bandit_frame(core, shared=shared, seed=5)
        m = _est(pkg, "VowpalWabbitContextualBandit", num_bits=10,
                 num_passes=2, args=f"--cb_type {cb_type}",
                 l2=1e-3).fit(df)
        models[pkg] = m
        scores[pkg] = np.stack(m.transform(df).collect()["prediction"])
    _weights_close(models)
    np.testing.assert_allclose(scores["port"], scores["jax"], rtol=1e-5,
                               atol=1e-5)


def _bfgs_objective(weights, df, loss, l1, l2):
    from mmlspark_tpu_torch.vw.learners import pack_sparse_column
    col = np.concatenate([p["features"] for p in df.partitions])
    y = np.concatenate([p["label"] for p in df.partitions])
    idx, val = pack_sparse_column(col, mask=len(weights) - 1)
    pred = (weights[idx] * val).sum(1).astype(np.float64)
    if loss == "logistic":
        base = np.mean(np.logaddexp(0.0, -np.where(y > 0, 1, -1) * pred))
    else:
        base = np.mean(0.5 * (pred - y) ** 2)
    w64 = weights.astype(np.float64)
    return base + 0.5 * l2 * (w64 ** 2).sum() + l1 * np.abs(w64).sum()


@pytest.mark.parametrize("cls,params,smooth", [
    ("VowpalWabbitClassifier", {"l2": 1e-3}, True),
    ("VowpalWabbitRegressor", {}, True),
    ("VowpalWabbitRegressor", {"l2": 1e-2, "args": "--passes 10"}, True),
    ("VowpalWabbitClassifier", {"l1": 1e-3}, False),
])
def test_bfgs_matches_jax(cls, params, smooth):
    """20 L-BFGS iterations (or ``--passes``): on smooth objectives the
    objective within 1e-5 relative and the weights within 1e-4.  With l1
    the objective is not smooth at 0: once rounding (the two packages'
    dot products sum in different orders) puts a weight on the other side
    of 0, the iterates part (after 5-10 iterations here), so the l1 case
    holds the objective within 1e-3 relative and below the start's."""
    classify = cls == "VowpalWabbitClassifier"
    args = "--bfgs " + params.pop("args", "")
    models = _fit_both(cls, {"classify": classify, "density": 0.5},
                       num_bits=10, args=args, **params)
    df = _sparse_frame(tcore, classify=classify, density=0.5)[0]
    loss = "logistic" if classify else "squared"
    l1, l2 = params.get("l1", 0.0), params.get("l2", 0.0)
    oj = _bfgs_objective(models["jax"].weights, df, loss, l1, l2)
    ot = _bfgs_objective(models["port"].weights, df, loss, l1, l2)
    assert abs(ot - oj) <= (1e-5 if smooth else 1e-3) * abs(oj), (oj, ot)
    assert ot < _bfgs_objective(np.zeros_like(models["port"].weights), df,
                                loss, l1, l2)
    if smooth:
        np.testing.assert_allclose(models["port"].weights,
                                   models["jax"].weights, rtol=0, atol=1e-4)
    stats = models["port"].get("stats")
    assert stats[0]["passes"] == (10 if "--passes" in args else 20)


def test_lbfgs_copy_tracks_optax():
    """The first three iterates of ``vw.lbfgs.LBFGS`` within 1e-6 of
    ``optax.lbfgs()``'s on a small quadratic."""
    import jax.numpy as jnp
    import optax
    from mmlspark_tpu_torch.vw.lbfgs import LBFGS, value_and_grad
    rng = np.random.default_rng(0)
    d = 12
    A = rng.normal(size=(d, d)).astype(np.float32)
    H = (A @ A.T / d + np.eye(d)).astype(np.float32)
    b = rng.normal(size=d).astype(np.float32)

    def fj(w):
        return 0.5 * w @ (jnp.asarray(H) @ w) - jnp.asarray(b) @ w

    def ft(w):
        return 0.5 * w @ (torch.from_numpy(H) @ w) - torch.from_numpy(b) @ w

    opt = optax.lbfgs()
    vg = optax.value_and_grad_from_state(fj)
    w = jnp.full(d, 0.5)
    state = opt.init(w)
    ref = []
    for _ in range(3):
        v, g = vg(w, state=state)
        u, state = opt.update(g, state, w, value=v, grad=g, value_fn=fj)
        w = optax.apply_updates(w, u)
        ref.append(np.asarray(w))
    port = LBFGS(value_and_grad(ft))
    wt = torch.full((d,), 0.5)
    port.init(wt)
    for k in range(3):
        wt = port.step(wt)
        np.testing.assert_allclose(wt.numpy(), ref[k], rtol=0, atol=1e-6)


def test_bfgs_batch_mode():
    """VW --bfgs: full-batch L-BFGS matches (or beats) the online SGD path
    on a linear target, parsed from the arg string, in both packages."""
    rng = np.random.default_rng(0)
    n = 600
    x1, x2 = rng.normal(size=n), rng.normal(size=n)
    y = 2.0 * x1 - 1.0 * x2 + rng.normal(scale=0.1, size=n)
    col = np.empty(n, dtype=object)
    for i in range(n):
        col[i] = {"indices": np.array([3, 9], np.int32),
                  "values": np.array([x1[i], x2[i]], np.float32)}
    preds = {}
    for pkg, (core, _) in PKGS.items():
        df = core.DataFrame.from_dict({"features": col, "label": y}, 2)
        bfgs = _est(pkg, "VowpalWabbitRegressor", args="--bfgs --passes 20",
                    num_bits=10).fit(df)
        sgd = _est(pkg, "VowpalWabbitRegressor", num_passes=20,
                   num_bits=10).fit(df)
        p_b = bfgs.transform(df).collect()["prediction"]
        p_s = sgd.transform(df).collect()["prediction"]
        mse_b = float(np.mean((p_b - y) ** 2))
        assert mse_b < 0.05, mse_b
        assert mse_b <= float(np.mean((p_s - y) ** 2)) * 1.5
        yc = (y > 0).astype(np.float64)
        dfc = core.DataFrame.from_dict({"features": col, "label": yc}, 2)
        clf = _est(pkg, "VowpalWabbitClassifier", args="--bfgs",
                   num_bits=10).fit(dfc)
        acc = float((clf.transform(dfc).collect()["prediction"] == yc)
                    .mean())
        assert acc > 0.95, acc
        preds[pkg] = p_b
    np.testing.assert_allclose(preds["port"], preds["jax"], rtol=1e-4,
                               atol=1e-4)


def test_bandit_rejects_bfgs_and_optimizer_validates():
    for pkg, (core, vw) in PKGS.items():
        with pytest.raises(Exception):
            vw.VowpalWabbitRegressor().set_params(optimizer="lbfgs")
        cb = _est(pkg, "VowpalWabbitContextualBandit", args="--bfgs")
        acts = np.empty(4, dtype=object)
        for i in range(4):
            acts[i] = [{"indices": np.array([1], np.int32),
                        "values": np.array([1.0], np.float32)}] * 2
        df = core.DataFrame.from_dict({"action_features": acts,
                                       "chosen_action": np.ones(4),
                                       "cost": np.zeros(4),
                                       "probability": np.full(4, 0.5)})
        with pytest.raises(NotImplementedError, match="contextual bandit"):
            cb.fit(df)


# ---------------------------------------------------------------------------
# params, stats, interchange and scoring
# ---------------------------------------------------------------------------

def test_vw_classifier_learns():
    for pkg in PKGS:
        df, X, y = _sparse_frame(PKGS[pkg][0], 800, 30)
        model = _est(pkg, "VowpalWabbitClassifier", num_bits=10, num_passes=5,
                     learning_rate=0.5).fit(df)
        out = model.transform(df).collect()
        assert (out["prediction"] == y).mean() > 0.85
        stats = model.get_performance_statistics().collect()
        assert stats["rows"].sum() == 800


def test_vw_regressor_learns_and_bytes_roundtrip():
    """Warm starts from model bytes, across packages too: the JAX model's
    bytes warm-start the port and the port's the JAX package."""
    fits = {}
    for pkg in PKGS:
        df, X, y = _sparse_frame(PKGS[pkg][0], 600, 20, classify=False)
        model = _est(pkg, "VowpalWabbitRegressor", num_bits=10,
                     num_passes=8).fit(df)
        pred = model.transform(df).collect()["prediction"]
        assert float(np.mean((pred - y) ** 2)) < np.var(y) * 0.3
        fits[pkg] = (model, df, y)
    for src, dst in (("jax", "port"), ("port", "jax")):
        model, _, _ = fits[src]
        _, df, y = fits[dst]
        m2 = _est(dst, "VowpalWabbitRegressor", num_bits=10, num_passes=1,
                  initial_model=model.model_bytes()).fit(df)
        pred2 = m2.transform(df).collect()["prediction"]
        assert float(np.mean((pred2 - y) ** 2)) < np.var(y) * 0.3
    # the same warm start gives the same weights in both packages, to the
    # summation order of the predictions (nonzero from the first step: the
    # two packages sum a row's products in different orders)
    b = fits["jax"][0].model_bytes()
    warm = {pkg: _est(pkg, "VowpalWabbitRegressor", num_bits=10,
                      initial_model=b).fit(fits[pkg][1]) for pkg in PKGS}
    _weights_close(warm, rtol=1e-4, atol=1e-5)


def test_model_bytes_roundtrip_bit_identical():
    m = _fit_both("VowpalWabbitClassifier", num_bits=10)["port"]
    b = m.model_bytes()
    back = tvw.VowpalWabbitClassificationModel.bytes_to_weights(b, 1024)
    assert back.tobytes() == b
    assert jvw.VowpalWabbitClassificationModel.bytes_to_weights(b, 1024) \
        .tobytes() == b
    with pytest.raises(ValueError, match="expected 2048"):
        tvw.VowpalWabbitClassificationModel.bytes_to_weights(b, 2048)


def test_vw_args_string():
    for pkg in PKGS:
        reg = _est(pkg, "VowpalWabbitRegressor",
                   args="-b 12 -l 0.1 --passes 3 --l1 0.01 --l2 0.2 "
                        "--power_t 0.25 --initial_t 2 --noadaptive "
                        "--nonormalized -q ab --interactions cd "
                        "--loss_function quantile --quiet")
        reg._parse_args()
        reg._parse_args()                      # idempotent
        assert reg.get("num_bits") == 12
        assert reg.get("learning_rate") == 0.1
        assert reg.get("num_passes") == 3
        assert reg.get("interactions") == ["ab", "cd"]
        bf = _est(pkg, "VowpalWabbitRegressor", args="--bfgs")
        bf._parse_args()
        assert bf.get("optimizer") == "bfgs"  # batch L-BFGS mode
    params = {}
    for pkg in PKGS:
        est = _est(pkg, "VowpalWabbitContextualBandit",
                   args="-b 9 --cb_type mtr --passes 2 -l 0.3")
        est._parse_args()
        params[pkg] = {k: est.get(k) for k in (
            "num_bits", "cb_type", "num_passes", "learning_rate", "l1",
            "adaptive", "normalized", "optimizer")}
    assert params["port"] == params["jax"]
    for pkg in PKGS:
        with pytest.raises(NotImplementedError, match="cb_type"):
            _est(pkg, "VowpalWabbitClassifier",
                 args="--cb_type dr")._parse_args()


def test_performance_statistics_have_the_same_columns():
    models = _fit_both("VowpalWabbitClassifier", {"parts": 3}, num_bits=10)
    frames = {k: m.get_performance_statistics().collect()
              for k, m in models.items()}
    assert sorted(frames["port"]) == sorted(frames["jax"])
    for col in ("partition_id", "rows", "features_per_example", "passes"):
        np.testing.assert_array_equal(frames["port"][col], frames["jax"][col])
    bf = _fit_both("VowpalWabbitRegressor", {"classify": False},
                   num_bits=10, args="--bfgs --passes 3")
    assert sorted(bf["port"].get_performance_statistics().collect()) == \
        sorted(bf["jax"].get_performance_statistics().collect())


def test_vw_save_load(tmp_path):
    for pkg, (core, _) in PKGS.items():
        df, X, y = _sparse_frame(core, 300, 10)
        model = _est(pkg, "VowpalWabbitClassifier", num_bits=10,
                     num_passes=3).fit(df)
        p = str(tmp_path / pkg)
        core.save(model, p)
        m2 = core.load(p)
        a = model.transform(df).collect()["prediction"]
        b = m2.transform(df).collect()["prediction"]
        assert np.array_equal(a, b)


def _retarget(path, to_pkg):
    """The saved stage's class path pointed at the other package's twin
    (the on-disk layout is the same; only the class path differs)."""
    meta_p = os.path.join(path, "metadata.json")
    with open(meta_p) as f:
        meta = json.load(f)
    mod, name = meta["class"].rsplit(".", 1)
    rel = mod.split(".", 1)[1]
    meta["class"] = f"{to_pkg}.{rel}.{name}"
    meta["params"].pop("device", None)
    with open(meta_p, "w") as f:
        json.dump(meta, f)


@pytest.mark.parametrize("cls", ["VowpalWabbitClassifier",
                                 "VowpalWabbitRegressor"])
def test_models_interchange_between_packages(tmp_path, cls):
    """A model saved by the JAX package loads in the port (its class path
    names the port's twin) and scores as it does; the port's saved model,
    its class path pointed at the JAX twin, loads in the JAX package and
    scores equal."""
    classify = cls == "VowpalWabbitClassifier"
    models = _fit_both(cls, {"classify": classify}, num_bits=10,
                       args="-q fb")
    col = "prediction"
    frames = {pkg: _sparse_frame(core, classify=classify)[0]
              for pkg, (core, _) in PKGS.items()}
    jpath, tpath = str(tmp_path / "jax"), str(tmp_path / "port")
    jcore.save(models["jax"], jpath)
    back = tcore.load(jpath)
    assert type(back).__module__.startswith("mmlspark_tpu_torch.")
    back.set("device", "cpu")
    np.testing.assert_array_equal(back.weights, models["jax"].weights)
    np.testing.assert_allclose(
        back.transform(frames["port"]).collect()[col],
        models["jax"].transform(frames["jax"]).collect()[col], rtol=1e-6,
        atol=1e-6)
    tcore.save(models["port"], tpath)
    _retarget(tpath, "mmlspark_tpu")
    jback = jcore.load(tpath)
    assert type(jback).__module__.startswith("mmlspark_tpu.vw")
    np.testing.assert_array_equal(jback.weights, models["port"].weights)
    np.testing.assert_allclose(
        jback.transform(frames["jax"]).collect()[col],
        models["port"].transform(frames["port"]).collect()[col], rtol=1e-6,
        atol=1e-6)
    if classify:
        for pkg, m in (("jax", jback), ("port", models["port"])):
            prob = m.transform(frames[pkg]).collect()["probability"]
            assert np.all((prob[0] >= 0) & (prob[0] <= 1))


def _scored(core, seed=6, n=500):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) > 0.4).astype(float)
    p1 = np.clip(y * 0.6 + rng.random(n) * 0.5, 0, 1)
    prob = np.empty(n, dtype=object)
    for i in range(n):
        prob[i] = np.asarray([1 - p1[i], p1[i]])
    return core.DataFrame.from_dict({
        "label": y, "prediction": (p1 > 0.5).astype(float),
        "probability": prob, "reg": y + rng.normal(size=n)}, 2)


def test_compute_model_statistics_equal_jax():
    for kind, kw in (("classification", {"scored_probabilities_col":
                                         "probability"}),
                     ("regression", {"scores_col": "reg"}),
                     ("all", {})):
        outs = []
        for core, tr in ((jcore, jtrain), (tcore, ttrain)):
            outs.append(tr.ComputeModelStatistics().set_params(
                label_col="label", evaluation_metric=kind, **kw)
                .transform(_scored(core)).collect())
        assert sorted(outs[0]) == sorted(outs[1])
        for k in outs[0]:
            np.testing.assert_array_equal(np.asarray(outs[0][k]),
                                          np.asarray(outs[1][k]))
    assert ttrain.MetricConstants.AUC == jtrain.MetricConstants.AUC
    assert ttrain.MetricConstants.CLASSIFICATION_METRICS == \
        jtrain.MetricConstants.CLASSIFICATION_METRICS


def test_compute_per_instance_statistics_equal_jax():
    for kind, kw in (("classification", {"scored_probabilities_col":
                                         "probability"}),
                     ("regression", {"scores_col": "reg"})):
        outs = []
        for core, tr in ((jcore, jtrain), (tcore, ttrain)):
            outs.append(tr.ComputePerInstanceStatistics().set_params(
                label_col="label", evaluation_metric=kind, **kw)
                .transform(_scored(core)).collect())
        new = sorted(set(outs[1]) - {"label", "prediction", "probability",
                                     "reg"})
        assert new == sorted(set(outs[0]) - {"label", "prediction",
                                             "probability", "reg"})
        assert new
        for k in new:
            np.testing.assert_array_equal(outs[0][k], outs[1][k])


def test_allreduce_pass_end_raises_in_a_world_of_two(monkeypatch):
    import torch.distributed as dist
    state = (torch.zeros(4), torch.zeros(4), torch.zeros(4))
    assert tlearners._allreduce_pass_end(state) is state
    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 2)
    with pytest.raises(NotImplementedError, match="item 10"):
        tlearners._allreduce_pass_end(state)
    df = _sparse_frame(tcore, 100, 5)[0]
    with pytest.raises(NotImplementedError, match="item 10"):
        _est("port", "VowpalWabbitClassifier", num_bits=8).fit(df)


def test_ingest_and_scoring_book_their_transfer_bytes():
    from mmlspark_tpu_torch.observability import get_registry

    def booked(site):
        fam = get_registry().family("mmlspark_device_transfer_bytes_total")
        if fam is None:
            return 0.0
        return {k[0]: c.value for k, c in fam._snapshot()}.get(site, 0.0)

    df = _sparse_frame(tcore, 300, 10)[0]
    before = booked("vw.ingest"), booked("vw.score")
    m = _est("port", "VowpalWabbitClassifier", num_bits=8,
             num_passes=3).fit(df)
    ingest = booked("vw.ingest") - before[0]
    # packed once per partition (int64 indices, values, labels, weights),
    # each padded to whole batches of 256: not again on later passes
    assert ingest == 2 * 256 * (10 * 12 + 8)
    m.transform(df)
    assert booked("vw.score") - before[1] >= 1024 + 300 * 10 * 12


def test_entry_points_need_the_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    df = _sparse_frame(tcore, 50, 5)[0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tvw.VowpalWabbitClassifier().set_params(num_bits=6).fit(df)
    m = _est("port", "VowpalWabbitClassifier", num_bits=6).fit(df)
    m2 = m.copy()
    m2._paramMap.pop("device", None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        m2.transform(df).collect()
