"""The port's twins of the JAX package's plain ``jax.jit`` programs (the VW
step and its ``--bfgs`` iteration, the speech encoder's step, the lasso's
ISTA loop, KNN's search, AccessAnomaly's half-sweep, ImageTransformer's
chain) and of its last booked program, ``featurize.word2vec_epoch``, on
the CPU.

- Word2Vec books its epoch as the reference does: the same names in
  ``compile_report()`` and the same ``mmlspark_jit_compile_total`` deltas
  after one fit of two epochs and after two same-shape fits in a row
  (each package builds its epoch wrapper inside the fit, so a second fit
  books again and the wrapper leaves the report with its fit).
- ``observability.compute.captured`` runs eagerly on the CPU and books
  nothing, and a VW fit, a speech stream and a lasso add no name to the
  report (the reference's programs are plain ``jax.jit``); neither does
  a KNN transform, an AccessAnomaly fit, an ImageTransformer transform
  or a ``--bfgs`` fit, on either package.
- KNN's, AccessAnomaly's, the image chain's and --bfgs's programs
  against the JAX functions on the same
  seeded inputs: KNN's chunked search with a padded tail (indices equal,
  scores within 1e-6 relative), the ALS half-sweep over two chunks
  (within 1e-5 x max), the image chain over every stage kind in row
  buckets (within 1e-5), a ``--bfgs`` fit (objective within 1e-4
  relative of optax's), each with the signatures its program keys.
- Every ``jax.jit`` / ``instrumented_jit`` site of the JAX package has a
  named twin program in the port or an exemption naming its ROADMAP.md
  item, read from the sources as text.

The card's side (captures, replays = eager) is in
``tests/test_torch_cuda_graphs.py``.
"""
import ast
import pathlib
import re

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.observability import compute, get_registry

REPO = pathlib.Path(__file__).resolve().parents[1]


def _docs(n=60, vocab=40, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(vocab)]
    docs = np.empty(n, dtype=object)
    for i in range(n):
        docs[i] = " ".join(rng.choice(words, 12))
    return docs


def _state(report_fn, registry, name):
    fam = registry.family("mmlspark_jit_compile_total")
    count = 0.0 if fam is None else fam.labels(fn=name).value
    return set(report_fn()["functions"]), count


# ---------------------------------------------------------------------------
# Word2Vec's booked epoch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fits", [1, 2])
def test_word2vec_epoch_books_as_the_reference(fits):
    """One fit of ``max_iter=2`` books one compile (both epochs share the
    signature); a second same-shape fit books another.  The report lists
    the same names before and after on both packages (the wrappers die
    with their fits)."""
    from mmlspark_tpu.core import DataFrame as JFrame
    from mmlspark_tpu.featurize.word2vec import Word2Vec as JWord2Vec
    from mmlspark_tpu.observability import compute as jcompute
    from mmlspark_tpu.observability import get_registry as jregistry
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.featurize import Word2Vec

    name = "featurize.word2vec_epoch"
    kw = dict(input_col="text", output_col="v", vector_size=8, max_iter=2,
              batch_size=32, min_count=1)
    docs = _docs()
    deltas = {}
    for side, est, frame, report, reg in (
            ("jax", lambda: JWord2Vec(**kw), JFrame, jcompute.compile_report,
             jregistry()),
            ("port", lambda: Word2Vec(device="cpu", **kw), DataFrame,
             compute.compile_report, get_registry())):
        names0, count0 = _state(report, reg, name)
        for _ in range(fits):
            est().fit(frame.from_dict({"text": docs}))
        names1, count1 = _state(report, reg, name)
        deltas[side] = (sorted(names1 - names0), sorted(names0 - names1),
                        count1 - count0)
    assert deltas["port"] == deltas["jax"] == ([], [], float(fits))


def test_word2vec_blocks_run_eagerly_on_the_cpu():
    """On the CPU the epoch's blocks of steps run eagerly: nothing is
    captured or replayed, and the block program books no name."""
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.featurize import Word2Vec, word2vec
    m = Word2Vec(device="cpu", input_col="text", output_col="v",
                 vector_size=8, max_iter=1, batch_size=8, min_count=1) \
        .fit(DataFrame.from_dict({"text": _docs()}))
    st = m.fit_stats
    assert st["steps"] > word2vec.BLOCK_STEPS
    assert (st["captures"], st["recaptures"], st["replays"],
            st["capture_s"]) == (0, 0, 0, [])
    assert "featurize.word2vec_block" not in \
        compute.compile_report()["functions"]


# ---------------------------------------------------------------------------
# the unbooked program
# ---------------------------------------------------------------------------

def test_captured_runs_eagerly_on_the_cpu_and_books_nothing():
    calls = []

    def fn(state, x, k):
        calls.append(k)
        state.add_(x * k)
        return state.sum()

    prog = compute.captured(fn, name="test.captured_cpu",
                            donate_argnums=(0,))
    st = torch.zeros(4)
    assert float(prog(st, torch.ones(4), 2.0)) == 8.0
    assert float(prog(st, torch.ones(4), 3.0)) == 20.0
    assert calls == [2.0, 3.0] and st.tolist() == [5.0] * 4
    assert prog.compiles == 1            # one signature, keyed not booked
    assert (prog.captures, prog.recaptures, prog.replays) == (0, 0, 0)
    assert "test.captured_cpu" not in compute.compile_report()["functions"]
    fam = get_registry().family("mmlspark_jit_compile_total")
    assert fam is None or ("test.captured_cpu",) not in \
        {k for k, _ in fam._snapshot()}
    # the decorator form
    dec = compute.captured(name="test.captured_dec")(lambda x: x + 1)
    assert dec(torch.ones(2)).tolist() == [2.0, 2.0]
    assert dec.booked is False


def test_plain_programs_add_no_name_to_the_report():
    """A VW fit, a speech stream and a lasso run their programs and the
    report gains no name: the reference's are plain ``jax.jit``."""
    from mmlspark_tpu_torch.cognitive import StreamingRecognizer
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.explainers.regression import lasso_regression
    from mmlspark_tpu_torch.vw import VowpalWabbitClassifier

    before = set(compute.compile_report()["functions"])
    rng = np.random.default_rng(3)
    feats = np.empty(64, dtype=object)
    for i in range(64):
        idx = np.sort(rng.choice(1 << 10, 6, replace=False)).astype(np.int32)
        feats[i] = {"indices": idx,
                    "values": rng.normal(size=6).astype(np.float32)}
    y = rng.integers(0, 2, 64).astype(np.float64)
    VowpalWabbitClassifier().set_params(
        device="cpu", num_bits=10, batch_size=16).fit(
            DataFrame.from_dict({"features": feats, "label": y}))
    rec = StreamingRecognizer(chunk_s=0.2, device="cpu")
    state = rec.new_state()
    t = np.arange(8000) / 16000
    for lo in range(0, 8000, rec.chunk_samples):
        rec.process_chunk(state, np.sin(2 * np.pi * 440 * t[lo:lo +
                                        rec.chunk_samples]).astype(
                                            np.float32))
    rec.finish(state)
    X = rng.normal(size=(50, 6))
    lasso_regression(X, X @ rng.normal(size=6), np.ones(50), device="cpu")
    assert set(compute.compile_report()["functions"]) == before


# ---------------------------------------------------------------------------
# KNN's search, the ALS half-sweep, the image chain and --bfgs against JAX
# ---------------------------------------------------------------------------

KNN_SCORE_RTOL = 1e-6
ALS_TOL = 1e-5                    # x max |factor|
IMAGE_ATOL = 1e-5                 # normalized pixels, |values| < 2
BFGS_OBJECTIVE_RTOL = 1e-4


def _rows_of(prog) -> set:
    """The leading dimension of every signature ``prog`` keyed."""
    return {int(e.rendered.split("[", 1)[1].split(",", 1)[0].rstrip("]"))
            for e in prog._entries.values()}


def test_knn_search_pads_the_tail_and_equals_jax():
    """40 queries in chunks of 16: the tail's 8 rows padded to 16 as the
    reference pads them, so the three chunks share one signature; indices
    equal and scores within ``KNN_SCORE_RTOL`` of the JAX package's."""
    from mmlspark_tpu.nn.knn import _device_topk as jax_topk
    from mmlspark_tpu_torch.nn import knn
    rng = np.random.default_rng(7)
    X = rng.normal(size=(200, 16)).astype(np.float32)
    Q = rng.normal(size=(40, 16)).astype(np.float32)
    want_sc, want_ix = jax_topk(X, Q, 5, batch=16)
    prog = knn._search_program()
    got_sc, got_ix = knn._device_topk(torch.from_numpy(X), Q, 5, batch=16,
                                      program=prog)
    np.testing.assert_array_equal(got_ix, want_ix)
    np.testing.assert_allclose(got_sc, want_sc, rtol=KNN_SCORE_RTOL, atol=0)
    assert _rows_of(prog) == {16} and got_ix.shape == (40, 5)
    # one chunk alone is the queries' own size, as in the reference
    knn._device_topk(torch.from_numpy(X), Q[:10], 5, batch=16, program=prog)
    assert _rows_of(prog) == {16, 10}


def test_knn_model_keeps_its_program_and_items_until_pickled():
    """A second transform reuses the model's program and item table; a
    pickled model carries neither."""
    import pickle
    from mmlspark_tpu_torch.core import DataFrame, vector_column
    from mmlspark_tpu_torch.nn import KNN
    X = np.random.default_rng(2).normal(size=(64, 8))
    df = DataFrame.from_dict({"features": vector_column(list(X))})
    model = KNN().set_params(output_col="m", k=3, device="cpu").fit(df)
    first = model.transform(df).collect()["m"]
    prog, items = model._program(), model._item_cache[1]
    second = model.transform(df).collect()["m"]
    assert model._program() is prog and model._item_cache[1] is items
    assert [[r["value"] for r in row] for row in first] == \
        [[r["value"] for r in row] for row in second]
    back = pickle.loads(pickle.dumps(model))
    assert "_search_prog" not in back.__dict__
    assert "_item_cache" not in back.__dict__
    assert back.transform(df).collect()["m"][0] == first[0]


@pytest.mark.parametrize("implicit", [True, False])
def test_als_half_sweep_over_two_chunks_equals_jax(monkeypatch, implicit):
    """4,000 nonzeros in chunks of 2,500 (a full chunk and a tail, each
    its own accumulate signature, as in the reference): the factors
    within ``ALS_TOL`` x max of the JAX package's."""
    from mmlspark_tpu.cyber import anomaly as janom
    from mmlspark_tpu_torch.cyber import anomaly as tanom
    monkeypatch.setattr(janom, "_CHUNK_NNZ", 2_500)
    monkeypatch.setattr(tanom, "_CHUNK_NNZ", 2_500)
    rng = np.random.default_rng(11)
    n_rows, n_other, k, nnz = 300, 200, 5, 4_000
    other = rng.normal(size=(n_other, k)).astype(np.float32)
    rows = rng.integers(0, n_rows, nnz).astype(np.int32)
    cols = rng.integers(0, n_other, nnz).astype(np.int32)
    if implicit:
        tgt = np.ones(nnz, np.float32)
        conf = (1 + 10 * rng.integers(1, 4, nnz)).astype(np.float32)
        gram = other.T @ other
    else:
        tgt = rng.integers(0, 2, nnz).astype(np.float32)
        conf = np.where(tgt > 0, 1.0, 0.5).astype(np.float32)
        gram = None
    want = janom._solve_side(other, rows, cols, tgt, conf, n_rows, 0.1, gram)
    progs = tanom._ALSPrograms()
    t = torch.from_numpy
    got = tanom._solve_side(
        t(other), t(rows.astype(np.int64)), t(cols.astype(np.int64)), t(tgt),
        t(conf), n_rows, 0.1, None if gram is None else t(gram),
        progs).numpy()
    assert np.abs(got - want).max() <= ALS_TOL * np.abs(want).max()
    assert (progs.accumulate.compiles, progs.solve.compiles) == (2, 1)


def test_als_singular_system_raises_as_linalg_solve():
    """The solve's ``info`` is checked after the program: a row with no
    nonzeros and no ridge raises ``torch.linalg.solve``'s error."""
    from mmlspark_tpu_torch.cyber import anomaly as tanom
    other = torch.ones((2, 2))
    idx = torch.zeros(3, dtype=torch.int64)
    ones = torch.ones(3)
    with pytest.raises(torch.linalg.LinAlgError) as got:
        tanom._solve_side(other, idx, idx, ones, ones, 2, 0.0, None)
    with pytest.raises(torch.linalg.LinAlgError) as want:
        torch.linalg.solve(torch.zeros((2, 2, 2)), torch.zeros((2, 2)))
    assert str(got.value) == str(want.value)


def test_access_anomaly_reuses_its_buffers_and_drops_them_when_pickled():
    """Two tenants of one shape share the estimator's buffers, and each
    keeps its own factors (copies, not the buffers); a second fit reuses
    the buffers; a pickled estimator carries none."""
    import pickle
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.cyber import AccessAnomaly
    rng = np.random.default_rng(1)
    n = 200
    cols = {"tenant": np.asarray(["a"] * n + ["b"] * n, dtype=object),
            "user": np.asarray([f"u{i % 20}" for i in range(2 * n)],
                               dtype=object),
            "res": np.asarray([f"r{i}" for i in rng.integers(0, 9, 2 * n)],
                              dtype=object)}
    alone = AccessAnomaly().set_params(device="cpu", rank=3, max_iter=2) \
        .fit(DataFrame.from_dict({k: v[:n] for k, v in cols.items()})) \
        .get("factors")["a"]
    est = AccessAnomaly().set_params(device="cpu", rank=3, max_iter=2)
    a = est.fit(DataFrame.from_dict(cols)).get("factors")
    bufs = [id(t) for ts in est._programs()._buffers.values() for t in ts]
    assert len(bufs) == 6          # users' and resources' (A, B, X) once
    np.testing.assert_array_equal(a["a"]["U"], alone["U"])
    assert not np.array_equal(a["a"]["U"], a["b"]["U"])
    b = est.fit(DataFrame.from_dict(cols)).get("factors")
    assert [id(t) for ts in est._programs()._buffers.values()
            for t in ts] == bufs
    np.testing.assert_array_equal(a["b"]["V"], b["b"]["V"])
    assert "_als" not in pickle.loads(pickle.dumps(est)).__dict__


def _every_stage(t):
    return (t.resize(20, 18).crop(1, 2, 16, 15).center_crop(12, 12)
            .flip(1).flip(0).blur(5, 5, 1.2).threshold(60.0, 250.0, "trunc")
            .gaussian_kernel(3, 0.8).normalize().color_format("gray")
            .unroll())


def _image_column(groups, seed=3):
    """Images of each ``(shape, rows)`` group, interleaved by a seeded
    permutation."""
    rng = np.random.default_rng(seed)
    shapes = [shape for shape, n in groups for _ in range(n)]
    col = np.empty(len(shapes), dtype=object)
    for j, i in enumerate(rng.permutation(len(shapes))):
        col[j] = (rng.random(shapes[i]) * 255).astype(np.float32)
    return col


@pytest.mark.parametrize("groups, buckets", [
    ([((24, 22, 3), 1), ((17, 31, 3), 3), ((40, 40, 3), 5)], {1, 4, 8}),
    ([((6, 5, 3), 70)], {64, 8}),
])
def test_image_chain_row_buckets_equal_jax(groups, buckets):
    """Shape groups padded to a power of two (at most 64 rows a call,
    larger groups sliced) through every stage kind: each row within
    ``IMAGE_ATOL`` of the JAX package's unpadded batch."""
    from mmlspark_tpu.core import DataFrame as JFrame
    from mmlspark_tpu.opencv import ImageTransformer as JTransformer
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.opencv import ImageTransformer
    col = _image_column(groups)
    port = _every_stage(ImageTransformer(input_col="image",
                                         output_col="out", device="cpu"))
    ref = _every_stage(JTransformer(input_col="image", output_col="out"))
    got = port.transform(DataFrame.from_dict({"image": col})) \
        .collect()["out"]
    want = ref.transform(JFrame.from_dict({"image": col})).collect()["out"]
    assert len(got) == len(want) == len(col)
    for a, b in zip(got, want):
        assert a.shape == b.shape == (144,)
        np.testing.assert_allclose(a, b, rtol=0, atol=IMAGE_ATOL)
    (prog,) = port._programs.values()
    assert _rows_of(prog) == buckets


def test_image_chain_program_follows_the_stage_list():
    """A stage added after a transform is a new program; the old stage
    list keeps its own; a pickled transformer carries none."""
    import pickle
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.opencv import ImageSetAugmenter, ImageTransformer
    df = DataFrame.from_dict({"image": _image_column([((6, 5, 3), 3)])})
    t = ImageTransformer(input_col="image", output_col="o", device="cpu") \
        .resize(4, 4)
    t.transform(df)
    t.flip(1).transform(df)
    assert len(t._programs) == 2
    assert "_programs" not in pickle.loads(pickle.dumps(t)).__dict__
    aug = ImageSetAugmenter().set_params(input_col="image", output_col="o",
                                         device="cpu")
    aug.transform(df)
    (flip,) = aug._flippers.values()
    aug.transform(df)
    assert list(aug._flippers.values()) == [flip]
    assert "_flippers" not in pickle.loads(pickle.dumps(aug)).__dict__


def _knn_path(pkg):
    core, nn = _pkg(pkg, "nn")
    X = np.random.default_rng(2).normal(size=(64, 8))
    df = core.DataFrame.from_dict({"features": core.vector_column(list(X))})
    _port_cpu(pkg, nn.KNN().set_params(output_col="m", k=3)).fit(df) \
        .transform(df).collect()


def _als_path(pkg):
    core, cyber = _pkg(pkg, "cyber")
    rng = np.random.default_rng(1)
    cols = {"user": np.asarray([f"u{i}" for i in rng.integers(0, 20, 200)],
                               dtype=object),
            "res": np.asarray([f"r{i}" for i in rng.integers(0, 9, 200)],
                              dtype=object)}
    _port_cpu(pkg, cyber.AccessAnomaly().set_params(rank=3, max_iter=2)) \
        .fit(core.DataFrame.from_dict(cols))


def _image_path(pkg):
    core, opencv = _pkg(pkg, "opencv")
    t = _every_stage(opencv.ImageTransformer(input_col="image",
                                             output_col="out"))
    _port_cpu(pkg, t).transform(core.DataFrame.from_dict({
        "image": _image_column([((24, 22, 3), 1), ((17, 31, 3), 3)])})) \
        .collect()


def _bfgs_path(pkg):
    core, vw = _pkg(pkg, "vw")
    _port_cpu(pkg, vw.VowpalWabbitClassifier().set_params(
        num_bits=9, optimizer="bfgs", num_passes=3)).fit(_bfgs_frame(core))


def _pkg(pkg, sub):
    import importlib
    root = "mmlspark_tpu" if pkg == "jax" else "mmlspark_tpu_torch"
    return (importlib.import_module(f"{root}.core"),
            importlib.import_module(f"{root}.{sub}"))


def _port_cpu(pkg, stage):
    return stage.set_params(device="cpu") if pkg == "port" else stage


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("path", [_knn_path, _als_path, _image_path,
                                  _bfgs_path])
def test_the_paths_leave_the_compile_report_as_it_was(pkg, path):
    """A KNN transform, an AccessAnomaly fit, an ImageTransformer
    transform and a ``--bfgs`` fit book nothing on either package: their
    programs are plain ``jax.jit`` in the reference."""
    import gc
    if pkg == "jax":
        from mmlspark_tpu.observability import compute as report_of
    else:
        report_of = compute
    gc.collect()             # wrappers of earlier tests leave the report now
    before = report_of.compile_report()["functions"]
    path(pkg)
    assert report_of.compile_report()["functions"] == before


def _bfgs_frame(core, n=600, d=24, seed=4):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    X[rng.random((n, d)) > 0.5] = 0.0
    y = (X @ rng.normal(size=d) > 0).astype(float)
    col = np.empty(n, dtype=object)
    for i in range(n):
        nz = np.nonzero(X[i])[0]
        col[i] = {"indices": (nz * 7919 % 509).astype(np.int32),
                  "values": X[i, nz].astype(np.float32)}
    return core.DataFrame.from_dict({"features": col, "label": y}, 2)


def test_bfgs_fit_equals_optax_with_one_signature_per_program():
    """``optimizer="bfgs"``: the objective within ``BFGS_OBJECTIVE_RTOL``
    of the JAX package's ``optax.lbfgs`` fit; every iteration runs the
    same direction signature and every trial point the same trial
    signature (the slot and the first step are inputs, not shapes); one
    host read a trial point and one a direction; a second fit reuses the
    examples' and the memory's storage."""
    import mmlspark_tpu.core as jcore
    import mmlspark_tpu.vw as jvw
    import mmlspark_tpu_torch.core as tcore
    from mmlspark_tpu_torch.vw import VowpalWabbitClassifier
    kw = dict(num_bits=9, l2=1e-3, optimizer="bfgs")
    ref = jvw.VowpalWabbitClassifier().set_params(**kw).fit(
        _bfgs_frame(jcore))
    est = VowpalWabbitClassifier().set_params(device="cpu", **kw)
    port = est.fit(_bfgs_frame(tcore))

    def objective(w):
        data = _bfgs_frame(tcore).collect()
        from mmlspark_tpu_torch.vw.learners import pack_sparse_column
        idx, val = pack_sparse_column(data["features"], mask=len(w) - 1)
        pred = (w[idx].astype(np.float64) * val).sum(1)
        ysgn = np.where(data["label"] > 0, 1.0, -1.0)
        return float(np.mean(np.logaddexp(0.0, -ysgn * pred))
                     + 0.5e-3 * (w.astype(np.float64) ** 2).sum())

    oj, ot = objective(ref.weights), objective(port.weights)
    assert abs(ot - oj) <= BFGS_OBJECTIVE_RTOL * abs(oj), (oj, ot)
    progs = est._bfgs_programs()
    assert (progs.direction.compiles, progs.trial.compiles) == (1, 1)
    run = progs.last_run
    assert run["iterations"] == 20 and run["trials"] > 20
    assert run["host_reads"] == run["trials"] + run["iterations"]

    def storage():
        return [id(t) for ts in (*progs._examples.values(),
                                 *progs._memories.values()) for t in ts]

    kept = storage()
    again = est.fit(_bfgs_frame(tcore))
    np.testing.assert_array_equal(again.weights, port.weights)
    assert storage() == kept


# ---------------------------------------------------------------------------
# every jit site of the JAX package: a named twin, or its ROADMAP item
# ---------------------------------------------------------------------------

#: (JAX package file, enclosing function, program name or None) -> the
#: port's twin: (file, the wrapper that builds it, program name)
TWINS = {
    ("cognitive/speech.py", "StreamingRecognizer.__init__", None):
        ("cognitive/speech.py", "captured", "cognitive.speech_step"),
    ("explainers/regression.py", "lasso_regression.solve", None):
        ("explainers/regression.py", "captured", "explainers.lasso_ista"),
    ("featurize/word2vec.py", "Word2Vec._fit", "featurize.word2vec_epoch"):
        ("featurize/word2vec.py", "instrumented_call",
         "featurize.word2vec_epoch"),
    ("vw/learners.py", "_VWBase._make_trainer.step", None):
        ("vw/learners.py", "captured", "vw.step"),
    # one reference iteration: the port's direction and trial point
    ("vw/learners.py", "_VWBase._fit_bfgs.lbfgs_step", None):
        ("vw/learners.py", "captured", ("vw.bfgs_direction",
                                        "vw.bfgs_trial")),
    ("nn/knn.py", "_device_topk.search", None):
        ("nn/knn.py", "captured", "nn.knn_search"),
    ("cyber/anomaly.py", "_get_accumulate.accumulate", None):
        ("cyber/anomaly.py", "captured", "cyber.als_accumulate"),
    ("cyber/anomaly.py", "_get_accumulate.solve_all", None):
        ("cyber/anomaly.py", "captured", "cyber.als_solve"),
    ("opencv/image_transformer.py", "ImageTransformer._transform", None):
        ("opencv/image_transformer.py", "captured", "opencv.image_chain"),
    ("models/gbdt.py", "GBDTBooster._walk_leaves.walk", "models.gbdt_walk"):
        ("models/gbdt.py", "instrumented_jit", "models.gbdt_walk"),
    ("models/runner.py", "ModelRunner._instrumented",
     "f'runner.{self.name}{suffix}'"):
        ("models/runner.py", "instrumented_jit",
         "f'runner.{self.name}{suffix}'"),
    ("ops/histogram.py", "bin_matrix", "ops.bin_matrix"):
        ("ops/histogram.py", "instrumented_jit", "ops.bin_matrix"),
    **{("lightgbm/core.py", fn, name):
       ("lightgbm/core.py", "instrumented_jit", name) for fn, name in (
           ("make_lambdarank_grad_fn", "lightgbm.lambdarank_grads"),
           ("make_binned_walker", "lightgbm.tree_walk"),
           ("train", "lightgbm.grower"), ("train", "lightgbm.iter"),
           ("train", "lightgbm.iter_pre"), ("train", "lightgbm.objective"),
           ("train._build_multi", "lightgbm.multi_iter"),
           ("train._build_valid_update", "lightgbm.valid_update"),
           ("train_streamed._build_grad", "lightgbm.ooc_grad"),
           ("train_streamed._build_accum", "lightgbm.ooc_tile_hist"),
           ("train_streamed._build_decide", "lightgbm.ooc_level_decide"),
           ("train_streamed._build_leaf_best", "lightgbm.ooc_leaf_best"))},
    # the sharded grower and the parallel/ steps hold gloo collectives:
    # booked, never captured (their local compute is ROADMAP item 20)
    ("lightgbm/core.py", "train._build_sharded", "lightgbm.sharded_grower"):
        ("lightgbm/core.py", "instrumented_call", "lightgbm.sharded_grower"),
    **{(f"parallel/{f}.py", fn, name):
       (f"parallel/{f}.py", "instrumented_call", name) for f, fn, name in (
           ("pipeline_parallel", "make_pipeline_train_step",
            "parallel.pipeline_step"),
           ("pipeline_parallel", "make_pipeline_train_step",
            "parallel.pipeline_forward"),
           ("ring_attention", "make_ring_attention_fn",
            "parallel.ring_attention"),
           ("seq_parallel", "make_seq_parallel_train_step",
            "parallel.seq_step"),
           ("trainer", "Trainer._build_train_step", "parallel.train_step"))},
}

#: sites the port runs eagerly, each with its open ROADMAP.md §1 item
#: (none left: item 20's ``parallel/`` steps book through
#: ``instrumented_call`` above)
EXEMPT = {}

_WRAPPERS = ("captured", "instrumented_jit", "instrumented_call")


def _dotted(node) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _name_of(call: ast.Call):
    kw = next((k.value for k in call.keywords if k.arg == "name"), None)
    if kw is None:
        return None
    return kw.value if isinstance(kw, ast.Constant) else ast.unparse(kw)


def _jit_sites(root: pathlib.Path):
    """``(file, enclosing function, program name)`` of every ``jax.jit``
    call, ``@jax.jit`` decorator, ``partial(jax.jit, ...)`` and
    ``instrumented_jit`` call or decorator."""
    sites = set()
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        if rel.startswith("analysis/") or rel == "observability/compute.py":
            continue
        tree = ast.parse(path.read_text())

        def walk(node, stack):
            for ch in ast.iter_child_nodes(node):
                scope = stack
                if isinstance(ch, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
                    scope = stack + [ch.name]
                    for d in getattr(ch, "decorator_list", []):
                        if not isinstance(d, ast.Call) and \
                                _dotted(d) == "jax.jit":
                            sites.add((rel, ".".join(scope), None))
                elif isinstance(ch, ast.Call):
                    fn = _dotted(ch.func)
                    partial_jit = fn.endswith("partial") and ch.args and \
                        _dotted(ch.args[0]) == "jax.jit"
                    if fn in ("jax.jit", "instrumented_jit") or partial_jit:
                        # a decorator's call is a child of its function,
                        # so it is keyed by that function, as ``@jax.jit``
                        sites.add((rel, ".".join(stack), _name_of(ch)))
                walk(ch, scope)
        walk(tree, [])
    return sites


def _port_programs(rel: str):
    """``(wrapper, names)`` of every program-building call in a port file:
    the names are the string constants of its ``name=`` (a conditional
    gives both) or the f-string's source."""
    tree = ast.parse((REPO / "mmlspark_tpu_torch" / rel).read_text())
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = _dotted(node.func).rsplit(".", 1)[-1]
        if fn not in _WRAPPERS:
            continue
        kw = next((k.value for k in node.keywords if k.arg == "name"), None)
        if kw is None:
            continue
        names = {ast.unparse(kw)} if isinstance(kw, ast.JoinedStr) else {
            c.value for c in ast.walk(kw)
            if isinstance(c, ast.Constant) and isinstance(c.value, str)}
        out.append((fn, names))
    return out


def test_every_jit_site_has_a_twin_or_a_roadmap_item():
    """Each ``jax.jit`` and ``instrumented_jit`` site of the JAX package
    has a named twin program in the port, built by the wrapper the table
    gives, or an exemption naming its open ROADMAP.md §1 item; a site in
    neither table, or a table entry whose site is gone, fails."""
    sites = _jit_sites(REPO / "mmlspark_tpu")
    known = set(TWINS) | set(EXEMPT)
    assert not TWINS.keys() & EXEMPT.keys()
    assert sites - known == set(), "sites with neither a twin nor an item"
    assert known - sites == set(), "table entries whose site is gone"
    missing = []
    for site, (rel, wrapper, want) in sorted(TWINS.items(),
                                            key=lambda kv: str(kv[0])):
        for name in (want if isinstance(want, tuple) else (want,)):
            if not any(fn == wrapper and name in names
                       for fn, names in _port_programs(rel)):
                missing.append((site, rel, wrapper, name))
    assert missing == []
    roadmap = (REPO / "ROADMAP.md").read_text()
    queue = roadmap.split("### 1.", 1)[1].split("### 2.", 1)[0]
    for item in sorted(set(EXEMPT.values()) | {20}):
        assert re.search(rf"^- \*\*{item}\. ", queue, re.M), \
            f"ROADMAP.md §1 has no open item {item}"


CAPTURED_SYNC = '''
from mmlspark_tpu_torch.observability.compute import captured


def _sync(x):
    return x.sum().item()


step = captured(_sync, name="fixture.step")
'''


@pytest.mark.parametrize("rel, rules", [
    ("mmlspark_tpu_torch/vw/fixture.py", ["TRC004"]),
    ("mmlspark_tpu_torch/explainers/fixture.py", ["TRC004"]),
    ("mmlspark_tpu_torch/nn/fixture.py", ["TRC004"]),
    ("mmlspark_tpu_torch/cyber/fixture.py", ["TRC004"]),
    ("mmlspark_tpu_torch/opencv/fixture.py", ["TRC004"]),
    ("mmlspark_tpu/vw/fixture.py", []),
    ("mmlspark_tpu/opencv/fixture.py", []),
])
def test_captured_is_a_trc_root_in_the_ports_own_scope(tmp_path, rel, rules):
    """``captured``'s function is a TRC root, and graft-lint scans the
    port's ``featurize/``, ``vw/``, ``cognitive/``, ``explainers/``,
    ``nn/``, ``cyber/`` and ``opencv/`` beyond the reference's scope; the
    same directories of the JAX package stay out of it."""
    from mmlspark_tpu_torch.analysis import (AnalysisEngine,
                                             TracerSafetyChecker)
    path = tmp_path / rel
    path.parent.mkdir(parents=True)
    path.write_text(CAPTURED_SYNC)
    found = AnalysisEngine([TracerSafetyChecker()],
                           root=str(tmp_path)).run([str(path)])
    assert [f.rule for f in found] == rules
