"""The port's twins of the JAX package's plain ``jax.jit`` programs (the VW
step, the speech encoder's step, the lasso's ISTA loop) and of its last
booked program, ``featurize.word2vec_epoch``, on the CPU.

- Word2Vec books its epoch as the reference does: the same names in
  ``compile_report()`` and the same ``mmlspark_jit_compile_total`` deltas
  after one fit of two epochs and after two same-shape fits in a row
  (each package builds its epoch wrapper inside the fit, so a second fit
  books again and the wrapper leaves the report with its fit).
- ``observability.compute.captured`` runs eagerly on the CPU and books
  nothing, and a VW fit, a speech stream and a lasso add no name to the
  report (the reference's programs are plain ``jax.jit``).
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
EXEMPT = {
    ("nn/knn.py", "_device_topk.search", None): 23,
    ("cyber/anomaly.py", "_get_accumulate.accumulate", None): 24,
    ("cyber/anomaly.py", "_get_accumulate.solve_all", None): 24,
    ("opencv/image_transformer.py", "ImageTransformer._transform", None): 25,
    ("vw/learners.py", "_VWBase._fit_bfgs.lbfgs_step", None): 26,
}

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
    for site, (rel, wrapper, name) in sorted(TWINS.items(),
                                            key=lambda kv: str(kv[0])):
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
    ("mmlspark_tpu/vw/fixture.py", []),
])
def test_captured_is_a_trc_root_in_the_ports_own_scope(tmp_path, rel, rules):
    """``captured``'s function is a TRC root, and graft-lint scans the
    port's ``featurize/``, ``vw/``, ``cognitive/`` and ``explainers/``
    beyond the reference's scope; the same directories of the JAX
    package stay out of it."""
    from mmlspark_tpu_torch.analysis import (AnalysisEngine,
                                             TracerSafetyChecker)
    path = tmp_path / rel
    path.parent.mkdir(parents=True)
    path.write_text(CAPTURED_SYNC)
    found = AnalysisEngine([TracerSafetyChecker()],
                           root=str(tmp_path)).run([str(path)])
    assert [f.rule for f in found] == rules
