"""The runner's compiled programs on the card: CUDA graphs captured per
signature by ``observability.compute.InstrumentedJit`` (and the plain-jit
twins through ``captured``: the VW step and ``--bfgs``, Word2Vec's
blocks, the speech step, the lasso, KNN's search, the ALS half-sweep,
the image chain).  Marked ``cuda``:
without a CUDA device every test skips (the CPU tier-1 run holds the keys
and compile counts to the JAX package's in ``test_torch_compile_stats.py``).
On the card:

    python -m pytest tests/test_torch_cuda_graphs.py -q -m cuda --noconftest

The eager baseline is the same runner code with its programs built by
``instrumented_call`` (booking only, never captured): replay must equal
it bit for bit, tokens and logits and outputs alike, since the graph
replays the kernels the eager call launches.
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.models import ModelRunner, PagePool, TransformerEncoder
from mmlspark_tpu_torch.models.runner import _pad_rows
from mmlspark_tpu_torch.observability import compute
from mmlspark_tpu_torch.observability.metrics import MetricsRegistry

pytestmark = pytest.mark.cuda

V = 64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


class EagerRunner(ModelRunner):
    """The runner with every program eager (booked, never captured)."""

    def _instrumented(self, fn, suffix="", **jit_kwargs):
        wrapper = compute.instrumented_call(
            fn, name=f"runner.{self.name}{suffix}", registry=self.registry,
            **jit_kwargs)
        self._wrappers.append(wrapper)
        return wrapper


def _lm(dev):
    lm = TransformerEncoder(V, num_classes=V, embed_dim=64, num_heads=4,
                            num_layers=2, mlp_dim=128, max_len=256,
                            causal=True, pool="none",
                            generator=torch.Generator().manual_seed(5))
    return lm.to(dev)


def _runners(dev, name):
    lm = _lm(dev)
    return (ModelRunner(module=lm, name=name, registry=MetricsRegistry()),
            EagerRunner(module=lm, name=name + ".eager",
                        registry=MetricsRegistry()))


@pytest.mark.parametrize("layout", [{}, {"kv_layout": "paged",
                                         "page_size": 8}])
def test_decode_replay_equals_eager_bit_for_bit(dev, layout):
    graphed, eager = _runners(dev, "g.decode")
    rng = np.random.default_rng(0)
    lengths = rng.integers(3, 13, 6).astype(np.int32)
    prompts = rng.integers(0, V, (6, 12)).astype(np.int32)
    for kw in ({"max_new_tokens": 12}, {"max_new_tokens": 12, "eos_id": 3},
               {"max_new_tokens": 12, "collect_logits": True}):
        for _ in range(2):                     # capture, then replay
            g = graphed.decode(prompts, lengths=lengths, **kw, **layout)
        e = eager.decode(prompts, lengths=lengths, **kw, **layout)
        np.testing.assert_array_equal(g.tokens, e.tokens)
        if kw.get("collect_logits"):
            np.testing.assert_array_equal(g.logits, e.logits)
    assert graphed.compile_stats() == eager.compile_stats()
    assert graphed.graph_stats()["captures"] >= \
        graphed.compile_stats()["compiles"] > 0


def test_apply_buckets_replay_equals_eager_and_outputs_are_not_aliased(dev):
    net = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.GELU(),
                              torch.nn.Linear(32, 8)).to(dev).eval()
    graphed = ModelRunner(module=net, name="g.apply", batch_size=8,
                          registry=MetricsRegistry())
    x = np.random.default_rng(1).normal(size=(21, 16)).astype(np.float32)
    graphed.apply_batch(x)                                 # capture
    got = graphed.apply_batch(x)                           # replay
    with torch.inference_mode():        # the module on the same buckets
        want = torch.cat([net(torch.from_numpy(_pad_rows(
            x[i:i + 8], 8)).to(dev))[:len(x[i:i + 8])]
            for i in range(0, len(x), 8)])
    np.testing.assert_array_equal(got, want.cpu().numpy())
    fn = graphed.executable(8, (16,))
    a, b = (torch.from_numpy(x[:8]).to(dev),
            torch.from_numpy(x[8:16]).to(dev))
    y1 = fn(a)
    kept = y1.clone()
    y2 = fn(b)
    assert torch.equal(y1, kept) and not torch.equal(y1, y2)
    assert y1.data_ptr() != y2.data_ptr()


def test_a_resized_pool_recaptures_without_compiling(dev):
    graphed, _ = _runners(dev, "g.resize")
    prompts = np.random.default_rng(2).integers(0, V, (4, 8)).astype(
        np.int32)
    kw = dict(max_new_tokens=8, kv_layout="paged", page_size=8)
    pool = graphed.page_pool(8, num_pages=16)
    first = graphed.decode(prompts, pool=pool, **kw)
    graphed.page_pool(8, num_pages=24)              # new shapes: compiles
    graphed.decode(prompts, pool=graphed.page_pool(8), **kw)
    compiles = graphed.compile_stats()["compiles"]
    recaptures = graphed.graph_stats()["recaptures"]
    back = graphed.page_pool(8, num_pages=16)       # old shapes, new slabs
    again = graphed.decode(prompts, pool=back, **kw)
    np.testing.assert_array_equal(again.tokens, first.tokens)
    assert graphed.compile_stats()["compiles"] == compiles
    assert graphed.graph_stats()["recaptures"] > recaptures


def test_a_failing_capture_raises_and_never_runs_eagerly(dev):
    calls = []

    def synced(x):
        calls.append(1)
        return x * float(x.sum().item())

    fn = compute.instrumented_jit(synced, name="g.synced",
                                  registry=MetricsRegistry())
    with torch.inference_mode():
        with pytest.raises(RuntimeError, match="CUDA-graph capture of "
                                               "g.synced"):
            fn(torch.ones(4, device=dev))
        assert fn.compiles == 0 and fn.captures == 0
        n = len(calls)
        with pytest.raises(RuntimeError, match="CUDA-graph capture"):
            fn(torch.ones(4, device=dev))
        assert len(calls) == n + 2          # warm-up + the refused capture
    torch.cuda.synchronize()
    # the card is still usable
    assert float(torch.ones(2, device=dev).sum()) == 2.0


def test_continuous_joins_replay_and_equal_the_eager_engine(dev):
    graphed, eager = _runners(dev, "g.cont")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, V, int(rng.integers(2, 9))).astype(np.int32)
               for _ in range(8)]
    out = []
    for r in (graphed, eager):
        dec = r.decode_stream(slots=4, prompt_bucket=8, max_new_tokens=9,
                              page_size=4)
        dec.warmup()
        n0 = r.compile_stats()["compiles"]
        handles, pending = [], list(prompts)
        while pending or dec._arrivals or dec._live:
            while pending and dec.occupancy() < dec.slots:
                handles.append(dec.submit(pending.pop(0)))
            dec.step()
        assert r.compile_stats()["compiles"] == n0
        out.append([h.tokens for h in handles])
        dec.close()
    assert out[0] == out[1]
    pool = PagePool(graphed.module, num_pages=8, page_size=4)
    assert pool.pages_in_use() == 0


# ---------------------------------------------------------------------------
# the GBDT family's programs (lightgbm.iter / iter_pre / multi_iter /
# objective / valid_update / tree_walk / lambdarank_grads, the ooc_*
# programs, models.gbdt_walk): graphed fits = the same code with its
# programs eager (``lightgbm.core.eager_programs``), bit for bit
# ---------------------------------------------------------------------------

_TREE_ARRAYS = ("split_feature", "threshold", "threshold_bin", "split_gain",
                "internal_value", "internal_count", "leaf_value",
                "leaf_count", "left_child", "right_child", "tree_weight")


def _gbdt_data(n=20_000, F=12, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] + rng.normal(scale=0.3, size=n)
         > 0).astype(np.float32)
    return rng, X, y


def _same_booster(a, b):
    for k in _TREE_ARRAYS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                      err_msg=k)


def _graphed_and_eager(fit):
    from mmlspark_tpu_torch.lightgbm import core
    graphed = fit()
    with core.eager_programs():
        eager = fit()
    _same_booster(graphed.booster, eager.booster)
    return graphed, eager


_RANK = {"objective": "lambdarank"}


@pytest.mark.parametrize("pkw", [
    dict(max_depth=5), dict(num_leaves=31),
    dict(num_leaves=15, objective="multiclass", num_class=3),
    dict(num_leaves=15, boosting_type="dart", drop_rate=0.5, skip_drop=0.0),
    dict(num_leaves=15, boosting_type="goss"),
    dict(max_depth=4, boosting_type="rf", bagging_fraction=0.7,
         bagging_freq=1, feature_fraction=0.8),
    dict(num_leaves=15, **_RANK)],
    ids=["level", "leaf", "multiclass", "dart", "goss", "rf", "lambdarank"])
def test_graphed_train_equals_eager_bit_for_bit(dev, pkw):
    from mmlspark_tpu_torch.lightgbm import GBDTParams, train
    rng, X, y = _gbdt_data()
    kw = {}
    if pkw.get("objective") == "multiclass":
        y = np.digitize(X[:, 0], [-0.5, 0.5]).astype(np.float32)
    if pkw.get("objective") == "lambdarank":
        y = rng.integers(0, 4, len(X)).astype(np.float32)
        kw["group_ptr"] = np.arange(0, len(X) + 1, 40)
    Xv = rng.normal(size=(2_000, X.shape[1])).astype(np.float32)
    yv = (Xv[:, 0] > 0).astype(np.float32)
    if "objective" not in pkw:
        kw["valid"] = (Xv, yv)
    params = GBDTParams(num_iterations=6, **pkw)
    graphed, eager = _graphed_and_eager(lambda: train(X, y, params, **kw))
    assert graphed.evals == eager.evals
    np.testing.assert_array_equal(graphed.booster.predict(X),
                                  eager.booster.predict(X))


def test_chunked_fit_equals_the_unchunked_fit_on_the_card(dev, monkeypatch):
    from mmlspark_tpu_torch.lightgbm import GBDTParams, core, train
    from mmlspark_tpu_torch.observability.compute import compile_report
    _, X, y = _gbdt_data(n=60_000)
    params = GBDTParams(num_iterations=9, num_leaves=15,
                        boosting_type="goss")
    monkeypatch.setenv("MMLSPARK_TPU_GBDT_CHUNK", "1")
    plain = train(X, y, params).booster
    monkeypatch.delenv("MMLSPARK_TPU_GBDT_CHUNK")       # four on the card
    chunked = train(X, y, params).booster
    _same_booster(chunked, plain)
    assert compile_report()["functions"]["lightgbm.multi_iter"][
        "compiles"] >= 1
    assert any(k[0] == "multi" for k in core._JIT_CACHE)


def test_streamed_graphed_equals_eager_and_replays_count_launches(dev):
    from mmlspark_tpu_torch.lightgbm import GBDTParams, train_streamed
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    _, X, y = _gbdt_data(n=40_000)
    for pkw in (dict(max_depth=4), dict(num_leaves=15)):
        params = GBDTParams(num_iterations=3, **pkw)
        CH.reset_launch_counts()
        graphed, _ = _graphed_and_eager(
            lambda: train_streamed(X, y, params, tile_rows=16_384))
        ex = graphed.extras
        # graphed and eager fits both launch once per tile per pass
        want = 2 * ex["hist_passes"] * ex["num_tiles"]
        assert CH.launch_counts() == {"hist_accumulate": want,
                                      "frontier_finish": want}


def test_replays_count_their_launches_and_a_second_fit_compiles_nothing(
        dev):
    from mmlspark_tpu_torch.lightgbm import GBDTParams, train
    from mmlspark_tpu_torch.observability import get_registry
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    _, X, y = _gbdt_data()
    params = GBDTParams(num_iterations=4, num_leaves=15)
    train(X, y, params)
    fam = get_registry().counter("mmlspark_jit_compile_total",
                                 labels=("fn",))
    before = {k: c.value for k, c in fam._snapshot()}
    CH.reset_launch_counts()
    train(X, y, params)                  # replays only: no compile
    assert {k: c.value for k, c in fam._snapshot()} == before
    # one fused step at the root and one per split, every tree
    assert CH.launch_counts() == {"hist_accumulate": 4 * 15,
                                  "frontier_finish": 4 * 15}


def test_python_scalars_are_staged_per_replay(dev):
    """Fault 3.16 on the card: a Python float is a 0-d input filled per
    replay, so one capture answers every value."""
    reg = MetricsRegistry()
    fn = compute.instrumented_jit(lambda x, s: x * s, name="g.scalar",
                                  registry=reg)
    x = torch.ones(3, device=dev)
    with torch.inference_mode():
        outs = [fn(x, s) for s in (1.5, 2.5, 3.5, 4.5)]
    assert [float(o[0]) for o in outs] == [1.5, 2.5, 3.5, 4.5]
    assert fn.compiles == 1 and fn.captures == 1 and fn.recaptures == 0


def test_card_positions_past_max_len_raise_and_the_context_survives(dev):
    """Fault 3.17 on the card: positions already on the card are read back
    for the host check outside a capture, so an out-of-range one raises
    ``ValueError`` instead of a device-side assert."""
    lm = _lm(dev)
    tokens = torch.zeros((1, 2), dtype=torch.int64, device=dev)
    with torch.inference_mode():
        for bad in ([[0, 256]], [[-1, 0]]):
            with pytest.raises(ValueError, match="max_len"):
                lm(tokens, positions=torch.tensor(bad, device=dev))
        out = lm(tokens, positions=torch.tensor([[0, 255]], device=dev))
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# the plain-jit twins (observability.compute.captured) and Word2Vec's blocks
# ---------------------------------------------------------------------------

class EagerProgram(compute.InstrumentedJit):
    """``captured``'s program with its capture swapped for an eager call:
    the same code, never captured (the baseline a replay is held to)."""

    def _run(self, sig, args, kwargs):
        return compute.InstrumentedCall._run(self, sig, args, kwargs)


def _eager_captured(fn, **kw):
    return EagerProgram(fn, booked=False, **kw)


def _w2v_docs(n=400, vocab=300, seed=5):
    from mmlspark_tpu_torch.core import DataFrame
    rng = np.random.default_rng(seed)
    p = np.arange(1, vocab + 1, dtype=np.float64) ** -1.1
    p /= p.sum()
    docs = np.empty(n, dtype=object)
    for i in range(n):
        docs[i] = " ".join(f"w{t}" for t in rng.choice(
            vocab, int(rng.integers(3, 25)), p=p))
    return DataFrame.from_dict({"text": docs})


def test_word2vec_blocks_replay_and_equal_the_eager_fit(dev, monkeypatch):
    """Replayed blocks = the eager fit within 1e-4 x max|v| (``index_add_``
    adds in atomic order), the epochs under sync debug "error"; one
    capture per block length, every other block call a replay."""
    from mmlspark_tpu_torch.featurize import Word2Vec, word2vec

    class SyncChecked(Word2Vec):
        def _epoch(self, *args):
            torch.cuda.set_sync_debug_mode("error")
            try:
                super()._epoch(*args)
            finally:
                torch.cuda.set_sync_debug_mode(0)

    df = _w2v_docs()
    kw = dict(input_col="text", output_col="v", vector_size=32, max_iter=2,
              batch_size=64, seed=3)
    st = Word2Vec(device="cpu", **{**kw, "max_iter": 0}).fit(df).fit_stats
    S, B = st["steps"], st["pairs"] // st["steps"]
    L = word2vec.BLOCK_STEPS
    assert S > L and S % L
    rng = np.random.default_rng(9)
    us = [rng.random((S, B, 5), dtype=np.float32) for _ in range(2)]
    replayed = SyncChecked(negative_uniforms=us, **kw).fit(df)
    monkeypatch.setattr(word2vec, "captured", _eager_captured)
    eager = Word2Vec(negative_uniforms=us, **kw).fit(df)
    a = np.asarray(replayed.get("vectors"))
    b = np.asarray(eager.get("vectors"))
    assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()
    st = replayed.fit_stats
    calls = 2 * (S // L + 1)
    assert (st["captures"], st["recaptures"], st["replays"]) == \
        (2, 0, calls - 2)
    assert eager.fit_stats["captures"] == eager.fit_stats["replays"] == 0


def _vw_frame(n=3000, seed=0):
    from mmlspark_tpu_torch.core import DataFrame
    rng = np.random.default_rng(seed)
    w = rng.normal(size=1 << 12)
    feats = np.empty(n, dtype=object)
    y = np.empty(n)
    for i in range(n):
        k = int(rng.integers(3, 12))
        idx = np.sort(rng.choice(1 << 12, k, replace=False)).astype(np.int32)
        val = rng.normal(size=k).astype(np.float32)
        feats[i] = {"indices": idx, "values": val}
        y[i] = float(val @ w[idx] + rng.normal(scale=0.5) > 0)
    return DataFrame.from_dict({"features": feats, "label": y})


@pytest.mark.parametrize("extra", [{}, {"adaptive": False, "l1": 1e-6,
                                        "l2": 1e-5}])
def test_vw_step_replays_and_equals_the_eager_fit(dev, monkeypatch, extra):
    """The VW step replays per (width, batch) with its state donated:
    weights = the eager fit's within 1e-4 x max|w| (``t`` staged as a
    0-d input under the non-adaptive rate)."""
    from mmlspark_tpu_torch.vw import VowpalWabbitClassifier, learners

    programs = []

    class Kept(VowpalWabbitClassifier):
        def _make_trainer(self, loss_name):
            step, D = super()._make_trainer(loss_name)
            programs.append(step)
            return step, D

    df = _vw_frame()
    kw = dict(num_bits=12, batch_size=128, **extra)
    replayed = Kept().set_params(**kw).fit(df)
    monkeypatch.setattr(learners, "captured", _eager_captured)
    eager = VowpalWabbitClassifier().set_params(**kw).fit(df)
    a = np.asarray(replayed.get("weights"))
    b = np.asarray(eager.get("weights"))
    assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()
    (prog,) = programs
    steps = -(-3000 // 128)
    assert (prog.captures, prog.recaptures, prog.replays) == \
        (1, 0, steps - 1)


def _speech_pair(dev, seed=4):
    """A recognizer on the card and the same one with its step eager."""
    from mmlspark_tpu_torch.cognitive import StreamingRecognizer
    rec = StreamingRecognizer(chunk_s=0.25, seed=seed)
    eager = StreamingRecognizer(chunk_s=0.25, seed=seed)
    eager._program = _eager_captured(eager._encode, inplace_argnums=(0,))
    return rec, eager


def _logits_of(rec, audio):
    """Stream ``audio`` through ``rec``, keeping each step's logits."""
    kept = []
    inner = rec._program

    def tap(*args):
        out = inner(*args)
        kept.append(out[1].cpu().numpy())
        return out
    rec._program = tap
    state = rec.new_state()
    for lo in range(0, len(audio), rec.chunk_samples):
        rec.process_chunk(state, audio[lo:lo + rec.chunk_samples])
    rec.finish(state)
    rec._program = inner
    return kept, state.text


def _speech_audio(seconds=2.0, sr=16000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f = rng.uniform(200, 2000, 4)
    return (sum(0.2 * np.sin(2 * np.pi * fi * t) for fi in f)
            + rng.normal(scale=0.01, size=t.size)).astype(np.float32)


def test_speech_step_replays_bit_for_bit_on_the_module_route(dev):
    """cuDNN's LSTM forward has no atomics: replayed logits = eager
    logits bit for bit; one capture per chunk length, two sessions in a
    row replay them."""
    rec, eager = _speech_pair(dev)
    audio = _speech_audio()
    for _ in range(2):
        got, text = _logits_of(rec, audio)
    want, want_text = _logits_of(eager, audio)
    assert text == want_text and len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    prog = rec._program
    lengths = {g.shape[1] for g in got}
    assert prog.captures == len(lengths) and prog.recaptures == 0
    assert prog.replays == 2 * len(got) - len(lengths)


def _onnx_lstm(dev, n_mels=40, hidden=16, n_sym=29):
    """The speech tests' torch LSTM + head in ONNX wire format, imported
    by the port as a recognizer's ``apply_fn``."""
    import torch.nn as tnn
    from mmlspark_tpu_torch.dl.onnx_import import onnx_to_jax
    from mmlspark_tpu_torch.dl.onnx_wire import build_model, encode_node
    torch.manual_seed(0)
    lstm = tnn.LSTM(input_size=n_mels, hidden_size=hidden).eval()
    head = tnn.Linear(hidden, n_sym).eval()

    def reorder(w):
        i, f, g, o = np.split(w.detach().numpy(), 4, axis=0)
        return np.concatenate([i, o, f, g], axis=0)

    init = {
        "W": reorder(lstm.weight_ih_l0)[None].astype(np.float32),
        "R": reorder(lstm.weight_hh_l0)[None].astype(np.float32),
        "B": np.concatenate([reorder(lstm.bias_ih_l0[:, None])[:, 0],
                             reorder(lstm.bias_hh_l0[:, None])[:, 0]])[None]
        .astype(np.float32),
        "hw": head.weight.detach().numpy(), "hb": head.bias.detach().numpy(),
        "shape2d": np.asarray([-1, hidden], np.int64)}
    nodes = [
        encode_node("LSTM", ["x", "W", "R", "B", "", "h0", "c0"],
                    ["Y", "Y_h", "Y_c"], hidden_size=hidden),
        encode_node("Squeeze", ["Y"], ["Ys"], axes=[1]),
        encode_node("Reshape", ["Ys", "shape2d"], ["Ys_2d"]),
        encode_node("Gemm", ["Ys_2d", "hw", "hb"], ["logits2d"], transB=1)]
    data = build_model(nodes, init,
                       [("x", [8, 1, n_mels]), ("h0", [1, 1, hidden]),
                        ("c0", [1, 1, hidden])],
                       [("logits2d", [8, n_sym]), ("Y_h", [1, 1, hidden]),
                        ("Y_c", [1, 1, hidden])])
    fn, variables = onnx_to_jax(data, device=dev)

    def apply_fn(v, carry, feats):
        h0, c0 = carry
        logits2d, yh, yc = fn(v, feats.transpose(0, 1), h0, c0)
        return (yh, yc), logits2d[None]
    return apply_fn, variables, hidden


def test_speech_step_replays_bit_for_bit_on_the_onnx_route(dev):
    """An imported ONNX LSTM as the recognizer's ``apply_fn`` captures
    (its variables read in place) and replays = its eager run bit for
    bit."""
    from mmlspark_tpu_torch.cognitive import StreamingRecognizer
    apply_fn, variables, hidden = _onnx_lstm(dev)
    recs = []
    for _ in range(2):
        rec = StreamingRecognizer(apply_fn=apply_fn, variables=variables,
                                  chunk_s=0.2)
        rec.init_carry = lambda batch=1: (
            torch.zeros((1, 1, hidden), device=dev),
            torch.zeros((1, 1, hidden), device=dev))
        recs.append(rec)
    recs[1]._program = _eager_captured(recs[1]._encode, inplace_argnums=(0,))
    audio = _speech_audio(1.0, seed=2)
    for _ in range(2):
        got, text = _logits_of(recs[0], audio)
    want, want_text = _logits_of(recs[1], audio)
    assert text == want_text
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert recs[0]._program.captures >= 1 and recs[0]._program.replays > 0


def test_lasso_ista_is_one_graph_and_replays_bit_for_bit(dev, monkeypatch):
    """The 200 ISTA steps replay as one graph = the eager loop bit for
    bit; a new ``alpha`` is a staged scalar, not a new capture."""
    from mmlspark_tpu_torch.explainers import regression
    rng = np.random.default_rng(4)
    X = rng.normal(size=(300, 23))
    y = X @ rng.normal(size=23) + rng.normal(scale=0.1, size=300)
    w = rng.uniform(0.5, 1.5, 300)
    prog = regression._ISTA
    c0, r0 = prog.captures, prog.replays
    got = [regression.lasso_regression(X, y, w, alpha=a)
           for a in (0.01, 0.02, 0.01)]
    assert prog.captures - c0 <= 1 and prog.replays - r0 >= 2
    monkeypatch.setattr(regression, "_ISTA", _eager_captured(
        regression._ista, static_argnums=(4,)))
    want = [regression.lasso_regression(X, y, w, alpha=a)
            for a in (0.01, 0.02, 0.01)]
    for (gb, gi), (wb, wi) in zip(got, want):
        np.testing.assert_array_equal(gb, wb)
        assert gi == wi


def test_a_failing_capture_of_an_unbooked_program_raises(dev):
    """No fallback: a host sync inside ``captured``'s function refuses the
    capture, which raises naming the program."""
    prog = compute.captured(lambda x: x * x.sum().item(),
                            name="g.unbooked_sync")
    with pytest.raises(RuntimeError, match="g.unbooked_sync"):
        prog(torch.ones(4, device=dev))
    assert prog.captures == 0


def test_a_capture_after_a_failed_one_succeeds(dev):
    """A failed capture gives its pool back: with another graph holding
    the shared pool, the next program still captures and replays."""
    held = compute.captured(lambda x: x * 2, name="g.holder")
    held(torch.ones(4, device=dev))                # a live graph
    bad = compute.captured(lambda x: x * x.sum().item(), name="g.bad")
    for _ in range(2):
        with pytest.raises(RuntimeError, match="g.bad"):
            bad(torch.ones(4, device=dev))
    good = compute.captured(lambda x: x + 1, name="g.good")
    for _ in range(2):
        assert good(torch.ones(4, device=dev)).tolist() == [2.0] * 4
    assert (good.captures, good.replays, held.captures) == (1, 1, 1)


def test_orbax_checkpoint_round_trips_card_tensors(dev, tmp_path):
    """``backend="orbax"`` (torch.distributed.checkpoint) saves a card
    trainer's state as host copies and restores it into a template,
    equal bit for bit with the same next loss."""
    from mmlspark_tpu_torch import parallel as TP
    from mmlspark_tpu_torch.parallel.checkpoint import (load_train_state,
                                                        save_train_state)
    from mmlspark_tpu_torch.parallel.trainer import (Trainer,
                                                     softmax_cross_entropy)

    def trainer(seed):
        torch.manual_seed(seed)
        module = torch.nn.Sequential(torch.nn.Linear(16, 64),
                                     torch.nn.ReLU(), torch.nn.Linear(64, 4))
        return Trainer(module, lambda ps: torch.optim.Adam(ps, lr=1e-2),
                       softmax_cross_entropy,
                       mesh=TP.make_mesh({"data": 1}, device="cuda"))

    rng = np.random.default_rng(0)
    batch = {"x": rng.normal(size=(8, 16)).astype(np.float32),
             "y": rng.integers(0, 4, 8)}
    tr = trainer(0)
    st, _ = tr.train_step(tr.init_state(), batch)
    save_train_state(st, str(tmp_path), backend="orbax", trainer=tr)
    tr2 = trainer(1)
    restored = load_train_state(str(tmp_path), trainer=tr2,
                                template=tr2.init_state())
    a, b = tr.full_state(st), tr2.full_state(restored)
    for k in a.params:
        for n in a.params[k]:
            np.testing.assert_array_equal(a.params[k][n], b.params[k][n])
    assert float(tr.train_step(st, batch)[1]) == \
        float(tr2.train_step(restored, batch)[1])


# ---------------------------------------------------------------------------
# KNN's search, the ALS half-sweep, the image chain, --bfgs
# ---------------------------------------------------------------------------

def _knn_frames(n=3000, d=64, queries=2500, seed=6):
    from mmlspark_tpu_torch.core import DataFrame, vector_column
    rng = np.random.default_rng(seed)
    X = np.abs(rng.normal(size=(n, d))).astype(np.float32)
    Q = np.abs(rng.normal(size=(queries, d))).astype(np.float32)
    return (DataFrame.from_dict({"features": vector_column(list(X))}),
            DataFrame.from_dict({"features": vector_column(list(Q))}))


def _matches(df):
    rows = df.collect()["m"]
    return (np.asarray([[r["value"] for r in row] for row in rows]),
            np.asarray([[r["distance"] for r in row] for row in rows]))


def test_knn_search_replays_bit_for_bit(dev, monkeypatch):
    """2,500 queries in three 1,024-row chunks (the tail padded): one
    capture and two replays; a second transform captures nothing and
    uploads no item table; replayed = the eager search bit for bit."""
    from mmlspark_tpu_torch.nn import KNN, knn
    items, queries = _knn_frames()
    model = KNN().set_params(output_col="m", k=5).fit(items)
    got = _matches(model.transform(queries))
    prog = model._program()
    table = model._item_cache[1][torch.device("cuda", 0)]
    assert (prog.captures, prog.recaptures, prog.replays) == (1, 0, 2)
    again = _matches(model.transform(queries))
    assert (prog.captures, prog.replays) == (1, 5)
    assert model._item_cache[1][torch.device("cuda", 0)] is table
    monkeypatch.setattr(knn, "captured", _eager_captured)
    want = _matches(model.copy().transform(queries))
    for a, b, c in zip(got, again, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)


def _access_frame(seed=3, n=6000):
    from mmlspark_tpu_torch.core import DataFrame
    rng = np.random.default_rng(seed)
    return DataFrame.from_dict({
        "user": np.asarray([f"u{i}" for i in rng.integers(0, 400, n)],
                           dtype=object),
        "res": np.asarray([f"r{i}" for i in rng.integers(0, 90, n)],
                          dtype=object),
        "count": rng.geometric(0.3, n).astype(np.float64)})


@pytest.mark.parametrize("implicit", [True, False])
def test_als_half_sweep_replays_within_1e4(dev, monkeypatch, implicit):
    """Chunks of 1,000 nonzeros (a tail too): the replayed factors within
    1e-4 x max of the eager fit's (``index_add_`` adds in atomic order);
    a second fit of the same shape captures nothing."""
    from mmlspark_tpu_torch.cyber import AccessAnomaly, anomaly
    monkeypatch.setattr(anomaly, "_CHUNK_NNZ", 1_000)
    df = _access_frame()
    kw = dict(likelihood_col="count", rank=6, max_iter=3,
              implicit_cf=implicit)
    est = AccessAnomaly().set_params(**kw)
    got = est.fit(df).get("factors")["_"]
    progs = est._programs()
    caps = (progs.accumulate.captures, progs.solve.captures)
    assert min(caps) >= 1 and progs.accumulate.replays > 0
    est.fit(df)
    assert (progs.accumulate.captures, progs.solve.captures) == caps
    monkeypatch.setattr(anomaly, "captured", _eager_captured)
    want = AccessAnomaly().set_params(**kw).fit(df).get("factors")["_"]
    for key in ("U", "V"):
        assert np.abs(got[key] - want[key]).max() <= \
            1e-4 * np.abs(want[key]).max()


def _frames_column(seed=8):
    rng = np.random.default_rng(seed)
    shapes = [(48, 64, 3)] * 11 + [(36, 48, 3)] * 5
    col = np.empty(len(shapes), dtype=object)
    for j, i in enumerate(rng.permutation(len(shapes))):
        col[j] = (rng.random(shapes[i]) * 255).astype(np.float32)
    return col


def _featurizer_chain(t):
    return t.resize(32, 32).center_crop(28, 28).blur(5, 5, 1.0) \
        .normalize().unroll()


def test_image_chain_replays_bit_for_bit_and_equals_the_cpu(dev,
                                                            monkeypatch):
    """Two partitions of mixed shapes in row buckets: replayed = the eager
    chain bit for bit, = the CPU within 1e-4; a second transform captures
    nothing."""
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.opencv import ImageTransformer, image_transformer
    df = DataFrame.from_dict({"image": _frames_column()}, num_partitions=2)

    def transformer(**kw):
        return _featurizer_chain(ImageTransformer(
            input_col="image", output_col="out", **kw))

    t = transformer()
    got = t.transform(df).collect()["out"]
    (prog,) = t._programs.values()
    caps = prog.captures
    again = t.transform(df).collect()["out"]
    assert prog.captures == caps and prog.replays >= caps
    cpu = transformer(device="cpu").transform(df).collect()["out"]
    monkeypatch.setattr(image_transformer, "captured", _eager_captured)
    eager = transformer().transform(df).collect()["out"]
    for a, b, e, c in zip(got, again, eager, cpu):
        np.testing.assert_array_equal(a, e)
        np.testing.assert_array_equal(b, e)
        np.testing.assert_allclose(a, c, rtol=0, atol=1e-4)


def _bfgs_objective_of(weights, df):
    from mmlspark_tpu_torch.vw.learners import pack_sparse_column
    data = df.collect()
    idx, val = pack_sparse_column(data["features"], mask=len(weights) - 1)
    pred = (weights[idx].astype(np.float64) * val).sum(1)
    ysgn = np.where(data["label"] > 0, 1.0, -1.0)
    return float(np.mean(np.logaddexp(0.0, -ysgn * pred)))


def test_bfgs_replays_and_a_second_fit_captures_nothing(dev, monkeypatch):
    """``optimizer="bfgs"``: one capture of each program, every other
    direction and trial point a replay; a second fit of the same shape
    captures nothing; the objective within 1e-4 relative of the eager
    fit's (the gather's backward adds in atomic order, so the line search
    may step elsewhere)."""
    from mmlspark_tpu_torch.vw import VowpalWabbitClassifier, learners
    df = _vw_frame()
    est = VowpalWabbitClassifier().set_params(num_bits=12,
                                              optimizer="bfgs")
    got = est.fit(df).weights
    progs = est._bfgs_programs()
    run = progs.last_run
    assert (progs.direction.captures, progs.trial.captures) == (1, 1)
    assert progs.direction.replays == run["iterations"] - 1
    assert progs.trial.replays == run["trials"] - 1
    est.fit(df)
    assert (progs.direction.captures, progs.trial.captures) == (1, 1)
    monkeypatch.setattr(learners, "captured", _eager_captured)
    want = VowpalWabbitClassifier().set_params(
        num_bits=12, optimizer="bfgs").fit(df).weights
    og, ow = _bfgs_objective_of(got, df), _bfgs_objective_of(want, df)
    assert abs(og - ow) <= 1e-4 * abs(ow)


@pytest.mark.parametrize("module, fn, name", [
    ("nn.knn", "_search", "nn.knn_search"),
    ("cyber.anomaly", "_accumulate", "cyber.als_accumulate"),
    ("cyber.anomaly", "_solve_all", "cyber.als_solve"),
    ("opencv.image_transformer", "_apply_stages", "opencv.image_chain"),
    ("vw.learners", "two_loop", "vw.bfgs_direction"),
    ("vw.learners", "_bfgs_trial", "vw.bfgs_trial"),
])
def test_a_failing_capture_of_each_path_raises(dev, monkeypatch, module,
                                               fn, name):
    """A host sync inside each program refuses its capture, and the entry
    point raises naming the program: nothing runs eagerly instead."""
    import importlib
    from mmlspark_tpu_torch.core import DataFrame
    mod = importlib.import_module(f"mmlspark_tpu_torch.{module}")
    inner = getattr(mod, fn)

    def synced(*args, **kwargs):
        torch.ones(1, device=dev).sum().item()
        return inner(*args, **kwargs)

    monkeypatch.setattr(mod, fn, synced)
    with pytest.raises(RuntimeError, match=name.replace(".", r"\.")):
        if module == "nn.knn":
            from mmlspark_tpu_torch.nn import KNN
            items, queries = _knn_frames(n=200, queries=50)
            KNN().set_params(output_col="m").fit(items).transform(queries)
        elif module == "cyber.anomaly":
            from mmlspark_tpu_torch.cyber import AccessAnomaly
            AccessAnomaly().set_params(rank=3, max_iter=1).fit(
                _access_frame(n=500))
        elif module == "opencv.image_transformer":
            from mmlspark_tpu_torch.opencv import ImageTransformer
            ImageTransformer(input_col="image", output_col="o").flip(1) \
                .transform(DataFrame.from_dict({"image": _frames_column()}))
        else:
            from mmlspark_tpu_torch.vw import VowpalWabbitClassifier
            VowpalWabbitClassifier().set_params(
                num_bits=12, optimizer="bfgs", num_passes=2).fit(_vw_frame())
