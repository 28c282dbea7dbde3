"""The runner's compiled programs on the card: CUDA graphs captured per
signature by ``observability.compute.InstrumentedJit``.  Marked ``cuda``:
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
