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
