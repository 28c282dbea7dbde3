"""Port parity for the runner's batched decode (``mmlspark_tpu_torch/
models/runner.py``: ``ModelRunner.decode``, ``PagePool``,
``DecodeResult``) against the JAX runner's ``decode`` on
``tests/test_paged_decode.py``'s tiny LM (vocab 48, embed 32, 2 heads,
2 layers, causal, ``pool="none"``), weights carried across by
``convert.transformer_state_dict_from_flax``, on the CPU; and the
reference's pool tests (``tests/test_paged_decode.py``,
``tests/test_continuous_batching.py``) run against the port.

Tolerances: tokens exactly (greedy argmax and host samplers on logits
that agree within 1e-6 here); logits within the reference's
``DECODE_ATOL`` of 1e-4 (measured 2.4e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.models import ModelRunner as JaxRunner
from mmlspark_tpu.models import TransformerEncoder as JaxEncoder
from mmlspark_tpu_torch.convert import transformer_state_dict_from_flax
from mmlspark_tpu_torch.models import (ModelRunner, PagePool,
                                       TransformerEncoder)
from mmlspark_tpu_torch.models.runner import DecodeResult, PagePoolExhausted
from mmlspark_tpu_torch.observability.metrics import MetricsRegistry

#: the reference's committed decode tolerance (tests/test_paged_decode.py)
DECODE_ATOL = 1e-4
V = 48


def _lms(layers=2, seed=0):
    ref = JaxEncoder(vocab_size=V, num_classes=V, embed_dim=32, num_heads=2,
                     num_layers=layers, mlp_dim=64, max_len=128, causal=True,
                     pool="none")
    variables = ref.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, 4), jnp.int32))
    port = TransformerEncoder(vocab_size=V, num_classes=V, embed_dim=32,
                              num_heads=2, num_layers=layers, mlp_dim=64,
                              max_len=128, causal=True, pool="none")
    port.load_state_dict(transformer_state_dict_from_flax(variables, port))
    return ref, variables, port


def _runner(name, layers=2, registry=None):
    _, _, port = _lms(layers)
    return ModelRunner(module=port, name=name, registry=registry,
                       device="cpu")


@pytest.fixture(scope="module")
def runners():
    ref, variables, port = _lms()
    return (JaxRunner(module=ref, variables=variables, name="t.jax"),
            ModelRunner(module=port, name="t.port", device="cpu"))


def _freeze_row0_at_step1(lg):
    _freeze_row0_at_step1.t += 1
    out = np.argmax(lg, axis=-1)
    if _freeze_row0_at_step1.t >= 1:
        out[0] = 0
    return out


CASES = {
    "dense": {},
    "paged3": {"kv_layout": "paged", "page_size": 3},
    "paged8": {"kv_layout": "paged", "page_size": 8},
    "eos": {"eos_id": 0},
    "eos_paged4": {"eos_id": 0, "kv_layout": "paged", "page_size": 4},
    "logits": {"collect_logits": True},
    "logits_paged4": {"collect_logits": True, "kv_layout": "paged",
                      "page_size": 4},
    "sample_fn": {"sample_fn": lambda lg: (np.argmax(lg, -1) * 7 + 3) % V},
    "sample_fn_eos_logits_paged4": {
        "sample_fn": _freeze_row0_at_step1, "eos_id": 0,
        "collect_logits": True, "kv_layout": "paged", "page_size": 4},
    "cache_len": {"cache_len": 64},
}


@pytest.mark.parametrize("batch", [3, 5])
@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_equals_the_jax_runner(runners, case, batch):
    """Ragged prompts (B = 3 buckets to 4, B = 5 to 8, born-finished pad
    rows), frontiers crossing page boundaries, eos, host samplers and
    collected logits: the same tokens, steps, counts and geometry as the
    JAX runner."""
    jr, pr = runners
    kw = CASES[case]
    rng = np.random.default_rng(batch)
    lengths = rng.integers(1, 8, batch).astype(np.int32)
    lengths[0] = 7
    prompts = rng.integers(0, V, (batch, 7)).astype(np.int32)
    results = []
    for runner in (jr, pr):
        _freeze_row0_at_step1.t = -1
        results.append(runner.decode(prompts, lengths=lengths,
                                     max_new_tokens=9, **kw))
    want, got = results
    assert isinstance(got, DecodeResult)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    assert got.steps == want.steps
    if kw.get("collect_logits"):
        assert got.logits.shape == want.logits.shape
        np.testing.assert_allclose(got.logits, want.logits,
                                   atol=DECODE_ATOL)
    else:
        assert got.logits is None
    assert set(got.extras) == set(want.extras) - {"prefix"}
    for key in ("kv_layout", "real_tokens", "batch_bucket", "cache_len",
                "cache_bytes_per_seq", "page_size", "table_width",
                "pool_pages", "pages_prefill", "pages_peak",
                "page_occupancy_pct"):
        assert got.extras.get(key) == want.extras.get(key), key
    for key in ("useful", "denied_row", "pad_row"):
        assert got.extras["attribution"][key] == \
            want.extras["attribution"][key]


def test_decode_logits_match_full_recompute_every_step():
    """The reference's acceptance gate on the port: at every step the
    KV-cached logits equal a full causal forward over the sequence's true
    history (its prompt and the runner's own tokens)."""
    runner = _runner("t.recompute")
    rng = np.random.default_rng(1)
    lengths = np.asarray([7, 4, 2], np.int32)
    prompts = rng.integers(0, V, (3, 7)).astype(np.int32)
    T = 5
    res = runner.decode(prompts, lengths=lengths, max_new_tokens=T,
                        collect_logits=True)
    assert res.tokens.shape == (3, T) and res.logits.shape == (3, T, V)
    for b in range(3):
        L = int(lengths[b])
        hist = np.concatenate([prompts[b, :L], res.tokens[b]])
        with torch.no_grad():
            full = runner.module(torch.from_numpy(hist[None]))[0].numpy()
        for t in range(T):
            np.testing.assert_allclose(res.logits[b, t], full[L + t - 1],
                                       atol=DECODE_ATOL)


def test_decode_eos_freezes_and_pad_rows_never_hold_the_exit_open():
    runner = _runner("t.eos", layers=1)
    for n in (2, 3):                      # 3 real rows pad to 4
        prompts = np.random.default_rng(n).integers(0, V, (n, 4)).astype(
            np.int32)
        res = runner.decode(prompts, max_new_tokens=6, eos_id=0,
                            sample_fn=lambda lg: np.zeros(lg.shape[0],
                                                          np.int64))
        assert res.tokens.shape == (n, 1) and (res.tokens == 0).all()
        assert res.steps == 0


def test_decode_rejects_cacheless_models_and_unported_options():
    mlp = ModelRunner(apply_fn=lambda s, x: x, device="cpu")
    with pytest.raises(TypeError, match="init_cache"):
        mlp.decode(np.zeros((1, 4), np.int32))
    runner = _runner("t.args", layers=1)
    prompts = np.zeros((2, 4), np.int32) + 3
    # the prefix cache shares pool pages and skips cached logits: paged
    # and greedy only, as the reference refuses it
    with pytest.raises(ValueError, match="kv_layout='paged'"):
        runner.decode(prompts, prefix_cache=True)
    with pytest.raises(ValueError, match="greedy fused path"):
        runner.decode(prompts, kv_layout="paged", prefix_cache=True,
                      sample_fn=lambda lg: np.argmax(lg, -1))
    # what the port still lacks of the runner is its jit cache
    for name in ("executable", "compile_stats"):
        with pytest.raises(NotImplementedError, match="item 6"):
            getattr(runner, name)(*(() if name == "compile_stats"
                                    else (1, (4,))))


# ---------------------------------------------------------------------------
# the reference's pool tests, on the port
# ---------------------------------------------------------------------------

def test_pad_rows_never_allocate_pages():
    reg = MetricsRegistry()
    runner = _runner("paged.pads", layers=1, registry=reg)
    lengths = np.asarray([7, 4, 1], np.int32)
    prompts = np.random.default_rng(4).integers(0, V, (3, 7)).astype(
        np.int32)
    ps = 4
    res = runner.decode(prompts, lengths=lengths, max_new_tokens=3,
                        kv_layout="paged", page_size=ps)
    expect = sum(-(-int(l) // ps) for l in lengths)        # 2 + 1 + 1
    assert res.extras["pages_prefill"] == expect
    fam = reg.family("mmlspark_runner_page_ops_total")
    ops = {op: fam.labels(runner="paged.pads", page_size="4", op=op).value
           for op in ("allocate", "extend", "free")}
    assert ops["allocate"] == expect
    assert ops["free"] == ops["allocate"] + ops["extend"]
    pool = runner.page_pool(ps)
    assert pool.pages_in_use() == 0 and pool.high_water > 0


def test_free_on_eos_returns_pages_midflight():
    """A pool that can serve the batch only if eos frees pages mid-decode:
    row 0 finishes at step 0, and its 2 pages fund row 1's extends."""
    reg = MetricsRegistry()
    runner = _runner("paged.eosfree", layers=1, registry=reg)
    pool = PagePool(runner.module, num_pages=6, page_size=2,
                    name="paged.eosfree", registry=reg)
    prompts = np.random.default_rng(5).integers(1, V, (2, 4)).astype(
        np.int32)
    lengths = np.asarray([4, 3], np.int32)

    def sf(lg):
        sf.t += 1
        out = np.full(lg.shape[0], 7, np.int64)
        if sf.t == 0:
            out[0] = 0
        return out
    sf.t = -1
    res = runner.decode(prompts, lengths=lengths, max_new_tokens=5,
                        eos_id=0, sample_fn=sf, pool=pool)
    assert list(res.tokens[0]) == [0] * 5
    assert (res.tokens[1] == 7).all()
    fam = reg.family("mmlspark_runner_page_ops_total")
    ops = {op: fam.labels(runner="paged.eosfree", page_size="2",
                          op=op).value
           for op in ("allocate", "extend", "free")}
    assert ops == {"allocate": 4, "extend": 2, "free": 6}
    assert pool.pages_in_use() == 0


def test_pool_sized_for_n_tokens_serves_4x_dense_concurrency():
    runner = _runner("paged.conc", layers=1)
    ps, n_tokens = 8, 256
    pool = PagePool(runner.module, num_pages=n_tokens // ps + 1,
                    page_size=ps, name="paged.conc")
    assert pool.token_capacity() == n_tokens
    B = 16
    prompts = np.random.default_rng(6).integers(0, V, (B, 8)).astype(
        np.int32)
    res = runner.decode(prompts, max_new_tokens=8, pool=pool)
    assert res.tokens.shape == (B, 8)
    assert res.extras["pages_peak"] <= pool.capacity
    dense = runner.decode(prompts, max_new_tokens=8, cache_len=64)
    np.testing.assert_array_equal(dense.tokens, res.tokens)
    assert B * 64 == 4 * n_tokens
    assert res.extras["cache_bytes_per_seq"] < \
        dense.extras["cache_bytes_per_seq"]


def test_pool_validation_and_accounting_standalone():
    with pytest.raises(ValueError, match="trash page"):
        PagePool(None, num_pages=1, page_size=4)
    with pytest.raises(ValueError, match="page_size"):
        PagePool(None, num_pages=4, page_size=0)
    pool = PagePool(None, num_pages=5, page_size=4, name="acct",
                    registry=MetricsRegistry())
    assert pool.capacity == 4 and pool.token_capacity() == 16
    pages = pool.allocate(3)
    assert 0 not in pages
    assert pool.pages_in_use() == 3 and pool.high_water == 3
    assert pool.shortfall(2) == 1 and pool.shortfall(1) == 0
    with pytest.raises(PagePoolExhausted, match="exhausted"):
        pool.allocate(2)
    # refcounts: a pinned page survives one holder's free
    pool.pin(pages[:1])
    assert pool.refcount(pages[0]) == 2
    pool.free(pages[:2])
    assert pool.refcount(pages[0]) == 1 and pool.pages_in_use() == 2
    with pytest.raises(ValueError, match="double free"):
        pool.free([pages[1]])
    with pytest.raises(ValueError, match="trash"):
        pool.free([0])
    with pytest.raises(ValueError, match="not allocated"):
        pool.pin([pages[1]])
    assert pool.page_seconds() >= 0.0 and 0 < pool.occupancy_pct() <= 100
    with pytest.raises(TypeError, match="without a module"):
        pool.borrow_cache()


def test_auto_pool_grows_for_larger_batches_but_budgets_do_not():
    runner = _runner("paged.grow", layers=1)
    rng = np.random.default_rng(11)
    small = rng.integers(0, V, (2, 4)).astype(np.int32)
    runner.decode(small, max_new_tokens=4, kv_layout="paged", page_size=8)
    n0 = runner.page_pool(8).num_pages
    big = rng.integers(0, V, (8, 4)).astype(np.int32)
    res = runner.decode(big, max_new_tokens=4, kv_layout="paged",
                        page_size=8)
    assert res.tokens.shape == (8, 4)
    assert runner.page_pool(8).num_pages > n0
    pool = runner.page_pool(8, num_pages=64)
    assert pool.num_pages == 64 and runner.page_pool(8) is pool
    runner.page_pool(8, num_pages=3)
    with pytest.raises(PagePoolExhausted, match="exhausted"):
        runner.decode(big, max_new_tokens=4, kv_layout="paged", page_size=8)
    held = runner.page_pool(8)
    assert held.pages_in_use() == 0            # the refused decode leaked none
    held.allocate(1)
    with pytest.raises(RuntimeError, match="busy"):
        held.resized(128)


def test_cache_len_is_rejected_for_paged_layout():
    runner = _runner("paged.args", layers=1)
    prompts = np.zeros((2, 4), np.int32) + 3
    with pytest.raises(ValueError, match="dense-layout parameter"):
        runner.decode(prompts, max_new_tokens=2, kv_layout="paged",
                      cache_len=64)
    with pytest.raises(ValueError, match="paged"):
        runner.decode(prompts, max_new_tokens=8, cache_len=4)
    with pytest.raises(ValueError, match="max_len"):
        runner.decode(prompts, max_new_tokens=200, kv_layout="paged")


def test_budgeted_pool_exhausting_mid_decode_yields_partial_result():
    reg = MetricsRegistry()
    runner = _runner("cont.partial", layers=1, registry=reg)
    prompt = np.asarray([[3, 1, 4, 1]], np.int32)
    free = runner.decode(prompt, max_new_tokens=6, kv_layout="paged",
                         page_size=2)
    pool = PagePool(runner.module, num_pages=3, page_size=2,
                    name="cont.partial", registry=reg)
    res = runner.decode(prompt, max_new_tokens=6, pool=pool)
    assert res.extras["denied_rows"] == [0]
    cut = res.extras["denied_at"][0]
    assert 1 <= cut < 6
    np.testing.assert_array_equal(res.tokens[0][:cut], free.tokens[0][:cut])
    assert set(res.tokens[0][cut:].tolist()) <= {0}
    assert pool.pages_in_use() == 0
    fam = reg.family("mmlspark_runner_page_ops_total")
    assert fam.labels(runner="cont.partial", page_size="2",
                      op="denied").value > 0


def test_fused_path_denial_stays_frozen_and_tokens_stay_honest():
    reg = MetricsRegistry()
    runner = _runner("cont.thaw", layers=1, registry=reg)
    prompts = np.random.default_rng(7).integers(0, V, (2, 4)).astype(
        np.int32)
    free = runner.decode(prompts, max_new_tokens=6, kv_layout="paged",
                         page_size=2)
    pool = PagePool(runner.module, num_pages=6, page_size=2,
                    name="cont.thaw", registry=reg)
    fam = reg.family("mmlspark_runner_decode_tokens_total")
    before = fam.labels(runner="cont.thaw").value
    res = runner.decode(prompts, max_new_tokens=6, pool=pool)
    assert res.extras["denied_rows"] == [1]
    assert res.extras["denied_at"] == {1: 1}
    np.testing.assert_array_equal(res.tokens[0], free.tokens[0])
    np.testing.assert_array_equal(res.tokens[1][:1], free.tokens[1][:1])
    assert res.extras["real_tokens"] == 7
    assert fam.labels(runner="cont.thaw").value - before == 7.0


def test_decode_tokens_counter_counts_unfrozen_steps_only():
    reg = MetricsRegistry()
    runner = _runner("paged.count", layers=1, registry=reg)
    prompts = np.random.default_rng(9).integers(1, V, (2, 4)).astype(
        np.int32)

    def sf(lg):
        sf.t += 1
        out = np.full(lg.shape[0], 7, np.int64)
        if sf.t == 0:
            out[0] = 0
        return out
    sf.t = -1
    res = runner.decode(prompts, max_new_tokens=4, eos_id=0, sample_fn=sf)
    fam = reg.family("mmlspark_runner_decode_tokens_total")
    assert fam.labels(runner="paged.count").value == 5.0
    assert res.extras["real_tokens"] == 5
    steps = reg.family("mmlspark_runner_decode_steps_total")
    assert steps.labels(runner="paged.count").value == res.steps == 3
    p3 = np.random.default_rng(10).integers(0, V, (3, 4)).astype(np.int32)
    runner.decode(p3, max_new_tokens=5)
    assert fam.labels(runner="paged.count").value == 5.0 + 15.0


def test_a_pool_on_another_device_than_the_model_is_refused():
    runner = _runner("t.devices", layers=1)

    class Elsewhere:
        def init_paged_cache(self, n, ps):
            return ((torch.zeros(n, ps, 2, 16, device="meta"),) * 2,)

    pool = PagePool(Elsewhere(), num_pages=8, page_size=4,
                    registry=MetricsRegistry())
    with pytest.raises(ValueError, match="runner.module"):
        runner.decode(np.zeros((1, 3), np.int32) + 2, pool=pool)
    assert pool.pages_in_use() == 0
