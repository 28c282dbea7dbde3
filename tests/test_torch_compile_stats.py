"""The runner's compiled-program layer (``ModelRunner.executable`` /
``compile_stats``, the decode's prefill, step and sampler programs, the
copy-on-write clone, the continuous engine on them) against the JAX
package's, on the CPU.

Each scenario is one of the reference's own compile-contract tests
(``tests/test_model_runner.py``, ``tests/test_paged_decode.py``,
``tests/test_continuous_batching.py``, ``tests/test_prefix_cache.py``,
``tests/test_attribution.py``) replayed on both packages' runners over
the same weights (``convert.transformer_state_dict_from_flax``), with
``compile_stats()`` compared after every stage: the executable keys equal
but for their device field (the port's is its device index, the
reference's the ids of the 8 virtual CPU devices), the compile counts
equal.  On the CPU the port's programs run eagerly under the same
booking; on the card they are CUDA graphs
(``tests/test_torch_cuda_graphs.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.models import ModelRunner as JaxRunner
from mmlspark_tpu.models import PagePool as JaxPool
from mmlspark_tpu.models import SlotsExhausted as JaxSlotsExhausted
from mmlspark_tpu.models import TransformerEncoder as JaxEncoder
from mmlspark_tpu.observability import MetricsRegistry as JaxRegistry
from mmlspark_tpu.utils.resilience import FakeClock as JaxClock
from mmlspark_tpu_torch.convert import transformer_state_dict_from_flax
from mmlspark_tpu_torch.models import ModelRunner, PagePool, TransformerEncoder
from mmlspark_tpu_torch.models import runner as port_runner
from mmlspark_tpu_torch.models.runner import SlotsExhausted
from mmlspark_tpu_torch.observability import MetricsRegistry
from mmlspark_tpu_torch.utils.resilience import FakeClock

V = 48


def _pair(name, layers=1, seed=0):
    """One JAX runner and one port runner over the same tiny LM (vocab 48,
    embed 32, 2 heads, causal, ``pool="none"``: the reference tests')."""
    ref = JaxEncoder(vocab_size=V, num_classes=V, embed_dim=32, num_heads=2,
                     num_layers=layers, mlp_dim=64, max_len=128, causal=True,
                     pool="none")
    variables = ref.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, 4), jnp.int32))
    port = TransformerEncoder(vocab_size=V, num_classes=V, embed_dim=32,
                              num_heads=2, num_layers=layers, mlp_dim=64,
                              max_len=128, causal=True, pool="none")
    port.load_state_dict(transformer_state_dict_from_flax(variables, port))
    jreg, preg = JaxRegistry(), MetricsRegistry()
    return (JaxRunner(module=ref, variables=variables, name=name,
                      registry=jreg),
            ModelRunner(module=port, name=name, registry=preg,
                        device="cpu"))


def _keys(stats):
    """The executable keys without their device field."""
    out = []
    for k in stats["executables"]:
        parts = k.split("/")
        out.append("/".join(parts[:1] + parts[2:]))
    return sorted(out)


def _same(jr, pr):
    js, ps = jr.compile_stats(), pr.compile_stats()
    assert set(ps) == set(js) == {"executables", "compiles"}
    assert _keys(ps) == _keys(js), (ps, js)
    assert ps["compiles"] == js["compiles"], (ps, js)
    return ps["compiles"]


def _mlp_pair(batch_size=8):
    w = np.arange(6, dtype=np.float32).reshape(3, 2) / 10.0
    jr = JaxRunner(apply_fn=lambda vs, x: x @ vs["w"] + 1.0,
                   variables={"w": w}, name="cs.mlp", batch_size=batch_size,
                   registry=JaxRegistry())
    reg = MetricsRegistry()
    pr = ModelRunner(apply_fn=lambda vs, x: x @ vs["w"] + 1.0,
                     variables={"w": w}, name="cs.mlp",
                     batch_size=batch_size, registry=reg, device="cpu")
    return jr, pr, reg


def test_one_compile_per_bucket_over_a_ragged_sweep():
    jr, pr, reg = _mlp_pair()
    rng = np.random.default_rng(0)
    for n in (1, 2, 3, 5, 7, 8, 11, 13, 16, 17):       # ragged sweep
        x = rng.normal(size=(n, 3)).astype(np.float32)
        # float32 sums of three products in either summation order
        np.testing.assert_allclose(pr.apply_batch(x), jr.apply_batch(x),
                                   rtol=0, atol=1e-6)
    assert _same(jr, pr) == 4                            # buckets 1 2 4 8
    for n in (1, 3, 9, 16):                              # cache hits only
        x = rng.normal(size=(n, 3)).astype(np.float32)
        pr.apply_batch(x)
        jr.apply_batch(x)
    assert _same(jr, pr) == 4
    fam = reg.family("mmlspark_jit_compile_total")
    assert sum(c.value for c in fam._children.values()) == 4
    assert _keys(pr.compile_stats()) == [
        f"apply/{b}/(3,)" for b in (1, 2, 4, 8)]
    assert pr.graph_stats() == {"captures": 0, "recaptures": 0,
                                "capture_seconds": {"runner.cs.mlp": []}}


def test_fused_decode_signature_compiles_three_then_none_across_requests():
    jr, pr = _pair("cs.sig")
    rng = np.random.default_rng(3)
    p1 = rng.integers(0, V, (3, 6)).astype(np.int32)
    np.testing.assert_array_equal(pr.decode(p1, max_new_tokens=4).tokens,
                                  jr.decode(p1, max_new_tokens=4).tokens)
    # prefill + fused step + on-device sampler
    assert _same(jr, pr) == 3
    p2 = rng.integers(0, V, (4, 5)).astype(np.int32)
    for r in (jr, pr):
        r.decode(p2, lengths=[5, 3, 2, 1], max_new_tokens=4)
    assert _same(jr, pr) == 3
    assert sorted(_keys(pr.compile_stats())) == [
        "prefill/4/8/16", "sample/4/None", "step/4/16/fused/None"]


def test_paged_step_is_flat_in_cache_length_dense_adds_two():
    jr, pr = _pair("cs.paged")
    prompts = np.random.default_rng(7).integers(0, V, (3, 8)).astype(
        np.int32)
    for r in (jr, pr):               # table_w = ceil((8 + new) / 32) = 1
        r.decode(prompts, max_new_tokens=8, kv_layout="paged", page_size=32)
    n_paged = _same(jr, pr)
    for r in (jr, pr):
        r.decode(prompts, max_new_tokens=24, kv_layout="paged",
                 page_size=32)
    assert _same(jr, pr) == n_paged
    for r in (jr, pr):
        r.decode(prompts, max_new_tokens=8)                # cache_len 16
    n_dense = _same(jr, pr)
    for r in (jr, pr):
        r.decode(prompts, max_new_tokens=24)               # cache_len 32
    assert _same(jr, pr) == n_dense + 2
    assert any("step_paged" in k for k in pr.compile_stats()["executables"])
    # the logits path keys its own (unfused) step
    for r in (jr, pr):
        r.decode(prompts, max_new_tokens=8, collect_logits=True)
    assert _same(jr, pr) == n_dense + 3


def _drain(dec, pending, exhausted):
    handles = []
    pending = list(pending)
    while pending or dec._arrivals or dec._live:
        while pending:
            try:
                p, b = pending[0]
                handles.append(dec.submit(p, max_new_tokens=b))
                pending.pop(0)
            except exhausted:
                break
        dec.step()
    return handles


def test_continuous_joins_mint_no_key_after_warmup():
    jr, pr = _pair("cs.cont")
    decs = [r.decode_stream(slots=4, prompt_bucket=8, max_new_tokens=9,
                            page_size=4) for r in (jr, pr)]
    for d in decs:
        d.warmup()
    n0 = _same(jr, pr)
    assert n0 == 3                        # join prefill, sampler, step
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, V, int(rng.integers(2, 9))).astype(np.int32)
               for _ in range(8)]
    budgets = [9, 4, 7, 2, 9, 5, 3, 8]
    got = [_drain(d, zip(prompts, budgets), exc)
           for d, exc in zip(decs, (JaxSlotsExhausted, SlotsExhausted))]
    assert _same(jr, pr) == n0
    for hj, hp in zip(*got):
        assert hp.status == hj.status == "ok"
        assert hp.tokens == [int(t) for t in hj.tokens]
    for d in decs:
        d.close()


def test_a_cow_split_compiles_the_page_clone_once():
    jr, pr = _pair("cs.cow")
    ps, budget = 4, 5
    base = np.random.default_rng(7).integers(1, 40, size=12).astype(np.int32)
    pools = [JaxPool(jr.module, num_pages=24, page_size=ps, name=jr.name,
                     registry=jr.registry),
             PagePool(pr.module, num_pages=24, page_size=ps, name=pr.name,
                      registry=pr.registry)]
    for r, pool in zip((jr, pr), pools):
        r.prefix_cache(ps, pool=pool)

    def cached(r, pool):
        return [int(t) for t in r.decode(
            base[None], max_new_tokens=budget, kv_layout="paged",
            page_size=ps, pool=pool, prefix_cache=True).tokens[0]]

    miss = [cached(r, p) for r, p in zip((jr, pr), pools)]   # retains
    assert miss[0] == miss[1]
    n_miss = _same(jr, pr)
    assert not any(k.startswith("cow_copy")
                   for k in _keys(pr.compile_stats()))
    # a full hit covers 11 of 12 positions, ending mid-page: the suffix
    # write on the shared third page splits it first
    hit = [cached(r, p) for r, p in zip((jr, pr), pools)]
    assert hit[0] == hit[1] == miss[0]
    assert _same(jr, pr) == n_miss + 1
    assert "cow_copy" in _keys(pr.compile_stats())
    hit = [cached(r, p) for r, p in zip((jr, pr), pools)]
    assert _same(jr, pr) == n_miss + 1    # the clone compiled once


def test_attribution_leaves_compile_stats_unchanged():
    """Every booking edge (a join, a mid-flight denial, a deadline leave,
    pad rows) on both packages' engines leaves ``compile_stats()`` as the
    warmup left it."""
    jr, pr = _pair("cs.att")
    stats = {}
    for r, pool_cls, clock_cls in ((jr, JaxPool, JaxClock),
                                   (pr, PagePool, FakeClock)):
        pool = pool_cls(r.module, num_pages=6, page_size=2, name=r.name,
                        registry=r.registry)
        clk = clock_cls()
        dec = r.decode_stream(slots=2, prompt_bucket=4, max_new_tokens=6,
                              pool=pool, clock=clk)
        dec.warmup()
        before = r.compile_stats()
        p = np.asarray([3, 1, 4, 1], np.int32)
        dec.submit(p, max_new_tokens=6)
        dec.submit(p + 1, max_new_tokens=6)      # one of these is denied
        while dec._arrivals or dec._live:
            dec.step()
        h = dec.submit(p, deadline_s=clk() + 0.1)  # expires mid-flight
        dec.step()
        clk.advance(1.0)
        while dec._arrivals or dec._live:
            dec.step()
        assert h.status == "expired"
        assert r.compile_stats() == before
        stats[r is pr] = before
        dec.close()
    assert _keys(stats[True]) == _keys(stats[False])
    assert stats[True]["compiles"] == stats[False]["compiles"]


def test_a_returned_output_does_not_change_under_a_second_call():
    _, pr, _ = _mlp_pair(batch_size=4)
    fn = pr.executable(4, (3,))
    a = np.ones((4, 3), np.float32)
    y1 = fn(a)
    want = y1.clone()
    y2 = fn(a * 5)
    assert torch.equal(y1, want) and not torch.equal(y1, y2)
    # decode keeps every step's logits: each is its own array
    _, lm = _pair("cs.logits")
    prompts = np.random.default_rng(1).integers(0, V, (2, 5)).astype(
        np.int32)
    res = lm.decode(prompts, max_new_tokens=4, collect_logits=True)
    assert res.logits.shape == (2, 4, V)
    assert not np.array_equal(res.logits[:, 0], res.logits[:, 1])


def test_out_of_range_positions_still_raise():
    _, pr = _pair("cs.pos")
    lm = pr.module
    toks = torch.zeros((1, 2), dtype=torch.int32)
    cache = lm.init_cache(1, 128)
    with pytest.raises(ValueError, match="max_len = 128"):
        lm(toks, positions=torch.tensor([[127, 128]]), kv_cache=cache)
    with pytest.raises(ValueError, match="max_len = 128"):
        port_runner._check_positions(lm, np.asarray([0, 128]))
    port_runner._check_positions(lm, np.asarray([0, 127]))


def test_the_dense_cache_is_reset_to_a_fresh_init_cache():
    _, pr = _pair("cs.dense")
    prompts = np.random.default_rng(2).integers(0, V, (2, 5)).astype(
        np.int32)
    first = pr.decode(prompts, max_new_tokens=6)
    st = pr._borrow_dense(2, 16)
    try:
        fresh = pr.module.init_cache(2, 16)
        for (k, v), (fk, fv) in zip(st.cache, fresh):
            assert torch.equal(k, fk) and torch.equal(v, fv)
    finally:
        pr._return_dense(st)
    again = pr.decode(prompts, max_new_tokens=6)
    np.testing.assert_array_equal(first.tokens, again.tokens)
    assert len(pr._dense) == 1            # one cache for the geometry
