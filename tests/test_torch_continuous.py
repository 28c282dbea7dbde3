"""Port parity for the continuous decode engine and the prefix cache
(``mmlspark_tpu_torch/models/runner.py``: ``ContinuousDecoder``,
``StreamHandle``, ``decode(prefix_cache=True)``, copy-on-write pages;
``models/prefix_cache.py``) against the JAX package on the CPU.

Each scenario is the reference's own (``tests/test_continuous_batching.py``
:104-384, ``tests/test_prefix_cache.py``:83-380), written once as a
function of a package namespace and run on both packages over the same
tiny LM (vocab 48, embed 32, 2 heads, 1 layer, causal; the flax init's
weights carried across by ``convert.transformer_state_dict_from_flax``):
the scenario's own laws hold in each package (stream tokens = one-shot
``decode`` of the prompt, cached = cold, the refcount ledger closed), and
the two packages' outcomes are equal — tokens and statuses exactly, page
counts, slots and counters exactly.  Tolerance: none; greedy tokens are
compared exactly (the tiny LM's logits agree within 1e-6 across the
packages, far from its top-two gaps).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mmlspark_tpu.models as jax_models
import mmlspark_tpu.models.runner as jax_runner_mod
import mmlspark_tpu.observability as jax_obs
import mmlspark_tpu.utils.resilience as jax_res
import mmlspark_tpu_torch.models as port_models
import mmlspark_tpu_torch.models.runner as port_runner_mod
import mmlspark_tpu_torch.observability as port_obs
import mmlspark_tpu_torch.utils.resilience as port_res
from mmlspark_tpu_torch.convert import transformer_state_dict_from_flax

V = 48
_LMS = {}


def _lm(layers=1):
    """The reference tests' tiny LM in both packages, one flax init."""
    if layers not in _LMS:
        ref = jax_models.TransformerEncoder(
            vocab_size=V, num_classes=V, embed_dim=32, num_heads=2,
            num_layers=layers, mlp_dim=64, max_len=128, causal=True,
            pool="none")
        variables = ref.init(jax.random.PRNGKey(0),
                             jnp.zeros((1, 4), jnp.int32))
        port = port_models.TransformerEncoder(
            vocab_size=V, num_classes=V, embed_dim=32, num_heads=2,
            num_layers=layers, mlp_dim=64, max_len=128, causal=True,
            pool="none")
        port.load_state_dict(transformer_state_dict_from_flax(variables,
                                                              port))
        _LMS[layers] = (ref, variables, port)
    return _LMS[layers]


class Pkg(types.SimpleNamespace):
    """One package's names, and a runner on the shared tiny LM."""

    def runner(self, name, layers=1, registry=None):
        ref, variables, port = _lm(layers)
        if self.which == "jax":
            return self.ModelRunner(module=ref, variables=variables,
                                    name=name, registry=registry)
        return self.ModelRunner(module=port, name=name, registry=registry,
                                device="cpu")

    def pool(self, runner, pages, ps=4, reg=None, name=None):
        return self.PagePool(runner.module, num_pages=pages, page_size=ps,
                             name=name or runner.name, registry=reg)


def _pkg(which, models, runner_mod, obs, res):
    return Pkg(which=which, ModelRunner=models.ModelRunner,
               PagePool=models.PagePool,
               SlotsExhausted=models.SlotsExhausted,
               ContinuousDecoder=models.ContinuousDecoder,
               PagePoolExhausted=models.PagePoolExhausted,
               EngineUnavailable=runner_mod.EngineUnavailable,
               EngineDraining=runner_mod.EngineDraining,
               MetricsRegistry=obs.MetricsRegistry,
               FakeClock=res.FakeClock,
               RestartSupervisor=res.RestartSupervisor)


PKGS = {"jax": _pkg("jax", jax_models, jax_runner_mod, jax_obs, jax_res),
        "port": _pkg("port", port_models, port_runner_mod, port_obs,
                     port_res)}


def both(scenario, *args):
    """Run ``scenario(pkg, *args)`` on each package; their outcomes must
    be equal."""
    got = {k: scenario(p, *args) for k, p in PKGS.items()}
    assert got["port"] == got["jax"], got
    return got["port"]


def _drain(P, dec, pending=None):
    handles = []
    pending = list(pending or [])
    while pending or dec._arrivals or dec._live:
        while pending:
            try:
                p, b = pending[0]
                handles.append(dec.submit(p, max_new_tokens=b))
                pending.pop(0)
            except P.SlotsExhausted:
                break
        dec.step()
    return handles


def _one_shot(runner, p, b, **kw):
    kw.setdefault("kv_layout", "paged")
    return list(runner.decode(np.asarray(p, np.int32)[None],
                              max_new_tokens=b, **kw).tokens[0])


def _ops(reg, runner, ps):
    fam = reg.family("mmlspark_runner_page_ops_total")
    return {op: fam.labels(runner=runner, page_size=str(ps), op=op).value
            for op in ("allocate", "extend", "free", "denied", "pin",
                       "cow")}


# ---------------------------------------------------------------------------
# the continuous engine (tests/test_continuous_batching.py:104-384)
# ---------------------------------------------------------------------------

def test_continuous_equals_one_shot_and_the_reference_across_ragged_arrivals():
    def scenario(P):
        runner = P.runner("c.ragged")
        dec = runner.decode_stream(slots=4, prompt_bucket=8,
                                   max_new_tokens=9, page_size=4)
        dec.warmup()
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, V, int(rng.integers(2, 9))).astype(
            np.int32) for _ in range(8)]
        budgets = [9, 4, 7, 2, 9, 5, 3, 8]
        hs = _drain(P, dec, list(zip(prompts, budgets)))
        assert len({h.slot for h in hs}) <= 4          # slots were reused
        for p, b, h in zip(prompts, budgets, hs):
            assert h.tokens == _one_shot(runner, p, b, page_size=4)
            assert list(h.result(timeout=1).tokens[0]) == h.tokens
        out = [(h.status, h.slot, [int(t) for t in h.tokens]) for h in hs]
        assert dec.pool.pages_in_use() == 0
        dec.close()
        return out, dec.steps, dec.joined, dec.left
    both(scenario)


def test_eos_leave_matches_one_shot_and_frees_the_slot():
    def scenario(P):
        runner = P.runner("c.eos")
        rng = np.random.default_rng(3)
        p = rng.integers(0, V, 6).astype(np.int32)
        eos = _one_shot(runner, p, 8, page_size=4)[2]
        ref = _one_shot(runner, p, 8, page_size=4, eos_id=eos)
        dec = runner.decode_stream(slots=2, prompt_bucket=8,
                                   max_new_tokens=8, eos_id=eos,
                                   page_size=4)
        q = rng.integers(0, V, 5).astype(np.int32)
        h1 = dec.submit(p, max_new_tokens=8)
        h2 = dec.submit(q, max_new_tokens=8)
        h3, seen_free = None, False
        while dec._arrivals or dec._live:
            dec.step()
            if h1.done.is_set() and h3 is None and dec._live:
                seen_free = True
                h3 = dec.submit(q, max_new_tokens=8)
        assert h1.status == "ok" and seen_free
        assert h1.tokens == ref[:len(h1.tokens)] and h1.tokens[-1] == eos
        assert set(ref[len(h1.tokens):]) <= {eos}
        ref_q = _one_shot(runner, q, 8, page_size=4, eos_id=eos)
        for h in (h2, h3):
            assert h.status == "ok"
            assert h.tokens == ref_q[:len(h.tokens)]
        dec.close()
        return [(h.status, h.slot, [int(t) for t in h.tokens])
                for h in (h1, h2, h3)]
    both(scenario)


def test_freed_slot_pages_fund_later_requests_while_batch_runs():
    def scenario(P):
        reg = P.MetricsRegistry()
        runner = P.runner("c.reuse", registry=reg)
        pool = P.pool(runner, 7, 2, reg)
        dec = runner.decode_stream(slots=2, prompt_bucket=4,
                                   max_new_tokens=6, pool=pool)
        rng = np.random.default_rng(5)
        A, B, C = (rng.integers(0, V, 4).astype(np.int32) for _ in range(3))
        hA = dec.submit(A, max_new_tokens=2)
        hB = dec.submit(B, max_new_tokens=6)
        hC = None
        while dec._arrivals or dec._live:
            dec.step()
            if hA.done.is_set() and hC is None:
                hC = dec.submit(C, max_new_tokens=2)  # only fits if A freed
        for p, b, h in ((A, 2, hA), (B, 6, hB), (C, 2, hC)):
            assert h.status == "ok"
            assert h.tokens == _one_shot(runner, p, b, page_size=2,
                                         pool=pool)
        assert pool.pages_in_use() == 0
        ops = _ops(reg, "c.reuse", 2)
        assert ops["denied"] == 0
        assert ops["free"] == ops["allocate"] + ops["extend"]
        dec.close()
        return ops, pool.high_water, [h.tokens for h in (hA, hB, hC)]
    both(scenario)


def test_admission_control_sheds_on_slots_and_pages():
    def scenario(P):
        reg = P.MetricsRegistry()
        runner = P.runner("c.admit", registry=reg)
        pool = P.pool(runner, 4, 2, reg)
        dec = runner.decode_stream(slots=2, prompt_bucket=4,
                                   max_new_tokens=2, pool=pool)
        p = np.asarray([1, 2, 3, 4], np.int32)
        dec.submit(p)
        dec.submit(np.asarray([1], np.int32))
        with pytest.raises(P.SlotsExhausted) as ei:
            dec.submit(p)
        assert ei.value.shed is True and dec.occupancy() == 2
        dec.close()
        assert pool.pages_in_use() == 0 and dec.occupancy() == 0
        dec2 = runner.decode_stream(slots=2, prompt_bucket=4,
                                    max_new_tokens=2, pool=pool)
        pool.allocate(2)                          # external hold
        with pytest.raises(P.PagePoolExhausted) as ei2:
            dec2.submit(p)
        assert ei2.value.shed is True and dec2.occupancy() == 0
        dec2.close()
        return _ops(reg, "c.admit", 2)
    assert both(scenario)["denied"] == 2.0


def test_idle_stream_adopts_resized_pool():
    def scenario(P):
        runner = P.runner("c.resize")
        dec = runner.decode_stream(slots=2, prompt_bucket=4,
                                   max_new_tokens=2, page_size=2)
        h = dec.submit(np.asarray([1, 2], np.int32))
        _drain(P, dec)
        old = dec.pool
        new = runner.page_pool(2, num_pages=64)
        assert new is not old and new.num_pages == 64
        h2 = dec.submit(np.asarray([3, 4], np.int32))
        assert dec.pool is new and new.pages_in_use() > 0
        _drain(P, dec)
        assert new.pages_in_use() == 0
        dec.close()
        return h.status, h.tokens, h2.status, h2.tokens
    both(scenario)


def test_stream_mid_flight_denial_resolves_denied_and_slot_recovers():
    def scenario(P):
        reg = P.MetricsRegistry()
        runner = P.runner("c.deny", registry=reg)
        pool = P.pool(runner, 6, 2, reg)
        dec = runner.decode_stream(slots=2, prompt_bucket=4,
                                   max_new_tokens=6, pool=pool)
        p = np.asarray([3, 1, 4, 1], np.int32)
        hA = dec.submit(p, max_new_tokens=6)
        hB = dec.submit(p + 1, max_new_tokens=6)
        _drain(P, dec)
        assert sorted([hA.status, hB.status]) == ["denied", "ok"]
        denied = hA if hA.status == "denied" else hB
        assert 1 <= len(denied.tokens) < 6
        assert denied.result(timeout=1).extras["status"] == "denied"
        assert pool.pages_in_use() == 0
        fam = reg.family("mmlspark_runner_slots_left_total")
        left = {o: fam.labels(runner="c.deny", outcome=o).value
                for o in ("ok", "denied")}
        dec.close()
        return hA.status, hA.tokens, hB.status, hB.tokens, left
    both(scenario)


def test_ttft_and_occupancy_metrics_on_fake_clock():
    def scenario(P):
        clk = P.FakeClock()
        reg = P.MetricsRegistry()
        runner = P.runner("c.clock", registry=reg)
        dec = runner.decode_stream(slots=4, prompt_bucket=4,
                                   max_new_tokens=3, page_size=2, clock=clk)
        occ = reg.family("mmlspark_runner_slot_occupancy_pct").labels(
            runner="c.clock")
        seen = [occ.value]
        p = np.asarray([5, 7], np.int32)
        h1, h2 = dec.submit(p), dec.submit(p + 1)
        seen.append(occ.value)
        clk.advance(0.125)
        dec.step()
        ttft = reg.family("mmlspark_runner_ttft_seconds").labels(
            runner="c.clock")
        assert ttft.count == 2 and abs(ttft.sum - 0.25) < 1e-9
        assert h1.ttft_s == h2.ttft_s == 0.125
        while dec._live:
            dec.step()
        seen.append(occ.value)
        h3 = dec.submit(p, deadline_s=clk() + 0.5)
        dec.step()
        clk.advance(1.0)
        dec.step()
        left = reg.family("mmlspark_runner_slots_left_total")
        dec.close()
        return (seen, h3.status, h3.tokens,
                left.labels(runner="c.clock", outcome="ok").value,
                left.labels(runner="c.clock", outcome="expired").value,
                reg.family("mmlspark_runner_slots_joined_total").labels(
                    runner="c.clock").value)
    got = both(scenario)
    assert got[0] == [0.0, 50.0, 0.0] and got[1] == "expired"


def test_debug_state_and_the_token_ledger_equal_the_reference():
    def scenario(P):
        reg = P.MetricsRegistry()
        runner = P.runner("c.ledger", registry=reg)
        dec = runner.decode_stream(slots=3, prompt_bucket=8,
                                   max_new_tokens=5, page_size=4)
        rng = np.random.default_rng(9)
        hs = _drain(P, dec, [(rng.integers(0, V, n).astype(np.int32), b)
                             for n, b in ((3, 5), (7, 2), (5, 4), (2, 5))])
        st = dec.debug_state()
        st.pop("watchdog", None)
        fam = reg.family("mmlspark_decode_tokens_outcome_total")
        ledger = {o: fam.labels(outcome=o).value
                  for o in ("useful", "pad_row")}
        costs = [{k: v for k, v in h.cost.as_dict().items()
                  if k in ("prefill_tokens", "decode_tokens",
                           "prefill_cached")} for h in hs]
        dec.close()
        return st, ledger, costs
    both(scenario)


# ---------------------------------------------------------------------------
# the prefix cache (tests/test_prefix_cache.py:83-380)
# ---------------------------------------------------------------------------

def _assert_no_free_while_referenced(pool):
    assert not set(pool._free) & set(pool._ref)


def test_refcount_pin_share_free_and_double_free_guard():
    def scenario(P):
        pool = P.PagePool(None, num_pages=6, page_size=4, name="px.ref")
        a, b = pool.allocate(2)
        got = pool.allocate(1, shared=[a])
        c = got[1]
        assert got[0] == a and c not in (a, b)
        assert pool.refcount(a) == 2 and pool.refcount(b) == 1
        pool.free([a])
        assert pool.refcount(a) == 1 and a not in pool._free
        pool.free([a])
        assert pool.refcount(a) == 0 and a in pool._free
        with pytest.raises(ValueError, match="double free"):
            pool.free([a])
        with pytest.raises(ValueError, match="not allocated"):
            pool.pin([a])
        pool.pin([b])
        pool.free([b])
        pool.free([b])
        pool.free([c])
        with pytest.raises(ValueError, match="trash page"):
            pool.free([0])
        held = pool.allocate(5)
        with pytest.raises(P.PagePoolExhausted):
            pool.allocate(1, shared=[held[0]])
        assert pool.refcount(held[0]) == 1
        return a, b, c, held, pool.high_water
    both(scenario)


def test_one_shot_cached_equals_cold_on_hit_partial_miss_and_cow():
    def scenario(P):
        reg = P.MetricsRegistry()
        runner = P.runner("px.oneshot", registry=reg)
        ps, budget = 4, 5
        rng = np.random.default_rng(7)
        base = rng.integers(1, 40, size=12).astype(np.int32)
        partial = base.copy()
        partial[8:] = [41, 42, 43, 44]
        cold = {k: _one_shot(runner, p, budget, page_size=ps,
                             pool=P.pool(runner, 24, ps, reg))
                for k, p in (("base", base), ("partial", partial))}
        pool = P.pool(runner, 24, ps, reg)
        idx = runner.prefix_cache(ps, pool=pool)

        def cached(p):
            return _one_shot(runner, p, budget, page_size=ps, pool=pool,
                             prefix_cache=True)

        assert cached(base) == cold["base"]           # miss
        assert cached(base) == cold["base"]           # full hit, mid-page
        assert cached(partial) == cold["partial"]     # 2-page partial hit
        assert pool.pages_in_use() == idx.retained_pages() > 0
        _assert_no_free_while_referenced(pool)
        counters = {n: reg.family(f"mmlspark_prefix_{n}_total").labels(
            runner="px.oneshot").value
            for n in ("hits", "hit_tokens", "cow_splits")}
        return cold, counters, idx.stats(), _ops(reg, "px.oneshot", ps), \
            runner.last_decode_extras["prefix"]
    got = both(scenario)
    assert got[1]["hits"] == 2 and got[1]["cow_splits"] > 0


def test_one_shot_pressure_evicts_retention_not_live_pages():
    def scenario(P):
        reg = P.MetricsRegistry()
        runner = P.runner("px.pressure", registry=reg)
        ps, budget = 4, 4
        rng = np.random.default_rng(11)
        p1, p2 = (rng.integers(1, 40, size=12).astype(np.int32)
                  for _ in range(2))
        cold2 = _one_shot(runner, p2, budget, page_size=ps,
                          pool=P.pool(runner, 24, ps, reg))
        pool = P.pool(runner, 5, ps, reg)
        idx = runner.prefix_cache(ps, pool=pool)
        _one_shot(runner, p1, budget, page_size=ps, pool=pool,
                  prefix_cache=True)
        assert idx.retained_pages() == 4
        assert _one_shot(runner, p2, budget, page_size=ps, pool=pool,
                         prefix_cache=True) == cold2
        _assert_no_free_while_referenced(pool)
        return reg.family("mmlspark_prefix_evictions_total").labels(
            runner="px.pressure", reason="pressure").value, idx.stats()
    assert both(scenario)[0] >= 4


def test_continuous_cached_equals_cold_and_books_the_prefill_cached_lane():
    def scenario(P):
        reg = P.MetricsRegistry()
        runner = P.runner("px.stream", registry=reg)
        ps, budget = 4, 6
        rng = np.random.default_rng(3)
        base = rng.integers(1, 40, size=12).astype(np.int32)
        partial = base.copy()
        partial[8:] = [41, 42, 43, 44]
        cold = {k: _one_shot(runner, p, budget, page_size=ps,
                             pool=P.pool(runner, 24, ps, reg))
                for k, p in (("base", base), ("partial", partial))}
        pool = P.pool(runner, 32, ps, reg)
        dec = runner.decode_stream(slots=2, prompt_bucket=16,
                                   max_new_tokens=budget, page_size=ps,
                                   pool=pool, prefix_cache=True)
        h1 = _drain(P, dec, [(base, budget)])[0]
        h2, h3 = _drain(P, dec, [(base, budget), (partial, budget)])
        assert h1.covered == 0 and (h2.covered, h3.covered) == (11, 8)
        assert h2.tokens == cold["base"] and h3.tokens == cold["partial"]
        assert h2.cost.as_dict()["prefill_cached"] == 11
        st = dec.debug_state()["prefix_cache"]
        assert st["retained_pages"] == pool.pages_in_use()
        _assert_no_free_while_referenced(pool)
        dec.close()
        return st, [h.tokens for h in (h1, h2, h3)]
    got = both(scenario)
    assert got[0]["hits"] == 2 and got[0]["misses"] == 1


def test_index_eviction_never_yanks_a_live_requests_pages():
    def scenario(P):
        reg = P.MetricsRegistry()
        runner = P.runner("px.live", registry=reg)
        ps, budget = 4, 6
        base = np.random.default_rng(9).integers(1, 40, size=12).astype(
            np.int32)
        cold = _one_shot(runner, base, budget, page_size=ps,
                         pool=P.pool(runner, 24, ps, reg))
        pool = P.pool(runner, 32, ps, reg)
        dec = runner.decode_stream(slots=2, prompt_bucket=16,
                                   max_new_tokens=budget, page_size=ps,
                                   pool=pool, prefix_cache=True)
        _drain(P, dec, [(base, budget)])
        idx = dec.index
        h = dec.submit(base, max_new_tokens=budget)
        dec.step()
        shared_pages = list(h.pages[:2])
        assert h.covered == 11
        assert all(pool.refcount(p) >= 2 for p in shared_pages)
        idx.evict_pages(idx.retained_pages(), reason="pressure")
        assert idx.retained_pages() == 0
        assert all(pool.refcount(p) == 1 for p in shared_pages)
        assert all(p not in pool._free for p in shared_pages)
        while dec._live or dec._arrivals:
            dec.step()
        assert h.status == "ok" and h.tokens == cold
        dec.close()
        return h.tokens, shared_pages
    both(scenario)


def test_early_finisher_frees_while_sharing_keeps_pages_resident():
    def scenario(P):
        reg = P.MetricsRegistry()
        runner = P.runner("px.early", registry=reg)
        ps = 4
        base = np.random.default_rng(13).integers(1, 40, size=12).astype(
            np.int32)
        cold_long = _one_shot(runner, base, 6, page_size=ps,
                              pool=P.pool(runner, 24, ps, reg))
        pool = P.pool(runner, 32, ps, reg)
        dec = runner.decode_stream(slots=2, prompt_bucket=16,
                                   max_new_tokens=6, page_size=ps,
                                   pool=pool, prefix_cache=True)
        _drain(P, dec, [(base, 6)])
        h_long = dec.submit(base, max_new_tokens=6)
        h_short = dec.submit(base, max_new_tokens=2)
        while h_short.status in ("queued", "live"):
            dec.step()
        assert h_short.status == "ok" and h_long.status == "live"
        assert all(pool.refcount(p) >= 1 for p in h_long.pages[:3])
        _assert_no_free_while_referenced(pool)
        while dec._live or dec._arrivals:
            dec.step()
        assert h_long.tokens == cold_long
        assert h_short.tokens == cold_long[:2]
        dec.close()
        return h_long.tokens, h_short.tokens, _ops(reg, "px.early", ps)
    both(scenario)


def test_resized_pool_flushes_index_and_rebinds():
    def scenario(P):
        reg = P.MetricsRegistry()
        runner = P.runner("px.resize", registry=reg)
        ps, budget = 4, 4
        base = np.random.default_rng(17).integers(1, 40, size=12).astype(
            np.int32)
        pool = P.pool(runner, 16, ps, reg)
        idx = runner.prefix_cache(ps, pool=pool)
        _one_shot(runner, base, budget, page_size=ps, pool=pool,
                  prefix_cache=True)
        retained = idx.retained_pages()
        new_pool = pool.resized(24)
        booked = reg.family("mmlspark_prefix_evictions_total").labels(
            runner="px.resize", reason="pool_replaced").value
        assert booked == retained > 0 and idx.retained_pages() == 0
        assert pool.prefix_index is None and new_pool.prefix_index is idx
        assert runner.prefix_cache(ps, pool=new_pool) is idx
        assert idx.lookup(base) == ([], 0)
        assert pool.pages_in_use() == 0
        got = _one_shot(runner, base, budget, page_size=ps, pool=new_pool,
                        prefix_cache=True)
        assert got == _one_shot(runner, base, budget, page_size=ps,
                                pool=P.pool(runner, 24, ps, reg))
        held = new_pool.allocate(2)                   # a live holder
        with pytest.raises(RuntimeError, match="busy"):
            new_pool.resized(32)
        new_pool.free(held)
        return retained, got
    both(scenario)


def test_prefix_cache_needs_the_paged_greedy_path():
    for P in PKGS.values():
        runner = P.runner("px.args")
        prompts = np.zeros((2, 4), np.int32) + 3
        with pytest.raises(ValueError, match="kv_layout='paged'"):
            runner.decode(prompts, prefix_cache=True)
        with pytest.raises(ValueError, match="greedy fused path"):
            runner.decode(prompts, kv_layout="paged", prefix_cache=True,
                          collect_logits=True)


# ---------------------------------------------------------------------------
# supervised recovery (tests/test_tail_tolerance.py:223-318)
# ---------------------------------------------------------------------------

def test_stall_abort_resolves_live_requests_and_the_rebuild_equals_one_shot(
        monkeypatch):
    """The stall drill: a continuous scorer with two live requests is
    poison-aborted as the watchdog would; both shed ``shed_engine_stall``,
    the rebuild waits out its backoff (``engine_restarting``), the first
    request the rebuilt engine serves equals one-shot, and the third stall
    in the window quarantines the runner.  The engines are stepped by hand
    (``start`` runs no thread here) so the abort lands between steps."""
    def scenario(P):
        monkeypatch.setattr(P.ContinuousDecoder, "start", lambda self: self)
        clk = P.FakeClock()
        reg = P.MetricsRegistry()
        runner = P.runner("sup.cont", registry=reg)
        sup = P.RestartSupervisor(initial_backoff_s=0.5, backoff_cap_s=8.0,
                                  quarantine_stalls=3,
                                  quarantine_window_s=300.0, clock=clk)
        scorer = runner.scorer(mode="decode", continuous=True, slots=2,
                               prompt_bucket=8, max_new_tokens=3,
                               page_size=4, supervisor=sup)
        verdicts, reasons, served = [], [], []

        def resolve(**kw):
            verdicts.append((kw["status"], kw["verdict"]))

        prompts = [np.asarray([5, 7, 11], np.int32),
                   np.asarray([9, 2], np.int32)]
        restarts = reg.family("mmlspark_engine_restarts_total").labels(
            runner="sup.cont")
        for _ in range(3):
            dec = scorer._ensure_decoder()
            if restarts.value:
                # the rebuilt engine's first request equals one-shot
                h = dec.submit(prompts[0])
                _drain(P, dec)
                served.append(h.tokens)
                assert h.tokens == _one_shot(runner, prompts[0], 3,
                                             page_size=4)
            for p in prompts:
                scorer._continuous_submit(p, resolve)
            dec.step()                   # both joined and live
            assert dec._live == 2
            dec._stall_abort("dispatch", 99.0)
            assert dec.pool.pages_in_use() == 0 and dec.occupancy() == 0
            with pytest.raises(P.EngineUnavailable) as exc:
                scorer._ensure_decoder()
            reasons.append(exc.value.shed_reason)
            assert exc.value.shed is True
            clk.advance(exc.value.retry_after_s + 0.1)
        assert verdicts == [(503, "shed_engine_stall")] * 6
        assert reasons == ["engine_restarting", "engine_restarting",
                           "engine_quarantined"]
        assert scorer.serving_healthy is False and sup.quarantined
        scorer.continuous_close()
        return verdicts, reasons, served, restarts.value
    got = both(scenario)
    assert got[3] == 2.0 and len(got[2]) == 2


def test_a_stall_abort_racing_the_engine_thread_resolves_and_frees():
    """On the engine thread, an abort from another thread while requests
    are live resolves every handle, frees every page, and the rebuilt
    engine's first request equals one-shot (the aborted thread touches no
    slot state after the teardown)."""
    P = PKGS["port"]
    runner = P.runner("sup.race")
    for _ in range(3):
        dec = runner.decode_stream(slots=2, prompt_bucket=8,
                                   max_new_tokens=100, page_size=4).start()
        hs = [dec.submit(np.asarray(p, np.int32)) for p in ([5, 7], [9])]
        for h in hs:
            while h.status == "queued":
                h.done.wait(0.001)
        dec._stall_abort("dispatch", 99.0)
        for h in hs:
            assert h.done.wait(30) and h.status in ("error", "ok")
        assert dec.pool.pages_in_use() == 0 and dec.occupancy() == 0
    dec = runner.decode_stream(slots=2, prompt_bucket=8, max_new_tokens=4,
                               page_size=4).start()
    h = dec.submit(np.asarray([5, 7], np.int32))
    assert h.done.wait(30) and h.status == "ok"
    assert h.tokens == _one_shot(runner, [5, 7], 4, page_size=4)
    dec.close()
