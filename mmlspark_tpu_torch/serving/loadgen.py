"""Concurrent HTTP load generator for serving benchmarks and CI gates.

One implementation shared by ``bench.py``'s sustained-load phase and
``tests/test_serving_latency.py`` so the reported metric and the CI gate
can never drift apart.  Reference context: the reference's serving claims
are about SUSTAINED throughput (``docs/mmlspark-serving.md:10-11``), not
single-connection latency.

``mixed_load`` drives several request classes — e.g. vector
scoring AND generative decode — through one shared measurement window, the
traffic shape the multi-model serving-fleet ROADMAP item needs a generator
for: per-class latency percentiles under combined load, not per-class runs
that never contend.

Per-class gates: a workload may carry ``"gates": {"p99_ms":
..., "p50_ms": ..., "max_error_rate": ..., "min_rps": ...}`` and its
result gains a ``"gates"`` verdict — pass/fail per class with every
limit/actual pair, the ROADMAP's "per-class p99 gates" hook reused by the
fleet E2E suite and bench.

TTFT gates: decode classes care about FIRST-token latency, not
just whole-response p99 — a ticked drain that batches arrivals serves a
fine p99 at low load while every request waits out the flush tick before
its first token.  A workload carrying ``"ttft_key": "ttft_ms"`` has each
2xx reply body parsed as JSON and that field collected (the continuous
decode scorer reports it in-band via ``report_ttft=True``: engine-measured
admission→first-token; the ticked scorer reports its honest value — the
full latency, since no token is client-visible before the batch resolves).
The class's stats gain ``ttft_p50_ms``/``ttft_p99_ms``/``ttft_count`` and
the gate spec accepts ``ttft_p99_ms``/``ttft_p50_ms`` upper bounds.

Goodput accounting: a workload carrying ``"tokens_key":
"tokens"`` has each 2xx reply body parsed and that field counted as
decode tokens (a list counts ``len``, a number its value) — the class's
stats gain ``decode_tokens``/``decode_tokens_per_sec`` so mixed-class
runs report per-class token throughput, the denominator the fleet
capacity model is judged against.  ``check_gates`` accepts
``min_goodput_pct``, a lower bound on the ``goodput_pct`` the caller
folds into ``stats`` (from ``GET /fleet/capacity``); it fails on zero
``goodput_samples`` — never vacuous.

Template-sharing traffic: a workload carrying
``"prompt_pool": {"prefixes": [...], "suffixes": [...]}`` builds each
request's body per-request — shared prefix (cycled from ``prefixes``) +
per-request suffix (cycled from ``suffixes``) — instead of a static
``body``, the traffic shape whose prefill the cross-request prefix cache
exists to skip.  ``check_gates`` accepts ``min_prefix_hit_pct``, a lower
bound on the ``prefix_hit_rate_pct`` the caller folds into ``stats``
(with ``prefix_lookups`` as its no-vacuous-pass sample count, e.g. from
the engine's ``debug_state()["prefix_cache"]``).
"""
from __future__ import annotations

import http.client
import json
import threading
import time
from typing import Any, Dict, List, Optional, Sequence


def check_gates(gates: Dict[str, float],
                stats: Dict[str, float]) -> Dict[str, Any]:
    """Evaluate one class's gate spec against its measured stats.

    Known gates: ``p99_ms`` / ``p50_ms`` (upper bounds on the measured
    percentiles), ``max_error_rate`` (lost + non-2xx requests over the
    class's INTENDED request count when ``stats`` carries ``intended`` —
    a client thread dying mid-run loses every remaining request, not one
    "error" — else the legacy transport-errors/attempts ratio),
    ``max_failed`` (upper bound on the absolute COUNT of lost + non-2xx
    requests — the zero-drop drills gate on ``max_failed: 0``),
    ``min_rps`` (lower bound on completed-request throughput).  Unknown
    gate keys fail loudly — a typo'd gate that silently always passes is
    worse than no gate."""
    checks: Dict[str, Dict[str, float]] = {}
    failures: List[str] = []

    def book(name: str, actual: float, limit: float, ok: bool) -> None:
        checks[name] = {"limit": limit, "actual": actual, "ok": ok}
        if not ok:
            failures.append(f"{name}: {actual:.4g} vs limit {limit:.4g}")

    for name, limit in gates.items():
        limit = float(limit)
        if name in ("p99_ms", "p50_ms"):
            # a class that completed NOTHING reports 0.0 percentiles — a
            # vacuous pass there would wave a totally dead class through
            # its latency gate, the exact silent failure gates exist for
            ok = stats["completed"] > 0 and stats[name] <= limit
            book(name, stats[name], limit, ok)
        elif name in ("ttft_p99_ms", "ttft_p50_ms"):
            # same no-vacuous-pass rule, on the TTFT sample count: a class
            # whose replies never carried the ttft field (no ttft_key, or
            # a server that does not report it) must FAIL its ttft gate
            # rather than pass on a 0.0 placeholder
            actual = stats.get(name, 0.0)
            ok = stats.get("ttft_count", 0.0) > 0 and actual <= limit
            book(name, actual, limit, ok)
        elif name == "max_error_rate":
            intended = stats.get("intended", 0.0)
            if intended > 0:
                bad = max(0.0, intended - stats["completed"]) \
                    + stats.get("non_2xx", 0.0)
                rate = bad / intended
            else:
                attempts = stats["completed"] + stats["errors"]
                bad = stats["errors"] + stats.get("non_2xx", 0.0)
                rate = bad / attempts if attempts else 1.0
            book(name, rate, limit, rate <= limit)
        elif name == "max_failed":
            # absolute count of failed requests (lost + non-2xx), the
            # rolling-restart drill's gate: "zero dropped requests" is a
            # COUNT invariant — a rate gate would wave through one drop
            # per thousand, which is exactly the drop drains must not make
            intended = stats.get("intended", 0.0)
            bad = max(0.0, intended - stats["completed"]) \
                + stats.get("non_2xx", 0.0)
            book(name, bad, limit, bad <= limit)
        elif name == "min_rps":
            book(name, stats["rps"], limit, stats["rps"] >= limit)
        elif name == "min_goodput_pct":
            # lower bound on useful-token share.  The caller
            # folds the fleet ledger's goodput into stats as
            # goodput_pct/goodput_samples (e.g. from GET /fleet/capacity);
            # zero samples FAIL — a run whose ledger recorded no tokens
            # must not pass a goodput gate on a 0.0 placeholder
            actual = stats.get("goodput_pct", 0.0)
            ok = stats.get("goodput_samples", 0.0) > 0 and actual >= limit
            book(name, actual, limit, ok)
        elif name == "min_prefix_hit_pct":
            # lower bound on the prefix-cache hit rate.  The
            # caller folds the engine's index stats into stats as
            # prefix_hit_rate_pct/prefix_lookups (e.g. from the decoder's
            # debug_state()["prefix_cache"]: hits+misses = lookups); zero
            # lookups FAIL — a run that never consulted the index must
            # not pass a hit-rate gate on a 0.0 placeholder
            actual = stats.get("prefix_hit_rate_pct", 0.0)
            ok = stats.get("prefix_lookups", 0.0) > 0 and actual >= limit
            book(name, actual, limit, ok)
        else:
            raise ValueError(f"unknown gate {name!r}; expected one of "
                             "p99_ms/p50_ms/ttft_p99_ms/ttft_p50_ms/"
                             "max_error_rate/max_failed/min_rps/"
                             "min_goodput_pct/min_prefix_hit_pct")
    return {"passed": not failures, "failures": failures, "checks": checks}


def mixed_load(host: str, port: int,
               workloads: Sequence[Dict[str, Any]],
               warm: int = 10) -> Dict[str, Dict[str, Any]]:
    """Fire several request classes concurrently through one wall-clock
    window.

    Each workload is ``{"name", "path", "body", "headers", "n_clients",
    "per_client"}`` (``n_clients`` default 4, ``per_client`` default 100)
    plus an optional ``"prompt_pool"`` spec replacing the static ``body``
    with per-request bodies — ``{"prefixes": [token lists...],
    "suffixes": [token lists...]}``, each request JSON-encoding one
    cycled prefix + one cycled suffix (the template-sharing
    shape), an optional ``"gates"`` spec (see :func:`check_gates`), an
    optional ``"ttft_key"`` naming the reply-body field carrying in-band
    first-token latency (adds ``ttft_p50_ms``/``ttft_p99_ms``/
    ``ttft_count`` to the class's stats; see the module docstring), and an
    optional ``"tokens_key"`` naming the reply-body field carrying the
    generated tokens (adds ``decode_tokens``/``decode_tokens_per_sec``).  Every
    client opens its own persistent connection, fires ``warm`` untimed
    requests, then waits on ONE barrier shared by every workload — the
    clock starts when the whole mixed fleet is warm, so the classes
    genuinely contend for the server for the entire window.  Worker
    exceptions are caught and counted; a dying connection deflates (never
    inflates) its class's numbers.

    Returns ``{workload_name: {"rps", "p50_ms", "p99_ms", "completed",
    "errors", "non_2xx"[, "gates"]}, "combined": {...}}`` — per-class RPS
    shares the combined wall window, so the numbers add up; ``non_2xx``
    counts completed exchanges whose status was not 2xx (sheds, timeouts)
    so overload is visible without changing the completed/latency
    semantics.  Raises AssertionError if no request of any class
    completed.
    """
    names = [w["name"] for w in workloads]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate workload names: {sorted(names)} — "
                         "per-class attribution would silently merge them")
    for w in workloads:
        spec = w.get("prompt_pool")
        if spec is not None and not spec.get("prefixes"):
            # validated HERE, not in the worker threads, where a raise
            # would be swallowed into the class's error count
            raise ValueError(f"workload {w['name']!r}: prompt_pool needs a "
                             "non-empty 'prefixes' list")
    lats: Dict[str, List[float]] = {w["name"]: [] for w in workloads}
    errors: Dict[str, List[str]] = {w["name"]: [] for w in workloads}
    non_2xx: Dict[str, int] = {w["name"]: 0 for w in workloads}
    ttfts: Dict[str, List[float]] = {w["name"]: [] for w in workloads}
    tokens: Dict[str, float] = {w["name"]: 0.0 for w in workloads}
    lock = threading.Lock()
    total_clients = sum(int(w.get("n_clients", 4)) for w in workloads)
    barrier = threading.Barrier(total_clients + 1)

    def fire(w: Dict[str, Any]):
        name = w["name"]
        headers = w.get("headers") or {}
        ttft_key = w.get("ttft_key")
        tokens_key = w.get("tokens_key")
        pool_spec = w.get("prompt_pool")
        if pool_spec is None:
            body = w["body"]

            def next_body() -> str:
                return body
        else:
            # template-sharing traffic: shared prefix × per-
            # request suffix, both cycled deterministically so repeated
            # runs replay the same prompt stream — every repeat of a
            # prefix is a prefix-cache hit opportunity
            prefixes = [list(p) for p in pool_spec["prefixes"]]
            suffixes = [list(s) for s in
                        (pool_spec.get("suffixes") or [[]])]
            seq = iter(range(10 ** 9))

            def next_body() -> str:
                i = next(seq)
                return json.dumps(prefixes[i % len(prefixes)]
                                  + suffixes[i % len(suffixes)])
        mine: List[float] = []
        mine_ttft: List[float] = []
        mine_bad = 0
        mine_tokens = 0.0
        try:
            conn = http.client.HTTPConnection(host, port, timeout=30)
            for _ in range(warm):
                conn.request("POST", w["path"], next_body(), headers)
                conn.getresponse().read()
        except Exception as e:  # noqa: BLE001 - a dead warm-up is an error
            with lock:
                errors[name].append(f"warmup: {e!r}")
            try:
                barrier.wait(timeout=60)
            except Exception:  # noqa: BLE001
                pass
            return
        try:
            barrier.wait(timeout=60)
        except Exception:  # noqa: BLE001
            return
        try:
            for _ in range(int(w.get("per_client", 100))):
                t0 = time.perf_counter()
                conn.request("POST", w["path"], next_body(), headers)
                resp = conn.getresponse()
                data = resp.read()
                mine.append(time.perf_counter() - t0)
                if not 200 <= resp.status < 300:
                    mine_bad += 1
                elif ttft_key or tokens_key:
                    # in-band TTFT: the decode scorer reports first-token
                    # latency inside the reply body (see module docstring);
                    # a reply without the field just contributes no sample
                    # — the ttft gate fails on a zero sample count
                    try:
                        reply = json.loads(data.decode())
                    except (ValueError, AttributeError):
                        reply = None
                    if isinstance(reply, dict):
                        if ttft_key:
                            val = reply.get(ttft_key)
                            if val is not None:
                                mine_ttft.append(float(val))
                        if tokens_key:
                            # generated tokens: a (possibly row-nested)
                            # list counts its leaves, a bare number counts
                            # its value — only DELIVERED (2xx) tokens
                            # count, matching the ledger's "useful" lane
                            tok = reply.get(tokens_key)
                            if isinstance(tok, (list, tuple)):
                                mine_tokens += sum(
                                    len(r) if isinstance(r, (list, tuple))
                                    else 1 for r in tok)
                            elif isinstance(tok, (int, float)):
                                mine_tokens += float(tok)
        except Exception as e:  # noqa: BLE001 - count what completed
            with lock:
                errors[name].append(repr(e))
        finally:
            with lock:
                lats[name].extend(mine)
                non_2xx[name] += mine_bad
                ttfts[name].extend(mine_ttft)
                tokens[name] += mine_tokens

    threads = [threading.Thread(target=fire, args=(w,))
               for w in workloads for _ in range(int(w.get("n_clients", 4)))]
    for t in threads:
        t.start()
    barrier.wait(timeout=120)      # clock starts once the whole fleet is warm
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = max(time.perf_counter() - t0, 1e-9)

    def stats(vals: List[float], errs: List[str], bad: int
              ) -> Dict[str, float]:
        vals = sorted(vals)
        # the percentile keys are part of the return contract even for a
        # class that completed nothing (0.0, with completed==0 saying why)
        return {"rps": len(vals) / wall, "completed": float(len(vals)),
                "errors": float(len(errs)), "non_2xx": float(bad),
                "p50_ms": 1000 * vals[len(vals) // 2] if vals else 0.0,
                "p99_ms": 1000 * vals[int(len(vals) * 0.99)] if vals else 0.0}

    def ttft_stats(vals: List[float]) -> Dict[str, float]:
        vals = sorted(vals)
        return {"ttft_count": float(len(vals)),
                "ttft_p50_ms": vals[len(vals) // 2] if vals else 0.0,
                "ttft_p99_ms": vals[int(len(vals) * 0.99)] if vals else 0.0}

    all_lats = [v for vs in lats.values() for v in vs]
    all_errs = [e for es in errors.values() for e in es]
    assert all_lats, f"no request completed; errors={all_errs[:3]}"
    result: Dict[str, Dict[str, Any]] = {}
    intended_total = 0.0
    for w in workloads:
        name = w["name"]
        st = stats(lats[name], errors[name], non_2xx[name])
        if w.get("ttft_key"):
            st.update(ttft_stats(ttfts[name]))
        if w.get("tokens_key"):
            # per-class decode token throughput over the SHARED wall
            # window, so classes' tokens/sec add up like their rps does
            st["decode_tokens"] = tokens[name]
            st["decode_tokens_per_sec"] = tokens[name] / wall
        # the class's intended request count: the honest error-rate
        # denominator (a dead client loses all its remaining requests)
        st["intended"] = float(int(w.get("n_clients", 4))
                               * int(w.get("per_client", 100)))
        intended_total += st["intended"]
        if w.get("gates"):
            st["gates"] = check_gates(w["gates"], st)
        result[name] = st
    result["combined"] = stats(all_lats, all_errs, sum(non_2xx.values()))
    result["combined"]["intended"] = intended_total
    all_ttfts = [v for vs in ttfts.values() for v in vs]
    if all_ttfts:
        result["combined"].update(ttft_stats(all_ttfts))
    if any(w.get("tokens_key") for w in workloads):
        total_tokens = sum(tokens.values())
        result["combined"]["decode_tokens"] = total_tokens
        result["combined"]["decode_tokens_per_sec"] = total_tokens / wall
    return result


def sustained_load(host: str, port: int, path: str, body: str,
                   headers: Dict[str, str], n_clients: int = 8,
                   per_client: int = 250, warm: int = 10,
                   gates: Optional[Dict[str, float]] = None
                   ) -> Dict[str, float]:
    """Fire ``per_client`` requests from ``n_clients`` persistent
    connections concurrently — the single-workload special case of
    :func:`mixed_load` (one shared warm barrier, completed-request RPS
    numerator, caught-and-counted worker errors, optional ``gates``).

    Returns {"rps", "p50_ms", "p99_ms", "completed", "errors", "non_2xx"}.
    Raises AssertionError if no request completed.
    """
    res = mixed_load(host, port, [{
        "name": "default", "path": path, "body": body, "headers": headers,
        "n_clients": n_clients, "per_client": per_client, "gates": gates}],
        warm=warm)
    return res["default"]
