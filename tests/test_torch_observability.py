"""Port parity for the copied resilience and observability modules
(``mmlspark_tpu_torch/utils/resilience.py``, ``observability/{tracing,
slo,attribution,instruments,collector,flightrecorder}.py``,
``models/prefix_cache.py``) and the twins ``observability/profiling.py``
and ``observability/compute.py``, against the JAX package on the CPU.

Each scenario runs the same calls on both packages' objects, on
``FakeClock`` time where the module takes a clock, and their observable
results must be equal (exactly: these modules are host-side bookkeeping,
no floating-point tolerance applies).  The twins are held to the
reference's report shapes and metric names.
"""
import json
import threading
import time

import numpy as np
import pytest

import mmlspark_tpu.models.prefix_cache as jax_prefix
import mmlspark_tpu.observability as jax_obs
import mmlspark_tpu.observability.attribution as jax_att
import mmlspark_tpu.observability.collector as jax_col
import mmlspark_tpu.observability.flightrecorder as jax_fr
import mmlspark_tpu.observability.tracing as jax_tr
import mmlspark_tpu.utils.resilience as jax_res
import mmlspark_tpu_torch.models.prefix_cache as port_prefix
import mmlspark_tpu_torch.models.runner as port_runner
import mmlspark_tpu_torch.observability as port_obs
import mmlspark_tpu_torch.observability.attribution as port_att
import mmlspark_tpu_torch.observability.collector as port_col
import mmlspark_tpu_torch.observability.compute as port_compute
import mmlspark_tpu_torch.observability.flightrecorder as port_fr
import mmlspark_tpu_torch.observability.profiling as port_prof
import mmlspark_tpu_torch.observability.tracing as port_tr
import mmlspark_tpu_torch.utils.resilience as port_res
from mmlspark_tpu.observability.federation import FleetView

PKGS = {
    "jax": dict(res=jax_res, obs=jax_obs, att=jax_att, col=jax_col,
                fr=jax_fr, tr=jax_tr, prefix=jax_prefix),
    "port": dict(res=port_res, obs=port_obs, att=port_att, col=port_col,
                 fr=port_fr, tr=port_tr, prefix=port_prefix),
}


def both(scenario):
    got = {k: scenario(**m) for k, m in PKGS.items()}
    assert got["port"] == got["jax"], got
    return got["port"]


# ---------------------------------------------------------------------------
# utils/resilience.py
# ---------------------------------------------------------------------------

def test_watchdog_arms_heartbeats_and_trips_once_per_section():
    def scenario(res, **_):
        clk = res.FakeClock()
        trips = []
        wd = res.Watchdog(stall_timeout_s=2.0, clock=clk,
                          on_stall=lambda label, el: trips.append(
                              (label, el)))
        seen = [wd.check()]
        wd.arm("dispatch")
        clk.advance(1.5)
        seen += [wd.check(), wd.stalled_for()]
        wd.heartbeat()
        clk.advance(1.5)
        seen.append(wd.check())
        clk.advance(1.0)
        seen += [wd.check(), wd.check(), wd.trips]
        wd.disarm()
        seen += [wd.check(), wd.stalled_for()]
        wd.arm("dispatch#2")
        clk.advance(3.0)
        seen += [wd.check(), wd.trips]

        def bad_hook(label, elapsed):
            raise RuntimeError("hook crashed")

        wd2 = res.Watchdog(stall_timeout_s=1.0, clock=clk, on_stall=bad_hook)
        with wd2.section("step"):
            clk.advance(5.0)
            seen += [wd2.check(), wd2.check()]
        seen += [wd2.check(), wd2.as_dict()["trips"], wd2.as_dict()["armed"]]
        with pytest.raises(ValueError):
            res.Watchdog(stall_timeout_s=0.0)
        return trips, seen
    trips, seen = both(scenario)
    assert trips == [("dispatch", 2.5), ("dispatch#2", 3.0)]


def test_watchdog_monitor_thread_detects_a_real_stall():
    fired = threading.Event()
    wd = port_res.Watchdog(stall_timeout_s=0.05,
                           on_stall=lambda label, el: fired.set())
    wd.start(poll_interval_s=0.01)
    try:
        wd.arm("hung-dispatch")
        assert fired.wait(5.0) and wd.trips >= 1
    finally:
        wd.disarm()
        wd.stop()


def test_retry_budget_and_restart_supervisor():
    def scenario(res, **_):
        out = []
        b = res.RetryBudget(ratio=0.1, initial=0.0)
        out += [b.tokens(), b.try_withdraw()]
        for _ in range(10):
            b.deposit()
        out += [round(b.tokens(), 9), b.try_withdraw(), b.try_withdraw(),
                b.as_dict()]
        b2 = res.RetryBudget(ratio=0.5, cap=3.0)
        for _ in range(100):
            b2.deposit()
        out += [b2.tokens(), [b2.try_withdraw() for _ in range(4)]]
        for bad in (dict(ratio=-0.1), dict(cap=0.0)):
            with pytest.raises(ValueError):
                res.RetryBudget(**bad)
        clk = res.FakeClock()
        sup = res.RestartSupervisor(initial_backoff_s=0.5, backoff_cap_s=4.0,
                                    quarantine_stalls=99, clock=clk)
        out.append([sup.note_failure("error") for _ in range(5)])
        clk.advance(4.0)
        out.append(sup.retry_after_s())
        sup.note_success()
        out += [sup.note_failure("error"), sup.failures, sup.quarantined]
        q = res.RestartSupervisor(initial_backoff_s=0.1, backoff_cap_s=8.0,
                                  quarantine_stalls=3,
                                  quarantine_window_s=60.0, clock=clk)
        for dt in (0.0, 61.0, 1.0, 1.0):
            clk.advance(dt)
            q.note_failure("stall")
            out.append(q.quarantined)
        q.note_success()
        out += [q.retry_after_s(), q.quarantined, q.as_dict()]
        return out
    out = both(scenario)
    assert out[8] == [0.5, 1.0, 2.0, 4.0, 4.0]


def test_circuit_breaker_and_retries_on_a_fake_clock():
    def scenario(res, **_):
        clk = res.FakeClock()
        br = res.CircuitBreaker(failure_threshold=2, window_s=10.0,
                                cooldown_s=5.0, clock=clk, name="b")
        transitions = []
        br.add_listener(lambda b, old, new: transitions.append((old, new)))

        def boom():
            raise ConnectionError("down")

        out = []
        for _ in range(2):
            with pytest.raises(ConnectionError):
                br.call(boom)
        out.append(br.state)
        with pytest.raises(res.CircuitOpenError) as e:
            br.call(lambda: 1)
        out.append(e.value.retry_after_s)
        clk.advance(5.0)
        out += [br.state, br.call(lambda: 7), br.state, br.failure_rate()]
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise ConnectionError("again")
            return "ok"

        out.append(res.with_retries(flaky, retries=5, initial_delay_s=0.0,
                                    sleep=lambda s: None))
        return out, transitions, br.rejected, br.opened_count
    out, transitions, rejected, opened = both(scenario)
    assert out[0] == "open" and out[-1] == "ok" and rejected == 1


# ---------------------------------------------------------------------------
# tracing, the span collector, SLOs, attribution
# ---------------------------------------------------------------------------

def test_spans_nest_propagate_and_land_in_the_collector():
    def scenario(tr, col, obs, **_):
        reg = obs.MetricsRegistry()
        c = col.SpanCollector(capacity=4, registry=reg,
                              clock=lambda: 0.0)
        with tr.trace_span("outer", trace_id="t" * 32) as outer:
            with tr.trace_span("inner", attributes={"k": 1}) as inner:
                assert tr.current_trace_id() == "t" * 32
        for i in range(6):
            s = tr.Span("serving.request", trace_id=f"{i:032x}",
                        start_s=0.0)
            s.finish(float(i))
            c.record(s)
        tree = c.trace_tree("t" * 32)
        slow = c.slowest(k=2)
        tp = tr.format_traceparent("a" * 32)
        return (inner.parent_id == outer.span_id, tree and tree["name"],
                len(c.trace("t" * 32)), slow,
                tr.parse_traceparent(tp)[0], c.queue_depth())
    both(scenario)


def test_collector_file_and_http_sinks_export(tmp_path):
    """Both sinks export on both packages: a ``file://`` endpoint appends
    one payload per line, an ``http://`` endpoint POSTs it through
    ``io/http.py``'s client to a local receiver (the payload parity suite
    is ``tests/test_torch_http.py``)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    posts = []

    class Receiver(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            posts.append(json.loads(self.rfile.read(
                int(self.headers["Content-Length"]))))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Receiver)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        for name, col in (("jax", jax_col), ("port", port_col)):
            path = tmp_path / f"{name}.jsonl"
            for endpoint in (f"file://{path}",
                             f"http://127.0.0.1:{httpd.server_port}/v1"):
                c = col.SpanCollector(
                    registry=PKGS[name]["obs"].MetricsRegistry(),
                    endpoint=endpoint, flush_interval_s=3600.0)
                s = PKGS[name]["tr"].Span("x", trace_id="b" * 32,
                                          start_s=0.0)
                s.finish(1.0)
                c.record(s)
                assert c.flush_now() == 1
            spans = json.loads(path.read_text())["resourceSpans"][0][
                "scopeSpans"][0]["spans"]
            assert [sp["name"] for sp in spans] == ["x"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(5)
    assert [[sp["name"] for sp in p["resourceSpans"][0]["scopeSpans"][0][
        "spans"]] for p in posts] == [["x"], ["x"]]


def _lat_view(obs, values):
    reg = obs.MetricsRegistry()
    h = reg.histogram("mmlspark_t_lat_seconds", "t")
    for v in values:
        h.observe(v)
    return FleetView.from_texts({"w0": reg.to_prometheus()})


def test_slo_engine_burns_and_recovers_in_step_with_the_reference():
    def scenario(res, obs, **_):
        clk = res.FakeClock()
        reg = obs.MetricsRegistry()
        eng = obs.SLOEngine(["p99(mmlspark_t_lat_seconds) <= 0.01"],
                            registry=reg, clock=clk, fast_window_s=300.0,
                            slow_window_s=3600.0)
        history = [0.001] * 50
        verdicts = [eng.evaluate(_lat_view(jax_obs, history))]
        clk.advance(60)
        history += [0.5] * 10
        verdicts.append(eng.evaluate(_lat_view(jax_obs, history)))
        clk.advance(400)
        verdicts.append(eng.evaluate(_lat_view(jax_obs, history)))
        return [[(v["burning"], v["ok"], v["burn_rate"],
                  v["budget_remaining"]) for v in out["slos"]]
                for out in verdicts], eng.burning()
    out, _ = both(scenario)
    assert out[1][0][0] is True and out[2][0][1] is True


def test_request_cost_and_the_record_ring():
    def scenario(att, **_):
        c = att.RequestCost(prefill_tokens=12)
        c.prefill_cached = 8
        c.page_edge(0.0, 3)
        c.page_edge(2.0, 1)
        c.decode_tokens = 5
        c.device_s = 0.25
        c.close_pages(3.0)
        ring = att.RequestRecordRing(maxlen=3)
        for i in range(5):
            ring.append({"trace_id": str(i), "class": "a" if i % 2 else "b",
                         "verdict": "ok"})
        return (c.as_dict(), [r["trace_id"] for r in ring.query(k=10)],
                [r["trace_id"] for r in ring.query(klass="a")],
                dict(att.ENGINE_OUTCOME_MAP))
    both(scenario)


# ---------------------------------------------------------------------------
# the prefix index alone (models/prefix_cache.py)
# ---------------------------------------------------------------------------

def test_prefix_index_lookup_release_evict_and_flush():
    from mmlspark_tpu.models import PagePool as JaxPool
    pools = {"jax": JaxPool, "port": port_runner.PagePool}

    def scenario(prefix, obs, **kw):
        Pool = pools["jax" if prefix is jax_prefix else "port"]
        reg = obs.MetricsRegistry()
        pool = Pool(None, num_pages=16, page_size=4, name="ix",
                    registry=reg)
        idx = prefix.PrefixIndex(pool, budget_pages=5, name="ix",
                                 registry=reg)
        a = np.arange(1, 11, dtype=np.int32)            # 2.5 pages
        out = [idx.lookup(a)]
        pages = pool.allocate(3)
        idx.release(a, pages)
        out += [idx.retained_pages(), idx.lookup(a)]
        pool.free(out[-1][0])
        b = np.concatenate([a[:8], [40, 41, 42]]).astype(np.int32)
        hit = idx.lookup(b)
        out.append(hit)
        pool.free(hit[0])
        for i in range(3):                               # budget pressure
            c = np.arange(20 + 4 * i, 28 + 4 * i, dtype=np.int32)
            idx.release(c, pool.allocate(2))
        out += [idx.retained_pages(), idx.evict_pages(2, reason="pressure"),
                idx.stats()]
        idx.flush(reason="pool_replaced")
        out += [idx.retained_pages(), pool.pages_in_use(), idx.stats()]
        return out
    both(scenario)


# ---------------------------------------------------------------------------
# the flight recorder, the profiler twin, the compute twin
# ---------------------------------------------------------------------------

def test_flight_recorder_dumps_the_live_engine(tmp_path, monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_FLIGHT_DUMP_DIR", str(tmp_path))
    from mmlspark_tpu_torch.models import TransformerEncoder
    reg = port_obs.MetricsRegistry()
    lm = TransformerEncoder(16, num_classes=16, embed_dim=8, num_heads=2,
                            num_layers=1, mlp_dim=8, max_len=32, causal=True,
                            pool="none")
    runner = port_runner.ModelRunner(module=lm, name="fr", registry=reg,
                                     device="cpu")
    dec = runner.decode_stream(slots=2, prompt_bucket=4, max_new_tokens=4,
                               page_size=2)
    dec.submit(np.asarray([1, 2, 3], np.int32))
    dec.step()
    rec = port_fr.get_flight_recorder(reg)
    try:
        path = rec.dump(trigger="demand")
        snap = json.loads(open(path).read())
        assert snap["trigger"] == "demand"
        (state,) = snap["decode_streams"]
        assert state["live"] == 1 and state["runner"] == "fr"
        assert snap["runners"][0]["runner"] == "fr"
        # the engine's programs, booked as the reference's jit wrappers
        # are: the join prefill, its sampler and the step, once each
        assert snap["compile"]["storm_threshold_default"] == 8
        assert {k: v["compiles"] for k, v in
                snap["compile"]["functions"].items()} == {
            "runner.fr.prefill_paged": 1, "runner.fr.decode_sample": 1,
            "runner.fr.decode_step_paged": 1}
        sections = set(jax_fr.get_flight_recorder(
            jax_obs.MetricsRegistry()).snapshot())
        assert set(snap) == sections
    finally:
        dec.close()
        rec.close()


def test_profile_window_attributes_phases_and_reports_the_torch_hatch(
        monkeypatch, tmp_path):
    stop = threading.Event()

    def busy():
        # short sleeps hand the interpreter lock back, so the sampler and
        # the profiler's exit are not starved
        with port_tr.ambient_phase("runner.decode.step"):
            while not stop.is_set():
                sum(range(100))
                time.sleep(0.001)

    t = threading.Thread(target=busy)
    t.start()
    try:
        rep = port_prof.profile_window(seconds=0.3, hz=97,
                                       registry=port_obs.MetricsRegistry())
    finally:
        stop.set()
        t.join()
    assert rep["samples"] > 0 and "runner.decode.step" in rep["by_span"]
    assert "torch_trace" not in rep                # off unless asked for
    monkeypatch.setenv(port_prof.TORCH_TRACE_DIR_ENV, str(tmp_path / "t"))
    rep = port_prof.profile_window(seconds=0.1,
                                   registry=port_obs.MetricsRegistry())
    assert rep["torch_trace"]["ok"] is True, rep["torch_trace"]
    assert json.loads(open(rep["torch_trace"]["file"]).read())
    # every failure lands in the verdict, host sampling still serves
    monkeypatch.setenv(port_prof.TORCH_TRACE_DIR_ENV, "/dev/null/x")
    rep = port_prof.profile_window(seconds=0.05,
                                   registry=port_obs.MetricsRegistry())
    assert rep["torch_trace"]["ok"] is False and rep["torch_trace"]["error"]
    ref = jax_obs.profile_window(seconds=0.05,
                                 registry=jax_obs.MetricsRegistry())
    assert set(ref) <= set(rep)


def test_compute_twin_keeps_the_reference_names_and_raises_the_rest(
        monkeypatch):
    """The compute twin's reports and its compile booking.  (The name
    dates from when ``InstrumentedJit`` raised; nothing here raises now.)
    ``compile_report`` and the build-info and device-memory gauges keep the
    reference's names, and an ``instrumented_jit`` wrapper registers,
    books its signatures and reports."""
    reg = port_obs.MetricsRegistry()
    assert port_compute.compile_report(reg) == {
        "functions": {}, "storm_threshold_default": 8}
    assert port_compute.ensure_build_info(reg) is True
    (sample,) = reg.to_dict()["mmlspark_build_info"]["samples"]
    assert sample["labels"]["device_kind"] == "cpu"
    assert sample["labels"]["torch"]
    # no card: no device-memory series
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    reg2 = port_obs.MetricsRegistry()
    assert port_compute.ensure_device_memory_gauges(reg2) is False
    assert "mmlspark_device_bytes_in_use" not in reg2.to_dict()
    # the compile booking is ported (its parity with the reference's is
    # in test_torch_trainer.py): a wrapper registers, books and reports
    import torch
    live = []           # the registry's table holds its wrappers weakly
    for fn in (port_compute.instrumented_jit, port_compute.InstrumentedJit):
        live.append(fn(lambda x: x + 1, name="twin", registry=reg))
        assert float(live[-1](torch.ones(2)).sum()) == 4.0
        assert live[-1].compiles == 1
    assert port_compute.compile_report(reg)["functions"]["twin"][
        "compiles"] == 2
    assert sorted(port_compute.__all__) == sorted(
        __import__("mmlspark_tpu.observability.compute",
                   fromlist=["x"]).__all__)
    assert time.monotonic() > 0



def test_device_put_books_transfer_bytes_by_site_in_both_packages():
    """The twin of ``tests/test_compute_telemetry.py::test_device_put_books_
    transfer_bytes_by_site``: the same array and nest booked by both
    packages' ``device_put`` under one site read the same bytes, and
    ``transfer_nbytes`` agrees over a nest of arrays and tensors."""
    import torch
    import mmlspark_tpu.observability.compute as jax_compute
    x = np.ones((10, 10), np.float32)
    got = {}
    for name, mod, reg, kw in (
            ("jax", jax_compute, jax_obs.MetricsRegistry(), {}),
            ("port", port_compute, port_obs.MetricsRegistry(),
             {"device": "cpu"})):
        out = mod.device_put(x, site="test.site", registry=reg, **kw)
        assert np.allclose(np.asarray(out), x)
        fam = reg.counter("mmlspark_device_transfer_bytes_total",
                          labels=("site",))
        assert fam.value(site="test.site") == 400.0
        nest = mod.device_put({"a": x, "b": x}, site="test.site",
                              registry=reg, **kw)
        assert sorted(nest) == ["a", "b"]
        got[name] = fam.value(site="test.site")
        assert mod.transfer_nbytes([x, x]) == 800
    assert got == {"jax": 1200.0, "port": 1200.0}
    # the port's leaves: tensors count their bytes, a tuple keeps its type
    t = torch.ones(5, dtype=torch.int16)
    assert port_compute.transfer_nbytes((x, [t, None], {"k": t})) == 420
    moved = port_compute.device_put((x, [t]), "cpu", site="s",
                                    registry=port_obs.MetricsRegistry())
    assert isinstance(moved, tuple) and isinstance(moved[0], torch.Tensor)
    assert torch.equal(moved[1][0], t)

def test_runner_stall_watchdog_books_the_stall_and_dumps(tmp_path,
                                                          monkeypatch):
    """``tests/test_tail_tolerance.py:223``: a trip of the runner's stall
    watchdog books ``mmlspark_runner_stalls_total``, leaves a flight
    recorder dump with ``trigger="stall"``, then chains the caller's
    ``on_stall`` — in both packages."""
    from mmlspark_tpu.models import ModelRunner as JaxRunner
    runners = {"jax": lambda reg: JaxRunner(
        apply_fn=lambda v, x: x, variables={}, name="stall.unit",
        registry=reg),
        "port": lambda reg: port_runner.ModelRunner(
            apply_fn=lambda v, x: x, name="stall.unit", registry=reg,
            device="cpu")}

    def scenario(res, obs, **kw):
        which = "jax" if res is jax_res else "port"
        out_dir = tmp_path / which
        out_dir.mkdir()
        monkeypatch.setenv("MMLSPARK_TPU_FLIGHT_DUMP_DIR", str(out_dir))
        reg = obs.MetricsRegistry()
        runner = runners[which](reg)
        clk = res.FakeClock()
        chained = []
        wd = runner.stall_watchdog(2.0, clock=clk,
                                   on_stall=lambda label, el:
                                   chained.append(label))
        try:
            wd.arm("decode-dispatch")
            clk.advance(3.0)
            tripped = wd.check()
            (dump,) = list(out_dir.glob("flightdump_*_stall.json"))
            trigger = json.loads(dump.read_text())["trigger"]
        finally:
            wd.stop()
            reg._flight_recorder.close()
        return tripped, chained, trigger, reg.family(
            "mmlspark_runner_stalls_total").labels(runner="stall.unit").value
    assert both(scenario) == (True, ["decode-dispatch"], "stall", 1.0)
