"""Port parity for the live training monitor
(``mmlspark_tpu_torch/observability/trainwatch.py``) and its wiring into
both GBDT drivers, against the JAX package on the CPU.

Each unit scenario of the reference's ``tests/test_trainwatch.py:48-289``
runs on both packages' ``TrainingRun``/``MonitorServer`` on a ``FakeClock``
and must give equal results (exactly: host-side bookkeeping).  Then the
drivers: ``train(device="cpu", monitor_port=0)`` and ``train_streamed``
serve live progress over a real socket, and their boosters equal the
unmonitored fits' in every array; a hung tile prefetcher trips the stall
watchdog into ``mmlspark_training_stalls_total`` and a ``train_stall``
flight dump that names it; the ``ambient_phase`` names a fit marks are
the reference's.
"""
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import mmlspark_tpu.io.chunked as jax_chunked
import mmlspark_tpu.observability.flightrecorder as jax_fr
import mmlspark_tpu.observability.metrics as jax_metrics
import mmlspark_tpu.observability.tracing as jax_tr
import mmlspark_tpu.observability.trainwatch as jax_tw
import mmlspark_tpu.serving.distributed as jax_dist
import mmlspark_tpu.utils.resilience as jax_res
import mmlspark_tpu_torch.io.chunked as port_chunked
import mmlspark_tpu_torch.observability.flightrecorder as port_fr
import mmlspark_tpu_torch.observability.metrics as port_metrics
import mmlspark_tpu_torch.observability.tracing as port_tr
import mmlspark_tpu_torch.observability.trainwatch as port_tw
import mmlspark_tpu_torch.serving.distributed as port_dist
import mmlspark_tpu_torch.utils.resilience as port_res
from mmlspark_tpu_torch.testing.chaos import HungLoadInjector
from mmlspark_tpu_torch.lightgbm import GBDTParams, train, train_streamed
from mmlspark_tpu_torch.observability import (active_monitors, active_runs,
                                              get_registry)

PKGS = {
    "jax": dict(tw=jax_tw, m=jax_metrics, res=jax_res, fr=jax_fr,
                chunked=jax_chunked, dist=jax_dist, tr=jax_tr),
    "port": dict(tw=port_tw, m=port_metrics, res=port_res, fr=port_fr,
                 chunked=port_chunked, dist=port_dist, tr=port_tr),
}

BOOSTER_ARRAYS = ("split_feature", "threshold", "threshold_bin",
                  "split_gain", "internal_value", "internal_count",
                  "leaf_value", "leaf_count", "tree_weight", "left_child",
                  "right_child")


def both(scenario):
    got = {k: scenario(**m) for k, m in PKGS.items()}
    assert got["port"] == got["jax"], got
    return got["port"]


def _get_json(url, timeout=5):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _get_text(url, timeout=5, accept=None):
    req = urllib.request.Request(url)
    if accept:
        req.add_header("Accept", accept)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read().decode(), r.headers.get("Content-Type", "")


def _no_elapsed(p):
    """A progress snapshot without its wall-clock-dependent fields."""
    return {k: v for k, v in p.items() if k != "elapsed_seconds"}


# ---------------------------------------------------------------------------
# TrainingRun on a FakeClock
# ---------------------------------------------------------------------------

def test_ewma_step_time_rate_eta_and_gauges_alike():
    def scenario(tw, m, res, **_):
        clk = res.FakeClock()
        reg = m.MetricsRegistry()
        run = tw.TrainingRun("j", total_steps=10, rows_per_step=100,
                             registry=reg, clock=clk, flight_dump=False)
        run.tick(step=1)
        clk.advance(1.0)
        run.tick(step=2, loss=0.5)
        clk.advance(1.0)
        run.tick(step=3, loss=0.4)
        fams = reg._training_families
        out = (_no_elapsed(run.progress()),
               fams["progress"].labels(job="j").value,
               fams["eta"].labels(job="j").value,
               fams["rate"].labels(job="j").value)
        run.close()
        return out
    p, prog, eta, rate = both(scenario)
    assert p["ewma_step_seconds"] == pytest.approx(1.0)
    assert p["rows_per_second"] == pytest.approx(100.0)
    assert (p["eta_seconds"], p["loss_tail"], p["step"], p["rows"]) == \
        (7.0, [0.5, 0.4], 3, 300)
    assert (prog, eta, rate) == (pytest.approx(0.3), pytest.approx(7.0),
                                 pytest.approx(100.0))


def test_unknowns_before_ticks_and_without_total_alike():
    def scenario(tw, m, res, **_):
        reg = m.MetricsRegistry()
        run = tw.TrainingRun("j", registry=reg, clock=res.FakeClock(),
                             flight_dump=False)
        fams = reg._training_families
        out = (_no_elapsed(run.progress()),
               str(fams["progress"].labels(job="j").value),
               str(fams["eta"].labels(job="j").value))
        run.close()
        return out
    p, prog, eta = both(scenario)
    assert p["ewma_step_seconds"] is None and p["eta_seconds"] is None
    assert (prog, eta) == ("nan", "inf")


def test_chunked_step_delta_and_bounded_loss_tail_alike():
    def scenario(tw, m, res, **_):
        clk = res.FakeClock()
        reg = m.MetricsRegistry()
        run = tw.TrainingRun("j", rows_per_step=10, registry=reg, clock=clk,
                             flight_dump=False)
        run.tick(step=4)
        clk.advance(8.0)
        run.tick(step=8)
        fams = reg._training_families
        out = [fams["steps"].labels(job="j").value,
               fams["rows"].labels(job="j").value,
               run.progress()["ewma_step_seconds"]]
        run.close()
        tail = tw.TrainingRun("t", registry=m.MetricsRegistry(),
                              clock=clk, loss_window=4, flight_dump=False)
        for i in range(10):
            tail.tick(loss=float(i))
        out.append(tail.progress()["loss_tail"])
        tail.close()
        return out
    assert both(scenario) == [8.0, 80.0, pytest.approx(2.0),
                              [6.0, 7.0, 8.0, 9.0]]


def test_close_removes_gauges_keeps_counters_and_roster_alike():
    def scenario(tw, m, res, **_):
        reg = m.MetricsRegistry()
        run = tw.TrainingRun("j", total_steps=4, registry=reg,
                             clock=res.FakeClock(), flight_dump=False)
        run.tick(step=1)
        out = [tw.active_runs(reg) == [run]]
        run.close()
        fams = reg._training_families
        out += [tw.active_runs(reg), dict(fams["progress"]._snapshot()),
                fams["steps"].labels(job="j").value]
        run.close()
        run.tick(step=2)
        out.append(fams["steps"].labels(job="j").value)
        return out
    assert both(scenario) == [True, [], {}, 1.0, 1.0]


# ---------------------------------------------------------------------------
# the stall watchdog
# ---------------------------------------------------------------------------

def test_stall_latches_once_dumps_and_rearms_on_recovery_alike(tmp_path):
    def scenario(tw, m, res, fr, **_):
        d = tmp_path / str(id(tw))
        clk = res.FakeClock()
        reg = m.MetricsRegistry()
        fr.get_flight_recorder(reg, dump_dir=str(d))
        run = tw.TrainingRun("j", total_steps=100, registry=reg, clock=clk,
                             stall_timeout_s=5.0)
        run.tick(step=1)
        clk.advance(1.0)
        run.tick(step=2)
        clk.advance(30.0)
        out = [run.check(), run.check()]
        fams = reg._training_families
        out += [fams["stalls"].labels(job="j").value,
                len(list(d.glob("flightdump_*_train_stall.json"))),
                run.progress()["stalls"]]
        run.tick(step=3)
        out.append(run.check())
        clk.advance(1000.0)
        out += [run.check(), fams["stalls"].labels(job="j").value]
        run.close()
        return out
    assert both(scenario) == [True, True, 1.0, 1, 1, False, True, 2.0]


def test_stall_dump_names_the_hung_prefetcher_alike(tmp_path):
    """The reference's chaos drill (``tests/test_trainwatch.py:168``) on
    each package's ``TilePrefetcher``: a tile load that never returns
    freezes the ticks; the trip books ``mmlspark_training_stalls_total``
    and leaves a ``train_stall`` dump whose training source shows the
    prefetcher."""
    def scenario(tw, m, res, fr, chunked, **_):
        d = tmp_path / str(id(tw))
        clk = res.FakeClock()
        reg = m.MetricsRegistry()
        fr.get_flight_recorder(reg, dump_dir=str(d))
        run = tw.TrainingRun("hungjob", total_steps=8, registry=reg,
                             clock=clk, stall_timeout_s=5.0)
        inj = HungLoadInjector(hang_at=2)
        pf = chunked.TilePrefetcher(range(8), inj.wrap(lambda i: i * 10),
                                    site="hung", registry=reg)
        run.set_prefetch_fn(pf.snapshot)
        got = []
        it = iter(pf)
        got.append(next(it))
        got.append(next(it))
        run.tick(step=1)
        run.tick(step=2)
        assert inj.hanging.wait(5.0), "injector never blocked the worker"
        clk.advance(60.0)
        tripped = run.check()
        dumps = sorted(d.glob("flightdump_*_train_stall.json"))
        src = json.loads(dumps[0].read_text())["source.training.hungjob"]
        out = [tripped, len(dumps), src["step"], src["stalls"],
               {k: src["prefetch"][k] for k in ("waiting", "tiles_served",
                                                "site")},
               reg._training_families["stalls"].labels(
                   job="hungjob").value]
        inj.release()
        got.extend(it)
        run.tick(step=3)
        out += [got, run.check()]
        run.close()
        return out
    got = both(scenario)
    assert got[:6] == [True, 1, 2, 1, {"waiting": False, "tiles_served": 2,
                                       "site": "hung"}, 1.0]
    assert got[6] == [i * 10 for i in range(8)] and got[7] is False


def test_preempt_on_stall_requests_graceful_shutdown_alike():
    def scenario(tw, m, res, **_):
        clk = res.FakeClock()
        run = tw.TrainingRun("j", registry=m.MetricsRegistry(), clock=clk,
                             stall_timeout_s=5.0, preempt_on_stall=True,
                             flight_dump=False)
        with res.preemption_scope() as token:
            run.set_preemption_token(token)
            out = [run.progress()["preemption_requested"]]
            clk.advance(60.0)
            out += [run.check(), token.requested,
                    run.progress()["preemption_requested"]]
        run.close()
        return out
    assert both(scenario) == [False, True, True, True]


# ---------------------------------------------------------------------------
# MonitorServer over a real socket
# ---------------------------------------------------------------------------

def test_monitor_endpoints_and_openmetrics_negotiation_alike():
    def scenario(tw, m, res, **_):
        clk = res.FakeClock()
        reg = m.MetricsRegistry()
        run = tw.TrainingRun("srv", total_steps=4, rows_per_step=10,
                             registry=reg, clock=clk, flight_dump=False)
        run.tick(step=1)
        clk.advance(2.0)
        run.tick(step=2, loss=0.25)
        srv = tw.MonitorServer(run, port=0).start()
        out = []
        try:
            out.append(tw.active_monitors(reg) == [srv])
            out.append(_no_elapsed(_get_json(srv.address + "/progress")))
            body, ctype = _get_text(srv.address + "/metrics")
            out += ["text/plain; version=0.0.4" in ctype,
                    'mmlspark_training_steps_total{job="srv"} 2' in body]
            om, om_ctype = _get_text(srv.address + "/metrics",
                                     accept="application/openmetrics-text")
            out += ["application/openmetrics-text" in om_ctype,
                    om.endswith("# EOF\n")]
            out.append(_get_json(srv.address + "/stats"))
            out.append(_get_text(srv.address + "/health")[0])
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get_json(srv.address + "/nope")
            out.append(ei.value.code)
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get_json(srv.address + "/debug/profile?seconds=x")
            out.append(ei.value.code)
        finally:
            srv.stop()
            run.close()
        out.append(tw.active_monitors(reg))
        return out
    got = both(scenario)
    assert got[0] and got[1]["step"] == 2 and all(got[2:6])
    assert got[6]["role"] == "trainer" and got[7:] == ["ok", 404, 400, []]


def test_monitor_debug_dump_and_profile_over_http_alike(tmp_path):
    def scenario(tw, m, res, fr, **_):
        d = tmp_path / str(id(tw))
        reg = m.MetricsRegistry()
        fr.get_flight_recorder(reg, dump_dir=str(d))
        run = tw.TrainingRun("dmp", registry=reg, clock=res.FakeClock())
        run.tick(step=1)
        srv = tw.MonitorServer(run, port=0).start()
        try:
            snap = _get_json(srv.address + "/debug/dump", timeout=10)
            prof = _get_json(srv.address + "/debug/profile?seconds=0.2",
                             timeout=10)
            return (snap["source.training.dmp"]["step"],
                    len(list(d.glob("flightdump_*_http.json"))),
                    sorted(k for k in prof if k in ("samples", "seconds",
                                                    "hz")))
        finally:
            srv.stop()
            run.close()
    assert both(scenario)[:2] == (1, 1)


def test_trainer_federates_but_never_routes_alike():
    def scenario(tw, m, res, dist, **_):
        reg = m.MetricsRegistry()
        svc = dist.TopologyService(registry=reg,
                                   probe_interval_s=None).start()
        topo = f"http://{svc.host}:{svc.port}"
        run = tw.TrainingRun("fleet.job", total_steps=10, rows_per_step=50,
                             registry=reg, clock=res.FakeClock(),
                             flight_dump=False)
        run.tick(step=2)
        srv = tw.MonitorServer(run, port=0, topology_address=topo).start()
        try:
            out = [srv.registered, "train-fleet.job" in svc.routing_table(),
                   "train-fleet.job" in _get_json(topo + "/routing")]
            body, _ = _get_text(topo + "/fleet/metrics?refresh=1",
                                timeout=10)
            out.append('mmlspark_training_steps_total{job="fleet.job"} 2'
                       in body)
            out.append(svc.aggregate_stats()["workers"]["train-fleet.job"])
        finally:
            srv.stop()
            run.close()
            svc.stop()
        out.append("train-fleet.job" in svc.routing_table())
        return out
    got = both(scenario)
    assert got[:4] == [True, True, False, True] and got[-1] is False
    assert got[4]["role"] == "trainer" and got[4]["step"] == 2


def test_start_training_monitor_one_call_wiring_alike():
    def scenario(tw, m, res, **_):
        reg = m.MetricsRegistry()
        clk = res.FakeClock()
        run, srv = tw.start_training_monitor(
            "wired", total_steps=5, rows_per_step=10, registry=reg,
            monitor_port=0, clock=clk)
        try:
            out = [tw.active_runs(reg) == [run],
                   tw.active_monitors(reg) == [srv]]
            run.tick(step=1)
            out.append(_get_json(srv.address + "/progress")["step"])
        finally:
            srv.stop()
            run.close()
        run2, srv2 = tw.start_training_monitor(
            "wd-only", registry=reg, stall_timeout_s=60.0, clock=clk)
        out += [srv2, run2.progress()["watchdog"]]
        run2.close()
        return out
    got = both(scenario)
    assert got[:4] == [True, True, 1, None]
    assert got[4]["stall_timeout_seconds"] == 60.0


# ---------------------------------------------------------------------------
# the drivers: train() and train_streamed() with monitor_port on the CPU
# ---------------------------------------------------------------------------

def _data(n=1500, f=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] + rng.normal(scale=0.3, size=n)
         > 0).astype(np.float32)
    return X, y


def _same_booster(a, b):
    for k in BOOSTER_ARRAYS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                      err_msg=k)


def _probe(job, at, hits):
    def probe(i, ev):
        if i == at and "progress" not in hits:
            mons = [mo for mo in active_monitors(get_registry())
                    if mo.run.job == job]
            assert mons, "no live monitor mid-run"
            hits["progress"] = _get_json(mons[0].address + "/progress")
            hits["metrics"] = _get_text(mons[0].address + "/metrics")[0]
    return probe


@pytest.mark.parametrize("growth", [dict(num_leaves=8), dict(max_depth=3)],
                         ids=["leaf", "level"])
def test_train_serves_live_progress_and_grows_the_same_booster(growth):
    X, y = _data()
    p = GBDTParams(objective="binary", num_iterations=6,
                   use_quantized_grad=True, **growth)
    hits = {}
    mon = train(X, y, p, valid=(X[:300], y[:300]), device="cpu",
                callbacks=[_probe("lightgbm.train", 3, hits)],
                monitor_port=0, monitor_stall_timeout_s=60.0)
    plain = train(X, y, p, valid=(X[:300], y[:300]), device="cpu")
    _same_booster(mon.booster, plain.booster)
    assert mon.evals == plain.evals
    prog = hits["progress"]
    assert prog["driver"] == "lightgbm.train" and prog["phase"] == "boosting"
    # the probe runs before the monitor's own callback: 3 ticks landed
    assert prog["step"] == 3 and prog["total_steps"] == 6
    assert prog["rows"] == 3 * len(X)
    assert prog["rows_per_second"] > 0 and prog["eta_seconds"] is not None
    assert len(prog["loss_tail"]) == 3        # the valid metric feeds it
    assert prog["watchdog"]["stall_timeout_seconds"] == 60.0
    assert 'mmlspark_training_steps_total{job="lightgbm.train"}' in \
        hits["metrics"]
    assert not [r for r in active_runs(get_registry())
                if r.job == "lightgbm.train"]
    assert not [mo for mo in active_monitors(get_registry())
                if mo.run.job == "lightgbm.train"]


@pytest.mark.parametrize("growth", [dict(num_leaves=8), dict(max_depth=3)],
                         ids=["leaf", "level"])
def test_train_streamed_serves_live_progress_and_grows_the_same_booster(
        growth):
    X, y = _data()
    p = GBDTParams(objective="binary", num_iterations=6,
                   use_quantized_grad=True, **growth)
    hits = {}
    mon = train_streamed(X, y, p, valid=(X[:300], y[:300]), tile_rows=512,
                         device="cpu", monitor_port=0,
                         callbacks=[_probe("lightgbm.train_streamed", 4,
                                           hits)])
    plain = train_streamed(X, y, p, valid=(X[:300], y[:300]), tile_rows=512,
                           device="cpu")
    _same_booster(mon.booster, plain.booster)
    prog = hits["progress"]
    assert prog["driver"] == "lightgbm.train_streamed"
    assert prog["step"] == 4 and prog["phase"] == "boosting"
    assert prog["rows_per_second"] > 0 and prog["loss_tail"]
    assert prog["prefetch"]["tiles"] > 0 and "overlap_pct" in prog["prefetch"]
    assert prog["watchdog"]["trips"] == 0
    assert not [r for r in active_runs(get_registry())
                if r.job == "lightgbm.train_streamed"]


def test_the_stall_timeout_alone_arms_the_watchdog_without_a_server():
    X, y = _data(n=400)
    seen = {}

    def probe(i, ev):
        runs = [r for r in active_runs(get_registry())
                if r.job == "lightgbm.train"]
        seen["runs"] = len(runs)
        seen["timeout"] = runs[0].progress()["watchdog"][
            "stall_timeout_seconds"]
        seen["monitors"] = [mo for mo in active_monitors(get_registry())
                            if mo.run.job == "lightgbm.train"]

    train(X, y, GBDTParams(num_iterations=2, num_leaves=4), device="cpu",
          callbacks=[probe], monitor_stall_timeout_s=45.0)
    assert seen == {"runs": 1, "timeout": 45.0, "monitors": []}


# ---------------------------------------------------------------------------
# ambient_phase: the phases a fit marks
# ---------------------------------------------------------------------------

def _phases_seen(tr, monkeypatch, fit):
    seen = set()
    enter = tr._enter_phase

    def spy(name):
        seen.add(name)
        return enter(name)

    monkeypatch.setattr(tr, "_enter_phase", spy)
    try:
        fit()
    finally:
        monkeypatch.setattr(tr, "_enter_phase", enter)
    return {s for s in seen if s.startswith(("lightgbm.", "ooc."))}


def test_the_drivers_mark_the_reference_phases(monkeypatch):
    import mmlspark_tpu.lightgbm.core as jax_lgb
    X, y = _data(n=600)
    valid = (X[:200], y[:200])
    p_port = GBDTParams(objective="binary", num_iterations=2, num_leaves=4)
    p_jax = jax_lgb.GBDTParams(objective="binary", num_iterations=2,
                               num_leaves=4)
    got = {}
    for name, tr, tr_fit, st_fit, p in (
            ("port", port_tr, train, train_streamed, p_port),
            ("jax", jax_tr, jax_lgb.train, jax_lgb.train_streamed, p_jax)):
        kw = {"device": "cpu"} if name == "port" else {}
        got[name] = (
            _phases_seen(tr, monkeypatch,
                         lambda: tr_fit(X, y, p, valid=valid, **kw)),
            _phases_seen(tr, monkeypatch,
                         lambda: st_fit(X, y, p, valid=valid, tile_rows=256,
                                        **kw)))
    assert got["port"] == got["jax"]
    assert got["port"][0] == {"lightgbm.binning", "lightgbm.histogram",
                              "lightgbm.eval"}
    assert got["port"][1] == {"ooc.binning", "ooc.tile_load",
                              "ooc.gradients", "ooc.histogram", "ooc.eval"}
