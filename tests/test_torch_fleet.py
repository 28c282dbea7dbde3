"""Port parity for the serving fleet: the fleet telemetry plane
(``mmlspark_tpu_torch/observability/{federation,autoscale}.py``) and the
topology, workers and router (``serving/distributed.py``), against the
JAX package on the CPU.

Each scenario runs the same calls on both packages' objects — the
exposition parser, the merge and the autoscale advisor on canned
expositions and a ``FakeClock``; a ``TopologyService`` with
``WorkerServer``s wrapping a doubler stage from each package's ``core``,
over 127.0.0.1 ports the OS chooses — and their observable results must
be equal (exactly: host-side bookkeeping, no floating-point tolerance
applies; ports and timings are left out of what is compared).  The
reference's own cases are ``tests/test_serving_distributed.py:24-237``,
``tests/test_fleet_telemetry.py``, ``tests/test_elastic_resume.py:301-460``
and ``tests/test_tail_tolerance.py:441``.  Then the wire: a port worker
joins a JAX ``TopologyService`` and is routed by the JAX client, and the
reverse; and a port worker serves a port GBDT booster's predictions.
"""
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import mmlspark_tpu.core as jax_core
import mmlspark_tpu.observability as jax_obs
import mmlspark_tpu.observability.federation as jax_fed
import mmlspark_tpu.serving as jax_serving
import mmlspark_tpu.serving.distributed as jax_dist
import mmlspark_tpu.utils.resilience as jax_res
import mmlspark_tpu_torch.core as port_core
import mmlspark_tpu_torch.observability as port_obs
import mmlspark_tpu_torch.observability.federation as port_fed
import mmlspark_tpu_torch.serving as port_serving
import mmlspark_tpu_torch.serving.distributed as port_dist
import mmlspark_tpu_torch.utils.resilience as port_res

PKGS = {
    "jax": dict(core=jax_core, obs=jax_obs, fed=jax_fed, srv=jax_serving,
                dist=jax_dist, res=jax_res),
    "port": dict(core=port_core, obs=port_obs, fed=port_fed,
                 srv=port_serving, dist=port_dist, res=port_res),
}


def both(scenario):
    got = {k: scenario(**m) for k, m in PKGS.items()}
    assert got["port"] == got["jax"], got
    return got["port"]


def doubler(core):
    """The reference's ``tests/serving_helpers.Doubler`` on a package's own
    ``core``: reply = 2 * request."""

    class Doubler(core.Transformer):
        def _transform(self, df):
            def per_part(p):
                vals = np.asarray([2 * float(v) for v in p["request"]],
                                  float)
                return {**p, "reply": vals}
            return df.map_partitions(per_part)

        def transform_schema(self, schema):
            return schema

    return Doubler()


def _post(url, payload, timeout=10):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read().decode())


def _get(url, timeout=10):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _register(svc, sid, alive=True, generation=0, role="trainer"):
    return _post(f"{svc.address}/register",
                 {"server_id": sid, "host": "127.0.0.1", "port": 1,
                  "alive": alive, "generation": generation, "role": role})


class Fleet:
    """A topology service and ``n`` doubler workers of one package."""

    def __init__(self, core, dist, obs, n=2, **svc_kw):
        svc_kw.setdefault("probe_interval_s", None)
        self.reg = obs.MetricsRegistry()
        self.svc = dist.TopologyService(registry=self.reg, **svc_kw).start()
        self.workers = [dist.WorkerServer(
            doubler(core), server_id=f"w{i}", driver_address=self.svc.address,
            port=0, partition_ids=[i], registry=obs.MetricsRegistry()).start()
            for i in range(n)]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for w in self.workers:
            w.stop()
        self.svc.stop()


# ---------------------------------------------------------------------------
# names
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["TopologyService", "WorkerServer",
                                  "RoutingClient", "MembershipWatcher",
                                  "FleetView", "MetricsFederator",
                                  "parse_prometheus", "AutoscaleAdvisor"])
def test_the_fleet_names_are_the_ported_code(name):
    mod = port_serving if hasattr(port_serving, name) else port_obs
    obj = getattr(mod, name)
    assert obj.__module__.startswith("mmlspark_tpu_torch.")
    assert obj.__module__.rsplit(".", 1)[-1] in ("distributed", "federation",
                                                 "autoscale")
    assert name in mod.__all__


# ---------------------------------------------------------------------------
# observability/federation.py: parse_prometheus, merge_snapshots, FleetView
# ---------------------------------------------------------------------------

def _exposition(obs, openmetrics=False):
    reg = obs.MetricsRegistry()
    c = reg.counter("mmlspark_t_reqs_total", "r", labels=("status", "name"))
    c.inc(5, status="received", name='db,primary "hot" \\ tier\none')
    c.inc(1, status="shed", name="plain")
    reg.gauge("mmlspark_t_depth", "d").set(3)
    h = reg.histogram("mmlspark_t_lat_seconds", "l",
                      buckets=(0.001, 0.01, 0.1))
    for i, v in enumerate((0.0005, 0.05, 0.5)):
        h.observe(v, trace_id=f"{i:032x}")
    return reg.to_prometheus(openmetrics=openmetrics)


@pytest.mark.parametrize("openmetrics", [False, True],
                         ids=["prometheus", "openmetrics"])
def test_parse_prometheus_alike(openmetrics):
    def scenario(obs, fed, **_):
        values, types, exemplars = fed.parse_prometheus(
            _exposition(obs, openmetrics))
        return (sorted((n, sorted(ls), v) for (n, ls), v in values.items()),
                types, sorted((k[0], sorted(k[1]), sorted(e[0].items()),
                               e[1]) for k, e in exemplars.items()))
    values, types, exemplars = both(scenario)
    assert types["mmlspark_t_lat_seconds"] == "histogram"
    assert bool(exemplars) == openmetrics


@pytest.mark.parametrize("garbage", [
    'metric{name="unterminated 1\n', "# TYPE m summary\n",
    'metric{name=noquotes} 1\n', "<html>proxy error page</html>\n",
    'm_bucket{le="0.1"} 1 # trace_id="x" 0.04\n'],
    ids=["unterminated", "summary", "unquoted", "html", "bad_exemplar"])
def test_parse_prometheus_rejects_garbage_alike(garbage):
    def scenario(fed, **_):
        with pytest.raises(ValueError) as e:
            fed.parse_prometheus(garbage)
        return str(e.value)
    both(scenario)


def _merge_view(obs, fed, bounds2=(0.001, 0.01, 0.1)):
    r0, r1, r2 = obs.MetricsRegistry(), obs.MetricsRegistry(), \
        obs.MetricsRegistry()
    for r, bounds in ((r0, (0.001, 0.01, 0.1)), (r1, (0.001, 0.01, 0.1)),
                      (r2, bounds2)):
        c = r.counter("mmlspark_t_reqs_total", "r", labels=("status",))
        c.inc(5, status="received")
        c.inc(1, status="shed")
        r.gauge("mmlspark_t_depth", "d").set(3)
        h = r.histogram("mmlspark_t_lat_seconds", "l", buckets=bounds)
        for v in (0.0005, 0.05, 0.5):
            h.observe(v)
    mismatches = []
    view = fed.FleetView.from_texts(
        {"w0": r0.to_prometheus(), "w1": r1.to_prometheus(),
         "w2": r2.to_prometheus()},
        on_mismatch=lambda fam, sid: mismatches.append((fam, sid)))
    return view, mismatches


@pytest.mark.parametrize("bounds2", [(0.001, 0.01, 0.1), (0.001, 0.02, 0.1)],
                         ids=["matching", "mismatched"])
def test_merge_sums_counters_labels_gauges_merges_histograms_alike(bounds2):
    def scenario(obs, fed, **_):
        view, mismatches = _merge_view(obs, fed, bounds2)
        agg = view.histogram_aggregate("mmlspark_t_lat_seconds")
        out = (view.counter_sum("mmlspark_t_reqs_total",
                                {"status": "received"}),
               view.counter_sum("mmlspark_t_reqs_total"),
               view.gauge_values("mmlspark_t_depth"),
               agg["count"], sorted(agg["cum"].items()),
               view.quantile("mmlspark_t_lat_seconds", 50),
               view.fraction_over("mmlspark_t_lat_seconds", 0.01),
               view.skipped_histograms, mismatches,
               view.to_prometheus(), json.dumps(view.to_dict(),
                                                sort_keys=True))
        for _ in range(3):                  # queries are pure reads
            view.quantile("mmlspark_t_lat_seconds", 99)
        return out + (view.skipped_histograms,)
    got = both(scenario)
    assert got[0] == 15 and got[1] == 18
    assert got[7] == ({} if bounds2[1] == 0.01
                      else {"mmlspark_t_lat_seconds": 1})


def test_merge_snapshots_alike():
    def scenario(fed, obs, **_):
        snaps = {}
        for sid in ("a", "b"):
            values, types, _ = fed.parse_prometheus(_exposition(obs))
            snaps[sid] = (values, types)
        return fed.merge_snapshots(snaps).to_prometheus()
    assert "mmlspark_t_depth{worker=" in both(scenario)


def test_federator_scrape_failures_book_counters_and_staleness_alike():
    def scenario(obs, fed, res, **_):
        clk = res.FakeClock()
        reg = obs.MetricsRegistry()
        r0 = obs.MetricsRegistry()
        r0.counter("mmlspark_t_ok_total", "x").inc()
        table = {"w0": {"host": "h", "port": 1},
                 "bad": {"host": "h", "port": 2},
                 "junk": {"host": "h", "port": 3}}

        def fetcher(url, timeout_s, deadline):
            if ":2/" in url:
                raise ConnectionError("connection refused")
            if ":3/" in url:
                return "<html>proxy</html>"
            return r0.to_prometheus()

        fd = fed.MetricsFederator(workers_fn=lambda: table, registry=reg,
                                  clock=clk, stale_after_s=15.0,
                                  fetcher=fetcher)
        view = fd.scrape_once()
        stale = reg.family("mmlspark_federation_stale_workers").labels(
            federation="default")
        out = [sorted((sid, w["ok"], w.get("age_s"))
                      for sid, w in view.workers.items()),
               stale.value]
        clk.advance(20)
        out.append(stale.value)
        scrapes = reg.family("mmlspark_federation_scrape_total")
        out.append(sorted((k, c.value) for k, c in scrapes._snapshot()))
        out.append((reg.breakers, reg.family("mmlspark_breaker_state")))
        fd.close()
        return out
    got = both(scenario)
    assert got[1:3] == [2, 3]


# ---------------------------------------------------------------------------
# observability/autoscale.py on a FakeClock
# ---------------------------------------------------------------------------

def _serving_view(obs, fed, per_server):
    reg = obs.MetricsRegistry()
    g_e = reg.gauge("mmlspark_serving_queue_delay_ewma_seconds", "e",
                    labels=("server",))
    g_d = reg.gauge("mmlspark_serving_queue_depth", "d", labels=("server",))
    c = reg.counter("mmlspark_serving_requests_total", "r",
                    labels=("server", "status"))
    for addr, (ewma, depth, shed, recv) in per_server.items():
        g_e.set(ewma, server=addr)
        g_d.set(depth, server=addr)
        c.inc(shed, server=addr, status="shed")
        c.inc(recv, server=addr, status="received")
    return fed.FleetView.from_texts({"w": reg.to_prometheus()})


def test_autoscale_scale_up_cooldown_hysteresis_decay_and_down_alike():
    def scenario(obs, fed, res, **_):
        clk = res.FakeClock()
        reg = obs.MetricsRegistry()
        adv = obs.AutoscaleAdvisor(registry=reg, clock=clk,
                                   target_queue_delay_s=0.1,
                                   shed_tolerance=0.01, window_s=50.0,
                                   cooldown_s=60.0,
                                   calm_s_for_downscale=200.0)
        fleet = {"score": [{"host": "h", "port": 1},
                           {"host": "h", "port": 2}]}
        a1, a2 = "h:1", "h:2"
        steps = [(0, {a1: (0.0, 0, 0, 0), a2: (0.0, 0, 0, 0)}),
                 (30, {a1: (0.05, 3, 50, 100), a2: (0.02, 2, 30, 80)}),
                 (10, {a1: (0.2, 9, 90, 150), a2: (0.2, 9, 70, 130)}),
                 (80, {a1: (0.002, 0, 90, 160), a2: (0.002, 0, 70, 140)}),
                 (80, {a1: (0.07, 0, 90, 165), a2: (0.07, 0, 70, 145)})] \
            + [(80, {a1: (0.0, 0, 90, 165), a2: (0.0, 0, 70, 145)})] * 6
        out = []
        for dt, per in steps:
            clk.advance(dt)
            r = adv.recommend(_serving_view(obs, fed, per), fleet)["score"]
            out.append(json.dumps(r, sort_keys=True, default=str))
        adv.recommend(_serving_view(obs, fed, steps[-1][1]),
                      {"other": fleet["score"]})
        out.append([s["labels"]["class"] for s in reg.to_dict()
                    ["mmlspark_autoscale_desired_replicas"]["samples"]])
        return out
    got = both(scenario)
    reasons = [json.loads(r)["reason"] for r in got[:-1]]
    assert reasons[1:5] == ["scale_up", "cooldown", "decay",
                            "hysteresis_band"]
    assert json.loads(got[-2])["desired"] == 1 and got[-1] == ["other"]


def test_autoscale_holds_when_blind_and_ignores_a_scrape_blip_alike():
    def scenario(obs, fed, res, **_):
        clk = res.FakeClock()
        out = []
        adv = obs.AutoscaleAdvisor(registry=obs.MetricsRegistry(), clock=clk,
                                   calm_s_for_downscale=10.0, cooldown_s=0.0)
        fleet = {"score": [{"server_id": "w1", "host": "h", "port": 1}]}
        for _ in range(5):
            clk.advance(20)
            view = fed.FleetView()
            view.workers["w1"] = {"ok": False, "error": "error: timeout"}
            r = adv.recommend(view, fleet)["score"]
        out.append(json.dumps(r, sort_keys=True, default=str))

        def fleet_view(per_sid, failed=()):
            texts = {}
            for sid, (addr, shed, recv) in per_sid.items():
                reg = obs.MetricsRegistry()
                reg.gauge("mmlspark_serving_queue_delay_ewma_seconds", "e",
                          labels=("server",)).set(0.0, server=addr)
                reg.gauge("mmlspark_serving_queue_depth", "d",
                          labels=("server",)).set(0, server=addr)
                c = reg.counter("mmlspark_serving_requests_total", "r",
                                labels=("server", "status"))
                c.inc(shed, server=addr, status="shed")
                c.inc(recv, server=addr, status="received")
                texts[sid] = reg.to_prometheus()
            for sid in failed:
                texts.pop(sid, None)
            view = fed.FleetView.from_texts(texts)
            for sid in failed:
                view.workers[sid] = {"ok": False, "error": "error: timeout"}
            return view

        adv = obs.AutoscaleAdvisor(registry=obs.MetricsRegistry(), clock=clk,
                                   shed_tolerance=0.02, window_s=300.0,
                                   cooldown_s=60.0,
                                   calm_s_for_downscale=1e9)
        fleet = {"score": [{"server_id": "w1", "host": "h", "port": 1},
                           {"server_id": "w2", "host": "h", "port": 2}]}
        base = {"w1": ("h:1", 0, 100), "w2": ("h:2", 30, 100)}
        for dt, per, failed in (
                (0, base, ()),
                (30, {"w1": ("h:1", 0, 110), "w2": base["w2"]}, ("w2",)),
                (30, {"w1": ("h:1", 0, 120), "w2": ("h:2", 30, 105)}, ())):
            clk.advance(dt)
            r = adv.recommend(fleet_view(per, failed), fleet)["score"]
            out.append(json.dumps(r, sort_keys=True, default=str))
        return out
    got = [json.loads(r) for r in both(scenario)]
    assert got[0]["reason"] == "telemetry_blind" and got[0]["desired"] == 1
    assert got[-1]["signals"]["shed_rate"] == 0.0 and got[-1]["desired"] == 2


# ---------------------------------------------------------------------------
# serving/distributed.py over real sockets
# ---------------------------------------------------------------------------

def test_routing_table_replies_and_aggregate_stats_alike():
    def scenario(core, dist, obs, **_):
        with Fleet(core, dist, obs) as f:
            table = f.svc.routing_table()
            client = dist.RoutingClient(f.svc.address,
                                        registry=obs.MetricsRegistry())
            rr = [client.request(i) for i in range(8)]
            keyed = [client.request(21, key="user_a") for _ in range(2)]
            agg = client.stats()
            per = {sid: (w.get("received"), w.get("replied"))
                   for sid, w in agg["workers"].items()}
            return (sorted((sid, w["partition_ids"], w["request_class"],
                            w["role"], w["api_path"])
                           for sid, w in table.items()),
                    rr, keyed, agg["received"], agg["replied"],
                    agg["errors"], agg["shed"], per, agg["evicted"])
    got = both(scenario)
    assert got[1] == [2 * i for i in range(8)] and got[2] == [42, 42]
    assert got[7] == {"w0": (6, 6), "w1": (4, 4)}     # both keyed to w0


def test_failover_off_a_dead_socket_alike():
    def scenario(core, dist, obs, **_):
        with Fleet(core, dist, obs) as f:
            reg = obs.MetricsRegistry()
            client = dist.RoutingClient(f.svc.address, registry=reg)
            out = [client.request(1)]
            f.workers[0].server.stop()   # socket gone, still registered
            out += [client.request(i, key="sticky") for i in range(4)]
            out += [client.request(i) for i in range(4)]
            fam = reg.family("mmlspark_routing_failovers_total")
            out.append(sorted((k, c.value) for k, c in fam._snapshot()))
            return out
    got = both(scenario)
    assert got[:9] == [2, 0, 2, 4, 6, 0, 2, 4, 6]


def test_eviction_after_failed_probes_alike():
    def scenario(core, dist, obs, **_):
        with Fleet(core, dist, obs,
                   prober=lambda w, t: w["server_id"] != "w1") as f:
            out = []
            for _ in range(3):
                f.svc.probe_once()
                out.append(sorted(f.svc.routing_table()))
            client = dist.RoutingClient(f.svc.address,
                                        registry=obs.MetricsRegistry())
            out.append([client.request(i) for i in range(3)])
            m = f.svc.membership()
            out.append((m["epoch"], sorted(m["workers"]),
                        sorted(m["evicted"])))
            probes = f.reg.family("mmlspark_topology_probes_total")
            out.append(sorted((k, c.value) for k, c in probes._snapshot()))
            return out
    got = both(scenario)
    assert got[2] == ["w0"] and got[4][1:] == (["w0"], ["w1"])


def test_router_prunes_breakers_of_departed_workers_alike():
    def scenario(core, dist, obs, **_):
        with Fleet(core, dist, obs) as f:
            reg = obs.MetricsRegistry()
            client = dist.RoutingClient(f.svc.address, registry=reg,
                                        refresh_s=0.0)
            out = [client.request(i) for i in range(4)]
            out.append((sorted(client.breakers), sorted(reg.breakers)))
            f.workers[1].stop()
            out.append(client.request(5))
            out.append((sorted(client.breakers), sorted(reg.breakers),
                        [s["labels"]["breaker"] for s in reg.to_dict()
                         ["mmlspark_breaker_state"]["samples"]]))
            f.workers[1] = dist.WorkerServer(
                doubler(core), server_id="w1",
                driver_address=f.svc.address, port=0,
                registry=obs.MetricsRegistry()).start()
            out += [client.request(i) for i in range(4)]
            out.append(sorted(client.breakers))
            return out
    got = both(scenario)
    assert got[6] == (["w0"], ["worker:w0"], ["worker:w0"])
    assert got[-1] == ["w0", "w1"]


def test_membership_epochs_on_join_drain_and_leave_alike():
    def scenario(core, dist, obs, **_):
        reg = obs.MetricsRegistry()
        svc = dist.TopologyService(registry=reg, probe_interval_s=None,
                                   prober=lambda w, t: w.get("alive", True)
                                   ).start()
        out = []
        try:
            out.append(_register(svc, "t1")["membership_epoch"])   # join
            out.append(_register(svc, "t1")["membership_epoch"])   # beat
            out.append(_register(svc, "t2")["membership_epoch"])
            out.append(_register(svc, "t1", generation=1)[
                "membership_epoch"])                              # rejoin
            fired = []
            watcher = dist.MembershipWatcher(svc.address, poll_s=600.0,
                                             on_shrink=fired.append)
            out.append(watcher.poll_once())                       # baseline
            w = dist.WorkerServer(doubler(core), server_id="w",
                                  driver_address=svc.address, port=0,
                                  role="serving",
                                  registry=obs.MetricsRegistry()).start()
            out.append((svc.membership()["epoch"], watcher.poll_once()))
            client = dist.RoutingClient(svc.address, refresh_s=0.0,
                                        registry=obs.MetricsRegistry())
            out.append(client.request(4))
            _post(f"{svc.address}/register",
                  w._registration(state="draining"))
            m = svc.membership()
            out.append((m["epoch"], m["workers"]["w"]["state"],
                        m["workers"]["t1"]["state"]))
            out.append(w.drain(timeout_s=5.0))
            info = watcher.poll_once()
            out.append((svc.membership()["epoch"], info))
            _register(svc, "t2", alive=False)
            for _ in range(3):
                svc.probe_once()
            info = watcher.poll_once()
            m = svc.membership()
            out.append((m["epoch"], sorted(m["workers"]),
                        sorted(m["evicted"]), info, watcher.shrinks))
            out.append(sorted((k, c.value) for k, c in reg.family(
                "mmlspark_fleet_membership_changes_total")._snapshot()))
            out.append(fired)
            w.stop()
        finally:
            svc.stop()
        return out
    got = both(scenario)
    assert got[:5] == [1, 1, 2, 3, None]
    assert got[7] == (4, "draining", "up") and got[8] is True
    assert got[9][0] == 5 and got[9][1]["lost"] == ["w"]


def test_fleet_endpoints_and_their_400s_alike():
    bad = ("/fleet/slow?k=abc", "/fleet/slow?k=-1", "/fleet/slow?k=1.5",
           "/fleet/slow?deadline_ms=0", "/fleet/slow?deadline_ms=nope",
           "/fleet/metrics?refresh=2", "/fleet/metrics?deadline_ms=-5",
           "/fleet/slo?refresh=maybe", "/fleet/autoscale?refresh=yes",
           "/fleet/capacity?refresh=2", "/fleet/trace/x?deadline_ms=0")
    ok = ("/fleet/slow?k=3&deadline_ms=1500", "/fleet/slow?novel=1",
          "/fleet/metrics?refresh=1", "/fleet/slo?refresh=0",
          "/fleet/autoscale", "/fleet/capacity?refresh=1", "/fleet/dump",
          "/fleet/membership", "/routing", "/stats", "/health",
          "/fleet/trace/" + "0" * 32)

    def scenario(core, dist, obs, fed, **_):
        with Fleet(core, dist, obs, fleet_slow_deadline_s=5.0) as f:
            for i in range(4):
                for w in f.workers:
                    _post(w.address, i)
            out = []
            for path in bad:
                status, body = _get(f.svc.address + path)
                out.append((path, status,
                            "bad query param" in json.loads(body)["error"]))
            for path in ok:
                status, body = _get(f.svc.address + path)
                out.append((path, status))
            slow = json.loads(_get(f.svc.address + "/fleet/slow?k=5")[1])
            out.append((sorted({r["worker"] for r in slow["slowest"]}),
                        len(slow["slowest"]),
                        sorted(slow["workers"])))
            auto = json.loads(_get(f.svc.address + "/fleet/autoscale")[1])
            out.append((sorted(auto["classes"]),
                        auto["classes"]["default"]["current"],
                        sorted(auto["workers"])))
            mem = json.loads(_get(f.svc.address + "/fleet/membership")[1])
            out.append((mem["epoch"], sorted(
                (sid, w["role"], w["state"], w["request_class"])
                for sid, w in mem["workers"].items())))
            text = _get(f.svc.address + "/fleet/metrics?refresh=1")[1]
            values, _, _ = fed.parse_prometheus(text)
            out.append(sum(v for (n, ls), v in values.items()
                           if n == "mmlspark_serving_requests_total"
                           and dict(ls).get("status") == "replied"))
            return out
    got = both(scenario)
    assert all(s == 400 and msg for _, s, msg in got[:len(bad)])
    assert [s for _, s in got[len(bad):len(bad) + len(ok)]] == \
        [200] * (len(ok) - 1) + [404]
    assert got[-1] == 8.0                  # federated = both workers' own


def test_fleet_slow_isolates_a_dead_worker_and_prunes_its_breaker_alike():
    def scenario(core, dist, obs, **_):
        with Fleet(core, dist, obs, fleet_slow_deadline_s=5.0) as f:
            for i in range(2):
                for w in f.workers:
                    _post(w.address, i)
            _post(f"{f.svc.address}/register",
                  {"server_id": "dead", "host": "127.0.0.1", "port": 9})
            verdicts = []
            for _ in range(4):
                got = f.svc.fleet_slow(k=3)
                d = got["workers"]["dead"]
                verdicts.append(("error" if "error" in d
                                 else d.get("skipped"),
                                 len(got["slowest"]) > 0))
            out = [verdicts, "fleet-slow:dead" in f.reg.breakers]
            _post(f"{f.svc.address}/deregister", {"server_id": "dead"})
            f.svc.fleet_slow(k=1)
            out.append("fleet-slow:dead" in f.reg.breakers)
            return out
    got = both(scenario)
    assert got[0][0] == ("error", True) and got[0][-1][0] == "circuit_open"
    assert got[1:] == [True, False]


# ---------------------------------------------------------------------------
# the wire: each package's worker in the other's fleet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("driver,worker", [("jax", "port"), ("port", "jax")],
                         ids=["port_worker_jax_topology",
                              "jax_worker_port_topology"])
def test_a_worker_joins_the_other_packages_topology(driver, worker):
    d, w = PKGS[driver], PKGS[worker]
    svc = d["dist"].TopologyService(registry=d["obs"].MetricsRegistry(),
                                    probe_interval_s=None).start()
    workers = [w["dist"].WorkerServer(
        doubler(w["core"]), server_id=f"{worker}{i}",
        driver_address=svc.address, port=0, request_class="score",
        registry=w["obs"].MetricsRegistry()).start() for i in range(2)]
    try:
        client = d["dist"].RoutingClient(
            svc.address, registry=d["obs"].MetricsRegistry())
        assert [client.request(i) for i in range(6)] == \
            [2 * i for i in range(6)]
        assert client.request(7, key="k") == 14
        agg = svc.aggregate_stats()
        assert agg["replied"] == 7
        assert sorted(agg["workers"]) == [f"{worker}0", f"{worker}1"]
        auto = svc._fleet_state(refresh=True)[2]
        assert auto["score"]["current"] == 2
        # the other package's watcher reads the same membership plane
        watcher = w["dist"].MembershipWatcher(svc.address, poll_s=600.0,
                                              on_shrink=lambda i: None)
        assert watcher.poll_once() is None
        workers[1].drain(timeout_s=5.0)
        assert watcher.poll_once()["lost"] == [f"{worker}1"]
        assert client.request(3) == 6
    finally:
        for wk in workers:
            wk.stop()
        svc.stop()


def test_a_port_worker_serves_a_port_gbdt_model():
    from mmlspark_tpu_torch.lightgbm import GBDTParams, train
    rng = np.random.default_rng(0)
    X = rng.normal(size=(600, 6)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    booster = train(X, y, GBDTParams(num_iterations=5, num_leaves=8),
                    device="cpu").booster

    class Scorer(port_core.Transformer):
        def _transform(self, df):
            def per_part(p):
                rows = np.stack([np.asarray(r, np.float32)
                                 for r in p["request"]])
                return {**p, "reply": booster.predict(rows, device="cpu")}
            return df.map_partitions(per_part)

        def transform_schema(self, schema):
            return schema

    svc = port_dist.TopologyService(registry=port_obs.MetricsRegistry(),
                                    probe_interval_s=None).start()
    w = port_dist.WorkerServer(Scorer(), server_id="gbdt",
                               driver_address=svc.address, port=0,
                               registry=port_obs.MetricsRegistry()).start()
    try:
        client = port_dist.RoutingClient(svc.address,
                                         registry=port_obs.MetricsRegistry())
        got = np.asarray([client.request([float(v) for v in X[i]])
                          for i in range(40)])
        want = booster.predict(X[:40], device="cpu")
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    finally:
        w.stop()
        svc.stop()
