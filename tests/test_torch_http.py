"""Port parity for the row batchers, the minibatch transformers, the HTTP
client plane (``mmlspark_tpu_torch/stages/{batchers,minibatch}.py``,
``io/http.py``) and the span collector's OTLP HTTP sink, against the JAX
package on the CPU.

Each scenario runs the same calls on both packages' objects — the
batchers on the same rows, the client's retries, breaker and deadline on
a ``FakeClock`` with a scripted transport, the transformers against one
local mock service on a 127.0.0.1 port the OS chooses — and their
observable results must be equal (exactly: host-side bookkeeping, no
floating-point tolerance applies).  The reference's own cases are
``tests/test_resilience.py:192-260``, ``tests/test_io_serving_cognitive.py
:69-100`` and ``tests/test_dl.py:99``.
"""
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import mmlspark_tpu.core as jax_core
import mmlspark_tpu.io.http as jax_http
import mmlspark_tpu.observability as jax_obs
import mmlspark_tpu.observability.collector as jax_col
import mmlspark_tpu.observability.tracing as jax_tr
import mmlspark_tpu.stages as jax_stages
import mmlspark_tpu.stages.batchers as jax_batchers
import mmlspark_tpu.utils.resilience as jax_res
import mmlspark_tpu_torch.core as port_core
import mmlspark_tpu_torch.io as port_io
import mmlspark_tpu_torch.io.http as port_http
import mmlspark_tpu_torch.observability as port_obs
import mmlspark_tpu_torch.observability.collector as port_col
import mmlspark_tpu_torch.observability.tracing as port_tr
import mmlspark_tpu_torch.stages as port_stages
import mmlspark_tpu_torch.stages.batchers as port_batchers
import mmlspark_tpu_torch.utils.resilience as port_res

PKGS = {
    "jax": dict(core=jax_core, http=jax_http, obs=jax_obs, col=jax_col,
                tr=jax_tr, stages=jax_stages, batchers=jax_batchers,
                res=jax_res),
    "port": dict(core=port_core, http=port_http, obs=port_obs, col=port_col,
                 tr=port_tr, stages=port_stages, batchers=port_batchers,
                 res=port_res),
}


def both(scenario):
    got = {k: scenario(**m) for k, m in PKGS.items()}
    assert got["port"] == got["jax"], got
    return got["port"]


def _plain(v):
    """A collected cell as plain Python, for equality across packages."""
    if isinstance(v, np.ndarray):
        return [_plain(x) for x in v.tolist()]
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, np.generic):
        return v.item()
    return v


def _frame(core, n=10):
    ids = np.arange(n)
    text = np.empty(n, dtype=object)
    for i in range(n):
        text[i] = f"row{i}"
    return core.DataFrame.from_dict({"id": ids, "text": text,
                                     "x": ids * 0.5}, num_partitions=2)


def _collect(df):
    return {k: _plain(v) for k, v in df.collect().items()}


# ---------------------------------------------------------------------------
# stages/batchers.py, stages/minibatch.py
# ---------------------------------------------------------------------------

def test_io_and_stages_export_the_reference_names():
    assert set(port_io.__all__) >= {
        "HTTPRequestData", "HTTPResponseData", "HTTPClient",
        "AsyncHTTPClient", "HTTPTransformer", "SimpleHTTPTransformer",
        "REQUEST_BINDING", "RESPONSE_BINDING"}
    # the minibatch transformers and, since ``transforms`` was ported, the
    # whole of the reference's ``stages`` package
    assert {"FixedMiniBatchTransformer", "DynamicMiniBatchTransformer",
            "TimeIntervalMiniBatchTransformer", "FlattenBatch"} <= \
        set(port_stages.__all__)
    assert set(port_stages.__all__) == set(jax_stages.__all__)


@pytest.mark.parametrize("size", [1, 3, 4, 10, 25])
def test_fixed_and_time_interval_batchers_cut_alike(size):
    def scenario(batchers, **_):
        rows = list(range(23))
        return (list(batchers.fixed_batches(rows, size)),
                # an interval no run reaches: the size alone cuts
                list(batchers.time_interval_batches(rows, 10 ** 7, size)))
    fixed, timed = both(scenario)
    assert fixed == timed and sum(map(len, fixed)) == 23


def test_dynamic_batcher_keeps_every_row_in_order():
    def scenario(batchers, **_):
        got = [list(batchers.dynamic_batches(range(200), m))
               for m in (1, 7, 2 ** 31)]
        assert all(len(b) <= 7 for b in got[1])
        # how rows group depends on the producer thread's pace; the rows
        # and their order do not
        return [[x for b in g for x in b] for g in got], \
            [len(b) for b in got[0]]
    flat, singles = both(scenario)
    assert flat == [list(range(200))] * 3 and singles == [1] * 200


@pytest.mark.parametrize("kind,kw", [
    ("FixedMiniBatchTransformer", {"batch_size": 3}),
    ("FixedMiniBatchTransformer", {"batch_size": 5}),
    ("DynamicMiniBatchTransformer", {"max_batch_size": 1}),
    ("TimeIntervalMiniBatchTransformer",
     {"millis_to_wait": 10 ** 7, "max_batch_size": 4})],
    ids=["fixed3", "fixed5", "dynamic1", "interval4"])
def test_minibatch_transformers_give_equal_batches_and_flatten_back(kind, kw):
    def scenario(core, stages, **_):
        df = _frame(core)
        batched = getattr(stages, kind)().set_params(**kw).transform(df)
        flat = stages.FlattenBatch().transform(batched)
        return _collect(batched), _collect(flat)
    batched, flat = both(scenario)
    assert flat == _collect(_frame(port_core))
    assert [len(b) for b in batched["id"]] and \
        sum(len(b) for b in batched["id"]) == 10


def test_dynamic_minibatch_rows_survive_the_round_trip():
    def scenario(core, stages, **_):
        df = _frame(core, n=40)
        batched = stages.DynamicMiniBatchTransformer().transform(df)
        return _collect(stages.FlattenBatch().transform(batched))
    assert both(scenario) == _collect(_frame(port_core, n=40))


def test_flatten_batch_pads_ragged_cells_with_none():
    def scenario(core, stages, **_):
        a = np.empty(2, dtype=object)
        b = np.empty(2, dtype=object)
        a[0], a[1] = [1, 2, 3], [4]
        b[0], b[1] = ["x"], ["y", "z"]
        df = core.DataFrame.from_dict({"a": a, "b": b})
        return _collect(stages.FlattenBatch().transform(df))
    assert both(scenario) == {"a": [1, 2, 3, 4, None],
                              "b": ["x", None, None, "y", "z"]}


# ---------------------------------------------------------------------------
# io/http.py: HTTPClient on a FakeClock with scripted transports
# ---------------------------------------------------------------------------

class Script:
    """A transport replaying a fixed list of outcomes ("ok", "refused",
    or an HTTP status, optionally with a Retry-After) and recording the
    clock at each call."""

    def __init__(self, http, clock, outcomes):
        self.http, self.clock = http, clock
        self.outcomes = list(outcomes)
        self.calls = []

    def __call__(self, req, timeout_s):
        out = self.outcomes[min(len(self.calls), len(self.outcomes) - 1)]
        self.calls.append((round(self.clock(), 9), round(timeout_s, 9),
                           dict(req.headers or {}).get(
                               "X-MMLSpark-Trace-Id")))
        if out == "refused":
            raise ConnectionRefusedError("refused")
        if out == "ok":
            return self.http.HTTPResponseData(status_code=200, reason="OK",
                                              entity=b'{"ok": 1}')
        status, retry_after = out
        headers = {} if retry_after is None else {"Retry-After": retry_after}
        return self.http.HTTPResponseData(status_code=status,
                                          reason="scripted", headers=headers,
                                          entity=b'{"error": 1}')


def _resp(r):
    return (r.status_code, r.reason, r.entity)


@pytest.mark.parametrize("outcomes,retries", [
    (["ok"], 3),
    (["refused", "refused", "ok"], 3),
    (["refused"] * 5, 3),
    ([(503, None), (503, None), "ok"], 2),
    ([(429, "0.25"), "ok"], 2),
    ([(503, "2"), (503, "2"), (503, "2")], 2),
    ([(404, None)], 3),
    ([(500, "not-a-number"), "ok"], 1)],
    ids=["ok", "refused_then_ok", "refused_always", "503_backoff",
         "429_retry_after", "503_retry_after_spent", "404_final",
         "bad_retry_after"])
def test_http_client_retries_alike(outcomes, retries):
    def scenario(http, res, **_):
        clk = res.FakeClock()
        t = Script(http, clk, outcomes)
        client = http.HTTPClient(retries=retries, backoff_ms=[100, 400],
                                 transport=t, clock=clk, sleep=clk.sleep)
        r = client.send(http.HTTPRequestData(url="http://svc/x"))
        return _resp(r), t.calls, round(clk(), 9)
    both(scenario)


def test_http_client_deadline_never_retries_past_budget():
    def scenario(http, res, **_):
        clk = res.FakeClock()
        t = Script(http, clk, ["refused"])
        client = http.HTTPClient(retries=10, backoff_ms=[100], transport=t,
                                 clock=clk, sleep=clk.sleep)
        with res.deadline_scope(res.Deadline.after(0.2, clk)):
            r = client.send(http.HTTPRequestData(url="http://svc/x"))
        assert clk() <= 0.2 + 1e-9
        return _resp(r)[0], t.calls
    code, calls = both(scenario)
    assert code == 0 and len(calls) == 2


def test_http_client_breaker_short_circuits_and_recovers():
    def scenario(http, res, **_):
        clk = res.FakeClock()
        b = res.CircuitBreaker(failure_threshold=3, window_s=60.0,
                               cooldown_s=5.0, clock=clk, name="edge")
        t = Script(http, clk, ["refused"])
        client = http.HTTPClient(retries=0, breaker=b, transport=t,
                                 clock=clk, sleep=clk.sleep)
        req = http.HTTPRequestData(url="http://svc/x")
        seen = [client.send(req).status_code for _ in range(3)]
        seen.append(b.state)
        shorted = client.send(req)
        seen += [shorted.status_code, shorted.reason,
                 shorted.headers.get("X-Circuit-Open"), len(t.calls)]
        clk.advance(5.0)
        t.outcomes = ["ok"]
        seen += [client.send(req).status_code, b.state]
        return seen
    assert both(scenario) == [0, 0, 0, "open", 503, "circuit open", "1", 3,
                              200, "closed"]


def test_http_client_expired_deadline_keeps_the_half_open_probe():
    def scenario(http, res, **_):
        clk = res.FakeClock()
        b = res.CircuitBreaker(failure_threshold=1, cooldown_s=5.0,
                               clock=clk)
        client = http.HTTPClient(retries=0, breaker=b,
                                 transport=Script(http, clk, ["ok"]),
                                 clock=clk, sleep=clk.sleep)
        req = http.HTTPRequestData(url="http://svc/x")
        b.record_failure()
        clk.advance(5.0)
        dead = res.Deadline.after(0.0, clk)
        clk.advance(0.1)
        r = client.send(req, deadline=dead)
        return (r.status_code, "deadline" in r.reason,
                client.send(req).status_code, b.state)
    assert both(scenario) == (0, True, 200, "closed")


def test_http_client_503_storm_trips_breaker_and_429_does_not():
    def scenario(http, res, **_):
        clk = res.FakeClock()
        out = []
        for status in (503, 429):
            b = res.CircuitBreaker(failure_threshold=2, clock=clk)
            client = http.HTTPClient(
                retries=0, breaker=b, clock=clk, sleep=clk.sleep,
                transport=Script(http, clk, [(status, "0.2")]))
            req = http.HTTPRequestData(url="http://svc/x")
            out.append([client.send(req).status_code for _ in range(3)]
                       + [b.state])
        return out
    assert both(scenario) == [[503, 503, 503, "open"],
                              [429, 429, 429, "closed"]]


def test_http_client_injects_the_ambient_trace_id():
    def scenario(http, res, tr, **_):
        clk = res.FakeClock()
        t = Script(http, clk, ["ok"])
        client = http.HTTPClient(retries=0, transport=t, clock=clk,
                                 sleep=clk.sleep)
        req = http.HTTPRequestData(url="http://svc/x", headers={"A": "1"})
        client.send(req)                            # no span: no header
        with tr.trace_span("outer", trace_id="c" * 32):
            client.send(req)
        client.send(req, trace_id="d" * 32)         # explicit wins
        return [c[2] for c in t.calls], req.headers
    ids, headers = both(scenario)
    assert ids == [None, "c" * 32, "d" * 32]
    assert headers == {"A": "1"}                    # copy-on-write


def test_async_client_keeps_order_and_skips_none():
    def scenario(http, res, **_):
        clk = res.FakeClock()

        def transport(req, timeout_s):
            n = json.loads(req.entity)["n"]
            if n % 3 == 0:
                raise ConnectionResetError("reset")
            return http.HTTPResponseData(status_code=200 + n % 2,
                                         entity=req.entity)

        client = http.AsyncHTTPClient(concurrency=4, retries=0,
                                      transport=transport, clock=clk,
                                      sleep=clk.sleep)
        reqs = [None if i == 5 else
                http.HTTPRequestData.post_json("http://svc/x", {"n": i})
                for i in range(12)]
        return [None if r is None else _resp(r)
                for r in client.send_all(reqs)]
    got = both(scenario)
    assert got[5] is None and got[3][0] == 0 and got[4][0] == 200


# ---------------------------------------------------------------------------
# HTTPTransformer / SimpleHTTPTransformer against one local mock service
# ---------------------------------------------------------------------------

class MockService:
    """An echoing JSON service on 127.0.0.1 (``/fail`` answers 500); the
    reference's ``tests/test_io_serving_cognitive.py`` mock."""

    def __init__(self):
        outer = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                outer.requests.append({"path": self.path, "body": body,
                                       "headers": dict(self.headers)})
                if self.path.endswith("/fail"):
                    self.send_response(500)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                try:
                    payload = json.loads(body or b"null")
                except ValueError:
                    payload = {"raw_len": len(body)}
                resp = json.dumps({"echo": payload,
                                   "path": self.path}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(resp)))
                self.end_headers()
                self.wfile.write(resp)

        self.requests = []
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.httpd.server_port}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(5)


@pytest.fixture()
def mock_service():
    s = MockService()
    yield s
    s.close()


def _cells(values):
    col = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        col[i] = v
    return col


@pytest.mark.parametrize("path", ["/t", "/fail"])
def test_http_transformer_columns_alike(mock_service, path):
    def scenario(core, http, **_):
        reqs = _cells([None if i == 2 else http.HTTPRequestData.post_json(
            mock_service.url + path, {"i": i}) for i in range(5)])
        df = core.DataFrame.from_dict({"req": reqs})
        out = http.HTTPTransformer(input_col="req", output_col="resp",
                                   concurrency=5).transform(df).collect()
        return [None if r is None else
                (r["status_code"], r["reason"], r["entity"])
                for r in out["resp"]]
    got = both(scenario)
    assert got[2] is None
    if path == "/t":
        assert json.loads(got[1][2].decode())["echo"] == {"i": 1}
    else:
        assert {g[0] for g in got if g is not None} == {500}


@pytest.mark.parametrize("kw", [
    {}, {"max_batch_size": 2}, {"headers": {"X-Extra": "1"}},
    {"output_parser": "echo"}],
    ids=["plain", "batched", "headers", "custom_parser"])
@pytest.mark.parametrize("path", ["/svc", "/fail"])
def test_simple_http_transformer_outputs_and_errors_alike(mock_service, kw,
                                                          path):
    def scenario(core, http, **_):
        df = core.DataFrame.from_dict({"data": _cells(
            [{"x": i} for i in range(5)])})
        params = dict(kw)
        if params.get("output_parser") == "echo":
            params["output_parser"] = lambda resp: resp.json()["echo"]
        t = http.SimpleHTTPTransformer(input_col="data", output_col="parsed",
                                       url=mock_service.url + path,
                                       concurrency=5, **params)
        out = t.transform(df).collect()
        return _plain(out["parsed"]), _plain(out["errors"])
    parsed, errors = both(scenario)
    if path == "/fail":
        assert all(p is None for p in parsed)
        assert all(e["status_code"] == 500 for e in errors)
    else:
        assert all(e is None for e in errors)
    got = [r for r in mock_service.requests if r["path"] == path]
    bodies = [r["body"] for r in got]
    half = len(bodies) // 2
    assert sorted(bodies[:half]) == sorted(bodies[half:])   # same wire
    if "headers" in kw:
        assert all(r["headers"].get("X-Extra") == "1" for r in got)


# ---------------------------------------------------------------------------
# observability/collector.py: the OTLP HTTP sink
# ---------------------------------------------------------------------------

def _normalize(obj):
    """The OTLP payload with the package's own name folded out (the port
    names itself where the reference does: ``service.name`` and the
    instrumentation scope) and the random span ids blanked."""
    obj = json.loads(json.dumps(obj).replace("mmlspark_tpu_torch",
                                             "mmlspark_tpu"))
    for rs in obj["resourceSpans"]:
        for ss in rs["scopeSpans"]:
            for sp in ss["spans"]:
                sp["spanId"] = "-"
    return obj


def test_collector_http_sink_posts_the_reference_payload(mock_service):
    def scenario(obs, tr, res, col, **_):
        clk = res.FakeClock()
        reg = obs.MetricsRegistry()
        c = col.SpanCollector(registry=reg, clock=clk, epoch_offset_s=0.0,
                              endpoint=mock_service.url + "/v1/traces",
                              batch_size=8, flush_interval_s=3600.0)
        for i in range(6):
            s = tr.Span(f"span{i}", trace_id=f"{i:032x}", start_s=float(i),
                        clock=clk, attributes={"i": i})
            s.finish(i + 0.5)
            c.record(s)
        sent = 0
        while (k := c.flush_now()):
            sent += k
        batches = reg.family("mmlspark_otlp_export_batches_total")
        return sent, sorted((tuple(k), ch.value)
                            for k, ch in batches._snapshot())
    got = both(scenario)
    assert got[0] == 6
    posts = [r for r in mock_service.requests if r["path"] == "/v1/traces"]
    assert len(posts) == 2                     # one batch per package
    payloads = [_normalize(json.loads(p["body"])) for p in posts]
    assert payloads[0] == payloads[1]
    spans = payloads[0]["resourceSpans"][0]["scopeSpans"][0]["spans"]
    assert spans and spans[0]["name"].startswith("span")


def test_collector_http_sink_fails_shut_on_a_dead_endpoint():
    """A refused endpoint drops and counts its batches; the breaker then
    short-circuits without a network call (one probe per cooldown)."""
    def scenario(obs, tr, res, col, **_):
        clk = res.FakeClock()
        reg = obs.MetricsRegistry()
        calls = []

        def transport(req, timeout_s):
            calls.append(req.url)
            raise ConnectionRefusedError("refused")

        c = col.SpanCollector(registry=reg, clock=clk, epoch_offset_s=0.0,
                              endpoint="http://127.0.0.1:9/v1/traces",
                              batch_size=1, transport=transport)
        for i in range(5):
            s = tr.Span(f"s{i}", trace_id="e" * 32, start_s=0.0, clock=clk)
            s.finish(1.0)
            c.record(s)
            c.flush_now()
        fam = reg.family("mmlspark_otlp_export_batches_total")
        return len(calls), c.breaker.state, sorted(
            (tuple(k), ch.value) for k, ch in fam._snapshot())
    n_calls, state, _ = both(scenario)
    assert n_calls == 3 and state == "open"
