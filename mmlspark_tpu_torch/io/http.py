"""HTTP-on-frame — full HTTP request/response as typed columns.

An own copy of the JAX package's ``io/http.py``, verbatim apart from module
paths.

Reference: ``core/.../io/http/`` —
- ``HTTPSchema.scala`` (358 LoC): HTTPRequestData/HTTPResponseData as Spark
  StructTypes via SparkBindings;
- ``Clients.scala:12,48``: sync + async clients, bounded concurrency;
- ``HTTPClients.scala:74-156``: ``sendWithRetries`` + advanced throttling;
- ``HTTPTransformer.scala:111`` / ``SimpleHTTPTransformer.scala:64``.

Here requests ride as dataclass cells in object columns (``Binding`` codec);
the async client is a bounded thread pool (Python's analogue of the
reference's Future pool) with exponential-backoff retries honoring
Retry-After.

Resilience (utils/resilience.py): clients optionally share a
``CircuitBreaker`` (open circuit -> synthetic 503 without touching the
network), and every retry loop is clipped to the ambient ``Deadline`` so a
caller's budget bounds the whole fan-out, not just a single attempt.  The
raw exchange is an injectable ``transport`` so the chaos harness
(testing/chaos.py) injects latency/errors/storms deterministically.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..core import (Binding, DataFrame, HasInputCol, HasOutputCol, Param,
                    Transformer)
from ..core.schema import ColumnType
from ..observability.tracing import (TRACE_HEADER, TRACEPARENT_HEADER,
                                     current_span, current_trace_id,
                                     format_traceparent)
from ..stages.minibatch import FixedMiniBatchTransformer, FlattenBatch
from ..utils.resilience import CircuitBreaker, Deadline, current_deadline


@dataclasses.dataclass
class HTTPRequestData:
    """Reference HTTPSchema request struct."""
    url: str
    method: str = "GET"
    headers: Optional[Dict[str, str]] = None
    entity: Optional[bytes] = None

    @staticmethod
    def post_json(url: str, payload: Any, headers: Optional[Dict[str, str]] = None):
        h = {"Content-Type": "application/json"}
        h.update(headers or {})
        return HTTPRequestData(url=url, method="POST", headers=h,
                               entity=json.dumps(payload).encode())


@dataclasses.dataclass
class HTTPResponseData:
    """Reference HTTPSchema response struct."""
    status_code: int
    reason: str = ""
    headers: Optional[Dict[str, str]] = None
    entity: Optional[bytes] = None

    def json(self) -> Any:
        return json.loads(self.entity.decode()) if self.entity else None


REQUEST_BINDING = Binding(HTTPRequestData)
RESPONSE_BINDING = Binding(HTTPResponseData)


def _urllib_transport(req: HTTPRequestData, timeout_s: float) -> HTTPResponseData:
    """One raw exchange.  HTTP error statuses come back as responses (not
    exceptions); transport-level failures (refused, reset, DNS) raise."""
    try:
        r = urllib.request.Request(req.url, data=req.entity, method=req.method,
                                   headers=dict(req.headers or {}))
        with urllib.request.urlopen(r, timeout=timeout_s) as resp:
            return HTTPResponseData(
                status_code=resp.status, reason=getattr(resp, "reason", ""),
                headers=dict(resp.headers), entity=resp.read())
    except urllib.error.HTTPError as e:
        body = e.read() if hasattr(e, "read") else b""
        return HTTPResponseData(status_code=e.code, reason=str(e.reason),
                                headers=dict(e.headers or {}), entity=body)


def _with_trace_header(req: HTTPRequestData,
                       trace_id: Optional[str] = None) -> HTTPRequestData:
    """Copy-on-write trace-id injection: the ambient span's trace id (or an
    explicit one — thread pools don't inherit the contextvar) rides
    ``X-MMLSpark-Trace-Id`` AND a W3C ``traceparent`` (an
    external frontend that only speaks Trace Context still joins the trace)
    so worker-side spans join the caller's trace.  An explicit header
    already on the request wins; the caller's request object is never
    mutated."""
    if req.headers and TRACE_HEADER in req.headers:
        # explicit legacy header wins for the trace id, but the W3C pair
        # must still ride next to it (a W3C-only downstream would start a
        # disconnected trace otherwise)
        if TRACEPARENT_HEADER in req.headers:
            return req
        headers = dict(req.headers)
        span = current_span()
        headers[TRACEPARENT_HEADER] = format_traceparent(
            headers[TRACE_HEADER], span.span_id if span is not None else None)
        return dataclasses.replace(req, headers=headers)
    tid = trace_id or current_trace_id()
    if tid is None:
        return req
    headers = dict(req.headers or {})
    headers[TRACE_HEADER] = tid
    if TRACEPARENT_HEADER not in headers:
        span = current_span()
        headers[TRACEPARENT_HEADER] = format_traceparent(
            tid, span.span_id if span is not None else None)
    return dataclasses.replace(req, headers=headers)


def circuit_open_response(retry_after_s: float) -> HTTPResponseData:
    """Synthetic 503 emitted when a breaker rejects without a network call."""
    return HTTPResponseData(
        status_code=503, reason="circuit open",
        headers={"Retry-After": str(max(0, int(retry_after_s)) or 1),
                 "X-Circuit-Open": "1"})


class HTTPClient:
    """Single-threaded client with retries (reference SingleThreadedHTTPClient
    + HandlingUtils.sendWithRetries).

    ``breaker`` (shared CircuitBreaker): 5xx/transport failures feed it; an
    open circuit short-circuits to a synthetic 503.  The ambient
    ``deadline_scope`` (or an explicit ``deadline=``) clips every attempt
    timeout and backoff sleep to the caller's remaining budget — retries
    never overshoot it.  ``transport``/``clock``/``sleep`` are injectable
    for the deterministic chaos harness.
    """

    def __init__(self, retries: int = 3, backoff_ms: Optional[List[int]] = None,
                 timeout_s: float = 60.0,
                 breaker: Optional[CircuitBreaker] = None,
                 transport: Optional[Callable[[HTTPRequestData, float],
                                              HTTPResponseData]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        self.retries = retries
        self.backoffs = backoff_ms or [100, 500, 1000]
        self.timeout_s = timeout_s
        self.breaker = breaker
        self.transport = transport or _urllib_transport
        self.clock = clock
        self.sleep = sleep

    def _sleep_budgeted(self, seconds: float, deadline: Optional[Deadline]) -> bool:
        """Sleep, clipped to the remaining budget.  False if the budget is
        already gone (caller should stop retrying)."""
        if deadline is not None:
            remaining = deadline.remaining()
            if remaining <= 0:
                return False
            seconds = min(seconds, remaining)
        self.sleep(seconds)
        return True

    def send(self, req: HTTPRequestData,
             deadline: Optional[Deadline] = None,
             trace_id: Optional[str] = None) -> HTTPResponseData:
        deadline = deadline or current_deadline()
        req = _with_trace_header(req, trace_id)
        last_err: Optional[HTTPResponseData] = None
        for attempt in range(self.retries + 1):
            # deadline check MUST precede breaker admission: allow() may
            # consume a half-open probe slot, and an early return here would
            # leak it (the breaker would stay half-open forever)
            timeout_s = self.timeout_s
            if deadline is not None:
                if deadline.expired():
                    return last_err or HTTPResponseData(
                        status_code=0, reason="deadline exceeded before attempt")
                timeout_s = deadline.clip(self.timeout_s)
            if self.breaker is not None and not self.breaker.allow():
                return last_err or circuit_open_response(
                    self.breaker.retry_after_s())
            try:
                resp = self.transport(req, timeout_s)
            except Exception as e:  # noqa: BLE001 — network errors retried
                last_err = HTTPResponseData(status_code=0, reason=str(e))
                if self.breaker is not None:
                    self.breaker.record_failure()
            else:
                last_err = resp
                code = resp.status_code
                # 429 is the dependency throttling us, not failing — it
                # retries but never trips the breaker
                if self.breaker is not None:
                    if code == 0 or code >= 500:
                        self.breaker.record_failure()
                    else:
                        self.breaker.record_success()
                if 0 < code < 500 and code != 429:
                    return resp  # 2xx/3xx/4xx: done
                # throttling/outage: honor Retry-After (reference advanced
                # handler), else fall through to exponential backoff
                retry_after = (resp.headers or {}).get("Retry-After")
                if retry_after and attempt < self.retries:
                    try:  # RFC 7231 also allows an HTTP-date here
                        wait_s = min(float(retry_after), 30.0)
                    except ValueError:
                        wait_s = None
                    if wait_s is not None:
                        if not self._sleep_budgeted(wait_s, deadline):
                            return last_err
                        continue
            if attempt < self.retries:
                if not self._sleep_budgeted(
                        self.backoffs[min(attempt, len(self.backoffs) - 1)] / 1000.0,
                        deadline):
                    return last_err
        return last_err

    def send_json(self, url: str, payload: Any,
                  headers: Optional[Dict[str, str]] = None,
                  deadline: Optional[Deadline] = None,
                  trace_id: Optional[str] = None) -> HTTPResponseData:
        """POST ``payload`` as JSON through the full resilient path
        (breaker, deadline clipping, retries).  The one-call shape internal
        clients want — the observability span exporter POSTs OTLP batches
        through here so graft-lint RES coverage holds by construction."""
        return self.send(HTTPRequestData.post_json(url, payload, headers),
                         deadline=deadline, trace_id=trace_id)


class AsyncHTTPClient(HTTPClient):
    """Bounded-concurrency async client (reference AsyncClient, Clients.scala:48).
    The ambient deadline is captured on the submitting thread and handed to
    every pooled ``send`` (contextvars don't cross thread-pool boundaries)."""

    def __init__(self, concurrency: int = 8, **kw):
        super().__init__(**kw)
        self.concurrency = concurrency

    def send_all(self, reqs: List[Optional[HTTPRequestData]]) -> List[Optional[HTTPResponseData]]:
        deadline = current_deadline()
        trace_id = current_trace_id()  # contextvars don't cross the pool
        out: List[Optional[HTTPResponseData]] = [None] * len(reqs)
        with concurrent.futures.ThreadPoolExecutor(self.concurrency) as ex:
            futs = {ex.submit(self.send, r, deadline, trace_id): i
                    for i, r in enumerate(reqs) if r is not None}
            for f in concurrent.futures.as_completed(futs):
                out[futs[f]] = f.result()
        return out


class HTTPTransformer(Transformer, HasInputCol, HasOutputCol):
    """Column of HTTPRequestData -> column of HTTPResponseData
    (reference HTTPTransformer.transform:111)."""

    concurrency = Param("concurrency", "max in-flight requests per partition", "int", default=8)
    concurrent_timeout = Param("concurrent_timeout", "request timeout seconds", "float", default=60.0)
    handler = Param("handler", "custom (client, request)->response handler", "object")
    breaker = Param("breaker", "shared CircuitBreaker guarding the endpoint",
                    "object", default=None)

    def __init__(self, uid=None, **kwargs):
        super().__init__(uid)
        if kwargs:
            self.set_params(**kwargs)

    def _client(self) -> AsyncHTTPClient:
        return AsyncHTTPClient(concurrency=self.get("concurrency"),
                               timeout_s=self.get("concurrent_timeout"),
                               breaker=self.get("breaker"))

    def _transform(self, df: DataFrame) -> DataFrame:
        in_col, out_col = self.get_or_fail("input_col"), self.get_or_fail("output_col")
        handler = self.get("handler")

        def per_part(p):
            client = self._client()
            reqs = []
            for v in p[in_col]:
                if v is None:
                    reqs.append(None)
                elif isinstance(v, HTTPRequestData):
                    reqs.append(v)
                else:
                    reqs.append(REQUEST_BINDING._decode(HTTPRequestData, v))
            if handler is not None:
                resps = [None if r is None else handler(client, r) for r in reqs]
            else:
                resps = client.send_all(reqs)
            out = np.empty(len(reqs), dtype=object)
            for i, r in enumerate(resps):
                out[i] = None if r is None else dataclasses.asdict(r)
            return {**p, out_col: out}

        return df.map_partitions(per_part)

    def transform_schema(self, schema):
        schema.require(self.get_or_fail("input_col"))
        return schema.add(self.get_or_fail("output_col"), ColumnType.STRUCT)


class SimpleHTTPTransformer(Transformer, HasInputCol, HasOutputCol):
    """JSON-in/JSON-out convenience (reference SimpleHTTPTransformer.scala:64):
    input column -> request (via input_parser), response -> parsed output
    column, optional error column and minibatching."""

    url = Param("url", "endpoint for the default JSON POST parser", "string")
    input_parser = Param("input_parser", "fn(cell) -> HTTPRequestData", "object")
    output_parser = Param("output_parser", "fn(HTTPResponseData) -> cell", "object")
    error_col = Param("error_col", "column for failed-request info", "string", default="errors")
    max_batch_size = Param("max_batch_size", "minibatch rows per request (0=off)", "int", default=0)
    concurrency = Param("concurrency", "max in-flight requests", "int", default=8)
    headers = Param("headers", "extra headers dict", "object", default=None)
    breaker = Param("breaker", "shared CircuitBreaker guarding the endpoint",
                    "object", default=None)

    def __init__(self, uid=None, **kwargs):
        super().__init__(uid)
        if kwargs:
            self.set_params(**kwargs)

    def _transform(self, df: DataFrame) -> DataFrame:
        in_col = self.get_or_fail("input_col")
        out_col = self.get_or_fail("output_col")
        err_col = self.get("error_col")
        url = self.get("url")
        in_parser = self.get("input_parser") or \
            (lambda cell: HTTPRequestData.post_json(url, cell, self.get("headers")))
        out_parser = self.get("output_parser") or (lambda resp: resp.json())
        batching = self.get("max_batch_size") or 0

        work = df
        if batching > 1:
            work = FixedMiniBatchTransformer().set("batch_size", batching).transform(work)

        def per_part(p):
            client = AsyncHTTPClient(concurrency=self.get("concurrency"),
                                     breaker=self.get("breaker"))
            cells = p[in_col]
            if batching > 1:
                reqs = [in_parser(list(c)) for c in cells]
            else:
                reqs = [None if c is None else in_parser(c) for c in cells]
            resps = client.send_all(reqs)
            out = np.empty(len(cells), dtype=object)
            errs = np.empty(len(cells), dtype=object)
            for i, r in enumerate(resps):
                if r is None:
                    out[i], errs[i] = None, None
                elif 200 <= r.status_code < 300:
                    try:
                        out[i], errs[i] = out_parser(r), None
                    except Exception as e:  # noqa: BLE001
                        out[i], errs[i] = None, f"parse error: {e}"
                else:
                    out[i] = None
                    errs[i] = {"status_code": r.status_code, "reason": r.reason}
                if batching > 1:
                    # cells must be per-row sequences so FlattenBatch can
                    # explode them alongside the original batched columns
                    m = len(cells[i])
                    if not isinstance(out[i], (list, np.ndarray)):
                        out[i] = [out[i]] * m
                    errs[i] = [errs[i]] * m
            res = {**p, out_col: out}
            if err_col:
                res[err_col] = errs
            return res

        result = DataFrame(
            [per_part(pp) for pp in work.partitions])
        if batching > 1:
            result = FlattenBatch().transform(result)
        return result

    def transform_schema(self, schema):
        schema.require(self.get_or_fail("input_col"))
        s = schema.add(self.get_or_fail("output_col"), ColumnType.STRUCT)
        if self.get("error_col"):
            s = s.add(self.get("error_col"), ColumnType.STRUCT)
        return s
