"""Structured-streaming facade for serving — source/sink over HTTP requests.

Reference: ``spark.readStream.server().address(h,p,api).load()`` ... pipeline
... ``.makeReply(col).writeStream.server().replyTo(api).start()``
(``io/IOImplicits.scala:22-74``, ``ServingUDFs.scala:22-49``;  micro-batch
source semantics ``HTTPSource.scala:43-140``: buffered requests ARE the
stream offsets, replies matched by uuid).

Here the same three pieces exist as first-class objects:

- ``HTTPStreamSource`` — binds a socket, buffers requests, and emits them as
  micro-batch ``DataFrame``s of ``(id, request)`` rows via ``get_batch``;
- ``reply`` — the sink half: complete requests by id (``sendReplyUDF``);
- ``StreamingQuery`` — the driver loop tying a source, a pipeline transform
  and the reply sink together with a trigger interval, exposed through
  ``read_stream().server(...)`` / ``.start()`` fluent wiring.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..core import DataFrame, Transformer
from .server import ServingStats, _default_encode, _prompt_hash


def _takes_prompt_hash(submit) -> bool:
    """Whether a continuous-submit front declares ``prompt_hash=``
    — same duck-typed introspection as the PipelineServer
    seam, so older fronts never see a kwarg they did not ask for."""
    import inspect
    try:
        params = inspect.signature(submit).parameters
    except (TypeError, ValueError):
        return False
    return "prompt_hash" in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())

# request ids key the pending-reply map: process uniqueness suffices, and
# uuid4's per-call entropy syscall sat on the request hot path (same
# counter pattern as serving/server.py entry ids and tracing span ids)
_REQUEST_IDS = itertools.count()


class _Pending:
    __slots__ = ("payload", "done", "reply", "status")

    def __init__(self, payload):
        self.payload = payload
        self.done = threading.Event()
        self.reply = None
        self.status = 200


class HTTPStreamSource:
    """Micro-batch source: buffered HTTP requests are the stream."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 api_path: str = "/score", id_col: str = "id",
                 value_col: str = "request",
                 input_parser: Optional[Callable[[bytes], Any]] = None,
                 request_timeout_s: float = 30.0):
        self.host, self.port, self.api_path = host, port, api_path
        self.id_col, self.value_col = id_col, value_col
        self.input_parser = input_parser or (lambda b: json.loads(b.decode() or "null"))
        self.request_timeout_s = request_timeout_s
        self.stats = ServingStats()
        self._buf: List[str] = []
        self._pending: Dict[str, _Pending] = {}
        self._lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._accept_thread: Optional[threading.Thread] = None

    def _make_handler(self):
        src = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path == "/health":
                    self.send_response(200)
                    self.send_header("Content-Length", "2")
                    self.end_headers()
                    self.wfile.write(b"ok")
                elif self.path == "/stats":
                    body = json.dumps(src.stats.as_dict()).encode()
                    self.send_response(200)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_response(404)
                    self.end_headers()

            def do_POST(self):
                if self.path != src.api_path:
                    self.send_response(404)
                    self.end_headers()
                    return
                t0 = time.perf_counter()
                length = int(self.headers.get("Content-Length", 0))
                try:
                    payload = src.input_parser(self.rfile.read(length))
                except Exception as e:  # noqa: BLE001
                    self._json(400, {"error": f"bad request: {e}"})
                    return
                uid = f"r{next(_REQUEST_IDS):x}"
                entry = _Pending(payload)
                with src._lock:
                    src._pending[uid] = entry
                    src._buf.append(uid)
                with src.stats.lock:
                    src.stats.received += 1
                ok = entry.done.wait(src.request_timeout_s)
                with src._lock:
                    src._pending.pop(uid, None)
                if not ok:
                    self._json(504, {"error": "timeout"})
                    with src.stats.lock:
                        src.stats.errors += 1
                    return
                # count before the socket write (see server.py: a client
                # holding the reply must never observe replied lagging it);
                # failed writes roll back as errors, latency sampled after
                with src.stats.lock:
                    src.stats.replied += 1
                try:
                    self._json(entry.status, entry.reply)
                    if entry.status == 200:
                        # latency is a SUCCESS metric (ServingStats
                        # contract): scorer-set 500s must not feed the pair
                        with src.stats.lock:
                            src.stats.latency_sum += time.perf_counter() - t0
                            src.stats.latency_count += 1
                except OSError:
                    with src.stats.lock:
                        src.stats.replied -= 1
                        src.stats.errors += 1

            def _json(self, status, obj):
                body = json.dumps(obj, default=str).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        return Handler

    # ---------------------------------------------------------------- source
    def start(self) -> "HTTPStreamSource":
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          self._make_handler())
        self.port = self._httpd.server_port
        self._accept_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
        t, self._accept_thread = self._accept_thread, None
        if t is not None and t.is_alive():
            # shutdown() already unwound serve_forever; the join only
            # fences the handoff so a restart cannot race the old acceptor
            t.join(timeout=5.0)

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}{self.api_path}"

    def get_batch(self, max_rows: int = 1024) -> Optional[DataFrame]:
        """Drain up to ``max_rows`` buffered requests as one micro-batch
        (the offset-range read, ``HTTPSource.getBatch``)."""
        with self._lock:
            ids, self._buf = self._buf[:max_rows], self._buf[max_rows:]
            entries = [self._pending.get(u) for u in ids]
        rows = [(u, e) for u, e in zip(ids, entries) if e is not None]
        if not rows:
            return None
        vals = np.empty(len(rows), dtype=object)
        for i, (_, e) in enumerate(rows):
            vals[i] = e.payload
        return DataFrame([{self.id_col: np.asarray([u for u, _ in rows],
                                                   dtype=object),
                           self.value_col: vals}])

    def reply(self, ids, replies, encoder=None) -> None:
        """Sink half: complete requests by id (``ServingUDFs.sendReplyUDF``).
        A per-row shed sentinel (duck-typed ``shed_reason`` — the decode
        scorer's mid-flight page denial) completes as a 503 shed
        instead of encoding the sentinel object into a 200 body."""
        encoder = encoder or _default_encode
        with self._lock:
            entries = [self._pending.get(str(u)) for u in ids]
        for e, r in zip(entries, replies):
            if e is not None:
                reason = getattr(r, "shed_reason", None)
                if reason is not None:
                    e.status, e.reply = 503, {"error": f"shed: {reason}"}
                else:
                    e.reply = encoder(r)
                e.done.set()


class StreamingQuery:
    """The running query: trigger loop of get_batch -> transform -> reply."""

    def __init__(self, source: HTTPStreamSource, model: Transformer,
                 reply_col: str, trigger_interval_ms: int = 1,
                 max_rows: int = 1024):
        self.source = source
        self.model = model
        self.reply_col = reply_col
        self.interval_s = trigger_interval_ms / 1000.0
        self.max_rows = max_rows
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[str] = None

    def _loop(self):
        # continuous admission: a model exposing
        # `continuous_submit` (the runner's continuous decode scorer) gets
        # each drained row the moment the trigger sees it, and every row
        # replies from the model's own engine as IT finishes — the trigger
        # loop goes back to draining instead of blocking on the batch
        submit = getattr(self.model, "continuous_submit", None)
        takes_hash = _takes_prompt_hash(submit) if submit is not None \
            else False
        while not self._stop.is_set():
            batch = self.source.get_batch(self.max_rows)
            if batch is None:
                time.sleep(self.interval_s)
                continue
            cols = batch.collect()
            ids = cols[self.source.id_col]
            if submit is not None:
                vals = cols[self.source.value_col]
                for u, v in zip(ids, vals):
                    self._submit_one(submit, str(u), v,
                                     takes_hash=takes_hash)
                continue
            try:
                out = self.model.transform(batch).collect()
                self.source.reply(ids, out[self.reply_col])
            except Exception as e:  # noqa: BLE001 — reply the error per-row
                self.last_error = str(e)
                with self.source._lock:
                    entries = [self.source._pending.get(str(u)) for u in ids]
                for en in entries:
                    if en is not None:
                        en.status, en.reply = 500, {"error": str(e)}
                        en.done.set()

    def _submit_one(self, submit, uid: str, payload,
                    takes_hash: bool = False) -> None:
        """Admit one row into the model's in-flight engine; shed-typed
        admission failures reply 503 so the client backs off.  When the
        front declares ``prompt_hash=`` the row's stable prompt identity
        rides along."""
        def resolve(reply=None, status=200, verdict=None,
                    retry_after_s=None, ttft_s=None):
            with self.source._lock:
                entry = self.source._pending.get(uid)
            if entry is not None:
                entry.status = status
                # 200s ride the same default encoding as the batch sink
                entry.reply = _default_encode(reply) if status == 200 \
                    else reply
                entry.done.set()

        try:
            kw = {"prompt_hash": _prompt_hash(payload)} if takes_hash else {}
            submit(payload, resolve=resolve, **kw)
        except Exception as e:  # noqa: BLE001 — per-row admission verdict
            self.last_error = str(e)
            status = 503 if getattr(e, "shed", False) else 500
            prefix = "shed: " if status == 503 else ""
            resolve(reply={"error": f"{prefix}{e}"}, status=status)

    def start(self) -> "StreamingQuery":
        self.source.start()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None and thread.is_alive():
            # the trigger loop wakes within one interval (or one drained
            # batch); an unjoined loop here would race a restarted query
            # into the same source's pending map
            thread.join(timeout=5.0)
        self.source.stop()
        closer = getattr(self.model, "continuous_close", None)
        if closer is not None:
            closer()

    def await_termination(self, timeout_s: float) -> None:
        time.sleep(timeout_s)


class _StreamReader:
    """Fluent ``read_stream().server(...)`` wiring (IOImplicits analogue)."""

    def server(self, host: str = "127.0.0.1", port: int = 0,
               api_path: str = "/score", **kw) -> "_StreamPipeline":
        return _StreamPipeline(HTTPStreamSource(host, port, api_path, **kw))


class _StreamPipeline:
    def __init__(self, source: HTTPStreamSource):
        self.source = source
        self._model = None
        self._scorer_kwargs: Dict[str, Any] = {}

    def transform_with(self, model, **scorer_kwargs) -> "_StreamPipeline":
        """Score micro-batches through ``model``: a fitted ``Transformer``,
        or a ``models.ModelRunner`` directly — the runner is
        wrapped in its serving scorer at ``reply_to`` time, bound to this
        source's value column, so streaming scoring rides the SAME
        lower-once executable cache as batch transform and PipelineServer
        (``scorer_kwargs`` forward, e.g. ``mode="decode"``,
        ``max_new_tokens=``)."""
        self._model = model
        self._scorer_kwargs = dict(scorer_kwargs)
        return self

    def reply_to(self, reply_col: str, trigger_interval_ms: int = 1) -> StreamingQuery:
        if self._model is None:
            raise ValueError("call transform_with(model) before reply_to")
        model = self._model
        if not isinstance(model, Transformer) and hasattr(model, "scorer"):
            model = model.scorer(input_col=self.source.value_col,
                                 reply_col=reply_col, **self._scorer_kwargs)
        return StreamingQuery(self.source, model, reply_col,
                              trigger_interval_ms).start()


def read_stream() -> _StreamReader:
    """``spark.readStream`` analogue for the serving engine."""
    return _StreamReader()
