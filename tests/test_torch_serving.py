"""Port parity for the serving front (``mmlspark_tpu_torch/serving/``:
``PipelineServer``, ``DistributedPipelineServer``, the streaming facade,
``mixed_load``/``sustained_load``/``check_gates``) and the runner's scorer
(``ModelRunner.scorer``), over real sockets on 127.0.0.1, on the CPU.

Both packages' servers answer the same prompts with equal replies: the
continuous decode scorer (``continuous=True``: each request joins a slot
of the in-flight engine) and the ticked one, on the reference tests'
tiny LM (vocab 48, embed 32, 1 layer; weights carried across), and the
score mode on a seeded two-layer MLP (replies within atol 1e-6: float32
products summed in another order).  Greedy tokens are compared exactly.
Then the reference's single-server behaviours on the port: the 503 shed
on exhausted slots, the zero-drop drain of a continuous engine with a
newcomer shed 503 + Retry-After, ``/admin/drain``, the quarantined
runner's ``/health``, and the ``mixed_load`` TTFT gate
(``tests/test_continuous_batching.py``:426-680,
``tests/test_tail_tolerance.py``:256-440).
"""
import http.client
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import mmlspark_tpu.serving as jax_serving
import mmlspark_tpu_torch.serving as port_serving
from mmlspark_tpu.models import ModelRunner as JaxRunner
from mmlspark_tpu_torch.core import Transformer
from mmlspark_tpu_torch.models import ModelRunner
from mmlspark_tpu_torch.utils.resilience import FakeClock, RestartSupervisor
from tests.test_torch_continuous import _lm, _one_shot


def post_json(port, path, obj, timeout=30):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", path, json.dumps(obj),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = json.loads(resp.read().decode())
    headers = dict(resp.getheaders())
    conn.close()
    return resp.status, body, headers


def _runners(name):
    ref, variables, port = _lm(1)
    return {"jax": (jax_serving, JaxRunner(module=ref, variables=variables,
                                           name=name)),
            "port": (port_serving, ModelRunner(module=port, name=name,
                                               device="cpu"))}


def _fire(srv, prompts):
    results = [None] * len(prompts)

    def fire(i):
        results[i] = post_json(srv.port, srv.api_path, prompts[i])

    threads = [threading.Thread(target=fire, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    return results


PROMPTS = [[5, 7, 11], [9, 2], [1, 2, 3, 4, 5], [40, 41, 42, 43, 44, 45],
           [3], [17, 16, 15, 14]]


@pytest.mark.parametrize("continuous", [True, False],
                         ids=["continuous", "ticked"])
def test_both_servers_answer_decode_prompts_alike(continuous):
    kw = dict(slots=8, prompt_bucket=8, max_new_tokens=4, page_size=4) \
        if continuous else dict(max_new_tokens=4, kv_layout="paged",
                                page_size=4)
    replies = {}
    for which, (serving, runner) in _runners(f"srv.{continuous}").items():
        scorer = runner.scorer(mode="decode", continuous=continuous,
                               report_ttft=True,
                               encode=lambda t: [int(x) for x in t], **kw)
        srv = serving.PipelineServer(
            scorer, port=0,
            mode="continuous" if continuous else "micro_batch").start()
        try:
            got = _fire(srv, PROMPTS)
        finally:
            srv.stop()
        if continuous:
            assert scorer._decoder is None      # stop() closed the stream
        assert all(s == 200 for s, _, _ in got), got
        assert all(r["ttft_ms"] >= 0.0 for _, r, _ in got)
        replies[which] = [r["tokens"] for _, r, _ in got]
        for p, toks in zip(PROMPTS, replies[which]):
            assert toks == _one_shot(runner, p, 4, page_size=4)
    assert replies["port"] == replies["jax"]


def test_both_servers_score_rows_alike():
    rng = np.random.default_rng(0)
    w1 = rng.normal(size=(5, 8)).astype(np.float32)
    w2 = rng.normal(size=(8, 3)).astype(np.float32)
    rows = rng.normal(size=(7, 5)).astype(np.float32).tolist()
    port_runner = ModelRunner(
        apply_fn=lambda s, x: torch.tanh(x @ s["w1"]) @ s["w2"],
        variables={"w1": w1, "w2": w2}, name="srv.score", device="cpu")
    import jax.numpy as jnp
    jax_runner = JaxRunner(
        apply_fn=lambda s, x: jnp.tanh(x @ s["w1"]) @ s["w2"],
        variables={"w1": w1, "w2": w2}, name="srv.score")
    replies = {}
    for which, serving, runner in (("jax", jax_serving, jax_runner),
                                   ("port", port_serving, port_runner)):
        srv = serving.PipelineServer(
            runner.scorer(encode=lambda y: [float(v) for v in y]),
            port=0, mode="continuous").start()
        try:
            got = _fire(srv, rows)
        finally:
            srv.stop()
        assert all(s == 200 for s, _, _ in got), got
        replies[which] = np.asarray([r for _, r, _ in got])
    np.testing.assert_allclose(replies["port"], replies["jax"], atol=1e-6)
    np.testing.assert_allclose(replies["port"],
                               np.tanh(np.asarray(rows) @ w1) @ w2,
                               atol=1e-5)


def test_server_sheds_503_when_slots_are_exhausted():
    _, runner = _runners("srv.shed")["port"]
    scorer = runner.scorer(mode="decode", continuous=True, slots=1,
                           prompt_bucket=8, max_new_tokens=110, page_size=8,
                           encode=lambda t: [int(x) for x in t])
    srv = port_serving.PipelineServer(scorer, port=0,
                                      mode="continuous").start()
    try:
        first = {}
        t = threading.Thread(target=lambda: first.update(
            res=post_json(srv.port, srv.api_path, [5, 7, 11], timeout=60)))
        t.start()
        deadline = time.monotonic() + 10
        while scorer._decoder is None or scorer._decoder.occupancy() == 0:
            assert time.monotonic() < deadline, "first request never joined"
            time.sleep(0.002)
        status, reply, headers = post_json(srv.port, srv.api_path, [1, 2])
        assert status == 503 and "shed" in reply["error"]
        assert int(headers["Retry-After"]) >= 1
        t.join(60)
        assert first["res"][0] == 200 and len(first["res"][1]) == 110
        assert srv.stats.as_dict()["shed"] == 1
    finally:
        srv.stop()


def test_continuous_drain_drops_nothing_and_sheds_newcomers():
    """``drain()`` with requests in flight: every one completes 200 with
    one-shot tokens, a newcomer gets 503 + Retry-After, and every page
    is back in the pool after ``stop()``."""
    _, runner = _runners("srv.drain")["port"]
    scorer = runner.scorer(mode="decode", continuous=True, slots=4,
                           prompt_bucket=8, max_new_tokens=60, page_size=4,
                           encode=lambda t: [int(x) for x in t])
    srv = port_serving.PipelineServer(scorer, port=0,
                                      mode="continuous").start()
    prompts = PROMPTS[:4]
    results = [None] * 4
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(
        i, post_json(srv.port, srv.api_path, prompts[i], timeout=60)))
        for i in range(4)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 10
    while scorer._decoder is None or scorer._decoder.occupancy() < 4:
        assert time.monotonic() < deadline
        time.sleep(0.002)
    late = {}
    drainer = threading.Thread(target=lambda: late.update(
        ok=srv.drain(timeout_s=60.0)))
    drainer.start()
    while not srv.draining:
        time.sleep(0.001)
    try:
        status, reply, headers = post_json(srv.port, srv.api_path, [1, 2],
                                           timeout=10)
        assert status == 503 and int(headers["Retry-After"]) >= 1
    except (ConnectionError, OSError):
        pass                          # the drain already closed the socket
    for t in threads:
        t.join(60)
    drainer.join(60)
    assert late["ok"] is True
    for p, (status, toks, _) in zip(prompts, results):
        assert status == 200 and toks == _one_shot(runner, p, 60,
                                                    page_size=4)
    srv.stop()
    assert runner.page_pool(4).pages_in_use() == 0
    s = srv.stats.as_dict()
    assert s["received"] == s["replied"] + s["errors"] + s["shed"]
    assert s["errors"] == 0


class _Doubler(Transformer):
    def __init__(self, delay_s=0.0):
        super().__init__()
        self.delay_s = delay_s

    def _transform(self, df):
        time.sleep(self.delay_s)

        def per_part(p):
            return {**p, "reply": np.asarray(
                [2 * float(v) for v in p["request"]], float)}
        return df.map_partitions(per_part)

    def transform_schema(self, schema):
        return schema


def _post(url, payload, timeout=10):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read().decode())


def test_admin_drain_endpoint_sheds_newcomers_and_completes_in_flight():
    srv = port_serving.PipelineServer(_Doubler(1.0), port=0,
                                      micro_batch_interval_ms=1).start()
    base = f"http://127.0.0.1:{srv.port}"
    slot = {}
    t = threading.Thread(target=lambda: slot.update(
        reply=_post(srv.address, 21, timeout=30)))
    t.start()
    deadline = time.monotonic() + 10
    while srv._pending == 0:
        assert time.monotonic() < deadline
        time.sleep(0.005)
    got = _post(f"{base}/admin/drain", {"timeout_s": 30.0})
    assert got["draining"] is True and got["already_draining"] is False
    with pytest.raises(urllib.error.HTTPError) as h:
        urllib.request.urlopen(f"{base}/health", timeout=10)
    assert h.value.code == 503 and h.value.read() == b"draining"
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(srv.address, 1, timeout=10)
    assert exc.value.code == 503
    assert exc.value.headers.get("Connection", "").lower() == "close"
    t.join(30)
    assert slot["reply"] == 42.0
    srv2 = port_serving.PipelineServer(_Doubler(), port=0).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as bad:
            _post(f"http://127.0.0.1:{srv2.port}/admin/drain",
                  {"timeout_s": "soon"})
        assert bad.value.code == 400 and not srv2.draining
    finally:
        srv2.stop()


def test_quarantined_runner_turns_health_503():
    clk = FakeClock()
    _, runner = _runners("srv.quarantine")["port"]
    sup = RestartSupervisor(quarantine_stalls=1, clock=clk)
    scorer = runner.scorer(mode="decode", continuous=True, slots=2,
                           prompt_bucket=8, max_new_tokens=2, page_size=4,
                           supervisor=sup)
    scorer._ensure_decoder()._stall_abort("dispatch", 99.0)
    srv = port_serving.PipelineServer(scorer, port=0,
                                      mode="continuous").start()
    try:
        status, reply, headers = post_json(srv.port, srv.api_path, [1, 2])
        assert status == 503 and int(headers["Retry-After"]) >= 1
        with pytest.raises(urllib.error.HTTPError) as h:
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/health",
                                   timeout=10)
        assert h.value.code == 503 and h.value.read() == b"unhealthy"
    finally:
        srv.stop()


def test_streaming_facade_and_distributed_servers():
    _, runner = _runners("srv.stream")["port"]
    query = (port_serving.read_stream().server(port=0)
             .transform_with(runner, mode="decode", continuous=True,
                             slots=2, prompt_bucket=8, max_new_tokens=3,
                             page_size=4,
                             encode=lambda t: [int(x) for x in t])
             .reply_to("reply"))
    try:
        status, reply, _ = post_json(query.source.port, "/score", [3, 1, 4])
        assert status == 200
        assert reply == _one_shot(runner, [3, 1, 4], 3, page_size=4)
    finally:
        query.stop()
    dist = port_serving.DistributedPipelineServer(_Doubler(),
                                                  num_servers=2).start()
    try:
        assert [_post(a, i) for i, a in enumerate(dist.addresses)] == \
            [0.0, 2.0]
    finally:
        dist.stop()


def test_mixed_load_and_sustained_load_gate_a_continuous_server():
    _, runner = _runners("srv.mix")["port"]
    scorer = runner.scorer(mode="decode", continuous=True, report_ttft=True,
                           slots=4, prompt_bucket=8, max_new_tokens=3,
                           page_size=4,
                           encode=lambda t: [int(x) for x in t])
    srv = port_serving.PipelineServer(scorer, port=0,
                                      mode="continuous").start()
    try:
        out = port_serving.mixed_load("127.0.0.1", srv.port, [
            {"name": "decode", "path": srv.api_path,
             "body": json.dumps([3, 1, 4]),
             "headers": {"Content-Type": "application/json"},
             "n_clients": 2, "per_client": 6, "ttft_key": "ttft_ms",
             "gates": {"p99_ms": 30000.0, "ttft_p99_ms": 5000.0}}], warm=2)
        assert out["decode"]["gates"]["passed"], out["decode"]
        assert out["decode"]["ttft_count"] == 12.0
        sus = port_serving.sustained_load(
            "127.0.0.1", srv.port, srv.api_path, json.dumps([5, 6]),
            {"Content-Type": "application/json"}, n_clients=2,
            per_client=5)
        assert sus["completed"] == 10.0 and sus["errors"] == 0.0
    finally:
        srv.stop()
    stats = {"p99_ms": 2.0, "completed": 5.0}
    verdict = port_serving.check_gates({"p99_ms": 1.0}, stats)
    ref = jax_serving.check_gates({"p99_ms": 1.0}, stats)
    assert verdict == ref and not verdict["passed"]


@pytest.mark.parametrize("name", ["TopologyService", "WorkerServer",
                                  "RoutingClient", "MembershipWatcher"])
def test_the_serving_fleet_is_not_ported_yet(name):
    with pytest.raises(NotImplementedError, match=r"item 9\(c\)"):
        getattr(port_serving, name)()
