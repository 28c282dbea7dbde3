"""The port's test harness (``mmlspark_tpu_torch/testing``) against the JAX
package's, on the CPU.

- ``seed_objects(device="cpu")``: the same 17 stages as the reference's
  seeds; each passes ``ExperimentFuzzing`` and ``SerializationFuzzing``
  (the reloaded stage or model transforms like the fitted one within the
  reference's atol 1e-5), and its transform equals the reference seed's
  output within the tolerance the stage's own port tests state: the
  LightGBM estimators' scores within rtol 1e-5 and 1e-5 x the largest
  score (``tests/test_torch_ranker.py``, ``test_torch_multiclass.py``),
  VW's within rtol 1e-5 / atol 1e-6 (``tests/test_torch_vw.py``), the
  resize on [0, 255] within atol 1e-3 (``tests/test_torch_image_ops.py``),
  every other column identical.  ``SpeechToTextSDK`` scores with one
  recognizer's weights on both sides, as ``tests/test_torch_speech.py``
  does.
- ``Benchmarks``: the compare semantics on a tmp CSV, both packages'
  harnesses alike, and the VW regressor accuracy gate through the port on
  the committed baseline (read-only).
- ``chaos``: each injector's seeded schedule equals the reference's;
  ``HungWorkerInjector`` registers with the port's ``TopologyService``;
  ``ElasticTopologyDrill`` keeps the data and params recipe; its legs are
  worlds of CPU ranks (``tests/test_torch_sharded_gbdt.py`` drives them
  across widths).
- ``modifiers``: retries, flaky and the time limit.
"""
import os
import socket

import numpy as np
import pytest

import mmlspark_tpu.cognitive as jcog
import mmlspark_tpu.testing as jax_testing
import mmlspark_tpu.testing.chaos as jax_chaos
import mmlspark_tpu.testing.seeds as jax_seeds
import mmlspark_tpu_torch.cognitive as tcog
import mmlspark_tpu_torch.testing as port_testing
import mmlspark_tpu_torch.testing.chaos as port_chaos
import mmlspark_tpu_torch.testing.modifiers as port_modifiers
import mmlspark_tpu_torch.testing.seeds as port_seeds
from mmlspark_tpu_torch.testing import (Benchmark, Benchmarks,
                                        ExperimentFuzzing,
                                        SerializationFuzzing)

RES = os.path.join(os.path.dirname(__file__), "resources", "benchmarks")
SEEDED = sorted(jax_seeds.seed_objects())

#: (rtol, atol as a share of the largest reference value) per stage; the
#: rest are identical
TOL = {"LightGBMClassifier": (1e-5, 1e-5), "LightGBMRegressor": (1e-5, 1e-5),
       "LightGBMRanker": (1e-5, 1e-5)}
#: (rtol, absolute atol)
TOL_ABS = {"VowpalWabbitClassifier": (1e-5, 1e-6),
           "ImageTransformer": (0.0, 1e-3)}


def _seed(name, pkg):
    objs = (port_seeds.seed_objects(device="cpu") if pkg == "port"
            else jax_seeds.seed_objects())
    obj = objs[name]
    if name == "SpeechToTextSDK":
        # one recognizer's weights on both sides (the default recognizer
        # of each package initialises its own)
        j = jcog.StreamingRecognizer(chunk_s=0.1, seed=0)
        j.new_state()
        if pkg == "port":
            t = tcog.StreamingRecognizer(chunk_s=0.1, device="cpu")
            t.variables = j.variables
            obj.stage.set("recognizer", t)
        else:
            obj.stage.set("recognizer", j)
    return obj


def test_the_seeds_cover_the_reference_stages():
    port = port_seeds.seed_objects(device="cpu")
    assert sorted(port) == SEEDED and len(SEEDED) == 17
    for name, obj in port.items():
        if "device" in obj.stage._params:
            assert obj.stage.get("device") == "cpu", name
    # unset, the device-bound stages are left to the card
    for name, obj in port_seeds.seed_objects().items():
        if "device" in obj.stage._params:
            assert not obj.stage.is_set("device"), name
    assert sum("device" in o.stage._params for o in port.values()) == 10


@pytest.mark.parametrize("name", SEEDED)
def test_seed_experiment_fuzzing(name):
    _, out = ExperimentFuzzing.run(_seed(name, "port"))
    assert out.count() > 0


@pytest.mark.parametrize("name", SEEDED)
def test_seed_serialization_fuzzing(name):
    SerializationFuzzing.run(_seed(name, "port"))


def _close(a, b, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                               rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("name", SEEDED)
def test_seed_transform_equals_the_reference(name):
    _, got = ExperimentFuzzing.run(_seed(name, "port"))
    _, want = jax_testing.ExperimentFuzzing.run(_seed(name, "jax"))
    assert sorted(got.columns) == sorted(want.columns)
    g, w = got.collect(), want.collect()
    for c in want.columns:
        a, b = g[c], w[c]
        assert len(a) == len(b), c
        numeric = b.dtype != object or (
            len(b) and isinstance(b[0], np.ndarray) and b[0].dtype != object)
        if name in TOL and numeric:
            rtol, share = TOL[name]
            scale = max(float(np.max(np.abs(np.stack(list(b)).astype(float)
                                             ))), 1.0) if len(b) else 1.0
            _close(list(a), list(b), rtol, share * scale, f"{name}.{c}")
        elif name in TOL_ABS and numeric:
            _close(list(a), list(b), *TOL_ABS[name], f"{name}.{c}")
        elif b.dtype != object:
            np.testing.assert_array_equal(a, b, err_msg=f"{name}.{c}")
        else:
            for i, (x, y) in enumerate(zip(a, b)):
                _identical(x, y, f"{name}.{c}[{i}]")


def _identical(x, y, what):
    """Equal cells: arrays element for element, dicts and lists
    recursively, anything else by ``==``."""
    if isinstance(y, np.ndarray):
        np.testing.assert_array_equal(x, y, err_msg=what)
    elif isinstance(y, dict):
        assert isinstance(x, dict) and sorted(x) == sorted(y), what
        for k in y:
            _identical(x[k], y[k], f"{what}.{k}")
    elif isinstance(y, (list, tuple)):
        assert len(x) == len(y), what
        for i, (u, v) in enumerate(zip(x, y)):
            _identical(u, v, f"{what}[{i}]")
    else:
        assert x == y, what


def test_lightgbm_classifier_predictions_equal_the_reference():
    name = "LightGBMClassifier"
    _, got = ExperimentFuzzing.run(_seed(name, "port"))
    _, want = jax_testing.ExperimentFuzzing.run(_seed(name, "jax"))
    np.testing.assert_array_equal(got.collect()["prediction"],
                                  want.collect()["prediction"])


# ---------------------------------------------------------------------------
# benchmarks.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", [jax_testing, port_testing],
                         ids=["jax", "port"])
def test_benchmarks_compare_semantics(pkg, tmp_path):
    path = str(tmp_path / "sub" / "base.csv")
    b = pkg.Benchmarks(path)
    b.add("m1", 0.9, 0.05, True)
    b.add("m2", 1.2, 0.1, False)
    b.write_baseline()
    b2 = pkg.Benchmarks(path)
    b2.add("m1", 0.851, 0.05, True)      # within precision
    b2.add("m2", 1.299, 0.1, False)
    b2.verify()
    for new in ([("m1", 0.84, 0.05, True), ("m2", 1.2, 0.1, False)],
                [("m1", 0.9, 0.05, True), ("m2", 1.31, 0.1, False)],
                [("m1", 0.9, 0.05, True)]):         # set changed
        b3 = pkg.Benchmarks(path)
        for row in new:
            b3.add(*row)
        with pytest.raises(AssertionError):
            b3.verify()


def test_benchmarks_read_each_others_files(tmp_path):
    for writer, reader in ((jax_testing, port_testing),
                           (port_testing, jax_testing)):
        path = str(tmp_path / f"{writer.__name__}.csv")
        w = writer.Benchmarks(path)
        w.add("a", 0.5, 0.01, True)
        w.add("b", 2.0, 1.0, False)
        w.write_baseline()
        got = reader.Benchmarks(path).load_baseline()
        assert {k: (v.name, v.value, v.precision, v.higher_is_better)
                for k, v in got.items()} == {
            "a": ("a", 0.5, 0.01, True), "b": ("b", 2.0, 1.0, False)}
    assert Benchmark.from_row({"name": "x", "value": "1", "precision": "0",
                               "higherIsBetter": " TRUE "}).higher_is_better


def test_vw_regressor_benchmark_gate_through_the_port():
    """The committed VW regressor baseline, gated through the port's
    learners on the CPU (read-only: nothing is written back)."""
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.vw import VowpalWabbitRegressor
    from tests.test_benchmark_regression import _datasets_regression, _split
    path = os.path.join(RES, "benchmarks_VerifyVowpalWabbitRegressor.csv")
    with open(path, "rb") as f:
        before = f.read()
    bench = Benchmarks(path)

    def sdf(Xs, ys):
        c = np.empty(len(Xs), dtype=object)
        for i in range(len(Xs)):
            c[i] = {"indices": np.arange(Xs.shape[1], dtype=np.int32),
                    "values": Xs[i].astype(np.float32)}
        return DataFrame.from_dict({"features": c, "label": ys}, 2)

    for ds_name, (X, y) in _datasets_regression().items():
        for tag in ("default", "no_adaptive", "bfgs"):
            Xtr, Xte, ytr, yte = _split(X, y)
            reg = VowpalWabbitRegressor().set_params(
                num_bits=10, num_passes=10, device="cpu")
            if tag == "no_adaptive":
                reg.set("adaptive", False)
            elif tag == "bfgs":
                reg.set("args", "--bfgs")
            pred = reg.fit(sdf(Xtr, ytr)).transform(
                sdf(Xte, yte)).collect()["prediction"]
            bench.add(f"VowpalWabbitRegressor_{ds_name}_{tag}",
                      float(np.mean((pred - yte) ** 2)), 1.0, False)
    bench.verify()
    with open(path, "rb") as f:
        assert f.read() == before


# ---------------------------------------------------------------------------
# chaos.py
# ---------------------------------------------------------------------------

def _schedule(mod, cls, n=40, **kw):
    inj = getattr(mod, cls)(seed=7, rate=0.35, **kw)
    fired = [inj._fire() for _ in range(n)]
    return fired, inj.calls, inj.injected


@pytest.mark.parametrize("cls", ["ChaosInjector", "LatencyInjector",
                                 "ConnectionErrorInjector",
                                 "StatusStormInjector", "FlakyLoadInjector"])
def test_injector_schedules_equal_the_reference(cls):
    assert _schedule(port_chaos, cls) == _schedule(jax_chaos, cls)


def test_http_injectors_act_like_the_reference():
    from mmlspark_tpu_torch.io.http import HTTPRequestData, HTTPResponseData
    ok = HTTPResponseData(status_code=200, reason="ok", headers={},
                          entity=b"{}")
    req = HTTPRequestData(url="http://127.0.0.1:1/x", method="GET")
    clock = port_chaos.FakeClock()
    lat = port_chaos.LatencyInjector(seed=1, latency_s=0.5,
                                     sleep=clock.sleep)
    assert lat.wrap(lambda r, t: ok)(req, 1.0).status_code == 200
    assert clock.now() == pytest.approx(0.5)
    with pytest.raises(TimeoutError):
        lat.wrap(lambda r, t: ok)(req, 0.1)
    with pytest.raises(ConnectionError):
        port_chaos.ConnectionErrorInjector(seed=1).wrap(
            lambda r, t: ok)(req, 1.0)
    storm = port_chaos.StatusStormInjector(seed=1, status=429,
                                           retry_after_s=2.0)
    resp = storm.wrap(lambda r, t: ok)(req, 1.0)
    assert resp.status_code == 429 and resp.headers["Retry-After"] == "2.0"


def test_load_injectors_and_preemption_simulator():
    flaky = port_chaos.FlakyLoadInjector(seed=3, rate=1.0, max_injections=2)
    load = flaky.wrap(lambda i: i * 2)
    for _ in range(2):
        with pytest.raises(ConnectionError):
            load(1)
    assert load(4) == 8 and flaky.injected == 2
    hung = port_chaos.HungLoadInjector(hang_at=5)
    assert hung.wrap(lambda i: i + 1)(1) == 2 and not hung.hanging.is_set()
    sims = [mod.PreemptionSimulator(seed=11, lo=2, hi=9)
            for mod in (port_chaos, jax_chaos)]
    assert sims[0].at_iteration == sims[1].at_iteration
    with pytest.raises(ValueError):
        port_chaos.PreemptionSimulator(lo=3, hi=3)


def test_hung_worker_registers_and_swallows_requests():
    from mmlspark_tpu_torch.serving.distributed import TopologyService
    svc = TopologyService().start()
    hung = port_chaos.HungWorkerInjector(mode="mid_body").start()
    try:
        hung.register(svc.address, server_id="hung-1")
        assert "hung-1" in svc.routing_table()
        with socket.create_connection(("127.0.0.1", hung.port), 5) as s:
            s.sendall(b"GET /score HTTP/1.1\r\nHost: x\r\n\r\n")
            s.settimeout(5)
            head = s.recv(4096)
        assert head.startswith(b"HTTP/1.1 200 OK")
        assert b'{"partial": ' in head and hung.accepted == 1
    finally:
        hung.stop()
        svc.stop()
    with pytest.raises(ValueError):
        port_chaos.HungWorkerInjector(mode="slow")


def test_elastic_drill_keeps_its_recipe_and_raises_naming_item_5(tmp_path):
    kw = dict(rows=101, features=4, num_iterations=3)
    port = port_chaos.ElasticTopologyDrill(tmp_path / "c", tmp_path / "m",
                                           **kw)
    ref = jax_chaos.ElasticTopologyDrill(tmp_path / "c", tmp_path / "m",
                                         **kw)
    for a, b in zip(port.make_data(), ref.make_data()):
        np.testing.assert_array_equal(a, b)
    pp, rp = port.make_params(), ref.make_params()
    for k in ("num_iterations", "objective", "max_depth", "seed",
              "use_quantized_grad", "bagging_fraction", "bagging_freq",
              "feature_fraction"):
        assert getattr(pp, k) == getattr(rp, k), k
    assert pp.growth == "level"
    # the legs are torch programs now: a world of ranks, no jax
    src = port.child_program(2)
    assert "World(2" in src and "import jax" not in src
    compile(src, "<leg>", "exec")
    res = port.train_inline(1, checkpoint=False)
    assert res.booster.num_trees == 3
    assert res.extras["shard_count"] == 1.0
    assert port._marker_lines() == 0


def test_worker_killer_picks_the_reference_victims():
    class W:
        def __init__(self, i):
            self.server_id = f"w{i}"
            self.server = self

        def stop(self):
            pass
    picks = []
    for mod in (port_chaos, jax_chaos):
        k = mod.WorkerKiller(seed=5)
        ws = [W(i) for i in range(6)]
        picks.append([k.kill_one(ws).server_id for _ in range(5)])
    assert picks[0] == picks[1]


# ---------------------------------------------------------------------------
# modifiers.py
# ---------------------------------------------------------------------------

def test_modifiers_retry_and_time_limit():
    calls = []

    @port_modifiers.try_with_retries(times=(0, 1, 1))
    def twice():
        calls.append(1)
        if len(calls) < 3:
            raise AssertionError("not yet")
        return "ok"
    assert twice() == "ok" and len(calls) == 3

    @port_modifiers.flaky(retries=2)
    def never():
        raise RuntimeError("always")
    with pytest.raises(RuntimeError):
        never()

    @port_modifiers.time_limited_flaky(seconds=0.0, retries=2)
    def slow():
        return sum(range(1000))
    with pytest.raises(TimeoutError):
        slow()
    assert port_modifiers.linux_only(lambda: 1)
