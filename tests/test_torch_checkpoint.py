"""Checkpoints, preemption and resume in the port: the ``io/checkpoint.py``
copy (atomic writes, retention, the torn-newest fallback, ``resume``
checks), snapshot files read across the two packages, and ``train()`` /
``train_streamed()`` preempted and resumed on the CPU.

Tolerances: the resumed boosters are bit-identical to uninterrupted ones
in every array (``train()`` on the CPU and ``train_streamed`` at the same
or at another tile width; the quantized streamed path keys its rounding
on the global row, so the tiling cannot move a bit).  Snapshots cross
between the packages unchanged: identical arrays and meta either way, and
a snapshot's booster scores the same through ``convert``.
"""
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

from mmlspark_tpu.io.checkpoint import CheckpointManager as JaxManager
from mmlspark_tpu.lightgbm import GBDTParams as JaxParams
from mmlspark_tpu.lightgbm import core as jax_core
from mmlspark_tpu_torch import convert
from mmlspark_tpu_torch.core import DataFrame
from mmlspark_tpu_torch.io.checkpoint import (CheckpointManager,
                                              atomic_write, snapshot_steps)
from mmlspark_tpu_torch.lightgbm import (GBDTParams, LightGBMClassifier,
                                         train, train_streamed)
from mmlspark_tpu_torch.observability.metrics import (MetricsRegistry,
                                                      get_registry)
from mmlspark_tpu_torch.utils.resilience import (FakeClock,
                                                 preemption_scope,
                                                 request_preemption)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOOSTER_ARRAYS = ("split_feature", "threshold", "threshold_bin",
                  "split_gain", "internal_value", "internal_count",
                  "leaf_value", "leaf_count", "left_child", "right_child",
                  "tree_weight")


def _data(n=2500, f=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] + rng.normal(scale=0.3, size=n) > 0) \
        .astype(np.float32)
    return X, y


def _same(a, b):
    for k in BOOSTER_ARRAYS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                      err_msg=f"booster arrays differ: {k}")


def _preempt_at(k):
    def cb(it, ev):
        if it == k:
            request_preemption("test")
    return cb


# ---------------------------------------------------------- the manager

def test_atomic_write_publishes_or_leaves_the_previous(tmp_path):
    p = str(tmp_path / "f.txt")
    with atomic_write(p, "w") as f:
        f.write("v1")
    with pytest.raises(RuntimeError):
        with atomic_write(p, "w") as f:
            f.write("torn")
            raise RuntimeError("crash mid-write")
    assert open(p).read() == "v1"
    assert os.listdir(tmp_path) == ["f.txt"]


def test_manager_retention_torn_fallback_and_age(tmp_path):
    reg = MetricsRegistry()
    clk = FakeClock()
    m = CheckpointManager(str(tmp_path), site="t", keep_last=2,
                          registry=reg, clock=clk)
    for s in (1, 2, 3):
        m.save(s, {"a": np.arange(s + 1)}, {"s": s}, block=True)
    assert m.steps() == [2, 3] and m.saves_ok == 3
    clk.advance(7.5)
    fam = reg.family("mmlspark_checkpoint_last_success_age_seconds")
    assert fam.value(site="t") == pytest.approx(7.5)
    with open(m.path_for(3), "r+b") as f:
        f.truncate(8)                            # a torn newest snapshot
    step, arrays, meta = m.load_latest()
    assert step == 2 and meta["s"] == 2
    np.testing.assert_array_equal(arrays["a"], np.arange(3))
    res = reg.family("mmlspark_checkpoint_resumes_total")
    assert res.labels(site="t", result="torn_skipped").value == 1
    m.close()


def test_resume_must_and_the_resume_argument(tmp_path):
    X, y = _data(n=600)
    p = GBDTParams(num_iterations=2, max_depth=2, seed=3)
    for fn in (train, train_streamed):
        with pytest.raises(FileNotFoundError):
            fn(X, y, p, checkpoint_dir=str(tmp_path / fn.__name__),
               resume="must", device="cpu")
        with pytest.raises(ValueError, match="resume must be"):
            fn(X, y, p, checkpoint_dir=str(tmp_path / "x"), resume="always",
               device="cpu")


@pytest.mark.parametrize("fn", [train, train_streamed],
                         ids=["train", "train_streamed"])
def test_fingerprint_mismatch_raises_and_never_trains_fresh(fn, tmp_path):
    X, y = _data(n=1500)
    d = str(tmp_path / "ck")
    p = GBDTParams(num_iterations=2, max_depth=3, seed=3)
    fn(X, y, p, checkpoint_dir=d, checkpoint_every=1, device="cpu")
    X2 = X.copy()
    X2[:100] += 1.0
    with pytest.raises(ValueError, match="fingerprint"):
        fn(X2, y, p, checkpoint_dir=d, device="cpu")
    r = fn(X2, y, p, checkpoint_dir=d, resume="never", device="cpu")
    assert r.booster.num_trees == 2


def test_preemption_scope_degrades_off_the_main_thread():
    seen = {}

    def body():
        with preemption_scope() as token:
            seen["armed"] = token.armed
            seen["fired"] = request_preemption("test") >= 1
            seen["requested"] = token.requested

    t = threading.Thread(target=body)
    t.start()
    t.join(10)
    assert seen == {"armed": False, "fired": True, "requested": True}


# --------------------------------------------- snapshots across packages

def _read_both(d):
    jm, pm = JaxManager(d, registry=None), CheckpointManager(d)
    (sj, aj, mj), (sp, ap, mp) = jm.load_latest(), pm.load_latest()
    jm.close()
    pm.close()
    assert sj == sp and mj == mp and sorted(aj) == sorted(ap)
    for k in aj:
        np.testing.assert_array_equal(aj[k], ap[k])
        assert aj[k].dtype == ap[k].dtype
    return ap, mp


def _snapshot_booster(arrs, meta, F):
    from mmlspark_tpu_torch.models.gbdt import children_depth_bound
    return convert.booster_from_arrays(
        {k: arrs[k] for k in BOOSTER_ARRAYS},
        dict(max_depth=children_depth_bound(arrs["left_child"],
                                            arrs["right_child"]),
             num_features=F, objective="binary",
             init_score=meta["init_score"]))


def test_each_package_reads_the_others_snapshot(tmp_path):
    X, y = _data(n=1200)
    kw = dict(num_iterations=3, max_depth=3, objective="binary", seed=3,
              bagging_fraction=0.7, bagging_freq=1)
    dj, dp = str(tmp_path / "jax"), str(tmp_path / "port")
    rj = jax_core.train_streamed(X, y, JaxParams(**kw), tile_rows=500,
                                 checkpoint_dir=dj, checkpoint_every=1)
    rp = train_streamed(X, y, GBDTParams(**kw), tile_rows=500,
                        checkpoint_dir=dp, checkpoint_every=1, device="cpu")
    for d, r, port in ((dj, rj, False), (dp, rp, True)):
        arrs, meta = _read_both(d)
        assert meta["format"] == "streamed_booster_v1"
        assert meta["iteration"] == 3 and meta["finished"]
        assert "bag_mask" in arrs
        b = _snapshot_booster(arrs, meta, X.shape[1])
        want = r.booster.predict(X, device="cpu") if port \
            else np.asarray(r.booster.predict(X))
        np.testing.assert_allclose(b.predict(X, device="cpu"), want,
                                   rtol=0, atol=1e-6)
    # the fingerprints are each package's own: no cross-package resume
    with pytest.raises(ValueError, match="fingerprint"):
        train_streamed(X, y, GBDTParams(**kw), tile_rows=500,
                       checkpoint_dir=dj, device="cpu")


def test_train_snapshot_reads_across_packages(tmp_path):
    X, y = _data(n=1000)
    d = str(tmp_path / "ck")
    r = train(X, y, GBDTParams(num_iterations=3, num_leaves=6, seed=1),
              checkpoint_dir=d, checkpoint_every=1, device="cpu")
    arrs, meta = _read_both(d)
    assert meta["format"] == "booster_v1" and meta["iteration"] == 3
    b = _snapshot_booster(arrs, meta, X.shape[1])
    np.testing.assert_array_equal(b.predict(X, device="cpu"),
                                  r.booster.predict(X, device="cpu"))


# ------------------------------------------------- preempt, then resume

@pytest.mark.parametrize("growth", [dict(max_depth=3),
                                    dict(num_leaves=15)],
                         ids=["level", "leaf"])
def test_train_preempted_and_resumed_equals_uninterrupted(growth, tmp_path):
    X, y = _data()
    Xv, yv = X[:400].copy(), y[:400].copy()
    p = GBDTParams(num_iterations=6, objective="binary",
                   feature_fraction=0.8, bagging_fraction=0.7,
                   bagging_freq=2, seed=3, **growth)
    ra = train(X, y, p, valid=(Xv, yv), device="cpu")
    d = str(tmp_path / "ck")
    r1 = train(X, y, p, valid=(Xv, yv), checkpoint_dir=d, checkpoint_every=2,
               callbacks=[_preempt_at(2)], device="cpu")
    assert r1.extras["preempted"] == 1.0 and r1.booster.num_trees == 3
    r2 = train(X, y, p, valid=(Xv, yv), checkpoint_dir=d, checkpoint_every=2,
               device="cpu")
    assert r2.extras["resumed_from_iteration"] == 3.0
    assert r2.extras["preempted"] == 0.0 and r2.booster.num_trees == 6
    _same(ra.booster, r2.booster)
    assert ra.evals == r2.evals


def test_train_finished_restore_and_larger_target(tmp_path):
    X, y = _data(n=1500)
    d = str(tmp_path / "ck")
    p = GBDTParams(num_iterations=4, num_leaves=7, seed=3)
    r1 = train(X, y, p, checkpoint_dir=d, checkpoint_every=2, device="cpu")
    assert snapshot_steps(d) == [2, 4]
    r2 = train(X, y, p, checkpoint_dir=d, checkpoint_every=2, device="cpu")
    assert r2.extras["resumed_from_iteration"] == 4.0
    assert r2.extras["checkpoint_saves"] == 0.0
    _same(r1.booster, r2.booster)
    p6 = GBDTParams(num_iterations=6, num_leaves=7, seed=3)
    r3 = train(X, y, p6, checkpoint_dir=d, device="cpu")
    assert r3.booster.num_trees == 6
    _same(train(X, y, p6, device="cpu").booster, r3.booster)


@pytest.mark.parametrize("growth,quant,tiles", [
    (dict(max_depth=3), False, (500, 500)),
    (dict(max_depth=3), True, (600, 300)),
    (dict(num_leaves=8), True, (300, 700)),
], ids=["level_float_same_width", "level_quant_shrink", "leaf_quant_grow"])
def test_train_streamed_preempted_and_resumed_is_bit_identical(
        growth, quant, tiles, tmp_path):
    X, y = _data(n=1200)
    Xv, yv = X[:300].copy(), y[:300].copy()
    p = GBDTParams(num_iterations=5, objective="binary", seed=3,
                   feature_fraction=0.8, bagging_fraction=0.7,
                   bagging_freq=2, use_quantized_grad=quant, **growth)
    t1, t2 = tiles
    ra = train_streamed(X, y, p, valid=(Xv, yv), tile_rows=t1, device="cpu")
    d = str(tmp_path / "ck")
    r1 = train_streamed(X, y, p, valid=(Xv, yv), tile_rows=t1,
                        checkpoint_dir=d, checkpoint_every=1,
                        callbacks=[_preempt_at(2)], device="cpu")
    assert r1.extras["preempted"] == 1.0 and r1.booster.num_trees == 3
    r2 = train_streamed(X, y, p, valid=(Xv, yv), tile_rows=t2,
                        checkpoint_dir=d, checkpoint_every=1, resume="must",
                        device="cpu")
    assert r2.extras["resumed_from_iteration"] == 3.0
    assert r2.extras["resharded"] == float(t1 != t2)
    _same(ra.booster, r2.booster)
    assert ra.evals == r2.evals
    if t1 != t2:
        # and uninterrupted at the other width
        _same(ra.booster, train_streamed(X, y, p, valid=(Xv, yv),
                                         tile_rows=t2, device="cpu").booster)
        fam = get_registry().family("mmlspark_reshard_total")
        direction = "shrink" if t2 < t1 else "grow"
        assert fam.labels(driver="lightgbm.train_streamed",
                          direction=direction).value >= 1


def test_train_streamed_cadence_finished_restore_and_warm_start(tmp_path):
    X, y = _data(n=1500)
    d = str(tmp_path / "ck")
    p = GBDTParams(num_iterations=6, max_depth=3, seed=3)
    r1 = train_streamed(X, y, p, checkpoint_dir=d, checkpoint_every=2,
                        device="cpu")
    assert snapshot_steps(d) == [2, 4, 6]
    assert r1.extras["checkpoint_saves"] == 4.0
    r2 = train_streamed(X, y, p, checkpoint_dir=d, checkpoint_every=2,
                        device="cpu")
    assert r2.extras["resumed_from_iteration"] == 6.0
    assert r2.extras["checkpoint_saves"] == 0.0
    _same(r1.booster, r2.booster)
    p3 = GBDTParams(num_iterations=3, max_depth=3, seed=3)
    r3 = train_streamed(X, y, p3, device="cpu")
    r33 = train_streamed(X, y, p3, init_booster=r3.booster, device="cpu")
    _same(r33.booster, r1.booster)


def test_train_streamed_init_booster_guards():
    from mmlspark_tpu_torch.models.gbdt import (GBDTBooster,
                                                perfect_tree_children)
    X, y = _data(n=600)

    def mini(num_features=8, num_class=1, objective="binary",
             categorical_features=None, average_output=False):
        lc, rc = perfect_tree_children(2)
        T = max(1, num_class)
        z3 = np.zeros((T, 3), np.float32)
        return GBDTBooster(
            np.zeros((T, 3), np.int32), z3, np.zeros((T, 3), np.int32), z3,
            z3, z3, np.zeros((T, 4), np.float32),
            np.zeros((T, 4), np.float32), np.ones((T,), np.float32),
            left_child=np.tile(lc, (T, 1)), right_child=np.tile(rc, (T, 1)),
            max_depth=2, num_features=num_features, objective=objective,
            num_class=num_class, average_output=average_output,
            categorical_features=list(categorical_features or []))

    p = GBDTParams(num_iterations=2, max_depth=3)
    for kw, match in ((dict(num_class=3, objective="multiclass"),
                       "single-output"),
                      (dict(num_features=4), "features"),
                      (dict(categorical_features=(1,)), "categorical"),
                      (dict(average_output=True), "rf-averaged")):
        with pytest.raises(ValueError, match=match):
            train_streamed(X, y, p, init_booster=mini(**kw), device="cpu")


def test_estimator_batches_checkpoint_into_their_own_directories(tmp_path):
    X, y = _data(n=800)
    d = str(tmp_path / "ck")
    LightGBMClassifier().set_params(
        device="cpu", num_iterations=4, num_leaves=4, num_batches=2,
        checkpoint_dir=d, checkpoint_every=1).fit(
        DataFrame.from_dict({"features": X, "label": y}))
    assert sorted(os.listdir(d)) == ["batch_0000", "batch_0001"]
    for b in ("batch_0000", "batch_0001"):
        assert snapshot_steps(os.path.join(d, b)) == [1, 2]


def test_sigkill_mid_stream_resume_bit_identical(tmp_path):
    """A child process is SIGKILLed (no grace, no handler) mid
    ``train_streamed``; the resumed run is bit-identical to an
    uninterrupted one (the reference's drill, at its size)."""
    ckdir = str(tmp_path / "ck")
    marker = str(tmp_path / "iters.log")
    prog = textwrap.dedent(f"""
        import numpy as np
        from mmlspark_tpu_torch.lightgbm import GBDTParams, train_streamed
        rng = np.random.default_rng(0)
        X = rng.normal(size=(2500, 8)).astype(np.float32)
        y = (X[:, 0] + 0.5 * X[:, 1]
             + rng.normal(scale=0.3, size=2500) > 0).astype(np.float32)
        p = GBDTParams(num_iterations=10, objective="binary", max_depth=3,
                       growth="level", seed=3, use_quantized_grad=True)
        def cb(it, ev):
            with open({marker!r}, "a") as f:
                f.write(str(it) + chr(10))
            if it >= 2:
                import time
                time.sleep(30)
        train_streamed(X, y, p, tile_rows=1000, checkpoint_dir={ckdir!r},
                       checkpoint_every=1, callbacks=[cb], device="cpu")
    """)
    proc = subprocess.Popen([sys.executable, "-c", prog], cwd=ROOT,
                            env=dict(os.environ, PYTHONPATH=ROOT))
    try:
        deadline = time.time() + 120
        while time.time() < deadline and proc.poll() is None:
            if os.path.exists(marker) and \
                    len(open(marker).read().splitlines()) >= 3:
                break
            time.sleep(0.05)
        if proc.poll() is None:
            proc.kill()                   # SIGKILL: no cleanup, no handler
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert snapshot_steps(ckdir), "child died before any checkpoint landed"
    X, y = _data()
    p = GBDTParams(num_iterations=10, objective="binary", max_depth=3,
                   growth="level", seed=3, use_quantized_grad=True)
    resumed = train_streamed(X, y, p, tile_rows=700, checkpoint_dir=ckdir,
                             checkpoint_every=1, device="cpu")
    assert resumed.extras["resumed_from_iteration"] >= 1
    assert resumed.extras["resharded"] == 1.0
    _same(train_streamed(X, y, p, tile_rows=1000, device="cpu").booster,
          resumed.booster)
