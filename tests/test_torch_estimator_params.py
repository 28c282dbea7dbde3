"""The port's estimators carry the JAX package's param surface: every param
of the reference's classifier, regressor and ranker exists with its default;
the GOSS and DART rates reach ``train()``; ``num_batches`` trains in
sequential batches as the reference does; the distributed params
(``parallelism="voting_parallel"``, ``top_k``, ``shard_rows``) and the
checkpoint params reach ``train()`` and train on one device.  Boosters are compared with
``test_torch_multiclass.same_booster`` (float histograms on both sides;
integer arrays identical unless an f32 near-tie parts them, scores within
rtol 1e-5 and 1e-5 of the largest score); tree weights and root row counts,
which come from host draws, exactly.
"""
import numpy as np
import pytest

from mmlspark_tpu.core import DataFrame as JaxDataFrame
from mmlspark_tpu.lightgbm import estimators as jax_est
from mmlspark_tpu_torch.core import DataFrame
from mmlspark_tpu_torch.lightgbm import estimators as port_est

from tests.test_torch_lightgbm import _data
from tests.test_torch_multiclass import same_booster

PAIRS = [(jax_est.LightGBMClassifier, port_est.LightGBMClassifier),
         (jax_est.LightGBMRegressor, port_est.LightGBMRegressor),
         (jax_est.LightGBMRanker, port_est.LightGBMRanker)]


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: p[0].__name__)
def test_estimators_have_the_reference_params_and_defaults(pair):
    jcls, tcls = pair
    jp, tp = jcls._params, tcls._params
    # the port adds one param of its own: where training and scoring run
    assert set(tp) == set(jp) | {"device"}
    for name, param in jp.items():
        assert tp[name].default == param.default, name


def _fit_both(kw, n=2000, seed=0):
    X, y = _data(n=n, f=6, seed=seed)
    cols = {"features": X, "label": y}
    tm = port_est.LightGBMClassifier().set_params(device="cpu", **kw).fit(
        DataFrame.from_dict(cols))
    jm = jax_est.LightGBMClassifier().set_params(**kw).fit(
        JaxDataFrame.from_dict(cols))
    return X, jm.booster, tm.booster


def test_goss_rates_reach_train():
    kw = dict(boosting_type="goss", top_rate=0.3, other_rate=0.25,
              num_iterations=3, num_leaves=7)
    X, jb, tb = _fit_both(kw)
    want = int(0.3 * 2000) + int(0.25 * 2000)
    assert (tb.internal_count[:, 0] == want).all()
    np.testing.assert_array_equal(tb.internal_count[:, 0],
                                  jb.internal_count[:, 0])


def test_dart_rates_reach_train():
    kw = dict(boosting_type="dart", drop_rate=0.5, max_drop=2, skip_drop=0.0,
              num_iterations=6, num_leaves=7, learning_rate=0.3)
    X, jb, tb = _fit_both(kw)
    np.testing.assert_array_equal(tb.tree_weight, jb.tree_weight)
    # skip_drop 0 drops every iteration after the first, max_drop caps it
    # at two trees: the newest tree of each iteration weighs 1 / (1 + 2)
    assert tb.tree_weight[-1] == np.float32(1.0 / 3.0)
    assert same_booster(jb, tb, X) == 6


@pytest.mark.parametrize("num_batches", [2, 3])
def test_num_batches_trains_as_the_reference(num_batches):
    kw = dict(num_batches=num_batches, num_iterations=6, num_leaves=7)
    X, jb, tb = _fit_both(kw, n=2400, seed=1)
    per_batch = max(1, 6 // num_batches)
    assert tb.num_trees == jb.num_trees == per_batch * num_batches
    assert same_booster(jb, tb, X) == tb.num_trees
    # each batch warm-starts from the last: a later batch's root sees only
    # its own slice of the rows
    bounds = np.linspace(0, 2400, num_batches + 1).astype(int)
    np.testing.assert_array_equal(
        tb.internal_count[::per_batch, 0], np.diff(bounds))


def test_regressor_trains_in_one_batch_as_the_reference():
    """The JAX package's regressor ignores ``num_batches`` (it calls
    ``train()`` once); the port's does too."""
    X, y = _data(n=1200, f=6, seed=4)
    y = X[:, 0] - 0.5 * X[:, 1]
    cols = {"features": X, "label": y}
    kw = dict(num_batches=3, num_iterations=4, num_leaves=7)
    tb = port_est.LightGBMRegressor().set_params(device="cpu", **kw).fit(
        DataFrame.from_dict(cols)).booster
    jb = jax_est.LightGBMRegressor().set_params(**kw).fit(
        JaxDataFrame.from_dict(cols)).booster
    assert tb.num_trees == jb.num_trees == 4
    # every tree's root saw all the rows: one batch
    np.testing.assert_array_equal(tb.internal_count[:, 0], 1200)
    assert same_booster(jb, tb, X) == 4


@pytest.mark.parametrize("kw,queue", [
    (dict(parallelism="voting_parallel"), "default"),
    (dict(parallelism="voting_parallel", top_k=1), "default"),
    (dict(shard_rows=True), "default"),
    (dict(checkpoint_dir="ckpt"), None),
    (dict(checkpoint_every=5), None)],
    ids=["voting", "voting_top_k", "shard_rows", "checkpoint_dir",
         "checkpoint_every"])
def test_unported_params_raise_their_queue(kw, queue, tmp_path):
    """No param's queue is open any more: each fit trains.  The distributed
    params on one device (``queue`` "default") grow the default fit's
    booster bit for bit: voting engages only across ranks (a ``top_k`` of 1
    would vote away 3 of the 4 features there), and ``shard_rows`` on a
    mesh of one position sums nothing.  The checkpoint params (``queue``
    None) train and, with a directory, leave the terminal snapshot
    there."""
    X, y = _data(n=300, f=4, seed=2)
    df = DataFrame.from_dict({"features": X, "label": y})
    if queue is None:
        from mmlspark_tpu_torch.io.checkpoint import snapshot_steps
        for est in (port_est.LightGBMClassifier(),
                    port_est.LightGBMRegressor()):
            if "checkpoint_dir" in kw:   # one fresh directory per run
                kw = dict(kw, checkpoint_dir=str(
                    tmp_path / type(est).__name__ / "ckpt"))
            model = est.set_params(device="cpu", num_iterations=1,
                                   num_leaves=4, **kw).fit(df)
            assert model.booster.num_trees == 1
            if "checkpoint_dir" in kw:
                assert snapshot_steps(kw["checkpoint_dir"]) == [1]
        return
    for cls in (port_est.LightGBMClassifier, port_est.LightGBMRegressor):
        base = dict(device="cpu", num_iterations=2, num_leaves=4)
        got = cls().set_params(**base, **kw).fit(df).booster
        want = cls().set_params(**base).fit(df).booster
        for k in ("split_feature", "threshold_bin", "leaf_value"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))


@pytest.mark.parametrize("kw", [dict(monitor_port=0),
                                dict(monitor_stall_timeout_s=30.0)],
                         ids=["monitor_port", "monitor_stall_timeout_s"])
def test_the_estimators_fit_serves_the_monitor(kw):
    """The monitor params reach ``train()``: ``monitor_port`` serves live
    ``/progress`` while ``fit`` runs, the stall timeout alone arms the
    watchdog without a server, and the model is the unmonitored fit's."""
    import json
    import urllib.request
    from mmlspark_tpu_torch.observability import (active_monitors,
                                                  active_runs, get_registry)
    X, y = _data(n=300, f=4, seed=2)
    df = DataFrame.from_dict({"features": X, "label": y})
    for est in (port_est.LightGBMClassifier, port_est.LightGBMRegressor):
        seen = []

        def probe(i, ev):
            runs = [r for r in active_runs(get_registry())
                    if r.job == "lightgbm.train"]
            mons = [m for m in active_monitors(get_registry())
                    if m.run.job == "lightgbm.train"]
            step = None
            if mons:
                with urllib.request.urlopen(mons[0].address + "/progress",
                                            timeout=10) as r:
                    step = json.loads(r.read())["step"]
            seen.append((len(runs), len(mons), step))

        base = dict(device="cpu", num_iterations=2, num_leaves=4)
        orig = port_est.gbdt_core.train

        def with_probe(*a, **k):
            return orig(*a, **dict(k, callbacks=[probe]))

        port_est.gbdt_core.train = with_probe
        try:
            model = est().set_params(**base, **kw).fit(df)
        finally:
            port_est.gbdt_core.train = orig
        plain = est().set_params(**base).fit(df)
        served = "monitor_port" in kw
        assert seen == [(1, int(served), 0 if served else None),
                        (1, int(served), 1 if served else None)]
        np.testing.assert_array_equal(model.booster.leaf_value,
                                      plain.booster.leaf_value)
        assert not [r for r in active_runs(get_registry())
                    if r.job == "lightgbm.train"]


def test_serial_and_data_parallel_train_alike():
    """``parallelism`` other than voting changes nothing on one device."""
    X, y = _data(n=800, f=4, seed=3)
    df = DataFrame.from_dict({"features": X, "label": y})
    boosters = [port_est.LightGBMClassifier().set_params(
        device="cpu", num_iterations=2, num_leaves=4,
        parallelism=par).fit(df).booster
        for par in ("data_parallel", "serial")]
    np.testing.assert_array_equal(boosters[0].split_feature,
                                  boosters[1].split_feature)
    np.testing.assert_array_equal(boosters[0].leaf_value,
                                  boosters[1].leaf_value)
