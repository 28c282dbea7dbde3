"""Port parity for the boosting modes: bagging, GOSS, RF and DART through
``train()``, on both growers, against the JAX package.

Each package draws its own quantizer noise and its own GOSS sample (a
``torch.Generator`` against a JAX key), so the boosters are held by quality,
as ``test_train_matches_jax_quality`` holds the gbdt mode: accuracy within
0.02, logloss within 2%.  The host draws (feature fraction, the bag, DART's
drops) come from ``np.random.default_rng(seed)`` in the same order on both
sides, so they must agree exactly: every tree's root row count (the bag, or
GOSS's top_rate + other_rate sample) and, for DART, every tree weight.
"""
import numpy as np
import pytest

from mmlspark_tpu.lightgbm import GBDTParams as JaxParams
from mmlspark_tpu.lightgbm import train as jax_train
from mmlspark_tpu_torch.lightgbm import GBDTParams, train

from tests.test_torch_lightgbm import _data, _logloss

MODES = {
    "bagging": dict(bagging_fraction=0.7, bagging_freq=2,
                    feature_fraction=0.8),
    "goss": dict(boosting_type="goss"),
    "rf": dict(boosting_type="rf", feature_fraction=0.7),
    "dart": dict(boosting_type="dart", drop_rate=0.3, skip_drop=0.2,
                 learning_rate=0.3),
}
GROWTH = {"leaf": dict(num_leaves=31), "level": dict(max_depth=4)}


@pytest.mark.parametrize("growth", sorted(GROWTH))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_boosting_mode_matches_jax(monkeypatch, mode, growth):
    monkeypatch.setenv("MMLSPARK_TPU_HIST_BACKEND", "pallas")
    X, y = _data(n=2500, f=10, seed=7)
    Xtr, ytr, Xte, yte = X[:2000], y[:2000], X[2000:], y[2000:]
    kw = dict(num_iterations=8, objective="binary", seed=3,
              use_quantized_grad=True, **GROWTH[growth], **MODES[mode])
    jb = jax_train(Xtr, ytr, JaxParams(**kw)).booster
    tb = train(Xtr, ytr, GBDTParams(**kw), device="cpu").booster
    jp, tp = jb.predict(Xte), tb.predict(Xte, device="cpu")
    j_acc = float(((jp > 0.5) == (yte > 0)).mean())
    t_acc = float(((tp > 0.5) == (yte > 0)).mean())
    assert abs(t_acc - j_acc) <= 0.02, (t_acc, j_acc)
    j_ll, t_ll = _logloss(yte, jp), _logloss(yte, tp)
    assert abs(t_ll - j_ll) <= 0.02 * j_ll, (t_ll, j_ll)
    assert tb.num_trees == 8 and tb.average_output == (mode == "rf")
    # the host draws agree: the same rows reach every root, the same trees
    # are dropped
    np.testing.assert_array_equal(tb.internal_count[:, 0],
                                  jb.internal_count[:, 0])
    np.testing.assert_array_equal(tb.tree_weight, jb.tree_weight)
    if mode == "goss":
        assert (tb.internal_count[:, 0] == int(0.2 * 2000)
                + int(0.1 * 2000)).all()
    elif mode == "dart":
        assert (tb.tree_weight < 1).any()
    else:
        assert (tb.internal_count[:, 0] < 2000).all()
