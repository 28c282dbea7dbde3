"""Port parity: a booster trained by the JAX package scores on the port.

The booster crosses as the JAX package's own ``to_string`` JSON and as its
raw arrays (``convert.booster_from_arrays``).  Leaf indices must be
identical; raw scores and probabilities agree within 1e-6 (the port sums
tree outputs in float64 on the device, the JAX package in float32 numpy).
"""
import dataclasses
import json

import numpy as np
import pytest

from mmlspark_tpu.lightgbm import GBDTParams as JaxParams
from mmlspark_tpu.lightgbm import train as jax_train
from mmlspark_tpu.models import gbdt as jax_gbdt
from mmlspark_tpu_torch import convert
from mmlspark_tpu_torch.models import gbdt as port_gbdt
from mmlspark_tpu_torch.models.gbdt import GBDTBooster


@pytest.fixture(scope="module")
def jax_booster():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(1500, 6)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] * X[:, 2] + rng.normal(scale=0.3, size=1500)
         > 0).astype(np.float32)
    r = jax_train(X, y, JaxParams(num_iterations=6, max_depth=3,
                                  objective="binary", seed=2))
    return r.booster


def _rows(n=700, seed=8):
    X = np.random.default_rng(seed).normal(size=(n, 6)).astype(np.float32)
    X[::17, 2] = np.nan            # missing values route left
    return X


def test_from_string_scores_like_jax(jax_booster):
    port = GBDTBooster.from_string(jax_booster.to_string())
    X = _rows()
    np.testing.assert_array_equal(port.predict_leaf(X, device="cpu"),
                                  jax_booster.predict_leaf(X))
    np.testing.assert_allclose(port.raw_scores(X, device="cpu"),
                               jax_booster.raw_scores(X), rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.predict(X, device="cpu"),
                               jax_booster.predict(X), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        port.raw_scores(X, num_iteration=2, device="cpu"),
        jax_booster.raw_scores(X, num_iteration=2), rtol=0, atol=1e-6)


def test_booster_from_arrays_and_device_walk_path(jax_booster):
    arrays = {k: getattr(jax_booster, k) for k in jax_booster._ARRAYS}
    meta = {k: getattr(jax_booster, k) for k in jax_booster._META}
    port = convert.booster_from_arrays(arrays, meta)
    X = _rows(n=30000, seed=1)     # the JAX package's device-walk branch
    np.testing.assert_array_equal(port.predict_leaf(X, device="cpu"),
                                  jax_booster.predict_leaf(X))
    np.testing.assert_allclose(port.predict(X, device="cpu"),
                               jax_booster.predict(X), rtol=0, atol=1e-6)
    for kind in ("split", "gain"):
        np.testing.assert_allclose(port.feature_importance(kind),
                                   jax_booster.feature_importance(kind))


def test_to_string_round_trips_to_the_same_json(jax_booster, tmp_path):
    s = jax_booster.to_string()
    port = GBDTBooster.from_string(s)
    assert json.loads(port.to_string()) == json.loads(s)
    port.save(str(tmp_path / "b"))
    back = jax_gbdt.GBDTBooster.load(str(tmp_path / "b"))
    assert json.loads(back.to_string()) == json.loads(s)
    again = GBDTBooster.load(str(tmp_path / "b"))
    assert again.to_string() == port.to_string()


@pytest.mark.parametrize("depth", [1, 3, 5])
def test_tree_shape_helpers_match(depth):
    for a, b in zip(port_gbdt.perfect_tree_children(depth),
                    jax_gbdt.perfect_tree_children(depth)):
        np.testing.assert_array_equal(a, b)
    lc, rc = jax_gbdt.perfect_tree_children(depth)
    assert port_gbdt.children_depth_bound(lc, rc) == \
        jax_gbdt.children_depth_bound(lc, rc) == depth


def test_params_from_jax_maps_every_field():
    jp = JaxParams(num_iterations=7, max_depth=4, lambda_l2=0.5,
                   use_quantized_grad=True)
    port = convert.params_from_jax(dataclasses.asdict(jp))
    assert dataclasses.asdict(port) == dataclasses.asdict(jp)
    assert dataclasses.asdict(port.resolve()) == \
        dataclasses.asdict(jp.resolve())
    with pytest.raises(ValueError, match="not in the port"):
        convert.params_from_jax({"bogus": 1})
