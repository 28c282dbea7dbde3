"""The sharded GBDT on the card: a world of two ranks on the one card over
gloo (NCCL refuses two ranks on a device; gloo takes CUDA tensors in
``all_reduce``).  Each rank fits ``train(shard_rows=True)`` on its block;
the boosters equal each other and the world-1 fit, bit for bit, and each
rank launched both Hopper kernels.  Marked ``cuda``: without a CUDA device
every test skips (the CPU tier-1 run holds the same path against the JAX
package in ``test_torch_sharded_gbdt.py``).  On the card:

    python -m pytest tests/test_torch_cuda_sharded.py -q -m cuda --noconftest
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.lightgbm import GBDTParams, train
from mmlspark_tpu_torch.parallel.world import World

pytestmark = pytest.mark.cuda

ARRAYS = ("split_feature", "threshold_bin", "threshold", "leaf_value",
          "split_gain", "left_child", "right_child")


@pytest.fixture(scope="module")
def world2():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with World(2, backend="gloo") as w:
        yield w


def _data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(100_001, 20)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] + rng.normal(scale=0.3, size=len(X))
         > 0).astype(np.float32)
    return X, y


def _rank_fit(pkw):
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    X, y = _data()
    CH.reset_launch_counts()
    r = train(X, y, GBDTParams(**pkw), shard_rows=True)
    torch.cuda.synchronize()
    return ({k: np.asarray(getattr(r.booster, k)) for k in ARRAYS},
            CH.launch_counts(), r.extras["shard_rows"])


@pytest.mark.parametrize("pkw", [
    dict(num_iterations=4, max_depth=4, objective="binary"),
    dict(num_iterations=4, num_leaves=15, objective="binary"),
    dict(num_iterations=4, num_leaves=15, objective="binary", voting_k=3)],
    ids=["level", "leaf", "voting"])
def test_two_ranks_on_the_card_grow_one_booster(world2, pkw):
    (a0, l0, rows0), (a1, l1, _) = world2.run(_rank_fit, pkw)
    assert rows0 == 50_001.0
    for k in ARRAYS:
        np.testing.assert_array_equal(a0[k], a1[k], err_msg=k)
    assert min(l0.values()) > 0 and min(l1.values()) > 0
    if "voting_k" not in pkw:
        X, y = _data()
        one = train(X, y, GBDTParams(**pkw), shard_rows=True).booster
        for k in ARRAYS:
            np.testing.assert_array_equal(a0[k], getattr(one, k), err_msg=k)
