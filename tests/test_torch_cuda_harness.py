"""The port's test harness on the card: every ``seed_objects()`` entry left
on the default device (the CUDA card) passes ``ExperimentFuzzing`` and
``SerializationFuzzing`` (reloaded = fitted within the reference's atol
1e-5), the three LightGBM seeds' fits launch both Hopper kernels, and
``LightGBMDelegate`` on ``train()`` on the card is called once per
iteration and grows the undelegated booster bit for bit.  Marked ``cuda``:
without a CUDA device every test skips (the CPU tier-1 run holds the same
modules against the JAX package in ``test_torch_testing_harness.py`` and
``test_torch_utils_names.py``).  On the card:

    python -m pytest tests/test_torch_cuda_harness.py -q -m cuda --noconftest
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.lightgbm import GBDTParams, train
from mmlspark_tpu_torch.lightgbm.delegate import LightGBMDelegate
from mmlspark_tpu_torch.ops import cuda_histogram as CH
from mmlspark_tpu_torch.testing import ExperimentFuzzing, SerializationFuzzing
from mmlspark_tpu_torch.testing.seeds import seed_objects
from mmlspark_tpu_torch.utils import ClusterUtil

pytestmark = pytest.mark.cuda

SEEDED = sorted(seed_objects())


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("name", SEEDED)
def test_seed_on_the_card(dev, name):
    obj = seed_objects()[name]
    CH.reset_launch_counts()
    _, out = ExperimentFuzzing.run(obj)
    assert out.count() > 0
    SerializationFuzzing.run(obj)
    torch.cuda.synchronize()
    counts = CH.launch_counts()
    if name.startswith("LightGBM"):
        assert counts["hist_accumulate"] > 0 and \
            counts["frontier_finish"] > 0, counts


def test_cluster_util_sees_the_card(dev):
    topo = ClusterUtil.get_topology()
    assert topo.platform == "gpu"
    assert topo.num_devices == torch.cuda.device_count()
    assert ClusterUtil.default_parallelism(64) == \
        min(64, torch.cuda.device_count())


def test_delegate_on_the_card(dev):
    rng = np.random.default_rng(2)
    X = rng.normal(size=(4000, 8)).astype(np.float32)
    y = (X[:, 0] + X[:, 3] > 0).astype(np.float32)
    params = GBDTParams(num_iterations=5, num_leaves=15, objective="binary")
    seen = []

    class Recorder(LightGBMDelegate):
        def after_training_iteration(self, iteration, eval_result=None):
            seen.append(iteration)

    plain = train(X, y, params).booster
    hooked = train(X, y, params,
                   callbacks=[Recorder().as_callback()]).booster
    assert seen == list(range(5))
    for k in plain._present_arrays():
        np.testing.assert_array_equal(getattr(plain, k), getattr(hooked, k),
                                      err_msg=k)
