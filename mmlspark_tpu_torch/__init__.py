"""mmlspark_tpu_torch — the PyTorch/CUDA port of ``mmlspark_tpu``.

The JAX package beside it is the reference: every module here sits at the
same relative path as its counterpart and keeps its public names, so a
reader can find each twin.  This package imports ``torch`` and numpy and
never ``jax`` or ``mmlspark_tpu``; what it needs from the JAX package's
jax-free modules (``core/``, ``io/``, ``utils/``, ``observability/metrics``)
it keeps as its own copy.

Ported so far (the GBDT main path, then deep-learning scoring):

- ``core``      — DataFrame, Params, Pipeline, persistence (copies)
- ``ops``       — quantized histogram ops and the card's binning
  (``bin_matrix``); ``ops.cuda_histogram`` holds the two hand-written
  Hopper kernels (``csrc/frontier.cu``) that replace the fused Pallas
  frontier kernel, each beside its plain PyTorch version; ``ops.image``,
  the NHWC image ops
- ``lightgbm``  — BinMapper (edges on the host by the JAX package's C++
  plane, copied as ``csrc/binning.cpp``, or numpy; bins on the card;
  ``fit_streaming`` from a streaming quantile sketch),
  ``train()`` with both growers, categorical splits and the binary,
  multiclass, regression and LambdaRank objectives, checkpoints,
  preemption and resume; ``train_streamed()``, out-of-core boosting of
  host-RAM tiles through pinned memory on a copy stream (both growers);
  LightGBMClassifier/Regressor/Ranker (the estimators and ``train_streamed``
  also exported here)
- ``io``        — out-of-core tiles (``chunked``) and atomic booster
  snapshots (``checkpoint``), copies
- ``utils``     — ``resilience`` (deadlines, preemption scopes),
  ``concurrency``, ``pickling`` (copies) and the native loader
- ``observability`` — ``metrics``, the registry (a copy)
- ``models``    — the GBDT booster artifact and its scoring walk; the
  ResNet family as ``nn.Module``s (NHWC, flax's padding); the model
  runner's batch front
- ``dl``        — ``JaxModel`` (the CNTKModel twin), ``ImageFeaturizer``,
  the model repository (``ModelDownloader``) and ONNX import
- ``opencv``    — ``ImageTransformer`` and ``ImageSetAugmenter``
- ``convert``   — state carried across from the JAX package (GBDT params,
  boosters, bin edges; flax ResNet variables -> ``state_dict``)

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see ``_device.resolve_device``).
"""

__version__ = "0.2.0"

from ._device import resolve_device  # noqa: E402
from .lightgbm import (LightGBMClassifier, LightGBMRanker,  # noqa: E402
                       LightGBMRegressor, train_streamed)

__all__ = ["resolve_device", "__version__", "LightGBMClassifier",
           "LightGBMRegressor", "LightGBMRanker", "train_streamed"]
