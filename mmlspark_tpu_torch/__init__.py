"""mmlspark_tpu_torch — the PyTorch/CUDA port of ``mmlspark_tpu``.

The JAX package beside it is the reference: every module here sits at the
same relative path as its counterpart and keeps its public names, so a
reader can find each twin.  This package imports ``torch`` and numpy and
never ``jax`` or ``mmlspark_tpu``; what it needs from the JAX package's
jax-free modules (``core/``, ``io/``, ``utils/``, ``observability/metrics``)
it keeps as its own copy.

Ported so far (the GBDT main path, deep-learning scoring, the sequence
models, serving, the serving fleet, VowpalWabbit, featurization and
Word2Vec, the auto-trainers and tuning, the isolation forest, KNN,
SAR, the explainers, the cognitive services, the test harness and
codegen):

- ``core``      — DataFrame, Params, Pipeline, persistence (copies)
- ``ops``       — histogram builds and their dispatcher (``cuda``,
  ``matmul``, ``scatter``) and the card's binning (``bin_matrix``);
  ``ops.cuda_histogram`` holds the two hand-written
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
- ``io``        — HTTP requests and responses as columns behind a
  breaker- and deadline-aware client (``http``), out-of-core tiles
  (``chunked``) and atomic booster snapshots (``checkpoint``), copies
- ``stages``    — the minibatch transformers and their batchers, and the
  plumbing transformers (``transforms``), copies
- ``utils``     — ``resilience`` (deadlines, preemption scopes),
  ``concurrency``, ``stopwatch``, ``streams``, ``fault`` (copies),
  ``cluster`` (the visible CUDA cards), ``pickling`` (its unpickler
  finds a JAX-pickled class's twin here) and the native loader (binning
  and VW's batch murmur hash)
- ``testing``   — the fuzzing harness, benchmark gates, test modifiers and
  chaos injectors (copies) and the seeded stages (``seeds``)
- ``codegen``   — the stage registry, stubs, docs, params manifest, R
  package and generated per-stage tests (``python -m mmlspark_tpu_torch
  codegen``)
- ``observability`` — the registry, spans, the span collector, SLOs,
  cost attribution, the flight recorder, the fleet plane
  (``federation``, ``autoscale``) and the live training monitor
  (``trainwatch``), copies; the profiler and compute twins (with
  host -> device transfer booking)
- ``serving``   — ``PipelineServer`` and the fleet (``TopologyService``,
  ``WorkerServer``, ``RoutingClient``, ``MembershipWatcher``), copies
- ``models``    — the GBDT booster artifact and its scoring walk; the
  ResNet family as ``nn.Module``s (NHWC, flax's padding); the sequence
  models; the model runner (batch front, decode, the continuous engine)
- ``dl``        — ``JaxModel`` (the CNTKModel twin), ``ImageFeaturizer``,
  the model repository (``ModelDownloader``) and ONNX import
- ``opencv``    — ``ImageTransformer`` and ``ImageSetAugmenter``
- ``vw``        — VowpalWabbit: the murmur featurizer and interactions
  (host), the SGD/AdaGrad classifier and regressor, ``--bfgs`` and the
  contextual bandit on the card
- ``train``     — ``TrainClassifier``/``TrainRegressor`` (``Featurize`` in
  front of any learner), ``ComputeModelStatistics`` and
  ``ComputePerInstanceStatistics`` (copies)
- ``featurize`` — ``Featurize`` and the column and text stages (host
  copies); ``Word2Vec``, trained on the card
- ``automl``    — ``TuneHyperparameters`` (candidates fitted on threads
  that share the card) and ``FindBestModel`` (copies)
- ``isolationforest`` — trees grown on the host, walked on the card
- ``nn``        — ball trees (host) and the KNN matmul query on the card
- ``recommendation`` — SAR's co-occurrence and scoring matmuls on the card;
  the indexer and the ranking stages (host)
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
