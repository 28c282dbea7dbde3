"""Seed TestObjects for flagship stages — consumed both by the in-repo
fuzzing sweep and by the GENERATED per-stage test files (the reference's
per-suite ``testObjects()`` declarations feeding PyTestFuzzing,
``Fuzzing.scala:47-172``).

The port's twin of the JAX package's ``testing/seeds.py``: the same stages,
params and frames, over the port's stages.  ``seed_objects(device=...)``
sets ``device`` on every seeded stage that has that param (``"cpu"`` runs
the sweep on the host); left unset, those stages run on the CUDA card, the
three LightGBM fits through the Hopper kernels."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..core import DataFrame
from ..core.schema import vector_column
from .fuzzing import TestObject


def vec_frame(n=60, d=5, seed=0, label=True) -> DataFrame:
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    cols = {"features": vector_column(list(X))}
    if label:
        cols["label"] = (X[:, 0] > 0).astype(float)
    return DataFrame.from_dict(cols, 2)


def seed_objects(device: Optional[str] = None) -> Dict[str, TestObject]:
    """Qualname -> TestObject for every stage with a declared seed; with
    ``device``, each stage that takes a ``device`` param is set to it."""
    from mmlspark_tpu_torch.lightgbm import (LightGBMClassifier, LightGBMRanker,
                                       LightGBMRegressor)
    from mmlspark_tpu_torch.vw import VowpalWabbitClassifier, VowpalWabbitFeaturizer
    from mmlspark_tpu_torch.featurize import CleanMissingData, ValueIndexer
    from mmlspark_tpu_torch.isolationforest import IsolationForest
    from mmlspark_tpu_torch.nn import KNN
    from mmlspark_tpu_torch.stages import (FixedMiniBatchTransformer, SummarizeData,
                                     TextPreprocessor)
    from mmlspark_tpu_torch.opencv import ImageTransformer, ImageSetAugmenter
    from mmlspark_tpu_torch.recommendation import SAR
    from mmlspark_tpu_torch.cognitive import SpeechToTextSDK
    from mmlspark_tpu_torch.featurize.text import MultiNGram
    from mmlspark_tpu_torch.io.audio import write_wav

    vec = vec_frame()
    rng = np.random.default_rng(1)
    sp_col = np.empty(40, dtype=object)
    for i in range(40):
        sp_col[i] = {"indices": np.arange(5, dtype=np.int32),
                     "values": rng.normal(size=5).astype(np.float32)}
    sparse = DataFrame.from_dict({"features": sp_col,
                                  "label": (rng.random(40) > 0.5).astype(float)}, 2)
    txt = DataFrame.from_dict({"text": np.array(["Hello World", "FOO bar"],
                                                dtype=object)})
    imgs = np.empty(2, dtype=object)
    for i in range(2):
        imgs[i] = rng.uniform(0, 255, (8, 8, 3)).astype(np.float32)
    img_df = DataFrame.from_dict({"image": imgs})
    nan_df = DataFrame.from_dict({"x": np.array([1.0, np.nan, 5.0])})

    objs = [
        TestObject(LightGBMClassifier().set_params(num_iterations=5, min_data_in_leaf=2), vec),
        TestObject(LightGBMRegressor().set_params(num_iterations=5, min_data_in_leaf=2), vec),
        TestObject(VowpalWabbitClassifier().set_params(num_bits=8, num_passes=2), sparse),
        TestObject(VowpalWabbitFeaturizer().set_params(input_cols=["text"], output_col="f"),
                   transform_df=txt),
        TestObject(CleanMissingData().set_params(input_cols=["x"]), nan_df),
        TestObject(ValueIndexer().set_params(input_col="text", output_col="i"), txt),
        TestObject(IsolationForest().set_params(num_estimators=10), vec.drop("label")),
        TestObject(KNN().set_params(k=2, output_col="m"), vec.drop("label")),
        TestObject(FixedMiniBatchTransformer().set_params(batch_size=3),
                   transform_df=vec),
        TestObject(SummarizeData(), transform_df=vec_frame(20, 2, label=False)
                   .with_column("n", lambda p: np.arange(len(p["features"]), dtype=float))
                   .drop("features")),
        TestObject(TextPreprocessor().set_params(input_col="text", output_col="t"),
                   transform_df=txt),
        TestObject(ImageTransformer(input_col="image", output_col="o").resize(4, 4),
                   transform_df=img_df),
        TestObject(ImageSetAugmenter().set_params(input_col="image",
                                                  output_col="aug"),
                   transform_df=img_df),
    ]

    # SAR: three users x five items, every pair seen twice
    sar_df = DataFrame.from_rows(
        [{"user": f"u{i % 3}", "item": f"i{(i * 7) % 5}", "rating": 1.0}
         for i in range(30)])
    objs.append(TestObject(SAR().set_params(support_threshold=1), sar_df))

    # ranker: grouped queries
    gsize, nq = 8, 6
    Xr = rng.normal(size=(gsize * nq, 4))
    rank_df = DataFrame.from_dict({
        "features": vector_column(list(Xr)),
        "label": (Xr[:, 0] > 0).astype(float),
        "group": np.repeat(np.arange(nq), gsize).astype(float)}, 1)
    objs.append(TestObject(LightGBMRanker().set_params(
        num_iterations=3, min_data_in_leaf=2), rank_df))

    # streaming speech over a wav column
    t = np.arange(4000) / 16000.0
    wavs = np.empty(1, dtype=object)
    wavs[0] = write_wav((0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32),
                        16000)
    stt_df = DataFrame.from_dict({"audio": wavs})
    objs.append(TestObject(SpeechToTextSDK(input_col="audio",
                                           output_col="events", chunk_s=0.1),
                           transform_df=stt_df))

    # n-grams over TOKENIZED text (the stage's contract: list column)
    toks = np.empty(2, dtype=object)
    toks[0] = ["the", "quick", "brown", "fox"]
    toks[1] = ["hello", "world"]
    tok_df = DataFrame.from_dict({"text": toks})
    objs.append(TestObject(MultiNGram().set_params(input_col="text",
                                                   output_col="ngrams"),
                           transform_df=tok_df))
    if device is not None:
        for o in objs:
            if "device" in o.stage._params:
                o.stage.set("device", device)
    return {type(o.stage).__qualname__: o for o in objs}
