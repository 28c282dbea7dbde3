"""Model-agnostic local explainers — LIME + KernelSHAP.

Reference: ``explainers/`` (~2.3k LoC): ``LIMEBase.transform``
(``LIMEBase.scala:67-116``: sample -> score -> weighted-lasso per row),
``KernelSHAPBase`` (:36), samplers per modality (tabular/vector/image/text),
facade ``LocalExplainer.LIME.tabular`` etc. (``LocalExplainer.scala:68-103``).

Each row's perturbed samples are scored through the wrapped model in one
batched transform (the reference uses groupByKey.mapGroups): for a port
LightGBM model that is the booster's walk on its device, for a ``JaxModel``
its module on its device.  The surrogate fits run on the explainer's
``device`` param (``regression.py``): LIME's ISTA lasso in float32 there,
KernelSHAP's weighted least squares on the host in float64, as in the JAX
package.  Unset, the device is the card and a transform raises without one;
``"cpu"`` runs the lasso on the host.  Masks and background draws come from
the same ``np.random.default_rng(seed)`` sequence as the JAX package's, so
the masks are equal bit for bit.

The port of ``mmlspark_tpu/explainers/local.py``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .._device import resolve_device
from ..core import (ComplexParam, DataFrame, HasInputCol, HasOutputCol, Model,
                    Param, Transformer)
from ..core.dataframe import _as_column, _part_len
from ..core.schema import ColumnType, stack_vector_column, vector_column
from .regression import lasso_regression, weighted_least_squares


def _extract_target(col: np.ndarray, target_classes: Optional[List[int]]) -> np.ndarray:
    """Model output column -> scalar score per row (probability of target
    class, or the raw value)."""
    first = col[0]
    if isinstance(first, (list, np.ndarray)):
        cls = (target_classes or [int(np.argmax(first))])[0]
        return np.asarray([np.asarray(v)[cls] for v in col], np.float64)
    return np.asarray(col, np.float64)


class _LocalExplainerBase(Transformer, HasInputCol, HasOutputCol):
    model = ComplexParam("model", "transformer to explain")
    target_col = Param("target_col", "model output column to explain", "string",
                       default="probability")
    target_classes = Param("target_classes", "class indices to explain", "list",
                           default=None)
    num_samples = Param("num_samples", "perturbations per row", "int", default=256)
    metrics_col = Param("metrics_col", "surrogate fit metric column", "string",
                        default="r2")
    seed = Param("seed", "sampling seed", "int", default=0)

    kind: str = "lime"   # or "shap"
    regularization = Param("regularization", "lasso alpha (LIME)", "float", default=0.01)
    kernel_width = Param("kernel_width", "LIME kernel width", "float", default=0.75)
    device = Param("device", "where the surrogate fit runs: unset = the CUDA "
                   "card (an error without one), 'cpu' = the host", "string",
                   default=None)

    def __init__(self, uid=None, **kwargs):
        super().__init__(uid)
        if kwargs:
            self.set_params(**kwargs)

    # subclass hooks --------------------------------------------------------
    def _make_samples(self, instance, rng, n: int):
        """-> (binary_mask (n, d), model_inputs list[n])."""
        raise NotImplementedError

    def _background_score(self, mask: np.ndarray) -> np.ndarray:
        """Similarity/coalition weights for each sample's mask."""
        if self.kind == "shap":
            d = mask.shape[1]
            z = mask.sum(axis=1)
            from math import comb
            w = np.empty(len(z))
            for i, zi in enumerate(z):
                zi = int(zi)
                if zi == 0 or zi == d:
                    w[i] = 1e6  # enforced endpoints
                else:
                    w[i] = (d - 1) / (comb(d, zi) * zi * (d - zi))
            return w
        # LIME: exponential kernel on cosine/hamming distance
        width = self.get("kernel_width")
        dist = 1.0 - mask.mean(axis=1)
        return np.sqrt(np.exp(-(dist ** 2) / width ** 2))

    def _fit_surrogate(self, mask, scores, weights, device):
        if self.kind == "shap":
            coefs, intercept = weighted_least_squares(mask, scores, weights)
            return coefs, intercept
        coefs, intercept = lasso_regression(mask, scores, weights,
                                            alpha=self.get("regularization"),
                                            device=device)
        return coefs, intercept

    # main ------------------------------------------------------------------
    def _transform(self, df: DataFrame) -> DataFrame:
        model = self.get_or_fail("model")
        in_col = self.get_or_fail("input_col")
        out_col = self.get_or_fail("output_col")
        n_samples = self.get("num_samples")
        device = resolve_device(self.get("device"))
        rng = np.random.default_rng(self.get("seed"))

        def per_part(p):
            n = _part_len(p)
            out = np.empty(n, dtype=object)
            r2s = np.zeros(n, np.float64)
            for i in range(n):
                instance = p[in_col][i]
                mask, inputs = self._make_samples(instance, rng, n_samples)
                sample_df = self._samples_to_frame(inputs)
                scored = model.transform(sample_df)
                scores = _extract_target(scored.collect()[self.get("target_col")],
                                         self.get("target_classes"))
                weights = self._background_score(mask)
                coefs, intercept = self._fit_surrogate(mask, scores, weights,
                                                       device)
                pred = mask @ coefs + intercept
                ss_res = float(np.sum(weights * (scores - pred) ** 2))
                ss_tot = float(np.sum(weights * (scores - np.average(scores, weights=weights)) ** 2))
                r2s[i] = 1.0 - ss_res / max(ss_tot, 1e-12)
                out[i] = coefs
            return {**p, out_col: out, self.get("metrics_col"): r2s}

        return df.map_partitions(per_part)

    def _samples_to_frame(self, inputs: List) -> DataFrame:
        col = np.empty(len(inputs), dtype=object)
        for i, v in enumerate(inputs):
            col[i] = v
        return DataFrame([{self._model_input_col(): col}])

    def _model_input_col(self) -> str:
        return self.get_or_fail("input_col")

    def transform_schema(self, schema):
        schema.require(self.get_or_fail("input_col"))
        return schema.add(self.get_or_fail("output_col"), ColumnType.VECTOR)


# ---------------------------------------------------------------------------
# Vector / tabular samplers
# ---------------------------------------------------------------------------

class _VectorExplainer(_LocalExplainerBase):
    background_data = ComplexParam("background_data", "background frame for "
                                   "replacement values")

    def _background_matrix(self, d: int) -> np.ndarray:
        bg = self.get("background_data")
        if bg is None:
            return np.zeros((1, d))
        data = bg.collect()
        in_col = self.get_or_fail("input_col")
        cols = self.get("input_cols") if "input_cols" in self._params else None
        if in_col not in data and cols:
            # tabular mode: the vector column is derived; assemble the
            # background from the raw tabular columns instead
            return np.column_stack([np.asarray(data[c], np.float64)
                                    for c in cols])
        return stack_vector_column(data[in_col])

    def _make_samples(self, instance, rng, n):
        x = np.asarray(instance, np.float64)
        d = len(x)
        mask = rng.integers(0, 2, (n, d)).astype(np.float64)
        mask[0] = 1.0   # all-on coalition
        mask[1] = 0.0   # all-off
        bg = self._background_matrix(d)
        repl = bg[rng.integers(0, len(bg), n)]
        inputs = [np.where(mask[i] > 0, x, repl[i]) for i in range(n)]
        return mask, inputs


class VectorLIME(_VectorExplainer):
    kind = "lime"


class VectorSHAP(_VectorExplainer):
    kind = "shap"


class TabularLIME(_VectorExplainer):
    kind = "lime"
    input_cols = Param("input_cols", "tabular columns to perturb", "list")

    def transform_schema(self, schema):
        cols = self.get("input_cols")
        if cols:  # input_col is DERIVED from the tabular columns in
            # _transform; require those instead (reference TabularLIME takes
            # inputCols and assembles internally)
            for c in cols:
                schema.require(c)
            from ..core.schema import ColumnType
            return schema.add(self.get_or_fail("output_col"),
                              ColumnType.VECTOR)
        return super().transform_schema(schema)

    def _transform(self, df):
        cols = self.get("input_cols")
        if cols:
            work = df.with_column(self.get_or_fail("input_col"),
                                  lambda p: vector_column(
                                      [np.asarray([p[c][i] for c in cols], float)
                                       for i in range(_part_len(p))]))
            return super()._transform(work)
        return super()._transform(df)


class TabularSHAP(TabularLIME):
    kind = "shap"


# ---------------------------------------------------------------------------
# Text sampler
# ---------------------------------------------------------------------------

class _TextExplainer(_LocalExplainerBase):
    tokens_col = Param("tokens_col", "output column of token lists", "string",
                       default="tokens")

    def _make_samples(self, instance, rng, n):
        tokens = str(instance).split()
        d = max(len(tokens), 1)
        mask = rng.integers(0, 2, (n, d)).astype(np.float64)
        mask[0] = 1.0
        inputs = [" ".join(t for t, m in zip(tokens, mask[i]) if m > 0)
                  for i in range(n)]
        self._last_tokens = tokens
        return mask, inputs

    def _transform(self, df):
        out = super()._transform(df)
        in_col = self.get_or_fail("input_col")
        return out.with_column(self.get("tokens_col"),
                               lambda p: _as_column([str(v).split() for v in p[in_col]]))


class TextLIME(_TextExplainer):
    kind = "lime"


class TextSHAP(_TextExplainer):
    kind = "shap"


# ---------------------------------------------------------------------------
# Image sampler (superpixel masking)
# ---------------------------------------------------------------------------

class _ImageExplainer(_LocalExplainerBase):
    cell_size = Param("cell_size", "superpixel size (SLIC-ish grid)", "float", default=16.0)
    modifier = Param("modifier", "superpixel compactness", "float", default=130.0)
    superpixel_col = Param("superpixel_col", "superpixel assignment output",
                           "string", default="superpixels")

    def _make_samples(self, instance, rng, n):
        from .superpixel import slic_superpixels
        img = np.asarray(instance, np.float64)
        segments = slic_superpixels(img, self.get("cell_size"), self.get("modifier"))
        d = int(segments.max()) + 1
        mask = rng.integers(0, 2, (n, d)).astype(np.float64)
        mask[0] = 1.0
        mean_color = img.reshape(-1, img.shape[-1]).mean(axis=0)
        inputs = []
        for i in range(n):
            on = mask[i][segments]  # (H, W)
            out = np.where(on[..., None] > 0, img, mean_color)
            inputs.append(out.astype(np.float32))
        self._last_segments = segments
        return mask, inputs

    def _transform(self, df):
        out = super()._transform(df)
        cs, mod = self.get("cell_size"), self.get("modifier")
        in_col = self.get_or_fail("input_col")

        def seg_col(p):
            from .superpixel import slic_superpixels
            res = np.empty(len(p[in_col]), dtype=object)
            for i, v in enumerate(p[in_col]):
                res[i] = slic_superpixels(np.asarray(v, np.float64), cs, mod)
            return res

        return out.with_column(self.get("superpixel_col"), seg_col)


class ImageLIME(_ImageExplainer):
    kind = "lime"


class ImageSHAP(_ImageExplainer):
    kind = "shap"


class LocalExplainer:
    """Facade (reference ``LocalExplainer.scala:68-103``)."""

    class LIME:
        tabular = TabularLIME
        vector = VectorLIME
        image = ImageLIME
        text = TextLIME

    class KernelSHAP:
        tabular = TabularSHAP
        vector = VectorSHAP
        image = ImageSHAP
        text = TextSHAP
