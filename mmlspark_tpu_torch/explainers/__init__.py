"""Model-agnostic local explainers (the port of ``mmlspark_tpu.explainers``):
LIME and KernelSHAP over vectors, tabular columns, text and images, the
SLIC superpixels, and the surrogate solvers."""
from .local import (LocalExplainer, TabularLIME, TabularSHAP, VectorLIME,
                    VectorSHAP, TextLIME, TextSHAP, ImageLIME, ImageSHAP)
from .superpixel import SuperpixelTransformer, slic_superpixels
from .regression import lasso_regression, weighted_least_squares

__all__ = ["LocalExplainer", "TabularLIME", "TabularSHAP", "VectorLIME",
           "VectorSHAP", "TextLIME", "TextSHAP", "ImageLIME", "ImageSHAP",
           "SuperpixelTransformer", "slic_superpixels", "lasso_regression",
           "weighted_least_squares"]
