"""Deep-learning scoring of the port: the model payloads, ``JaxModel`` (the
CNTKModel twin), ``ImageFeaturizer``, the model repository and ONNX import.
``dl/torch_import.py`` and ``dl/onnx_export.py`` are not ported yet
(ROADMAP.md §1 item 8)."""
from .jax_model import JaxModel, FlaxModelPayload
from .image_featurizer import ImageFeaturizer
from .model_downloader import ModelDownloader, ModelRepo, ModelSchema
from .onnx_import import (OnnxModelPayload, onnx_to_jax, onnx_to_jax_model)

__all__ = ["JaxModel", "FlaxModelPayload", "ImageFeaturizer", "ModelDownloader",
           "ModelRepo", "ModelSchema", "OnnxModelPayload", "onnx_to_jax",
           "onnx_to_jax_model"]
