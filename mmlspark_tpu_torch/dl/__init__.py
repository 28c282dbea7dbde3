"""Deep-learning scoring of the port: the model payloads, ``JaxModel`` (the
CNTKModel twin), ``ImageFeaturizer``, the model repository, ONNX import and
export, and torch model import."""
from .jax_model import JaxModel, FlaxModelPayload
from .image_featurizer import ImageFeaturizer
from .model_downloader import ModelDownloader, ModelRepo, ModelSchema
from .torch_import import torch_to_jax, torch_to_jax_model
from .onnx_import import (OnnxModelPayload, onnx_to_jax, onnx_to_jax_model)
from .onnx_export import export_gbdt, export_mlp, export_resnet

__all__ = ["JaxModel", "FlaxModelPayload", "ImageFeaturizer", "ModelDownloader",
           "ModelRepo", "ModelSchema", "torch_to_jax", "torch_to_jax_model",
           "OnnxModelPayload", "onnx_to_jax", "onnx_to_jax_model",
           "export_gbdt", "export_mlp", "export_resnet"]
