"""ModelDownloader — local repository of named model checkpoints.  The port
of ``mmlspark_tpu/dl/model_downloader.py``.

Reference: ``deep-learning/.../downloader/ModelDownloader.scala:26-112`` — a
``Repository`` of pretrained models with JSON ``ModelSchema`` metadata,
fetched from remote/HDFS into a local cache.  Here the repository is the
local filesystem only: models are registered (name -> module factory, or a
checkpoint directory) and materialised on demand, with weights drawn from a
seeded ``torch.Generator`` when no checkpoint exists.

A checkpoint directory holds ``variables.npz`` beside ``schema.json``.  A
directory the port wrote also holds ``module.json`` (``dl.jax_model``); one
the JAX package wrote holds a pickled flax module instead, which cannot be
read without flax, so its ResNet is inferred from the variables alone:
the block type and count from the ``BasicBlock_i`` / ``BottleneckBlock_i``
keys, the stage sizes from the runs of equal widths between the stride
changes, ``num_filters`` from ``conv_init``'s kernel, ``cifar_stem`` from a
3x3 stem, the classes from the head (``artifacts/model_repo/ShapesResNet20``
is such a directory).  A BiLSTM tagger's variables (``fwd_i`` / ``bwd_i``
cells) are read the same way: vocabulary and embedding width from the
embedding, the hidden width from a cell, the layers from the ``fwd_i``
count, the tags from the head.

Zoo weights drawn by ``download_by_name`` follow flax's initializers from
``torch.Generator().manual_seed(seed)``; they are not the JAX package's
weights for the same seed (its PRNG cannot be reproduced without JAX), so
only their names and shapes match the reference's.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from .jax_model import FlaxModelPayload


@dataclasses.dataclass
class ModelSchema:
    """Reference ``downloader/Schema.scala`` ModelSchema analogue."""
    name: str
    dataset: str = ""
    model_type: str = "classification"
    input_shape: Optional[List[int]] = None
    num_outputs: int = 1000
    uri: str = ""          # local checkpoint dir, if materialised

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(s: str) -> "ModelSchema":
        return ModelSchema(**json.loads(s))


def _zoo() -> Dict[str, Callable[..., Any]]:
    from ..models import bilstm, resnet
    return {
        "ResNet18": resnet.resnet18,
        "ResNet34": resnet.resnet34,
        "ResNet50": resnet.resnet50,
        "ResNet101": resnet.resnet101,
        "ShapesResNet20": lambda **kw: resnet.cifar_resnet20(
            num_classes=kw.pop("num_classes", 10), **kw),
        "BiLSTM": lambda **kw: bilstm.BiLSTMTagger(
            vocab_size=kw.pop("vocab_size", 32768),
            num_tags=kw.pop("num_tags", 32), **kw),
    }


_DEFAULT_SHAPES: Dict[str, List[int]] = {
    "ResNet18": [224, 224, 3], "ResNet34": [224, 224, 3],
    "ResNet50": [224, 224, 3], "ResNet101": [224, 224, 3],
}

_BLOCK_CONV0 = re.compile(
    r"^params/(BasicBlock|BottleneckBlock)_(\d+)/Conv_0/kernel$")


def resnet_from_variables(variables: Mapping):
    """The port's float32 ``ResNet`` holding a flax ResNet's variables
    (nested, or flat ``params/...`` keys), its architecture inferred from
    the key names and kernel shapes."""
    from ..convert import flatten_variables, resnet_state_dict_from_flax
    from ..models import resnet
    flat = flatten_variables(variables)
    blocks = {}
    for key, arr in flat.items():
        m = _BLOCK_CONV0.match(key)
        if m:
            blocks[int(m.group(2))] = (m.group(1), int(arr.shape[-1]))
    kinds = {kind for kind, _ in blocks.values()}
    if len(kinds) != 1 or sorted(blocks) != list(range(len(blocks))):
        raise ValueError("not a flax ResNet's variables: block keys "
                         f"{sorted(blocks)} of kinds {sorted(kinds)}")
    stem = flat["params/conv_init/kernel"]          # (kh, kw, 3, filters)
    num_filters = int(stem.shape[-1])
    widths = [blocks[i][1] for i in range(len(blocks))]
    stage_sizes: List[int] = []
    for i, w in enumerate(widths):
        if i == 0 or w != widths[i - 1]:
            if w != num_filters * 2 ** len(stage_sizes):
                raise ValueError(f"block {i}: width {w} is not stage "
                                 f"{len(stage_sizes)}'s")
            stage_sizes.append(0)
        stage_sizes[-1] += 1
    model = resnet.ResNet(
        stage_sizes, getattr(resnet, kinds.pop()),
        num_classes=int(flat["params/head/kernel"].shape[1]),
        num_filters=num_filters, cifar_stem=int(stem.shape[0]) == 3)
    model.load_state_dict(resnet_state_dict_from_flax(flat, model))
    return model


def bilstm_from_variables(variables: Mapping):
    """The port's float32 ``BiLSTMTagger`` holding a flax tagger's
    variables, its sizes read from the shapes."""
    from ..convert import bilstm_state_dict_from_flax, flatten_variables
    from ..models.bilstm import BiLSTMTagger
    flat = flatten_variables(variables)
    vocab, embed = flat["params/Embed_0/embedding"].shape
    layers = sum(1 for k in flat
                 if re.match(r"^params/fwd_\d+/OptimizedLSTMCell_0/hi/bias$",
                             k))
    model = BiLSTMTagger(
        vocab, int(flat["params/head/kernel"].shape[1]), embed_dim=embed,
        hidden=int(flat["params/fwd_0/OptimizedLSTMCell_0/hi/bias"].shape[0]),
        num_layers=layers)
    model.load_state_dict(bilstm_state_dict_from_flax(flat, model))
    return model


class ModelRepo:
    """Filesystem model repository (HDFSRepo/DefaultModelRepo analogue)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def list_models(self) -> List[ModelSchema]:
        out = []
        for name in sorted(os.listdir(self.root)):
            meta = os.path.join(self.root, name, "schema.json")
            if os.path.exists(meta):
                with open(meta) as f:
                    out.append(ModelSchema.from_json(f.read()))
        return out

    def save_model(self, schema: ModelSchema,
                   payload: FlaxModelPayload) -> str:
        path = os.path.join(self.root, schema.name)
        payload.save(os.path.join(path, "checkpoint"))
        schema.uri = os.path.join(path, "checkpoint")
        with open(os.path.join(path, "schema.json"), "w") as f:
            f.write(schema.to_json())
        return path

    def save_onnx_model(self, schema: ModelSchema, model_bytes: bytes,
                        cut_layers: int = 0) -> str:
        """Register a pretrained ONNX model file (the reference repo stores
        serialized graph files + JSON schema, ``ModelDownloader.scala:26``).
        Writes the artifact directly — the graph is decoded once, at load."""
        path = os.path.join(self.root, schema.name)
        onnx_dir = os.path.join(path, "onnx")
        os.makedirs(onnx_dir, exist_ok=True)
        with open(os.path.join(onnx_dir, "model.onnx"), "wb") as f:
            f.write(model_bytes)
        with open(os.path.join(onnx_dir, "meta.json"), "w") as f:
            json.dump({"cut_layers": cut_layers, "output_names": None}, f)
        schema.uri = onnx_dir
        with open(os.path.join(path, "schema.json"), "w") as f:
            f.write(schema.to_json())
        return path

    def load_model(self, name: str):
        """The payload of ``name``, on the host: an ``OnnxModelPayload``
        for an ONNX directory, else a ``FlaxModelPayload`` from the
        checkpoint (``module.json`` when the port wrote it, else the ResNet
        or BiLSTM tagger inferred from ``variables.npz``)."""
        base = os.path.join(self.root, name)
        onnx_dir = os.path.join(base, "onnx")
        if os.path.exists(os.path.join(onnx_dir, "model.onnx")):
            from .onnx_import import OnnxModelPayload
            return OnnxModelPayload.load(onnx_dir)
        path = os.path.join(base, "checkpoint")
        if not os.path.exists(path):
            raise FileNotFoundError(f"model '{name}' not in repo {self.root}")
        if os.path.exists(os.path.join(path, "module.json")):
            return FlaxModelPayload.load(path)
        with np.load(os.path.join(path, "variables.npz"),
                     allow_pickle=False) as z:
            flat = {k: z[k] for k in z.files}
        if "params/fwd_0/OptimizedLSTMCell_0/hi/bias" in flat:
            return FlaxModelPayload(module=bilstm_from_variables(flat))
        return FlaxModelPayload(module=resnet_from_variables(flat))


class ModelDownloader:
    """Materialise named models: from the local repo when present, otherwise
    drawn from the in-tree zoo with a seeded generator (the stand-in for the
    reference's remote fetch)."""

    def __init__(self, local_cache: Optional[str] = None):
        self.repo = ModelRepo(local_cache) if local_cache else None

    def import_onnx(self, name: str, source: "bytes | str",
                    cut_layers: int = 0,
                    input_shape: Optional[List[int]] = None):
        """Register a pretrained ONNX file (path or bytes) under ``name`` —
        the user supplies the artifact, the repo caches it with its
        schema."""
        if self.repo is None:
            raise ValueError("ModelDownloader needs a local_cache to import "
                             "into")
        if isinstance(source, str):
            with open(source, "rb") as f:
                source = f.read()
        schema = ModelSchema(name=name, input_shape=input_shape,
                             model_type="onnx")
        self.repo.save_onnx_model(schema, source, cut_layers=cut_layers)
        return self.repo.load_model(name)

    def download_by_name(self, name: str, seed: int = 0,
                         device: DeviceLike = None, **model_kwargs):
        """The payload of ``name``: from the repo when it holds it, else a
        zoo model drawn from ``torch.Generator().manual_seed(seed)`` (and
        saved into the repo, when there is one).  A module payload is
        placed on ``device`` (the card unless ``"cpu"``)."""
        dev = resolve_device(device)
        if self.repo is not None:
            try:
                return _placed(self.repo.load_model(name), dev)
            except FileNotFoundError:
                pass
        zoo = _zoo()
        if name not in zoo:
            raise KeyError(f"unknown model '{name}'; zoo has {sorted(zoo)}")
        module = zoo[name](generator=torch.Generator().manual_seed(seed),
                           **model_kwargs)
        payload = FlaxModelPayload(module=module)
        if self.repo is not None:
            schema = ModelSchema(name=name, input_shape=_DEFAULT_SHAPES.get(
                name), model_type="classification")
            self.repo.save_model(schema, payload)
        return _placed(payload, dev)


def _placed(payload, dev: torch.device):
    from .onnx_import import OnnxModelPayload
    if isinstance(payload, OnnxModelPayload):
        payload.device = dev
    elif payload.module is not None:
        payload.module.to(dev)
    return payload
