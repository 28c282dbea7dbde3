"""Carry state from the JAX package into the port — as plain data (dicts
and numpy arrays), so this module imports nothing of ``mmlspark_tpu``.

- ``params_from_jax`` — a ``GBDTParams`` field dict
  (``dataclasses.asdict`` of the JAX dataclass) -> the port's dataclass;
- ``booster_from_arrays`` — a JAX booster's ``_ARRAYS`` + ``_META``
  -> the port's ``GBDTBooster`` (``GBDTBooster.from_string`` also reads the
  JAX package's ``to_string`` output unchanged);
- ``bin_mapper_from_edges`` — fitted bin edges -> the port's ``BinMapper``;
- ``resnet_state_dict_from_flax`` — a flax ResNet's variables (the nested
  dict, or the flat ``"params/BasicBlock_0/Conv_0/kernel"`` keys of a
  ``variables.npz``) -> the ``state_dict`` of ``models.resnet.ResNet``;
- ``transformer_state_dict_from_flax`` / ``bilstm_state_dict_from_flax``
  — a flax ``TransformerEncoder``'s / ``BiLSTMTagger``'s variables -> the
  ``state_dict`` of ``models.transformer.TransformerEncoder`` /
  ``models.bilstm.BiLSTMTagger`` (``lstm_weights_from_flax`` maps one
  ``OptimizedLSTMCell``);
- ``streaming_encoder_state_dict_from_flax`` — the streaming speech
  recognizer's flax encoder variables -> the ``state_dict`` of
  ``cognitive.speech.StreamingEncoder``.

The featurization, Word2Vec, tuning, isolation-forest, KNN and SAR models
need nothing here: a directory the JAX package saved loads through
``core.serialize.load`` as the port's twin.  Their state is params
(``FeaturizeModel``'s plan, Word2Vec's vocabulary and vectors, SAR's
affinity, similarity and seen arrays, as JSON or ``.npy``), nested stages
(``TrainClassifier``'s, ``TuneHyperparametersModel``'s, ``BestModel``'s
and an explainer's inner models) or pickled payloads (the ``_Forest``, the
ball trees and ``AccessAnomalyModel``'s per-tenant factors), which
``utils.pickling`` unpickles as the port's classes.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from .lightgbm.binning import BinMapper
from .lightgbm.core import GBDTParams
from .models.gbdt import GBDTBooster


def params_from_jax(fields: Dict) -> GBDTParams:
    """Map a JAX ``GBDTParams`` field dict to the port's dataclass; a field
    the port does not know raises, so nothing is dropped silently."""
    known = {f.name for f in dataclasses.fields(GBDTParams)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"GBDTParams fields not in the port: {unknown}")
    return GBDTParams(**fields)


def booster_from_arrays(arrays: Dict[str, np.ndarray],
                        meta: Dict) -> GBDTBooster:
    """The port's booster from the JAX booster's arrays
    (``GBDTBooster._ARRAYS`` / ``_OPT_ARRAYS``) and meta
    (``GBDTBooster._META``)."""
    return GBDTBooster(**{k: np.asarray(v) for k, v in arrays.items()},
                       **meta)


def bin_mapper_from_edges(edges: np.ndarray, max_bin: int,
                          categorical_features: Optional[Sequence[int]]
                          = None) -> BinMapper:
    """A fitted ``BinMapper`` holding the given ``(F, max_bin - 1)`` edges."""
    edges = np.asarray(edges, np.float32)
    if edges.ndim != 2 or edges.shape[1] != max_bin - 1:
        raise ValueError(f"edges must be (F, {max_bin - 1}), got "
                         f"{edges.shape}")
    mapper = BinMapper(max_bin, categorical_features=categorical_features)
    mapper.edges = edges.copy()
    return mapper


_BLOCK = re.compile(r"^(?:BasicBlock|BottleneckBlock)_(\d+)$")
_LAYER = re.compile(r"^(Conv|BatchNorm)_(\d+)$")
_BN_LEAF = {("params", "scale"): "weight", ("params", "bias"): "bias",
            ("batch_stats", "mean"): "running_mean",
            ("batch_stats", "var"): "running_var"}


def flatten_variables(variables: Mapping, sep: str = "/"
                      ) -> Dict[str, np.ndarray]:
    """``{"params": {"a": {"kernel": x}}}`` -> ``{"params/a/kernel": x}``;
    keys already flat pass through."""
    flat: Dict[str, np.ndarray] = {}

    def walk(prefix, node):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(f"{prefix}{sep}{k}" if prefix else str(k), v)
        else:
            flat[prefix] = np.asarray(node)

    walk("", variables)
    return flat


def _resnet_name(collection: str, path: Sequence[str]) -> str:
    """The port's state_dict name of one flax leaf, or KeyError."""
    *mods, leaf = path
    if collection == "params" and mods == ["head"] \
            and leaf in ("kernel", "bias"):
        return "head." + ("weight" if leaf == "kernel" else "bias")
    if mods == ["conv_init"] and (collection, leaf) == ("params", "kernel"):
        return "conv_init.weight"
    if len(mods) == 1 and mods[0] == "bn_init" \
            and (collection, leaf) in _BN_LEAF:
        return "bn_init." + _BN_LEAF[collection, leaf]
    if len(mods) == 2 and _BLOCK.match(mods[0]):
        block = f"blocks.{_BLOCK.match(mods[0]).group(1)}."
        layer, m = mods[1], _LAYER.match(mods[1])
        if (collection, leaf) == ("params", "kernel"):
            if m and m.group(1) == "Conv":
                return f"{block}convs.{m.group(2)}.weight"
            if layer == "conv_proj":
                return block + "conv_proj.weight"
        elif (collection, leaf) in _BN_LEAF:
            if m and m.group(1) == "BatchNorm":
                return f"{block}norms.{m.group(2)}.{_BN_LEAF[collection, leaf]}"
            if layer == "norm_proj":
                return f"{block}norm_proj.{_BN_LEAF[collection, leaf]}"
    raise KeyError("/".join([collection, *path]))


def resnet_state_dict_from_flax(variables: Mapping,
                                model: Optional[torch.nn.Module] = None
                                ) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of ``models.resnet.ResNet`` holding a flax
    ResNet's weights (``mmlspark_tpu/models/resnet.py``).

    Conv kernels HWIO -> OIHW; the Dense head ``(in, out)`` -> ``(out,
    in)``; BatchNorm ``params/scale``, ``params/bias``,
    ``batch_stats/mean``, ``batch_stats/var`` -> ``weight``, ``bias``,
    ``running_mean``, ``running_var``; flax's auto names
    (``BasicBlock_i`` / ``BottleneckBlock_i`` numbered across stages,
    ``Conv_k``, ``BatchNorm_k``, ``conv_proj``, ``norm_proj``, ``conv_init``,
    ``bn_init``, ``head``) -> ``blocks.i.convs.k``, ``blocks.i.norms.k``
    and the same names.  A flax key that names nothing of the port raises
    ``KeyError``; with ``model`` given, a name or shape of its
    ``state_dict`` left unfilled, or filled with another shape, raises
    ``ValueError``.  Arrays come out float32 on the CPU
    (``load_state_dict`` casts them to the model's dtype)."""
    out: Dict[str, torch.Tensor] = {}
    for key, arr in flatten_variables(variables).items():
        collection, *path = key.split("/")
        name = _resnet_name(collection, path)
        a = np.asarray(arr, np.float32)
        if name.endswith("weight") and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif name == "head.weight":
            a = a.T
        out[name] = _tensor(a)
    return _check_fits(out, model)


def _check_fits(out: Dict[str, torch.Tensor],
                model: Optional[torch.nn.Module]) -> Dict[str, torch.Tensor]:
    """``out`` unchanged, after checking (with ``model`` given) that it
    fills every name of the model's ``state_dict`` with its shape."""
    if model is not None:
        want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        got = {k: tuple(v.shape) for k, v in out.items()}
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        wrong = sorted(k for k in set(want) & set(got) if want[k] != got[k])
        if missing or extra or wrong:
            raise ValueError(f"flax variables do not fit the model: missing "
                             f"{missing}, unexpected {extra}, shape differs "
                             f"{[(k, got[k], want[k]) for k in wrong]}")
    return out


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))


_TF_BLOCK = {"LayerNorm_0": "ln1", "LayerNorm_1": "ln2",
             "MultiHeadAttention_0/qkv": "attn.qkv",
             "MultiHeadAttention_0/proj": "attn.proj",
             "Dense_0": "dense1", "Dense_1": "dense2"}
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def transformer_state_dict_from_flax(variables: Mapping,
                                     model: Optional[torch.nn.Module] = None
                                     ) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of ``models.transformer.TransformerEncoder``
    holding a flax ``TransformerEncoder``'s weights
    (``mmlspark_tpu/models/transformer.py``).

    ``Embed_0/embedding`` -> ``embed.weight``; ``pos_embed`` as it is;
    ``block_i/{LayerNorm_0, MultiHeadAttention_0/qkv,
    MultiHeadAttention_0/proj, LayerNorm_1, Dense_0, Dense_1}`` ->
    ``blocks.i.{ln1, attn.qkv, attn.proj, ln2, dense1, dense2}``; the
    final ``LayerNorm_0`` -> ``ln_f``; ``head``.  Dense kernels ``(in,
    out)`` -> ``(out, in)`` (the ``qkv`` output axis keeps its ``(3, H,
    D)`` layout), LayerNorm ``scale`` -> ``weight``.  A key that names
    nothing of the port raises ``KeyError``; ``model`` given, a missing or
    misshapen name raises ``ValueError``.  Arrays come out float32 on the
    CPU."""
    out: Dict[str, torch.Tensor] = {}
    for key, arr in flatten_variables(variables).items():
        collection, *path = key.split("/")
        if collection != "params":
            raise KeyError(key)
        *mods, leaf = path
        scope = "/".join(mods)
        if mods == ["Embed_0"] and leaf == "embedding":
            name = "embed.weight"
        elif mods == [] and leaf == "pos_embed":
            name = "pos_embed"
        elif scope in ("LayerNorm_0", "head") and leaf in _LEAF:
            name = ("ln_f" if scope == "LayerNorm_0" else "head") + "." + \
                _LEAF[leaf]
        elif mods and mods[0].startswith("block_") and \
                "/".join(mods[1:]) in _TF_BLOCK and leaf in _LEAF:
            i = int(mods[0][len("block_"):])
            name = f"blocks.{i}.{_TF_BLOCK['/'.join(mods[1:])]}.{_LEAF[leaf]}"
        else:
            raise KeyError(key)
        a = np.asarray(arr, np.float32)
        out[name] = _tensor(a.T if leaf == "kernel" else a)
    return _check_fits(out, model)


def moe_state_dict_from_flax(variables: Mapping,
                             model: Optional[torch.nn.Module] = None
                             ) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of ``parallel.moe.MoELayer`` holding a flax
    ``MoELayer``'s weights (``mmlspark_tpu/parallel/moe.py``):
    ``gate/kernel`` ``(d, E)`` -> ``gate.weight`` ``(E, d)``,
    ``gate/bias``, and the expert stacks ``w_in`` ``(E, d, H)`` /
    ``w_out`` ``(E, H, d)`` as they are; the sown ``losses`` collection
    (``init``'s output, not weights) is skipped.  A key that names nothing
    of the port raises ``KeyError``; ``model`` given, a missing or
    misshapen name raises ``ValueError``.  Arrays come out float32 on the
    CPU."""
    names = {"params/gate/kernel": "gate.weight",
             "params/gate/bias": "gate.bias",
             "params/w_in": "w_in", "params/w_out": "w_out"}
    out: Dict[str, torch.Tensor] = {}
    for key, arr in flatten_variables(variables).items():
        if key.startswith("losses/"):
            continue
        if key not in names:
            raise KeyError(key)
        a = np.asarray(arr, np.float32)
        out[names[key]] = _tensor(a.T if key.endswith("kernel") else a)
    return _check_fits(out, model)


_GATES = ("i", "f", "g", "o")


def lstm_weights_from_flax(cell: Mapping) -> Dict[str, torch.Tensor]:
    """One flax ``OptimizedLSTMCell``'s params (``ii``..``io`` input
    kernels, ``hi``..``ho`` hidden kernels and biases) -> torch's
    ``weight_ih`` ``(4H, in)``, ``weight_hh`` ``(4H, H)``, ``bias_ih``
    (zeros) and ``bias_hh``, gates in the order i, f, g, o."""
    w_ih = np.concatenate([np.asarray(cell["i" + g]["kernel"], np.float32)
                           for g in _GATES], axis=-1).T
    w_hh = np.concatenate([np.asarray(cell["h" + g]["kernel"], np.float32)
                           for g in _GATES], axis=-1).T
    b_hh = np.concatenate([np.asarray(cell["h" + g]["bias"], np.float32)
                           for g in _GATES])
    return {"weight_ih": _tensor(w_ih), "weight_hh": _tensor(w_hh),
            "bias_ih": torch.zeros(b_hh.shape), "bias_hh": _tensor(b_hh)}


def _nested(variables: Mapping) -> Dict:
    """Flat ``a/b/c`` keys (or a nested dict) -> a nested dict."""
    tree: Dict = {}
    for key, arr in flatten_variables(variables).items():
        node = tree
        *mods, leaf = key.split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = arr
    return tree


def bilstm_state_dict_from_flax(variables: Mapping,
                                model: Optional[torch.nn.Module] = None
                                ) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of ``models.bilstm.BiLSTMTagger`` holding a flax
    ``BiLSTMTagger``'s weights (``mmlspark_tpu/models/bilstm.py``).

    ``Embed_0/embedding`` -> ``embed.weight``; ``fwd_i`` / ``bwd_i``
    (each an ``OptimizedLSTMCell_0``) -> ``lstm.*_l{i}`` /
    ``lstm.*_l{i}_reverse`` by ``lstm_weights_from_flax``; ``head``.  A
    scope that names nothing of the port raises ``KeyError``; ``model``
    given, a missing or misshapen name raises ``ValueError``."""
    params = _nested(variables)
    if set(params) != {"params"}:
        raise KeyError(f"not a params tree: {sorted(params)}")
    out: Dict[str, torch.Tensor] = {}
    for scope, sub in params["params"].items():
        m = re.match(r"^(fwd|bwd)_(\d+)$", scope)
        if scope == "Embed_0":
            out["embed.weight"] = _tensor(sub["embedding"])
        elif scope == "head":
            out["head.weight"] = _tensor(np.asarray(sub["kernel"]).T)
            out["head.bias"] = _tensor(sub["bias"])
        elif m and set(sub) == {"OptimizedLSTMCell_0"}:
            sfx = f"_l{m.group(2)}" + ("_reverse" if m.group(1) == "bwd"
                                       else "")
            for k, v in lstm_weights_from_flax(
                    sub["OptimizedLSTMCell_0"]).items():
                out[f"lstm.{k}{sfx}"] = v
        else:
            raise KeyError(f"params/{scope}")
    return _check_fits(out, model)


def streaming_encoder_state_dict_from_flax(
        variables: Mapping, model: Optional[torch.nn.Module] = None
) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of ``cognitive.speech.StreamingEncoder`` holding
    the JAX package's streaming encoder's weights
    (``mmlspark_tpu/cognitive/speech.py::streaming_encoder``).

    ``lstm_{i}`` (a scanned ``OptimizedLSTMCell``) -> ``lstm.*_l{i}`` by
    ``lstm_weights_from_flax``; ``head`` -> ``head.weight`` (the kernel
    transposed) and ``head.bias``.  A scope that names nothing of the port
    raises ``KeyError``; ``model`` given, a missing or misshapen name raises
    ``ValueError``."""
    params = _nested(variables)
    if set(params) != {"params"}:
        raise KeyError(f"not a params tree: {sorted(params)}")
    out: Dict[str, torch.Tensor] = {}
    for scope, sub in params["params"].items():
        m = re.match(r"^lstm_(\d+)$", scope)
        if scope == "head":
            out["head.weight"] = _tensor(np.asarray(sub["kernel"]).T)
            out["head.bias"] = _tensor(sub["bias"])
        elif m:
            for k, v in lstm_weights_from_flax(sub).items():
                out[f"lstm.{k}_l{m.group(1)}"] = v
        else:
            raise KeyError(f"params/{scope}")
    return _check_fits(out, model)
