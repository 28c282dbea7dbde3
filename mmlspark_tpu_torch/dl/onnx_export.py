"""ONNX export — boosters and zoo models -> serialized ModelProto bytes.  The
port of ``mmlspark_tpu/dl/onnx_export.py``, written through the port's own
wire codec (``dl/onnx_wire.py``).

Reference capability: the reference's interop surface ships models OUT as
well as in (``saveNativeModel`` for LightGBM, CNTK graph artifacts for the
DL side; ``LightGBMBooster.scala:454``, ``CNTKModel.scala:34``).  The
exporters emit standard ops — ``ai.onnx.ml`` TreeEnsemble for GBDT
boosters, Conv/BatchNormalization/Gemm/MaxPool graphs for the ResNet
family, Gemm chains for Dense stacks — so any ONNX runtime (and the port's
``dl/onnx_import``) can read them back.  For the same weights the bytes
are the JAX package's: the graphs are walked in the same order and every
initializer is the same float32 array.

- ``export_gbdt`` takes the port's ``models.gbdt.GBDTBooster``;
- ``export_mlp`` takes flax-layout Dense params (``{name: {"kernel": (in,
  out), "bias"}}``, numpy arrays or CPU tensors);
- ``export_resnet`` takes the port's ``models.resnet.ResNet`` and, by
  default, its own weights; flax-layout variables (``{"params": ...,
  "batch_stats": ...}``, as the reference takes them) may be passed
  instead.  The graph has the ImageNet stem only, so a CIFAR-stem model
  raises.

Round-trip contract (tested): ``onnx_to_jax(export_gbdt(b))(X) ==
b.raw_scores(X)`` and ``onnx_to_jax(export_resnet(model))(x_nchw) ==
model(x_nhwc)``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .onnx_wire import build_model, encode_node

ML_DOMAIN = "ai.onnx.ml"


# --------------------------------------------------------------------------
# GBDT booster -> TreeEnsembleRegressor / TreeEnsembleClassifier
# --------------------------------------------------------------------------

def _emit_tree(booster, t: int, weight_rows: List[Tuple[int, int, int, float]],
               nodes: Dict[str, list], target_id: int, bitset) -> None:
    """Flatten tree ``t``'s reachable slots into the ONNX parallel-array
    node encoding.  Sorted-subset categorical nodes (a SET left-decision,
    which ai.onnx.ml cannot express directly) expand into a BRANCH_EQ chain
    — one equality test per member code, any hit -> left."""
    sf = booster.split_feature[t]
    th = booster.threshold[t]
    lc, rc = booster.left_child[t], booster.right_child[t]
    lv = booster.leaf_value[t]
    w = float(booster.tree_weight[t])
    is_cat = booster._is_cat

    def resolve_leaf(j: int) -> int:
        # pass-through slots chase left pointers until a leaf encoding
        while j >= 0 and sf[j] < 0:
            j = int(lc[j])
        return ~j if j < 0 else ~0

    next_id = [0]

    def add_node(mode: str, feat: int, value: float, track_true: int) -> int:
        nid = next_id[0]
        next_id[0] += 1
        nodes["treeids"].append(t)
        nodes["nodeids"].append(nid)
        nodes["featureids"].append(feat)
        nodes["modes"].append(mode)
        nodes["values"].append(value)
        nodes["trueids"].append(0)      # patched by caller
        nodes["falseids"].append(0)
        nodes["track_true"].append(track_true)
        return nid

    def emit(j: int) -> int:
        """Emit the subtree rooted at slot j (or leaf ~j if j < 0); returns
        its ONNX node id."""
        if j < 0 or sf[j] < 0:
            leaf = ~j if j < 0 else resolve_leaf(j)
            nid = add_node("LEAF", 0, 0.0, 0)
            weight_rows.append((t, nid, target_id, float(lv[leaf]) * w))
            return nid
        f = int(sf[j])
        if is_cat[f] and bitset is not None and bitset[t, j].sum() != 1:
            codes = np.nonzero(bitset[t, j])[0]
            if len(codes) == 0:  # empty left set: all rows go right
                return emit(int(rc[j]))
            chain = [add_node("BRANCH_EQ", f, float(c), 0) for c in codes]
            left_id = emit(int(lc[j]))
            right_id = emit(int(rc[j]))
            for i, nid in enumerate(chain):
                pos = _pos(nodes, t, nid)
                nodes["trueids"][pos] = left_id
                nodes["falseids"][pos] = chain[i + 1] \
                    if i + 1 < len(chain) else right_id
            return chain[0]
        if is_cat[f]:
            code = float(bitset[t, j].argmax()) if bitset is not None \
                else float(th[j])
            nid = add_node("BRANCH_EQ", f, code, 0)  # NaN != code -> right
        else:
            # numeric x <= thr -> left; NaN tracks TRUE (missing routes left)
            nid = add_node("BRANCH_LEQ", f, float(th[j]), 1)
        left_id = emit(int(lc[j]))
        right_id = emit(int(rc[j]))
        pos = _pos(nodes, t, nid)
        nodes["trueids"][pos] = left_id
        nodes["falseids"][pos] = right_id
        return nid

    emit(0)


def _pos(nodes: Dict[str, list], t: int, nid: int) -> int:
    # nodes of tree t are contiguous and nid-ordered within the flat arrays
    for i in range(len(nodes["nodeids"]) - 1, -1, -1):
        if nodes["treeids"][i] == t and nodes["nodeids"][i] == nid:
            return i
    raise KeyError((t, nid))


def export_gbdt(booster, name: str = "gbdt") -> bytes:
    """GBDT booster -> ONNX TreeEnsemble model bytes.

    Regression/ranking objectives emit ``TreeEnsembleRegressor``; binary and
    multiclass emit ``TreeEnsembleClassifier`` (scores output, post_transform
    NONE — the raw margins, so consumers apply their own link exactly as
    ``raw_scores`` callers do here; binary mirrors weights into two score
    columns, column 1 = positive-class margin).  RF averaging folds
    ``1/T_c`` into the leaf weights.  Input: float tensor (N, num_features).

    Categorical caveat: categorical nodes use ``BRANCH_EQ`` with EXACT
    float equality, while the in-repo booster walk rounds first
    (``np.round(x)`` — 2.9999 scores as code 3).  Feed the exported model
    exactly-integral category codes; non-integral inputs route right here
    but left in-repo."""
    K = booster.num_class if booster.objective == "multiclass" else 1
    T = booster.num_trees
    classifier = booster.objective in ("binary", "multiclass")
    nodes: Dict[str, list] = {k: [] for k in
                              ("treeids", "nodeids", "featureids", "modes",
                               "values", "trueids", "falseids", "track_true")}
    weight_rows: List[Tuple[int, int, int, float]] = []
    for t in range(T):
        _emit_tree(booster, t, weight_rows, nodes, t % K, booster.cat_bitset)
    if booster.average_output:
        wsum = [float(booster.tree_weight[c::K].sum()) or 1.0
                for c in range(K)]
        weight_rows = [(t, n, cid, wt / wsum[cid])
                       for (t, n, cid, wt) in weight_rows]
    base = [float(booster.init_score)] * K
    if classifier and K == 1:
        # binary: mirror weights onto both declared classes ([-s, +s]
        # columns) so the scores output matches classlabels_int64s=[0,1]
        # and external ai.onnx.ml consumers (onnxruntime expands two-label
        # single-target ensembles to two columns) see the declared shape.
        # Column 1 carries the positive-class raw margin.
        weight_rows = [row for (t, n_, cid, wt) in weight_rows
                       for row in ((t, n_, 0, -wt), (t, n_, 1, wt))]
        base = [-base[0], base[0]]

    prefix = "class" if classifier else "target"
    attrs: Dict[str, Any] = {
        "nodes_treeids": nodes["treeids"], "nodes_nodeids": nodes["nodeids"],
        "nodes_featureids": nodes["featureids"],
        "nodes_modes": _strings(nodes["modes"]),
        "nodes_values": [float(v) for v in nodes["values"]],
        "nodes_truenodeids": nodes["trueids"],
        "nodes_falsenodeids": nodes["falseids"],
        "nodes_missing_value_tracks_true": nodes["track_true"],
        f"{prefix}_treeids": [r[0] for r in weight_rows],
        f"{prefix}_nodeids": [r[1] for r in weight_rows],
        f"{prefix}_ids": [r[2] for r in weight_rows],
        f"{prefix}_weights": [float(r[3]) for r in weight_rows],
        "base_values": base,
        "post_transform": "NONE",
    }
    if classifier:
        attrs["classlabels_int64s"] = list(range(max(K, 2)))
        outputs = [("label", [0]), ("scores", [0, max(K, 2)])]
        out_names = ["label", "scores"]
    else:
        attrs["n_targets"] = K
        outputs = [("scores", [0, K])]
        out_names = ["scores"]
    op = "TreeEnsembleClassifier" if classifier else "TreeEnsembleRegressor"
    node = encode_node(op, ["input"], out_names, **attrs)
    # domain field (NodeProto field 7) marks the ai.onnx.ml op
    from .onnx_wire import _str_field
    node += _str_field(7, ML_DOMAIN)
    # the IR requires an opset_import for EVERY domain a node uses —
    # onnx.checker/onnxruntime reject the model without this entry
    return build_model([node], {}, [("input", [0, booster.num_features])],
                       outputs, extra_domains=[(ML_DOMAIN, 2)])


def _strings(vals: Sequence[str]) -> list:
    return [v.encode() for v in vals]


# --------------------------------------------------------------------------
# flax Dense stacks (MLP) -> Gemm chains
# --------------------------------------------------------------------------

_ACTS = {"relu": "Relu", "tanh": "Tanh", "sigmoid": "Sigmoid",
         "leaky_relu": "LeakyRelu", None: None, "": None}


def export_mlp(params: Dict[str, Any], input_dim: int,
               activation: str = "relu", final_activation: str = "") -> bytes:
    """flax Dense-stack params -> ONNX Gemm(+activation) chain.

    ``params`` is the ``{'Dense_0': {'kernel', 'bias'}, ...}`` pytree (any
    key names; layer order = insertion order, matching flax ``nn.compact``
    tracing).  Kernels stay (in, out) — Gemm with transB=0."""
    layers = [(k, v) for k, v in params.items()
              if isinstance(v, dict) and "kernel" in v]
    if not layers:
        raise ValueError("no Dense layers found in params")
    act_op = _ACTS[activation]
    nodes: List[bytes] = []
    inits: Dict[str, np.ndarray] = {}
    cur = "input"
    for i, (lname, leaf) in enumerate(layers):
        k = np.asarray(leaf["kernel"], np.float32)
        inits[f"{lname}.w"] = k
        ins = [cur, f"{lname}.w"]
        if "bias" in leaf and leaf["bias"] is not None:
            inits[f"{lname}.b"] = np.asarray(leaf["bias"], np.float32)
            ins.append(f"{lname}.b")
        out = f"{lname}.out"
        nodes.append(encode_node("Gemm", ins, [out]))
        cur = out
        last = i == len(layers) - 1
        a = _ACTS[final_activation] if last else act_op
        if a:
            nodes.append(encode_node(a, [cur], [f"{lname}.act"]))
            cur = f"{lname}.act"
    nodes.append(encode_node("Identity", [cur], ["output"]))
    out_dim = int(np.asarray(layers[-1][1]["kernel"]).shape[1])
    return build_model(nodes, inits, [("input", [0, input_dim])],
                       [("output", [0, out_dim])])


# --------------------------------------------------------------------------
# flax ResNet -> Conv/BatchNormalization/MaxPool/Gemm graph (NCHW)
# --------------------------------------------------------------------------

class _GraphWriter:
    """Incremental node/initializer accumulator tracking the running spatial
    size, so SAME pads resolve to the exact asymmetric explicit pads flax/XLA
    would use at this input size."""

    def __init__(self, input_hw: int):
        self.nodes: List[bytes] = []
        self.inits: Dict[str, np.ndarray] = {}
        self.hw = input_hw
        self.n = 0

    def name(self, tag: str) -> str:
        self.n += 1
        return f"{tag}_{self.n}"

    def same_pads(self, k: int, s: int) -> List[int]:
        pt = max((int(np.ceil(self.hw / s)) - 1) * s + k - self.hw, 0)
        lo = pt // 2
        hi = pt - lo
        return [lo, lo, hi, hi]

    def conv(self, x: str, kernel: np.ndarray, strides: Tuple[int, int],
             pads: Optional[List[int]] = None) -> str:
        """flax HWIO kernel -> OIHW Conv node; pads=None means flax SAME."""
        k = kernel.shape[0]
        s = strides[0]
        if pads is None:
            pads = self.same_pads(k, s)
            self.hw = int(np.ceil(self.hw / s))
        else:
            self.hw = (self.hw + pads[0] + pads[2] - k) // s + 1
        w_name = self.name("w")
        self.inits[w_name] = np.ascontiguousarray(
            np.transpose(np.asarray(kernel, np.float32), (3, 2, 0, 1)))
        out = self.name("conv")
        self.nodes.append(encode_node(
            "Conv", [x, w_name], [out], strides=list(strides),
            pads=pads, kernel_shape=[k, k]))
        return out

    def bn(self, x: str, scope: Dict[str, Any], stats: Dict[str, Any]) -> str:
        names = []
        for key, arr in (("scale", scope.get("scale")),
                         ("bias", scope.get("bias")),
                         ("mean", stats["mean"]), ("var", stats["var"])):
            nm = self.name(key)
            if arr is None:
                arr = np.ones_like(np.asarray(stats["mean"])) \
                    if key == "scale" else np.zeros_like(np.asarray(stats["mean"]))
            self.inits[nm] = np.asarray(arr, np.float32).reshape(-1)
            names.append(nm)
        out = self.name("bn")
        self.nodes.append(encode_node(
            "BatchNormalization", [x] + names, [out], epsilon=1e-5))
        return out

    def op(self, op_type: str, ins: List[str], **attrs) -> str:
        out = self.name(op_type.lower())
        self.nodes.append(encode_node(op_type, ins, [out], **attrs))
        return out


def _flax_resnet_variables(model) -> Dict[str, Any]:
    """The port ResNet's weights in flax's layout (the inverse of
    ``convert.resnet_state_dict_from_flax``): OIHW -> HWIO kernels, the
    head ``(out, in)`` -> ``(in, out)``, BatchNorm ``weight``/``bias`` in
    ``params`` and ``running_mean``/``running_var`` in ``batch_stats``."""
    def a(t):
        return t.detach().to("cpu", torch.float32).numpy()

    def conv(m):
        return {"kernel": a(m.weight).transpose(2, 3, 1, 0)}

    def bn(m, params, stats, name):
        params[name] = {"scale": a(m.weight), "bias": a(m.bias)}
        stats[name] = {"mean": a(m.running_mean), "var": a(m.running_var)}

    params: Dict[str, Any] = {"conv_init": conv(model.conv_init)}
    stats: Dict[str, Any] = {}
    bn(model.bn_init, params, stats, "bn_init")
    block_name = model.block_cls.__name__
    for i, block in enumerate(model.blocks):
        scope: Dict[str, Any] = {}
        bstats: Dict[str, Any] = {}
        for k, (c, n) in enumerate(zip(block.convs, block.norms)):
            scope[f"Conv_{k}"] = conv(c)
            bn(n, scope, bstats, f"BatchNorm_{k}")
        if block.proj:
            scope["conv_proj"] = conv(block.conv_proj)
            bn(block.norm_proj, scope, bstats, "norm_proj")
        params[f"{block_name}_{i}"] = scope
        stats[f"{block_name}_{i}"] = bstats
    params["head"] = {"kernel": a(model.head.weight).T,
                      "bias": a(model.head.bias)}
    return {"params": params, "batch_stats": stats}


def export_resnet(module, variables: Optional[Dict[str, Any]] = None,
                  input_hw: int = 224, features_only: bool = False) -> bytes:
    """The port's ``models.resnet.ResNet`` -> ONNX bytes, with its own
    weights or flax-layout ``variables``.

    Walks the module's static structure (``stage_sizes`` / ``block_cls``)
    against the param tree, emitting the NCHW Conv/BN/MaxPool graph ONNX
    runtimes expect; input is fixed at ``(N, 3, input_hw, input_hw)``
    because SAME pads are resolved to explicit asymmetric pads per layer.
    ``features_only`` stops at the pooled embedding (the ImageFeaturizer
    cut, reference ``ImageFeaturizer.scala:49``)."""
    if getattr(module, "cifar_stem", False):
        raise ValueError("export_resnet writes the ImageNet stem (7x7 "
                         "stride-2 conv + max-pool); this model has the "
                         "CIFAR stem")
    if variables is None:
        variables = _flax_resnet_variables(module)
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    g = _GraphWriter(input_hw)
    x = g.conv("input", params["conv_init"]["kernel"], (2, 2),
               pads=[3, 3, 3, 3])
    x = g.bn(x, params["bn_init"], stats["bn_init"])
    x = g.op("Relu", [x])
    mp_pads = [1, 1, 1, 1]
    g.hw = (g.hw + 2 - 3) // 2 + 1
    x = g.op("MaxPool", [x], kernel_shape=[3, 3], strides=[2, 2],
             pads=mp_pads)
    block_name = module.block_cls.__name__
    bi = 0
    for i, count in enumerate(module.stage_sizes):
        for j in range(count):
            strides = (2, 2) if i > 0 and j == 0 else (1, 1)
            scope = params[f"{block_name}_{bi}"]
            bstats = stats[f"{block_name}_{bi}"]
            x = _export_block(g, x, scope, bstats, strides,
                              bottleneck=block_name == "BottleneckBlock")
            bi += 1
    x = g.op("GlobalAveragePool", [x])
    x = g.op("Flatten", [x], axis=1)
    if not features_only:
        g.inits["head.w"] = np.asarray(params["head"]["kernel"], np.float32)
        g.inits["head.b"] = np.asarray(params["head"]["bias"], np.float32)
        x = g.op("Gemm", [x, "head.w", "head.b"])
    g.nodes.append(encode_node("Identity", [x], ["output"]))
    return build_model(g.nodes, g.inits,
                       [("input", [0, 3, input_hw, input_hw])],
                       [("output", [0, 0])])


def _export_block(g: _GraphWriter, x: str, scope, bstats, strides,
                  bottleneck: bool) -> str:
    residual = x
    hw_in = g.hw
    if bottleneck:
        y = g.conv(x, scope["Conv_0"]["kernel"], (1, 1))
        y = g.bn(y, scope["BatchNorm_0"], bstats["BatchNorm_0"])
        y = g.op("Relu", [y])
        y = g.conv(y, scope["Conv_1"]["kernel"], strides)
        y = g.bn(y, scope["BatchNorm_1"], bstats["BatchNorm_1"])
        y = g.op("Relu", [y])
        y = g.conv(y, scope["Conv_2"]["kernel"], (1, 1))
        y = g.bn(y, scope["BatchNorm_2"], bstats["BatchNorm_2"])
    else:
        y = g.conv(x, scope["Conv_0"]["kernel"], strides)
        y = g.bn(y, scope["BatchNorm_0"], bstats["BatchNorm_0"])
        y = g.op("Relu", [y])
        y = g.conv(y, scope["Conv_1"]["kernel"], (1, 1))
        y = g.bn(y, scope["BatchNorm_1"], bstats["BatchNorm_1"])
    if "conv_proj" in scope:
        hw_out = g.hw
        g.hw = hw_in
        residual = g.conv(residual, scope["conv_proj"]["kernel"], strides)
        residual = g.bn(residual, scope["norm_proj"], bstats["norm_proj"])
        assert g.hw == hw_out
    out = g.op("Add", [residual, y])
    return g.op("Relu", [out])
