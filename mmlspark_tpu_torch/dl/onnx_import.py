"""ONNX graph import — serialized model files -> torch apply functions.  The
port of ``mmlspark_tpu/dl/onnx_import.py``.

Reference capability: ``CNTKModel`` evaluates externally-trained serialized
graphs on executors (``deep-learning/.../cntk/CNTKModel.scala:88-140``) and
``ImageFeaturizer`` runs *pretrained* zoo models (``ImageFeaturizer.scala:41``,
``downloader/ModelDownloader.scala:26``).  ``onnx_to_jax`` (the reference's
name, kept) decodes a ModelProto with the dependency-free wire codec in
``onnx_wire`` and builds ``apply_fn(variables, *inputs)`` whose ops run as
torch ops on the inputs' device, in the graph's native layout (NCHW for
vision models).

Supported op set, as in the reference: Conv, BatchNormalization, Gemm,
MatMul, LSTM (uni/bidirectional), MaxPool, AveragePool, GlobalAveragePool,
Relu/LeakyRelu/Sigmoid/Tanh/Softmax/Erf, elementwise arithmetic, Clip,
Concat, Flatten, Reshape, Transpose, Squeeze/Unsqueeze, Pad, Slice, Gather,
Shape, Cast, Constant, ConstantOfShape, ReduceMean, Dropout/Identity
(inference no-ops), and the ai.onnx.ml TreeEnsemble regressor/classifier.

Shape machinery (Shape -> Gather -> Concat -> Reshape chains emitted by
exporters) is evaluated on the HOST with numpy, as the reference folds it
to constants under ``jit``; integer initializers stay host constants.
Float32 convolutions and products run with TF32 off on the card
(``_device.float32_exact``), as float32.
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._device import DeviceLike, float32_exact, resolve_device
from .onnx_wire import DTYPES, Node, parse_model

_HOST_OPS = {"Shape", "Constant", "ConstantOfShape", "Range"}
_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64,
                 np.dtype(np.float16): torch.float16,
                 np.dtype(np.int64): torch.int64,
                 np.dtype(np.int32): torch.int32,
                 np.dtype(np.int16): torch.int16,
                 np.dtype(np.int8): torch.int8,
                 np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.bool_): torch.bool}


def _is_host(*vals) -> bool:
    return all(isinstance(v, (np.ndarray, np.generic, int, float)) or v is None
               for v in vals)


def _auto_pads(in_spatial, kernel, strides, mode: str):
    """SAME_UPPER / SAME_LOWER explicit pads from the input's dims."""
    pads = []
    for n, k, s in zip(in_spatial, kernel, strides):
        pt = max((int(np.ceil(n / s)) - 1) * s + k - n, 0)
        small, big = pt // 2, pt - pt // 2
        pads.append((small, big) if mode == "SAME_UPPER" else (big, small))
    return pads


def _pool_dims(node: Node, x_shape):
    """(kernel, strides, per-dim (low, high) pads, ceil extension)."""
    k = node.attr_ints("kernel_shape")
    s = node.attr_ints("strides", [1] * len(k))
    auto = node.attr_s("auto_pad", "NOTSET")
    if auto in ("SAME_UPPER", "SAME_LOWER"):
        pads = _auto_pads(x_shape[2:], k, s, auto)
    elif auto == "VALID":
        pads = [(0, 0)] * len(k)
    else:
        p = node.attr_ints("pads", [0] * (2 * len(k)))
        half = len(p) // 2
        pads = list(zip(p[:half], p[half:]))
    extra = [0] * len(k)
    if node.attr_i("ceil_mode"):
        # ceil output: extend the trailing pad so floor arithmetic lands on
        # ceil((n + pl + pr - k)/s) + 1 windows; the extension is padding
        # with the reduction's identity, and AveragePool's
        # count_include_pad divisor counts declared pads but NOT it
        extra = [_ceil_extra(n, pl, pr, kk, ss)
                 for (pl, pr), n, kk, ss in zip(pads, x_shape[2:], k, s)]
        pads = [(pl, pr + e) for (pl, pr), e in zip(pads, extra)]
    return list(k), list(s), pads, extra


def _ceil_extra(n: int, pl: int, pr: int, k: int, s: int) -> int:
    span = n + pl + pr - k
    out_ceil = -(-span // s) + 1
    # ONNX: the last window must start inside the real+explicit-pad region
    if (out_ceil - 1) * s >= n + pl:
        out_ceil -= 1
    return max(0, (out_ceil - 1) * s + k - (n + pl + pr))


def _torch_pad(pads) -> List[int]:
    """Per-dim (low, high) pairs, first spatial dim first -> ``F.pad``'s
    last-dim-first list."""
    out: List[int] = []
    for lo, hi in reversed(pads):
        out += [int(lo), int(hi)]
    return out


def _sum_pool(x: torch.Tensor, k, s) -> torch.Tensor:
    """Window sums over the trailing spatial dims, no padding."""
    pool = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}[len(k)]
    return pool(x, k, s) * float(np.prod(k))


def _max_pool(x: torch.Tensor, k, s) -> torch.Tensor:
    pool = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[len(k)]
    return pool(x, k, s)


class _Eval:
    """Turns a node's inputs into torch tensors on one device."""

    def __init__(self, device: torch.device):
        self.device = device

    def t(self, v) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v
        a = np.asarray(v)
        if not a.flags.writeable:      # views of the parsed model's bytes
            a = a.copy()
        return torch.as_tensor(a, dtype=_TORCH_DTYPES.get(a.dtype),
                               device=self.device)


def _eval_node(node: Node, env: Dict[str, Any], ev: _Eval):
    op = node.op_type
    ins = [env[n] if n else None for n in node.inputs]
    host = op in _HOST_OPS or (_is_host(*ins) and op in (
        "Gather", "Concat", "Unsqueeze", "Squeeze", "Slice", "Cast", "Add",
        "Sub", "Mul", "Div", "Reshape", "Transpose", "Identity"))
    x = ins[0] if ins else None
    t = ev.t

    if op in ("Identity", "Dropout"):
        return x
    if op == "Constant":
        a = node.attrs.get("value")
        if a is not None and a.t is not None:
            return a.t
        if "value_float" in node.attrs:
            return np.float32(node.attrs["value_float"].f)
        if "value_int" in node.attrs:
            return np.int64(node.attrs["value_int"].i)
        if "value_floats" in node.attrs:
            return np.asarray(node.attrs["value_floats"].floats, np.float32)
        if "value_ints" in node.attrs:
            return np.asarray(node.attrs["value_ints"].ints, np.int64)
        raise NotImplementedError("Constant without tensor value")
    if op == "Shape":
        return np.asarray(tuple(x.shape), np.int64)
    if op == "ConstantOfShape":
        a = node.attrs.get("value")
        fill = a.t.reshape(-1)[0] if a is not None and a.t is not None \
            else np.float32(0)
        return np.full(tuple(int(d) for d in np.asarray(x).reshape(-1)), fill)
    if op == "Cast":
        dt = np.dtype(DTYPES[node.attr_i("to", 1)])
        if host:
            return np.asarray(x).astype(dt)
        return t(x).to(_TORCH_DTYPES[dt])
    if host:
        return _eval_host(op, node, ins, x)
    if op == "Conv":
        x, w = t(x), t(ins[1])
        group = node.attr_i("group", 1)
        spatial = w.ndim - 2
        s = node.attr_ints("strides", [1] * spatial)
        d = node.attr_ints("dilations", [1] * spatial)
        p = node.attr_ints("pads", [0] * (2 * spatial))
        auto = node.attr_s("auto_pad", "NOTSET")
        if auto in ("SAME_UPPER", "SAME_LOWER"):
            ksz = [(w.shape[2 + i] - 1) * d[i] + 1 for i in range(spatial)]
            pads = _auto_pads(x.shape[2:], ksz, s, auto)
        elif auto in ("NOTSET", "", "VALID"):
            pads = list(zip(p[:spatial], p[spatial:])) \
                if auto != "VALID" else [(0, 0)] * spatial
        else:
            raise NotImplementedError(f"Conv auto_pad {auto}")
        conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[spatial]
        bias = t(ins[2]) if len(ins) > 2 and ins[2] is not None else None
        if all(lo == hi for lo, hi in pads):
            return conv(x, w, bias, stride=s, padding=[lo for lo, _ in pads],
                        dilation=d, groups=group)
        return conv(F.pad(x, _torch_pad(pads)), w, bias, stride=s,
                    dilation=d, groups=group)
    if op == "BatchNormalization":
        x = t(x)
        scale, bias, mean, var = (t(v) for v in ins[1:5])
        eps = node.attr_f("epsilon", 1e-5)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        inv = scale / torch.sqrt(var + eps)
        return x * inv.reshape(shape) + (bias - mean * inv).reshape(shape)
    if op == "Gemm":
        a, b = t(x), t(ins[1])
        if node.attr_i("transA"):
            a = a.T
        if node.attr_i("transB"):
            b = b.T
        out = node.attr_f("alpha", 1.0) * (a @ b)
        if len(ins) > 2 and ins[2] is not None:
            out = out + node.attr_f("beta", 1.0) * t(ins[2])
        return out
    if op == "MatMul":
        return t(x) @ t(ins[1])
    unary = {"Relu": F.relu, "Sigmoid": torch.sigmoid, "Tanh": torch.tanh,
             "Erf": torch.erf, "Exp": torch.exp, "Sqrt": torch.sqrt,
             "Reciprocal": torch.reciprocal, "Neg": torch.neg,
             "Abs": torch.abs}
    if op in unary:
        return unary[op](t(x))
    if op == "LeakyRelu":
        return F.leaky_relu(t(x), node.attr_f("alpha", 0.01))
    if op == "Softmax":
        return torch.softmax(t(x), dim=node.attr_i("axis", -1))
    if op == "Pow":
        return t(x) ** t(ins[1])
    if op in ("Add", "Sub", "Mul", "Div"):
        a, b = t(x), t(ins[1])
        return {"Add": torch.add, "Sub": torch.sub, "Mul": torch.mul,
                "Div": torch.true_divide}[op](a, b)
    if op == "Clip":
        lo = ins[1] if len(ins) > 1 and ins[1] is not None \
            else node.attrs.get("min")
        hi = ins[2] if len(ins) > 2 and ins[2] is not None \
            else node.attrs.get("max")
        lo = lo.f if hasattr(lo, "f") else lo
        hi = hi.f if hasattr(hi, "f") else hi
        return torch.clamp(t(x), None if lo is None else float(lo),
                           None if hi is None else float(hi))
    if op in ("MaxPool", "AveragePool"):
        return _pool(op, node, t(x))
    if op == "GlobalAveragePool":
        x = t(x)
        return x.mean(dim=tuple(range(2, x.ndim)), keepdim=True)
    if op == "Flatten":
        x = t(x)
        ax = node.attr_i("axis", 1)
        lead = int(np.prod(x.shape[:ax])) if ax else 1
        return x.reshape(lead, -1)
    if op == "Reshape":
        x = t(x)
        target = [int(d) for d in np.asarray(ins[1]).reshape(-1)]
        target = [x.shape[i] if d == 0 else d for i, d in enumerate(target)]
        return x.reshape(target)
    if op == "Transpose":
        x = t(x)
        perm = node.attr_ints("perm", list(range(x.ndim))[::-1])
        return x.permute(perm)
    if op == "Concat":
        return torch.cat([t(v) for v in ins if v is not None],
                         dim=node.attr_i("axis"))
    if op in ("Squeeze", "Unsqueeze"):
        x = t(x)
        axes = _axes(node, ins)
        if op == "Squeeze":
            if not axes:
                return x.squeeze()
            return x.squeeze(tuple(a % x.ndim for a in axes))
        for ax in sorted(axes):
            x = x.unsqueeze(ax)
        return x
    if op == "Gather":
        x = t(x)
        idx = t(ins[1]).long()
        ax = node.attr_i("axis", 0) % x.ndim
        idx = torch.where(idx < 0, idx + x.shape[ax], idx)
        out = torch.index_select(x, ax, idx.reshape(-1))
        return out.reshape(x.shape[:ax] + idx.shape + x.shape[ax + 1:])
    if op == "Slice":
        x = t(x)
        for ax, sl in enumerate(_slices(node, ins, x.ndim)):
            if sl.step is not None and sl.step < 0:   # torch slices step > 0
                idx = torch.arange(*sl.indices(x.shape[ax]), device=x.device)
                x = torch.index_select(x, ax, idx)
            elif sl != slice(None):
                x = x[(slice(None),) * ax + (sl,)]
        return x
    if op == "Pad":
        mode = node.attr_s("mode", "constant")
        if mode != "constant":
            raise NotImplementedError(f"Pad mode {mode}")
        if len(ins) > 1 and ins[1] is not None:
            p = [int(v) for v in np.asarray(ins[1]).reshape(-1)]
            cval = float(np.asarray(ins[2]).reshape(-1)[0]) \
                if len(ins) > 2 and ins[2] is not None else 0.0
        else:
            p = node.attr_ints("pads")
            cval = node.attr_f("value", 0.0)
        half = len(p) // 2
        return F.pad(t(x), _torch_pad(list(zip(p[:half], p[half:]))),
                     value=cval)
    if op == "ReduceMean":
        x = t(x)
        axes = node.attr_ints("axes") or (
            [int(d) for d in np.asarray(ins[1]).reshape(-1)]
            if len(ins) > 1 and ins[1] is not None else None)
        keep = bool(node.attr_i("keepdims", 1))
        return x.mean(dim=tuple(axes) if axes else tuple(range(x.ndim)),
                      keepdim=keep)
    if op == "LSTM":
        return _lstm(node, [t(v) if v is not None else None for v in ins])
    if op in ("TreeEnsembleRegressor", "TreeEnsembleClassifier"):
        return _tree_ensemble(node, t(x))
    raise NotImplementedError(f"ONNX op {op} not supported "
                              f"(node {node.name or node.outputs})")


def _axes(node: Node, ins) -> List[int]:
    return node.attr_ints("axes") or (
        [int(d) for d in np.asarray(ins[1]).reshape(-1)]
        if len(ins) > 1 else [])


def _slices(node: Node, ins, ndim: int):
    if len(ins) > 1:  # opset 10+: tensors
        starts = [int(v) for v in np.asarray(ins[1]).reshape(-1)]
        ends = [int(v) for v in np.asarray(ins[2]).reshape(-1)]
        axes = ([int(v) for v in np.asarray(ins[3]).reshape(-1)]
                if len(ins) > 3 and ins[3] is not None
                else list(range(len(starts))))
        steps = ([int(v) for v in np.asarray(ins[4]).reshape(-1)]
                 if len(ins) > 4 and ins[4] is not None
                 else [1] * len(starts))
    else:
        starts = node.attr_ints("starts")
        ends = node.attr_ints("ends")
        axes = node.attr_ints("axes", list(range(len(starts))))
        steps = [1] * len(starts)
    sl = [slice(None)] * ndim
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        sl[ax] = slice(st, None if en >= 2 ** 31 - 1 else en, sp)
    return tuple(sl)


def _eval_host(op: str, node: Node, ins, x):
    """The shape-machinery ops on host constants, in numpy."""
    if op == "Identity":
        return x
    if op in ("Add", "Sub", "Mul", "Div"):
        b = ins[1]
        return {"Add": lambda: x + b, "Sub": lambda: x - b,
                "Mul": lambda: x * b, "Div": lambda: x / b}[op]()
    if op == "Reshape":
        target = [int(d) for d in np.asarray(ins[1]).reshape(-1)]
        target = [x.shape[i] if d == 0 else d for i, d in enumerate(target)]
        return np.reshape(x, target)
    if op == "Transpose":
        x = np.asarray(x)
        return np.transpose(x, node.attr_ints("perm",
                                              list(range(x.ndim))[::-1]))
    if op == "Concat":
        return np.concatenate([v for v in ins if v is not None],
                              axis=node.attr_i("axis"))
    if op == "Squeeze":
        axes = _axes(node, ins)
        return np.squeeze(x, axis=tuple(axes) if axes else None)
    if op == "Unsqueeze":
        for ax in sorted(_axes(node, ins)):
            x = np.expand_dims(x, ax)
        return x
    if op == "Gather":
        return np.take(x, np.asarray(ins[1]), axis=node.attr_i("axis", 0))
    if op == "Slice":
        x = np.asarray(x)
        return x[_slices(node, ins, x.ndim)]
    raise NotImplementedError(f"ONNX op {op} on host constants")


def _pool(op: str, node: Node, x: torch.Tensor) -> torch.Tensor:
    k, s, pads, ceil_extra = _pool_dims(node, x.shape)
    if op == "MaxPool":
        xp = F.pad(x, _torch_pad(pads), value=float("-inf"))
        return _max_pool(xp, k, s)
    summed = _sum_pool(F.pad(x, _torch_pad(pads)), k, s)
    spatial = tuple(x.shape[2:])
    if node.attr_i("count_include_pad"):
        if any(ceil_extra):
            # the divisor counts real + declared-pad cells only: a ones
            # array padded with 1 over the declared pads, 0 over the ceil
            # extension
            ones = torch.ones((1, 1) + spatial, dtype=x.dtype,
                              device=x.device)
            decl = [(pl, pr - e) for (pl, pr), e in zip(pads, ceil_extra)]
            ones = F.pad(ones, _torch_pad(decl), value=1.0)
            ext = [(0, e) for e in ceil_extra]
            denom = _sum_pool(F.pad(ones, _torch_pad(ext)), k, s)
        else:
            denom = float(np.prod(k))
    else:  # divide by the number of REAL elements under each window
        ones = torch.ones((1, 1) + spatial, dtype=x.dtype, device=x.device)
        denom = _sum_pool(F.pad(ones, _torch_pad(pads)), k, s)
    return summed / denom


def _tree_ensemble(node: Node, X: torch.Tensor):
    """ai.onnx.ml TreeEnsemble{Regressor,Classifier} — the parallel-array
    tree walk as a fixed-depth vectorized gather chase.  Supports
    BRANCH_LEQ / BRANCH_EQ / LEAF (the modes ``onnx_export.export_gbdt``
    emits); BRANCH_EQ compares exactly.  Classifier returns (label,
    scores-raw) with post_transform NONE."""
    a = node.attrs
    pt = node.attr_s("post_transform", "NONE")
    if pt not in ("", "NONE"):
        raise NotImplementedError(
            f"TreeEnsemble post_transform {pt!r}: raw margins only — apply "
            f"the link downstream (export_gbdt emits NONE)")
    tre = node.attr_ints("nodes_treeids")
    nid = node.attr_ints("nodes_nodeids")
    n_nodes = len(tre)
    modes = [s.decode() if isinstance(s, bytes) else s
             for s in a["nodes_modes"].strings]
    bad = set(modes) - {"LEAF", "BRANCH_LEQ", "BRANCH_EQ"}
    if bad:
        raise NotImplementedError(f"TreeEnsemble node modes {sorted(bad)}")
    feat = np.asarray(node.attr_ints("nodes_featureids"), np.int64)
    vals = np.asarray(list(a["nodes_values"].floats), np.float32)
    track = np.asarray(node.attr_ints(
        "nodes_missing_value_tracks_true", [0] * n_nodes), bool)
    pos = {(int(t), int(n)): i for i, (t, n) in enumerate(zip(tre, nid))}
    tin = node.attr_ints("nodes_truenodeids")
    fin = node.attr_ints("nodes_falsenodeids")
    is_leaf = np.asarray([m == "LEAF" for m in modes])
    is_leq = np.asarray([m == "BRANCH_LEQ" for m in modes])
    tchild = np.asarray([i if is_leaf[i] else pos[(int(tre[i]), int(tin[i]))]
                         for i in range(n_nodes)], np.int64)
    fchild = np.asarray([i if is_leaf[i] else pos[(int(tre[i]), int(fin[i]))]
                         for i in range(n_nodes)], np.int64)
    roots = np.asarray([pos[(int(t), 0)] for t in sorted(set(tre))],
                       np.int64)

    # depth bound: host DFS with memo over the (acyclic) child graph
    depth: Dict[int, int] = {}
    for r in range(n_nodes):
        stack = [r]
        while stack:
            i = stack[-1]
            if i in depth:
                stack.pop()
                continue
            if is_leaf[i]:
                depth[i] = 1
                stack.pop()
                continue
            kids = [int(tchild[i]), int(fchild[i])]
            missing = [k for k in kids if k not in depth]
            if missing:
                stack.extend(missing)
            else:
                depth[i] = 1 + max(depth[k] for k in kids)
                stack.pop()
    D = max((depth[int(r)] for r in roots), default=1)

    prefix = "class" if node.op_type.endswith("Classifier") else "target"
    w_tre = node.attr_ints(f"{prefix}_treeids")
    w_nid = node.attr_ints(f"{prefix}_nodeids")
    w_ids = node.attr_ints(f"{prefix}_ids")
    w_val = list(a[f"{prefix}_weights"].floats)
    K = (max(w_ids) + 1) if w_ids else 1
    W = np.zeros((n_nodes, K), np.float32)
    for t_, n_, c_, v_ in zip(w_tre, w_nid, w_ids, w_val):
        W[pos[(int(t_), int(n_))], c_] += v_
    base = np.asarray(list(a["base_values"].floats), np.float32) \
        if "base_values" in a else np.zeros(K, np.float32)

    dev = X.device

    def d(arr):
        return torch.as_tensor(arr, device=dev)

    Xd = X.float()
    n = Xd.shape[0]
    cur = d(roots)[None, :].expand(n, len(roots))
    feat_d, vals_d, t_d, f_d = d(feat), d(vals), d(tchild), d(fchild)
    leq_d, track_d = d(is_leq), d(track)
    rows = torch.arange(n, device=dev)[:, None]
    for _ in range(D):
        xv = Xd[rows, feat_d[cur]]
        v = vals_d[cur]
        go_true = torch.where(leq_d[cur],
                              torch.where(torch.isnan(xv), track_d[cur],
                                          xv <= v),
                              xv == v)
        cur = torch.where(go_true, t_d[cur], f_d[cur])  # leaves self-loop
    scores = d(W)[cur].sum(dim=1) + d(base)
    if prefix == "target":
        return scores
    label = torch.argmax(scores, dim=1).to(torch.int32) if K > 1 \
        else (scores[:, 0] > 0).to(torch.int32)
    return (label, scores)


def _lstm(node: Node, ins):
    """ONNX LSTM: gates iofc, activations sigmoid/tanh/tanh.  Returns the
    (Y, Y_h, Y_c) triple; unused outputs are dropped by the caller."""
    X, W, R = ins[0], ins[1], ins[2]
    B = ins[3] if len(ins) > 3 else None
    if len(ins) > 4 and ins[4] is not None:
        raise NotImplementedError(
            "LSTM sequence_lens: variable-length batches are not supported; "
            "pad to equal length and drop the sequence_lens input")
    if len(ins) > 7 and ins[7] is not None:
        raise NotImplementedError(
            "LSTM peephole weights (input P) are not supported; importing "
            "would silently drop them and produce wrong outputs")
    H = node.attr_i("hidden_size", R.shape[-1])
    direction = node.attr_s("direction", "forward")
    dirs = 2 if direction == "bidirectional" else 1
    batch = X.shape[1]
    zeros = torch.zeros((dirs, batch, H), dtype=X.dtype, device=X.device)
    h0 = ins[5] if len(ins) > 5 and ins[5] is not None else zeros
    c0 = ins[6] if len(ins) > 6 and ins[6] is not None else zeros

    def run_dir(d, reverse):
        Wd, Rd = W[d], R[d]                       # (4H, in), (4H, H)
        bd = (B[d][:4 * H] + B[d][4 * H:]) if B is not None else 0.0
        h, c = h0[d], c0[d]
        ys = []
        steps = range(X.shape[0] - 1, -1, -1) if reverse \
            else range(X.shape[0])
        for step in steps:
            z = X[step] @ Wd.T + h @ Rd.T + bd    # (batch, 4H)
            i_g = torch.sigmoid(z[:, :H])
            o_g = torch.sigmoid(z[:, H:2 * H])
            f_g = torch.sigmoid(z[:, 2 * H:3 * H])
            c_t = torch.tanh(z[:, 3 * H:])
            c = f_g * c + i_g * c_t
            h = o_g * torch.tanh(c)
            ys.append(h)
        if reverse:
            ys = ys[::-1]
        return torch.stack(ys), h, c

    outs = [run_dir(0, direction == "reverse")]
    if dirs == 2:
        outs.append(run_dir(1, True))
    Y = torch.stack([o[0] for o in outs], dim=1)    # (seq, dirs, batch, H)
    Y_h = torch.stack([o[1] for o in outs], dim=0)  # (dirs, batch, H)
    Y_c = torch.stack([o[2] for o in outs], dim=0)
    return (Y, Y_h, Y_c)


def onnx_to_jax(model: "bytes | str", output_names: Optional[List[str]] = None,
                cut_layers: int = 0, device: DeviceLike = None
                ) -> Tuple[Callable, Dict[str, np.ndarray]]:
    """Decode ONNX bytes (or a file path) into ``(apply_fn, variables)``.

    ``apply_fn(variables, *inputs)`` runs the graph with torch ops on the
    device of its first tensor input; when no input is a tensor, on
    ``device`` (the card unless ``"cpu"``);
    ``variables`` holds the graph's float initializers (the pretrained
    weights) keyed by tensor name, as numpy arrays (a caller that scores
    repeatedly passes them as tensors already on the device, as
    ``models.runner.ModelRunner`` does).  Inputs/outputs keep the graph's
    declared order and native layout.

    ``cut_layers=N`` drops the trailing N nodes and outputs the last kept
    node's result — the reference ImageFeaturizer's ``cutOutputLayers``
    head truncation (``ImageFeaturizer.scala:49-120``); ``output_names``
    instead names any intermediate tensors to emit.
    """
    if isinstance(model, str):
        with open(model, "rb") as f:
            model = f.read()
    graph = parse_model(model)
    if cut_layers:
        if output_names is not None:
            raise ValueError("pass either cut_layers or output_names")
        graph.nodes = graph.nodes[:-cut_layers]
        output_names = [graph.nodes[-1].outputs[0]]
    # float initializers are the pretrained WEIGHTS; integer/bool ones are
    # shape machinery (Reshape targets, Gather indices, axes) and stay host
    # constants, folded with numpy
    variables = {k: v for k, v in graph.initializers.items()
                 if v.dtype.kind == "f"}
    consts = {k: v for k, v in graph.initializers.items()
              if v.dtype.kind != "f"}
    input_names = [vi.name for vi in graph.inputs
                   if vi.name not in graph.initializers]
    if output_names is None:
        output_names = [vi.name for vi in graph.outputs]
    nodes = list(graph.nodes)

    def apply_fn(variables, *inputs):
        if len(inputs) != len(input_names):
            raise ValueError(f"graph takes {input_names}, got "
                             f"{len(inputs)} inputs")
        dev = next((v.device for v in inputs
                    if isinstance(v, torch.Tensor)), None)
        if dev is None:
            dev = resolve_device(device)
        ev = _Eval(dev)
        env: Dict[str, Any] = dict(consts)
        env.update({k: ev.t(v) for k, v in variables.items()})
        env.update(zip(input_names, (ev.t(v) for v in inputs)))
        want = set(output_names)
        with torch.inference_mode(), float32_exact(dev.type == "cuda"):
            for node in nodes:
                out = _eval_node(node, env, ev)
                if isinstance(out, tuple):
                    for name, val in zip(node.outputs, out):
                        if name:
                            env[name] = val
                else:
                    env[node.outputs[0]] = out
                if want <= env.keys():
                    break  # requested intermediates reached; skip the head
        outs = tuple(env[n] for n in output_names)
        return outs[0] if len(outs) == 1 else outs

    return apply_fn, variables


class OnnxModelPayload:
    """Saveable bundle around raw ONNX bytes — the pretrained-model artifact
    the repo stores (reference ``ModelDownloader`` keeps CNTK graph files,
    ``downloader/ModelDownloader.scala:26``).  ``apply_fn`` / ``variables``
    expose the same surface as ``FlaxModelPayload`` so ``JaxModel`` and
    ``ImageFeaturizer`` take either.  ``apply`` runs on ``device`` (the
    card unless ``"cpu"``), where ``ModelDownloader.download_by_name``
    places it."""

    def __init__(self, model_bytes: bytes, cut_layers: int = 0,
                 output_names: Optional[List[str]] = None,
                 device: DeviceLike = None):
        self.model_bytes = model_bytes
        self.cut_layers = cut_layers
        self.output_names = output_names
        self.device = device
        self.apply_fn, self.variables = onnx_to_jax(
            model_bytes, output_names=output_names, cut_layers=cut_layers)
        self.module = None
        self.apply_kwargs: Dict[str, Any] = {}

    @property
    def pure_apply(self) -> Callable:
        return self.apply_fn

    def apply(self, batch):
        """The graph on ``batch`` (numpy or a tensor), moved to the
        payload's device first."""
        dev = resolve_device(self.device)
        return self.apply_fn(self.variables,
                             torch.as_tensor(batch, device=dev))

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "model.onnx"), "wb") as f:
            f.write(self.model_bytes)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"cut_layers": self.cut_layers,
                       "output_names": self.output_names}, f)

    @classmethod
    def load(cls, path: str) -> "OnnxModelPayload":
        with open(os.path.join(path, "model.onnx"), "rb") as f:
            data = f.read()
        meta = {"cut_layers": 0, "output_names": None}
        mp = os.path.join(path, "meta.json")
        if os.path.exists(mp):
            with open(mp) as f:
                meta = json.load(f)
        return cls(data, cut_layers=meta.get("cut_layers", 0),
                   output_names=meta.get("output_names"))


def onnx_to_jax_model(model: "bytes | str", input_col: str = "input",
                      output_col: str = "output", batch_size: int = 64,
                      device=None):
    """ONNX file -> ready-to-use ``JaxModel`` transformer (the CNTKModel
    load-a-serialized-graph path, ``CNTKModel.scala:500-545``), scoring on
    ``device`` (the card unless ``"cpu"``)."""
    from .jax_model import JaxModel
    apply_fn, variables = onnx_to_jax(model)
    jm = JaxModel()
    jm.set_model(apply_fn=apply_fn, variables=variables)
    jm.set_params(input_col=input_col, output_col=output_col,
                  batch_size=batch_size, device=device)
    return jm
