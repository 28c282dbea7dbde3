"""Minimal ONNX protobuf wire codec — no onnx/onnxruntime dependency.

Reference capability: CNTKModel loads externally-trained graph files
(``deep-learning/.../cntk/CNTKModel.scala:34-73`` broadcasts serialized model
bytes); the TPU rebuild's interchange format is ONNX (SURVEY.md §7 step 2).
This environment ships neither the ``onnx`` package nor its runtime, so this
module speaks the protobuf *wire format* directly: a reader that decodes
``ModelProto`` files produced by any exporter (torch, tf2onnx, skl2onnx...)
and a writer used by tests and ``OnnxModelPayload`` round-trips.

Field numbers follow the public ``onnx.proto`` spec (stable since IR v3):

- ModelProto:    ir_version=1 producer=2 graph=7 opset_import=8
- GraphProto:    node=1 name=2 initializer=5 input=11 output=12 value_info=13
- NodeProto:     input=1 output=2 name=3 op_type=4 attribute=5 domain=7
- AttributeProto:name=1 f=2 i=3 s=4 t=5 floats=7 ints=8 strings=9 type=20
- TensorProto:   dims=1 data_type=2 float_data=4 int32_data=5 string_data=6
                 int64_data=7 name=8 raw_data=9 double_data=10
- ValueInfoProto:name=1 type=2 ; TypeProto.tensor_type=1 (elem_type=1 shape=2)
- TensorShapeProto.dim=1 (dim_value=1 dim_param=2)
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

# TensorProto.DataType -> numpy
DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
          6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16,
          11: np.float64, 12: np.uint32, 13: np.uint64}
DTYPE_CODES = {np.dtype(v): k for k, v in DTYPES.items()}


# --------------------------------------------------------------------------
# decoding
# --------------------------------------------------------------------------

def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = val = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message buffer."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
        elif wt == 1:
            v = buf[i:i + 8]
            i += 8
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:
            v = buf[i:i + 4]
            i += 4
        else:  # groups (3/4) never appear in onnx.proto
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, v


def _packed_varints(v, wt) -> List[int]:
    if wt == 0:
        return [_signed(v)]
    out = []
    i = 0
    while i < len(v):
        x, i = _read_varint(v, i)
        out.append(_signed(x))
    return out


@dataclasses.dataclass
class Attr:
    name: str = ""
    f: float = 0.0
    i: int = 0
    s: bytes = b""
    t: Optional[np.ndarray] = None
    floats: List[float] = dataclasses.field(default_factory=list)
    ints: List[int] = dataclasses.field(default_factory=list)
    strings: List[bytes] = dataclasses.field(default_factory=list)
    type: int = 0


@dataclasses.dataclass
class Node:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Attr]
    name: str = ""

    def attr_i(self, name, default=0):
        return self.attrs[name].i if name in self.attrs else default

    def attr_f(self, name, default=0.0):
        return self.attrs[name].f if name in self.attrs else default

    def attr_ints(self, name, default=()):
        return list(self.attrs[name].ints) if name in self.attrs else list(default)

    def attr_s(self, name, default=""):
        return self.attrs[name].s.decode() if name in self.attrs else default


@dataclasses.dataclass
class ValueInfo:
    name: str
    elem_type: int = 1
    shape: List[Optional[int]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Graph:
    nodes: List[Node]
    initializers: Dict[str, np.ndarray]
    inputs: List[ValueInfo]
    outputs: List[ValueInfo]
    name: str = ""


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype = 1
    name = ""
    raw = None
    f32: List[float] = []
    i32: List[int] = []
    i64: List[int] = []
    f64: List[float] = []
    for field, wt, v in _fields(buf):
        if field == 1:
            dims.extend(_packed_varints(v, wt))
        elif field == 2:
            dtype = v
        elif field == 4:
            f32.extend(struct.unpack(f"<{len(v) // 4}f", v) if wt == 2
                       else struct.unpack("<f", v))
        elif field == 5:
            i32.extend(_packed_varints(v, wt))
        elif field == 7:
            i64.extend(_packed_varints(v, wt))
        elif field == 8:
            name = v.decode()
        elif field == 9:
            raw = v
        elif field == 10:
            f64.extend(struct.unpack(f"<{len(v) // 8}d", v) if wt == 2
                       else struct.unpack("<d", v))
    np_dtype = DTYPES.get(dtype, np.float32)
    if raw is not None:
        arr = np.frombuffer(raw, np_dtype)
    elif f32:
        arr = np.asarray(f32, np.float32)
    elif f64:
        arr = np.asarray(f64, np.float64)
    elif i64:
        arr = np.asarray(i64, np.int64)
    elif i32:
        arr = np.asarray(i32, np_dtype if np_dtype in (np.int32, np.int8, np.uint8,
                                                       np.int16, np.uint16, np.bool_)
                         else np.int32)
    else:
        arr = np.zeros(0, np_dtype)
    return name, arr.astype(np_dtype, copy=False).reshape(dims)


def _parse_attr(buf: bytes) -> Attr:
    a = Attr()
    for field, wt, v in _fields(buf):
        if field == 1:
            a.name = v.decode()
        elif field == 2:
            a.f = struct.unpack("<f", v)[0]
        elif field == 3:
            a.i = _signed(v)
        elif field == 4:
            a.s = v
        elif field == 5:
            a.t = _parse_tensor(v)[1]
        elif field == 7:
            a.floats.extend(struct.unpack(f"<{len(v) // 4}f", v) if wt == 2
                            else struct.unpack("<f", v))
        elif field == 8:
            a.ints.extend(_packed_varints(v, wt))
        elif field == 9:
            a.strings.append(v)
        elif field == 20:
            a.type = v
    return a


def _parse_node(buf: bytes) -> Node:
    node = Node("", [], [], {})
    for field, wt, v in _fields(buf):
        if field == 1:
            node.inputs.append(v.decode())
        elif field == 2:
            node.outputs.append(v.decode())
        elif field == 3:
            node.name = v.decode()
        elif field == 4:
            node.op_type = v.decode()
        elif field == 5:
            a = _parse_attr(v)
            node.attrs[a.name] = a
    return node


def _parse_value_info(buf: bytes) -> ValueInfo:
    vi = ValueInfo("")
    for field, wt, v in _fields(buf):
        if field == 1:
            vi.name = v.decode()
        elif field == 2:  # TypeProto
            for f2, _, v2 in _fields(v):
                if f2 == 1:  # tensor_type
                    for f3, wt3, v3 in _fields(v2):
                        if f3 == 1:
                            vi.elem_type = v3
                        elif f3 == 2:  # TensorShapeProto
                            for f4, _, v4 in _fields(v3):
                                if f4 == 1:  # dim
                                    dim_val: Optional[int] = None
                                    for f5, _, v5 in _fields(v4):
                                        if f5 == 1:
                                            dim_val = _signed(v5)
                                    vi.shape.append(dim_val)
    return vi


def _parse_graph(buf: bytes) -> Graph:
    g = Graph([], {}, [], [])
    for field, wt, v in _fields(buf):
        if field == 1:
            g.nodes.append(_parse_node(v))
        elif field == 2:
            g.name = v.decode()
        elif field == 5:
            name, arr = _parse_tensor(v)
            g.initializers[name] = arr
        elif field == 11:
            g.inputs.append(_parse_value_info(v))
        elif field == 12:
            g.outputs.append(_parse_value_info(v))
    return g


def parse_model(data: bytes) -> Graph:
    """Decode a serialized ONNX ModelProto into its Graph."""
    graph = None
    for field, wt, v in _fields(data):
        if field == 7:
            graph = _parse_graph(v)
    if graph is None:
        raise ValueError("no GraphProto in model bytes (is this an ONNX file?)")
    return graph


# --------------------------------------------------------------------------
# encoding (tests + payload round-trips)
# --------------------------------------------------------------------------

def _varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wt: int) -> bytes:
    return _varint((field << 3) | wt)


def _len_field(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _str_field(field: int, s) -> bytes:
    return _len_field(field, s if isinstance(s, bytes) else s.encode())


def encode_tensor(name: str, arr: np.ndarray) -> bytes:
    shape = np.shape(arr)  # before ascontiguousarray, which 1-d-ifies 0-d
    arr = np.ascontiguousarray(arr)
    out = b"".join(_key(1, 0) + _varint(int(d)) for d in shape)
    out += _key(2, 0) + _varint(DTYPE_CODES[arr.dtype])
    out += _str_field(8, name)
    out += _len_field(9, arr.tobytes())
    return out


def encode_attr(name: str, value) -> bytes:
    out = _str_field(1, name)
    if isinstance(value, float):
        out += _key(2, 5) + struct.pack("<f", value) + _key(20, 0) + _varint(1)
    elif isinstance(value, bool) or isinstance(value, (int, np.integer)):
        out += _key(3, 0) + _varint(int(value)) + _key(20, 0) + _varint(2)
    elif isinstance(value, (str, bytes)):
        out += _str_field(4, value) + _key(20, 0) + _varint(3)
    elif isinstance(value, np.ndarray):
        out += _len_field(5, encode_tensor("", value)) + _key(20, 0) + _varint(4)
    elif isinstance(value, (list, tuple)) and value and isinstance(value[0], float):
        out += b"".join(_key(7, 5) + struct.pack("<f", f) for f in value)
        out += _key(20, 0) + _varint(6)
    elif isinstance(value, (list, tuple)) and value \
            and isinstance(value[0], (str, bytes)):
        out += b"".join(_str_field(9, s) for s in value)
        out += _key(20, 0) + _varint(8)
    elif isinstance(value, (list, tuple)):
        out += b"".join(_key(8, 0) + _varint(int(i)) for i in value)
        out += _key(20, 0) + _varint(7)
    else:
        raise TypeError(f"cannot encode attribute {name}={value!r}")
    return out


def encode_node(op_type: str, inputs: List[str], outputs: List[str],
                **attrs) -> bytes:
    out = b"".join(_str_field(1, s) for s in inputs)
    out += b"".join(_str_field(2, s) for s in outputs)
    out += _str_field(4, op_type)
    out += b"".join(_len_field(5, encode_attr(k, v)) for k, v in attrs.items())
    return out


def _encode_value_info(name: str, shape, elem_type: int = 1) -> bytes:
    dims = b"".join(_len_field(1, _key(1, 0) + _varint(int(d))) for d in shape)
    tensor_type = _key(1, 0) + _varint(elem_type) + _len_field(2, dims)
    return _str_field(1, name) + _len_field(2, _len_field(1, tensor_type))


def build_model(nodes: List[bytes], initializers: Dict[str, np.ndarray],
                inputs: List[Tuple[str, List[int]]],
                outputs: List[Tuple[str, List[int]]],
                opset: int = 13,
                extra_domains: List[Tuple[str, int]] = ()) -> bytes:
    """Assemble a serialized ModelProto from encoded nodes + named arrays.

    ``extra_domains``: (domain, version) opset imports beyond the default
    domain — the ONNX IR requires every domain a node uses to be declared
    (onnx.checker/onnxruntime reject models that omit one), so TreeEnsemble
    exporters pass ``[("ai.onnx.ml", 2)]``."""
    g = b"".join(_len_field(1, n) for n in nodes)
    g += _str_field(2, "graph")
    g += b"".join(_len_field(5, encode_tensor(k, v))
                  for k, v in initializers.items())
    g += b"".join(_len_field(11, _encode_value_info(n, s)) for n, s in inputs)
    g += b"".join(_len_field(12, _encode_value_info(n, s)) for n, s in outputs)
    opset_b = _str_field(1, "") + _key(2, 0) + _varint(opset)
    out = (_key(1, 0) + _varint(8)            # ir_version
           + _str_field(2, "mmlspark_tpu")    # producer
           + _len_field(7, g)
           + _len_field(8, opset_b))
    for dom, ver in extra_domains:
        out += _len_field(8, _str_field(1, dom) + _key(2, 0) + _varint(ver))
    return out
