"""Params — single source of truth for stage configuration.

Reference: SparkML ``Params`` extended by mmlspark with ``ComplexParam``
(``core/serialize/ComplexParam.scala:13`` — params holding non-JSON payloads
with their own save/load) and ``ServiceParam`` (``cognitive/.../
CognitiveServiceBase.scala:29-127`` — a value *or* a column reference).

Params metadata drives three subsystems exactly as in the reference:
serialization (§core.serialize), codegen (stub/doc generation), and the
fuzzing test harness (reflection sweep over declared params).
"""
from __future__ import annotations

import copy
import uuid as _uuid
from typing import Any, Callable, Dict, Generic, List, Optional, TypeVar

T = TypeVar("T")


def _next_uid(prefix: str) -> str:
    return f"{prefix}_{_uuid.uuid4().hex[:12]}"


class Param(Generic[T]):
    """Declarative parameter: name, doc, type tag, default, validator."""

    def __init__(self, name: str, doc: str, dtype: str = "object",
                 default: Any = None, validator: Optional[Callable[[Any], bool]] = None,
                 is_complex: bool = False):
        self.name = name
        self.doc = doc
        self.dtype = dtype
        self.default = default
        self.validator = validator
        self.is_complex = is_complex

    def validate(self, value: Any) -> None:
        if value is not None and self.validator is not None and not self.validator(value):
            raise ValueError(f"invalid value for param '{self.name}': {value!r}")

    def __repr__(self):
        return f"Param({self.name}: {self.dtype})"


class ComplexParam(Param):
    """Param holding a non-JSON payload (model bytes, DataFrames, functions,
    ball trees).  Serialized via the payload's own save/load hooks — see
    ``core.serialize``.  Reference: ``ComplexParam.scala:13`` and the concrete
    types under ``org/apache/spark/ml/param/``."""

    def __init__(self, name: str, doc: str, dtype: str = "complex",
                 default: Any = None, validator=None):
        super().__init__(name, doc, dtype, default, validator, is_complex=True)


class ServiceParam(Param):
    """Value-or-column duality for request fields (cognitive services).

    ``set(v)`` binds a literal; ``set_col(c)`` binds a column name, resolved
    per-row at transform time.  Reference: ``HasServiceParams``
    (``CognitiveServiceBase.scala:29-127``)."""

    def __init__(self, name: str, doc: str, dtype: str = "service",
                 default: Any = None, validator=None, required: bool = False):
        super().__init__(name, doc, dtype, default, validator)
        self.required = required


class ServiceValue:
    """Bound value of a ServiceParam: either a literal or a column reference."""
    __slots__ = ("value", "col")

    def __init__(self, value: Any = None, col: Optional[str] = None):
        if (value is None) == (col is None):
            raise ValueError("exactly one of value/col must be set")
        self.value = value
        self.col = col

    def resolve(self, row) -> Any:
        return row[self.col] if self.col is not None else self.value

    def to_json(self):
        return {"col": self.col} if self.col is not None else {"value": self.value}

    @staticmethod
    def from_json(d):
        return ServiceValue(value=d.get("value"), col=d.get("col"))

    def __repr__(self):
        return f"ServiceValue(col={self.col!r})" if self.col else f"ServiceValue({self.value!r})"


class _ParamsMeta(type):
    """Collects Param class attributes into `_params`, inheriting from bases."""

    def __new__(mcls, name, bases, ns):
        cls = super().__new__(mcls, name, bases, ns)
        params: Dict[str, Param] = {}
        for base in reversed(cls.__mro__):
            for k, v in vars(base).items():
                if isinstance(v, Param):
                    params[v.name] = v
        cls._params = params
        return cls


class Params(metaclass=_ParamsMeta):
    """Base for anything configurable via Params (all pipeline stages).

    Values live in ``_paramMap``; defaults in each Param.  ``set``/``get``
    accept either the Param object or its name.  Fluent ``set_<name>`` and
    ``get_<name>`` accessors are synthesised on attribute access, mirroring
    the reference's setter/getter convention so generated bindings look alike.
    """

    _params: Dict[str, Param] = {}

    def __init__(self, uid: Optional[str] = None):
        self.uid = uid or _next_uid(type(self).__name__)
        self._paramMap: Dict[str, Any] = {}

    # ------------------------------------------------------------- access
    @classmethod
    def params(cls) -> List[Param]:
        return list(cls._params.values())

    @classmethod
    def get_param(cls, name: str) -> Param:
        try:
            return cls._params[name]
        except KeyError:
            raise KeyError(f"{cls.__name__} has no param '{name}'; has {list(cls._params)}")

    def _resolve(self, param) -> Param:
        return param if isinstance(param, Param) else self.get_param(param)

    def set(self, param, value) -> "Params":
        p = self._resolve(param)
        if isinstance(p, ServiceParam) and not isinstance(value, ServiceValue):
            value = ServiceValue(value=value)
        if isinstance(value, ServiceValue):
            if value.col is None:  # column bindings bypass literal validation
                p.validate(value.value)
        else:
            p.validate(value)
        self._paramMap[p.name] = value
        return self

    def set_col(self, param, col: str) -> "Params":
        p = self._resolve(param)
        if not isinstance(p, ServiceParam):
            raise TypeError(f"param '{p.name}' is not a ServiceParam")
        self._paramMap[p.name] = ServiceValue(col=col)
        return self

    def get(self, param) -> Any:
        p = self._resolve(param)
        if p.name in self._paramMap:
            return self._paramMap[p.name]
        return p.default

    def get_or_fail(self, param) -> Any:
        v = self.get(param)
        if v is None:
            raise ValueError(f"param '{self._resolve(param).name}' is required but unset on {self.uid}")
        return v

    def is_set(self, param) -> bool:
        return self._resolve(param).name in self._paramMap

    def is_defined(self, param) -> bool:
        p = self._resolve(param)
        return p.name in self._paramMap or p.default is not None

    def set_params(self, **kwargs) -> "Params":
        for k, v in kwargs.items():
            self.set(k, v)
        return self

    # ------------------------------------------------------------- fluent api
    def __getattr__(self, item: str):
        # Only called when normal lookup fails; synthesise set_x/get_x.
        if item.startswith("set_"):
            name = item[4:]
            if name in type(self)._params:
                return lambda v: self.set(name, v)
        elif item.startswith("get_"):
            name = item[4:]
            if name in type(self)._params:
                return self.get(name)
        raise AttributeError(f"{type(self).__name__} has no attribute {item!r}")

    # ------------------------------------------------------------- copy/explain
    def copy(self, extra: Optional[Dict[str, Any]] = None) -> "Params":
        other = copy.copy(self)
        other._paramMap = dict(self._paramMap)
        if extra:
            for k, v in extra.items():
                other.set(k, v)
        return other

    def explain_params(self) -> str:
        lines = []
        for p in self.params():
            cur = self._paramMap.get(p.name, "undefined")
            lines.append(f"{p.name}: {p.doc} (default: {p.default!r}, current: {cur!r})")
        return "\n".join(lines)

    def extract_param_map(self) -> Dict[str, Any]:
        out = {p.name: p.default for p in self.params() if p.default is not None}
        out.update(self._paramMap)
        return out

    def has_same_params(self, other: "Params") -> bool:
        return type(self) is type(other) and _param_maps_equal(self.extract_param_map(),
                                                              other.extract_param_map())


def _param_maps_equal(a: Dict[str, Any], b: Dict[str, Any]) -> bool:
    import numpy as np
    if a.keys() != b.keys():
        return False
    for k in a:
        va, vb = a[k], b[k]
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            if not np.array_equal(np.asarray(va), np.asarray(vb)):
                return False
        elif isinstance(va, ServiceValue) and isinstance(vb, ServiceValue):
            if va.col != vb.col or va.value != vb.value:
                return False
        elif va != vb:
            return False
    return True


# --------------------------------------------------------------------------
# Shared param mixins (reference: core/contracts/Params.scala)
# --------------------------------------------------------------------------

class HasInputCol(Params):
    input_col = Param("input_col", "name of the input column", "string", default="input")


class HasInputCols(Params):
    input_cols = Param("input_cols", "names of the input columns", "list")


class HasOutputCol(Params):
    output_col = Param("output_col", "name of the output column", "string", default="output")


class HasFeaturesCol(Params):
    features_col = Param("features_col", "name of the features column", "string", default="features")


class HasLabelCol(Params):
    label_col = Param("label_col", "name of the label column", "string", default="label")


class HasWeightCol(Params):
    weight_col = Param("weight_col", "name of the sample-weight column", "string")


class HasPredictionCol(Params):
    prediction_col = Param("prediction_col", "name of the prediction column", "string", default="prediction")


class HasProbabilityCol(Params):
    probability_col = Param("probability_col", "probability output column", "string", default="probability")


class HasRawPredictionCol(Params):
    raw_prediction_col = Param("raw_prediction_col", "raw margin output column", "string", default="raw_prediction")
