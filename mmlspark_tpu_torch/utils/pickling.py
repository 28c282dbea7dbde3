"""Pickle with closure support — cloudpickle when available, stdlib otherwise.

Used for ComplexParam payloads that are functions or locally-defined modules
(the reference serializes UDFs and model graphs through Spark's closure
serializer; cloudpickle is the Python analogue).
"""
from __future__ import annotations

try:
    import cloudpickle as _impl
except ImportError:  # pragma: no cover
    import pickle as _impl


def dump(obj, fileobj) -> None:
    _impl.dump(obj, fileobj)


def dumps(obj) -> bytes:
    return _impl.dumps(obj)


def load(fileobj):
    import pickle
    return pickle.load(fileobj)  # cloudpickle output is stdlib-loadable


def loads(data: bytes):
    import pickle
    return pickle.loads(data)
