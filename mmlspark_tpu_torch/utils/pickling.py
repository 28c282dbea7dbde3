"""Pickle with closure support — cloudpickle when available, stdlib otherwise.

Used for ComplexParam payloads that are functions or locally-defined modules
(the reference serializes UDFs and model graphs through Spark's closure
serializer; cloudpickle is the Python analogue).

Loading goes through ``_Unpickler``: a class the JAX package pickled
(module ``mmlspark_tpu`` or ``mmlspark_tpu.<x>``) is found as its twin in
this package (``mmlspark_tpu_torch`` / ``mmlspark_tpu_torch.<x>``), so a
pickled payload the JAX package saved (its isolation forest, its ball
trees) loads here without importing the JAX package.  Every other name
passes through unchanged.  The reverse (a payload pickled here, loaded by
the JAX package) is not supported.

Inside ``refusing()`` (a safe ``core.serialize.load``) every load raises
``PermissionError``: a ``Saveable`` payload that pickles itself (the
forest, the ball trees) is refused there as the ``pickle`` kind is.
"""
from __future__ import annotations

import contextlib
import contextvars
import io
import pickle

try:
    import cloudpickle as _impl
except ImportError:  # pragma: no cover
    import pickle as _impl

_REFERENCE = "mmlspark_tpu"
_PORT = "mmlspark_tpu_torch"


def port_module(module: str) -> str:
    """The port's twin of a JAX-package module path; any other path as
    given."""
    if module == _REFERENCE or module.startswith(_REFERENCE + "."):
        return _PORT + module[len(_REFERENCE):]
    return module


_refusing = contextvars.ContextVar("refusing_pickles", default=False)


@contextlib.contextmanager
def refusing(refuse: bool = True):
    """While ``refuse`` holds, ``load``/``loads`` raise instead of
    unpickling (pickle executes code from the payload)."""
    token = _refusing.set(bool(refuse) or _refusing.get())
    try:
        yield
    finally:
        _refusing.reset(token)


def _check_allowed() -> None:
    if _refusing.get():
        raise PermissionError(
            "safe load: refusing a pickled payload (pickle executes "
            "arbitrary code); load with safe=False only on trusted paths")


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        return super().find_class(port_module(module), name)


def dump(obj, fileobj) -> None:
    _impl.dump(obj, fileobj)


def dumps(obj) -> bytes:
    return _impl.dumps(obj)


def load(fileobj):
    _check_allowed()
    return _Unpickler(fileobj).load()  # cloudpickle output is stdlib-loadable


def loads(data: bytes):
    _check_allowed()
    return _Unpickler(io.BytesIO(data)).load()
