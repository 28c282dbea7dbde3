"""Model runner, batch front — the port of ``mmlspark_tpu/models/runner.py``
(``bucket_rows``, ``_pad_rows``, ``ModelRunner`` and its ``apply_batch``).

One object takes an in-tree model (``models.resnet``), an ONNX import
(``dl/onnx_import.py``) or any ``apply_fn(state, batch)`` callable, places
it on its device once, and scores stacked host batches of any row count:
chunk to ``batch_size``, pad each chunk to its power-of-two latency bucket
(a 1-row request pads to 1, not ``batch_size``), run, unpad, concatenate.
There is no jit: PyTorch runs eagerly, so a bucket is an eager call under
``torch.inference_mode()``, and the buckets keep the reference's padding
(and with it its outputs) rather than a compile cache.  The batch counters
(``mmlspark_runner_batches_total``, ``_rows_total``, ``_pad_rows_total``)
book into the port's registry under the reference's names.

The serving and decode side of the reference's runner (``scorer``,
``decode``, ``decode_stream``, ``PagePool``, ``ContinuousDecoder``, the
prefix cache) is not ported: each name raises ``NotImplementedError``
naming ROADMAP.md §1 item 9.
"""
from __future__ import annotations

import copy
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device

__all__ = ["ModelRunner", "DecodeResult", "PagePool", "ContinuousDecoder",
           "StreamHandle", "PagePoolExhausted", "SlotsExhausted", "ShedReply",
           "bucket_rows"]

#: fronts a batch can arrive through; metric label values
FRONTS = ("transform", "serving", "decode")

_NOT_PORTED = ("the serving/decode side of models/runner.py is not ported "
               "yet (ROADMAP.md §1 item 9, the decode/serving engine)")


def _not_ported(*_args, **_kwargs):
    raise NotImplementedError(_NOT_PORTED)


class _NotPorted:
    """A reference name of the decode/serving engine: raises on use."""

    def __init__(self, *args, **kwargs):
        _not_ported()


class DecodeResult(_NotPorted):
    pass


class PagePool(_NotPorted):
    pass


class ContinuousDecoder(_NotPorted):
    pass


class StreamHandle(_NotPorted):
    pass


class ShedReply(_NotPorted):
    pass


class PagePoolExhausted(RuntimeError):
    """Reference admission-control error of the paged decode (not ported)."""
    shed = True


class SlotsExhausted(RuntimeError):
    """Reference admission-control error of continuous decode (not
    ported)."""
    shed = True


def bucket_rows(m: int, batch_size: int) -> int:
    """Power-of-two latency bucket for an ``m``-row chunk: a 1-row serving
    request pads to 1, not ``batch_size``; full chunks use ``batch_size``
    itself."""
    if m >= batch_size:
        return batch_size
    return min(batch_size, 1 << (max(1, m) - 1).bit_length())


def _pad_rows(x: np.ndarray, target: int) -> np.ndarray:
    """Pad the leading dim to ``target`` by repeating the last row (cheap,
    and keeps the padded rows numerically tame for any model)."""
    m = x.shape[0]
    if m == target:
        return x
    pad = np.repeat(x[-1:], target - m, axis=0)
    return np.concatenate([x, pad], axis=0)


def _on_device(module: torch.nn.Module, dev: torch.device
               ) -> torch.nn.Module:
    """``module`` if all its tensors lie on ``dev``, else a copy moved
    there (the caller's module stays where it was)."""
    tensors = list(module.parameters()) + list(module.buffers())
    if all(t.device == dev for t in tensors):
        return module
    return copy.deepcopy(module).to(dev)


class ModelRunner:
    """Device placement + the batch front.

    Accepts any of:

    - ``payload`` — an object exposing ``module`` / ``apply_fn`` /
      ``variables`` / ``apply_kwargs``: ``dl.FlaxModelPayload``,
      ``dl.OnnxModelPayload``;
    - ``module=`` — an ``nn.Module`` holding its weights; ``apply_kwargs``
      forward to its ``forward`` (an ``apply_fn`` takes none, as in the
      reference);
    - ``apply_fn=`` + ``variables=`` — a ``(state, batch)`` callable and its
      state (a dict of arrays or tensors, moved to the device once).

    ``name`` labels every metric series this runner books — keep it
    low-cardinality (a model family, not a uid).  ``device``: ``None`` is
    the card (an error without one), ``"cpu"`` the host.

    ``phase_s`` accumulates where ``apply_batch`` spends its time:
    ``h2d`` (host batch -> device), ``device`` (the model), ``d2h``
    (outputs back), from CUDA events on the card and the host clock on
    the CPU; ``stack`` is booked by the callers that stack rows into the
    host batch (``dl.JaxModel``, ``dl.ImageFeaturizer``).
    """

    def __init__(self, payload=None, *, module=None, variables=None,
                 apply_fn: Optional[Callable] = None,
                 apply_kwargs: Optional[Dict[str, Any]] = None,
                 name: str = "model", batch_size: int = 64,
                 registry=None, device: DeviceLike = None):
        if payload is not None:
            module = getattr(payload, "module", None)
            apply_fn = getattr(payload, "apply_fn", None)
            variables = payload.variables
            apply_kwargs = getattr(payload, "apply_kwargs", None)
        if apply_fn is None and module is None:
            raise ValueError("need a payload, a module, or an apply_fn")
        self.device = resolve_device(device)
        self.apply_kwargs = dict(apply_kwargs or {})
        self.module: Optional[torch.nn.Module] = None
        self.state: Dict[str, torch.Tensor] = {}
        if apply_fn is not None:
            self._apply_fn = apply_fn
            self.state = {k: (v if isinstance(v, torch.Tensor) else
                              torch.from_numpy(np.array(v))).to(self.device)
                          for k, v in (variables or {}).items()}
        else:
            self.module = _on_device(module, self.device).eval()
        self.name = name
        self.batch_size = int(batch_size)
        #: bucket rows -> eager calls made at that bucket
        self.bucket_calls: Dict[int, int] = {}
        self.phase_s = {"stack": 0.0, "h2d": 0.0, "device": 0.0, "d2h": 0.0}
        from ..observability.metrics import get_registry
        self.registry = registry if registry is not None else get_registry()
        reg = self.registry
        c_batches = reg.counter(
            "mmlspark_runner_batches_total",
            "device dispatches per runner by front",
            labels=("runner", "front"))
        c_rows = reg.counter(
            "mmlspark_runner_rows_total",
            "real (unpadded) rows scored per runner by front",
            labels=("runner", "front"))
        self._c_batches = {f: c_batches.labels(runner=name, front=f)
                           for f in FRONTS}
        self._c_rows = {f: c_rows.labels(runner=name, front=f)
                        for f in FRONTS}
        self._c_pad = reg.counter(
            "mmlspark_runner_pad_rows_total",
            "padding rows added by bucketing (wasted device work)",
            labels=("runner",)).labels(runner=name)

    def __call__(self, batch: torch.Tensor) -> torch.Tensor:
        """The model on one device batch."""
        if self.module is not None:
            return self.module(batch, **self.apply_kwargs)
        return self._apply_fn(self.state, batch)

    # ------------------------------------------------------------ batch front
    def apply_batch(self, x: np.ndarray, front: str = "transform",
                    batch_size: Optional[int] = None) -> np.ndarray:
        """Score a stacked host batch of any row count: chunk to
        ``batch_size``, pad each chunk to its power-of-two bucket, run the
        model on the device, unpad, concatenate.  The chunks' outputs stay
        on the device until the last one is enqueued, then come back in
        one copy, so the host never waits for the card between chunks."""
        bs = int(batch_size or self.batch_size)
        n = x.shape[0]
        if n == 0:
            return np.empty((0,), dtype=np.float32)
        cuda = self.device.type == "cuda"
        marks = []                           # (start, copied, computed)
        outs = []
        pad_total = 0
        with torch.inference_mode():
            for start in range(0, n, bs):
                chunk = x[start:start + bs]
                m = chunk.shape[0]
                bucket = bucket_rows(m, bs)
                pad_total += bucket - m
                chunk = np.ascontiguousarray(_pad_rows(chunk, bucket))
                t = [_mark(cuda)]
                batch = torch.from_numpy(chunk).to(self.device)
                t.append(_mark(cuda))
                y = self(batch)
                outs.append(y[:m])
                t.append(_mark(cuda))
                marks.append(t)
                self.bucket_calls[bucket] = self.bucket_calls.get(bucket, 0) \
                    + 1
                self._c_batches[front].inc()
            t_out = _mark(cuda)
            y = torch.cat(outs)
            if y.dtype == torch.bfloat16:
                y = y.float()
            result = y.cpu().numpy()
            t_done = _mark(cuda)
        for a, b, c in marks:
            self.phase_s["h2d"] += _elapsed(a, b)
            self.phase_s["device"] += _elapsed(b, c)
        self.phase_s["d2h"] += _elapsed(t_out, t_done)
        self._c_rows[front].inc(n)
        if pad_total:
            self._c_pad.inc(pad_total)
        return result

    # ---------------------------------------------- serving/decode: not ported
    scorer = decode = decode_stream = page_pool = prefix_cache = \
        stall_watchdog = _not_ported


def _mark(cuda: bool):
    if not cuda:
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _elapsed(a, b) -> float:
    """Seconds between two marks (events must have completed)."""
    if isinstance(a, float):
        return b - a
    return a.elapsed_time(b) / 1e3
