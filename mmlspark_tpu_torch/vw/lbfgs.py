"""L-BFGS with a zoom line search — the algorithm that the JAX package's VW
``--bfgs`` mode runs through ``optax.lbfgs()``, written for torch tensors.

The JAX package drives ``optax.lbfgs()`` with its defaults (a memory of 10
pairs, the identity scaled by ``<dw, du> / <du, du>`` and, at the first
step, by ``min(1, 1 / |g|)``; then ``scale_by_zoom_linesearch`` with at most
20 steps, a first guess of 1, a sufficient-decrease slope of 1e-4, a
curvature bound of 0.9, the approximate-Wolfe decrease of 1e-6 and an
interval threshold of 1e-5), taking each iteration's value and gradient
from the line search's accepted point (``value_and_grad_from_state``).
``torch.optim.LBFGS`` is another algorithm (its line search and first step
differ), so this module copies optax's: ``optax/_src/transform.py::
scale_by_lbfgs`` (the two-loop recursion, Nocedal and Wright algorithm 7.4)
and ``optax/_src/linesearch.py::zoom_linesearch`` (algorithms 3.5 and 3.6).

Vectors stay on their device.  The recursion's scalars are 0-d float32
tensors beside them; the line search's scalars are float32 on the host,
where its branches are taken, so every decision is made in the float32
arithmetic optax makes it in.  Dot products accumulate in float64 and
round to float32: the path of L-BFGS over many line searches magnifies
rounding (at 20 iterations on 100,000 hashed tweets, a float32 sum in
another order moved the objective by 5e-4 relative), and this way the
card and the CPU round every reduction alike.  Each trial point costs one
host read of its value and slope.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np
import torch

F32 = np.float32

ValueAndGrad = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def value_and_grad(fn: Callable[[torch.Tensor], torch.Tensor]
                   ) -> ValueAndGrad:
    """``fn``'s value and its gradient from ``torch.autograd``."""
    def vg(w: torch.Tensor):
        w = w.detach().requires_grad_(True)
        with torch.enable_grad():
            v = fn(w)
            (g,) = torch.autograd.grad(v, w)
        return v.detach(), g
    return vg


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``<a, b>`` accumulated in float64 and rounded to ``a``'s dtype: a
    float32 result that does not depend on the device's summation order
    (so the card and the CPU take the same line-search branches)."""
    return torch.dot(a.reshape(-1).double(), b.reshape(-1).double()) \
        .to(a.dtype)


class _Line:
    """The zoom line search's state (optax's ``ZoomLinesearchState``) with
    float32 host scalars."""

    def __init__(self, params, updates, value, grad, slope):
        z = F32(0.0)
        self.params, self.updates = params, updates
        self.count = 0
        self.stepsize = z
        self.value, self.grad, self.slope = value, grad, slope
        self.value_init, self.slope_init = value, slope
        self.decrease_error = self.curvature_error = F32(np.inf)
        self.interval_found = self.done = self.failed = False
        self.low, self.value_low, self.slope_low = z, value, slope
        self.high, self.value_high, self.slope_high = z, value, slope
        self.cubic_ref, self.value_cubic_ref = z, value
        self.safe_stepsize, self.safe_value, self.safe_grad = z, value, grad


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Minimizer of the cubic through (a, fa, fpa), (b, fb), (c, fc)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    v0 = fb - fa - C * db
    v1 = fc - fa - C * dc
    A = (dc * dc * v0 + (-(db * db)) * v1) / denom
    B = ((-(dc * dc * dc)) * v0 + db * db * db * v1) / denom
    radical = B * B - F32(3.0) * A * C
    return a + (-B + np.sqrt(radical)) / (F32(3.0) * A)


def _quadmin(a, fa, fpa, b, fb):
    """Minimizer of the quadratic through (a, fa, fpa), (b, fb)."""
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db * db)
    return a - C / (F32(2.0) * B)


class LBFGS:
    """``optax.lbfgs()`` with its defaults, on torch tensors.

    ``vg(w) -> (value, grad)`` is the objective; ``run(w0, iterations)``
    returns the weights after ``iterations`` steps, each of which starts
    from the previous line search's accepted value and gradient."""

    def __init__(self, vg: ValueAndGrad, memory_size: int = 10,
                 scale_init_precond: bool = True,
                 max_linesearch_steps: int = 20, tol: float = 0.0,
                 increase_factor: float = 2.0, slope_rtol: float = 1e-4,
                 curv_rtol: float = 0.9, approx_dec_rtol: float = 1e-6,
                 stepsize_precision: float = 1e-5):
        if memory_size < 1:
            raise ValueError("memory_size must be >= 1")
        self.vg = vg
        self.m = memory_size
        self.scale_init_precond = scale_init_precond
        self.max_steps = max_linesearch_steps
        self.tol = F32(tol)
        self.increase_factor = F32(increase_factor)
        self.slope_rtol = F32(slope_rtol)
        self.curv_rtol = F32(curv_rtol)
        self.approx_dec_rtol = F32(approx_dec_rtol)
        self.dec_slope = F32(2 * slope_rtol - 1.0)
        self.interval_threshold = F32(stepsize_precision)

    # -- the two-loop recursion (scale_by_lbfgs) -------------------------

    def init(self, w: torch.Tensor) -> None:
        m, dev = self.m, w.device
        self.count = 0
        self.prev_params = torch.zeros_like(w)
        self.prev_updates = torch.zeros_like(w)
        self.dw = torch.zeros((m,) + tuple(w.shape), dtype=w.dtype,
                              device=dev)
        self.du = torch.zeros_like(self.dw)
        self.rho = torch.zeros(m, dtype=torch.float32, device=dev)
        self.ls_value = F32(np.inf)
        self.ls_grad = torch.zeros_like(w)

    def _direction(self, w: torch.Tensor, grad: torch.Tensor):
        """``P_k g_k``: the memory updated with the last step's pair, then
        the two-loop product.  Scalars stay 0-d tensors on the device."""
        m = self.m
        mi, pi = self.count % m, (self.count - 1) % m
        zero = torch.zeros((), dtype=torch.float32, device=w.device)
        if self.count > 0:
            dp = w - self.prev_params
            du = grad - self.prev_updates
            vd = _dot(du, dp)
            weight = torch.where(vd == 0.0, zero, 1.0 / vd)
        else:
            dp, du, weight = torch.zeros_like(w), torch.zeros_like(w), zero
        self.dw[pi] = dp
        self.du[pi] = du
        self.rho[pi] = weight
        if self.scale_init_precond:
            num = _dot(du, dp)
            den = _dot(du, du)
            scale = torch.where(den > 0.0, num / den, zero + 1.0)
            if self.count == 0:
                norm = torch.sqrt(_dot(grad, grad))
                scale = torch.minimum(zero + 1.0, 1.0 / norm)
        else:
            scale = zero + 1.0
        idx = [(mi + j) % m for j in range(m)]
        vec = grad
        alphas = {}
        for i in reversed(idx):
            alpha = self.rho[i] * _dot(self.dw[i], vec)
            vec = vec + (-alpha) * self.du[i]
            alphas[i] = alpha
        vec = scale * vec
        for i in idx:
            beta = self.rho[i] * _dot(self.du[i], vec)
            vec = vec + (alphas[i] - beta) * self.dw[i]
        self.count += 1
        self.prev_params, self.prev_updates = w, grad
        return vec

    # -- the zoom line search --------------------------------------------

    def _on_line(self, params, stepsize, updates):
        value, grad = self.vg(params + updates * float(stepsize))
        slope = F32(_dot(grad, updates).item())
        return F32(value.item()), grad, slope

    def _decrease_error(self, stepsize, value, slope, value_init,
                        slope_init):
        err = value - value_init - self.slope_rtol * stepsize * slope_init
        approx = slope - self.dec_slope * slope_init
        delta = value - value_init - self.approx_dec_rtol * abs(value_init)
        err = min(max(approx, delta), err)
        err = max(err, F32(0.0))
        return F32(np.inf) if np.isnan(err) else F32(err)

    def _curvature_error(self, slope, slope_init):
        err = abs(slope) - self.curv_rtol * abs(slope_init)
        err = max(err, F32(0.0))
        return F32(np.inf) if np.isnan(err) else F32(err)

    def _search_interval(self, s: _Line) -> None:
        new = s.stepsize_guess if s.count == 0 \
            else self.increase_factor * s.stepsize
        value, grad, slope = self._on_line(s.params, new, s.updates)
        de = self._decrease_error(new, value, slope, s.value_init,
                                  s.slope_init)
        ce = self._curvature_error(slope, s.slope_init)
        err = max(de, ce)
        if de <= self.tol:
            s.safe_stepsize, s.safe_value, s.safe_grad = new, value, grad
        high_to_new = bool(de > 0.0) or (bool(value >= s.value)
                                         and s.count > 0)
        low_to_new = bool(slope >= 0.0) and not high_to_new
        if low_to_new:
            s.low, s.value_low, s.slope_low = new, value, slope
            s.high, s.value_high, s.slope_high = s.stepsize, s.value, s.slope
        else:
            s.low, s.value_low, s.slope_low = s.stepsize, s.value, s.slope
            s.high, s.value_high, s.slope_high = new, value, slope
        s.interval_found = high_to_new or low_to_new or bool(err <= self.tol)
        s.done = bool(err <= self.tol)
        s.failed = s.count + 1 >= self.max_steps and not s.done
        s.count += 1
        s.stepsize, s.value, s.grad, s.slope = new, value, grad, slope
        s.decrease_error, s.curvature_error = de, ce
        s.cubic_ref, s.value_cubic_ref = s.low, s.value_low

    def _zoom(self, s: _Line) -> None:
        low, high = s.low, s.high
        delta = abs(high - low)
        left, right = min(high, low), max(high, low)
        cubic_chk = F32(0.2) * delta
        quad_chk = F32(0.1) * delta
        too_small = bool(delta <= self.interval_threshold)
        mc = _cubicmin(low, s.value_low, s.slope_low, high, s.value_high,
                       s.cubic_ref, s.value_cubic_ref)
        use_cubic = bool(mc > left + cubic_chk) and bool(mc < right
                                                         - cubic_chk)
        mq = _quadmin(low, s.value_low, s.slope_low, high, s.value_high)
        use_quad = not use_cubic and bool(mq > left + quad_chk) \
            and bool(mq < right - quad_chk)
        middle = mc if use_cubic else mq if use_quad \
            else (low + high) / F32(2.0)
        value, grad, slope = self._on_line(s.params, middle, s.updates)
        de = self._decrease_error(middle, value, slope, s.value_init,
                                  s.slope_init)
        ce = self._curvature_error(slope, s.slope_init)
        err = max(de, ce)
        if de <= self.tol and value < s.safe_value:
            s.safe_stepsize, s.safe_value, s.safe_grad = middle, value, grad
        done = bool(err <= self.tol)
        high_to_middle = bool(de > 0.0) or bool(value >= s.value_low)
        high_to_low = bool(slope * (high - low) >= 0.0) \
            and not high_to_middle
        new_high = (middle, value, slope) if high_to_middle \
            else (high, s.value_high, s.slope_high)
        if high_to_low:
            new_high = (low, s.value_low, s.slope_low)
        new_low = (low, s.value_low, s.slope_low) if high_to_middle \
            else (middle, value, slope)
        if high_to_middle or high_to_low:
            s.cubic_ref, s.value_cubic_ref = high, s.value_high
        else:
            s.cubic_ref, s.value_cubic_ref = low, s.value_low
        (s.high, s.value_high, s.slope_high) = new_high
        (s.low, s.value_low, s.slope_low) = new_low
        failed = (s.count + 1 >= self.max_steps) \
            or (too_small and bool(s.safe_stepsize > 0.0))
        s.failed = failed and not done
        s.done = done
        s.count += 1
        s.stepsize, s.value, s.grad, s.slope = middle, value, grad, slope
        s.decrease_error, s.curvature_error = de, ce

    def _linesearch(self, params, updates, value, grad):
        slope = F32(_dot(updates, grad).item())
        s = _Line(params, updates, value, grad, slope)
        s.stepsize_guess = F32(1.0)
        with np.errstate(all="ignore"):
            while not (s.done or s.failed):
                if s.interval_found:
                    self._zoom(s)
                else:
                    self._search_interval(s)
                if s.failed and (s.safe_stepsize > 0.0
                                 or math.isinf(s.decrease_error)):
                    s.stepsize, s.value, s.grad = \
                        s.safe_stepsize, s.safe_value, s.safe_grad
        return s.stepsize, s.value, s.grad

    # -- the optimizer's iteration ---------------------------------------

    def step(self, w: torch.Tensor) -> torch.Tensor:
        if np.isfinite(self.ls_value):
            value, grad = self.ls_value, self.ls_grad
        else:
            v, grad = self.vg(w)
            value = F32(v.item())
        updates = -self._direction(w, grad)
        lr, self.ls_value, self.ls_grad = self._linesearch(w, updates,
                                                           value, grad)
        return w + updates * float(lr)

    def run(self, w0: torch.Tensor, iterations: int) -> torch.Tensor:
        self.init(w0)
        w = w0
        for _ in range(iterations):
            w = self.step(w)
        return w
