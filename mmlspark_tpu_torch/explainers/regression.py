"""Weighted linear solvers for explainers (the port of
``mmlspark_tpu/explainers/regression.py``).

Reference: ``explainers/`` breeze-based ``LassoRegression`` /
``LeastSquaresRegression``.  Here: closed-form weighted least squares on
the host in float64, copied verbatim, and the ISTA lasso in float32 on a
``device``: the weighted centring, the normal matrix ``A``, ``b``, the
``trace(A)`` Lipschitz bound, ``iters`` proximal steps and the intercept,
as the JAX package's jitted loop computes them.  The loop is plain tensor
ops and never waits for the device inside it; the coefficients come back
once, at the end.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .._device import DeviceLike, float32_exact, resolve_device


def weighted_least_squares(X: np.ndarray, y: np.ndarray, w: np.ndarray,
                           fit_intercept: bool = True,
                           ridge: float = 1e-6) -> Tuple[np.ndarray, float]:
    """Host float64 normal equations: the SHAP kernel's 1e6 endpoint
    weights make the system ill-conditioned beyond float32 (jax truncates
    float64 by default), and the per-row solve is d<=dozens — too small for
    the device to matter."""
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    w = np.asarray(w, np.float64)
    if fit_intercept:
        X1 = np.concatenate([X, np.ones((X.shape[0], 1))], axis=1)
    else:
        X1 = X
    WX = X1 * w[:, None]
    A = X1.T @ WX + ridge * np.eye(X1.shape[1])
    b = WX.T @ y
    try:
        beta = np.linalg.solve(A, b)
    except np.linalg.LinAlgError:
        beta = np.linalg.lstsq(A, b, rcond=None)[0]
    if fit_intercept:
        return beta[:-1], float(beta[-1])
    return beta, 0.0


def _ista(A: torch.Tensor, b: torch.Tensor, L: torch.Tensor, alpha: float,
          iters: int) -> torch.Tensor:
    """``iters`` proximal-gradient steps from zero for ``0.5 beta'A beta -
    b'beta + alpha |beta|_1`` at step ``1/L``: plain tensor ops on the
    device of ``A``, nothing waiting for it."""
    shrink = alpha / L
    beta = torch.zeros_like(b)
    for _ in range(iters):
        z = beta - (A @ beta - b) / L
        beta = torch.sign(z) * torch.clamp_min(z.abs() - shrink, 0.0)
    return beta


def lasso_regression(X: np.ndarray, y: np.ndarray, w: np.ndarray,
                     alpha: float = 0.01, iters: int = 200,
                     fit_intercept: bool = True,
                     device: DeviceLike = None) -> Tuple[np.ndarray, float]:
    """Weighted lasso via ISTA (proximal gradient) in float32 on ``device``
    (``None``: the card, an error without one; ``"cpu"``: the host)."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    with torch.inference_mode(), float32_exact(dev.type == "cuda"):
        Xj, yj, wj = t(X), t(y), t(w)
        wj = wj / torch.clamp_min(wj.sum(), 1e-12)
        d = Xj.shape[1]
        if fit_intercept:
            x_mean = (Xj * wj[:, None]).sum(dim=0)
            y_mean = (yj * wj).sum()
        else:
            x_mean = torch.zeros(d, dtype=torch.float32, device=dev)
            y_mean = torch.zeros((), dtype=torch.float32, device=dev)
        Xc = Xj - x_mean
        yc = yj - y_mean
        WXc = Xc * wj[:, None]
        A = WXc.T @ Xc
        b = WXc.T @ yc
        L = torch.clamp_min(torch.trace(A), 1e-9)   # Lipschitz upper bound
        beta = _ista(A, b, L, alpha, iters)
        intercept = y_mean - x_mean @ beta
        beta_h, intercept_h = beta.cpu().numpy(), float(intercept.cpu())
    return beta_h, (intercept_h if fit_intercept else 0.0)
