"""Non-negative least squares (Lawson–Hanson active set), sklearn/scipy-free.

Ernest fits its system model with NNLS so that every cost term contributes
non-negatively (computation, communication terms can only add time).
"""
from __future__ import annotations

import numpy as np


def nnls(A: np.ndarray, b: np.ndarray, max_iter: int | None = None,
         tol: float = 1e-10) -> np.ndarray:
    """Solve min ||Ax - b||_2 s.t. x >= 0.  Returns x."""
    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    m, n = A.shape
    if max_iter is None:
        max_iter = 3 * n + 30
    passive: list[int] = []
    x = np.zeros(n)
    w = A.T @ (b - A @ x)
    it = 0
    while True:
        active = [j for j in range(n) if j not in passive]
        if not active:
            break
        w = A.T @ (b - A @ x)
        w_active = {j: w[j] for j in active}
        j_best = max(w_active, key=w_active.get)
        if w_active[j_best] <= tol:
            break
        passive.append(j_best)
        while True:
            it += 1
            if it > max_iter:
                return x
            Ap = A[:, passive]
            s_p, *_ = np.linalg.lstsq(Ap, b, rcond=None)
            if np.all(s_p > tol):
                x = np.zeros(n)
                x[passive] = s_p
                break
            # step back toward feasibility
            xp = x[passive]
            neg = s_p <= tol
            with np.errstate(divide="ignore", invalid="ignore"):
                ratios = np.where(neg, xp / np.maximum(xp - s_p, 1e-30), np.inf)
            alpha = float(np.min(ratios))
            x_new = np.zeros(n)
            x_new[passive] = xp + alpha * (s_p - xp)
            x = np.clip(x_new, 0.0, None)
            passive = [j for j in passive if x[j] > tol]
            if not passive:
                break
    return x


def nnls_fit(X: np.ndarray, y: np.ndarray) -> tuple[np.ndarray, float]:
    """Fit y ~ X theta with theta >= 0; returns (theta, rmse)."""
    theta = nnls(X, y)
    resid = y - X @ theta
    rmse = float(np.sqrt(np.mean(resid ** 2)))
    return theta, rmse
