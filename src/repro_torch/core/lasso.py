"""Lasso via cyclic coordinate descent + K-fold LassoCV (sklearn-free).

Solves  min_w  1/(2n) ||y - Xw - b||^2 + lam * ||w||_1
with an unpenalized intercept, on standardized features (the paper fits
log-suboptimality with scikit-learn's LassoCV; this is a drop-in offline
replacement, unit-tested against closed forms).

The descent works on the Gram matrix (G = X'X/n, c = X'y/n) with O(d)
coordinate updates and warm-started lambda paths, so the CV grid costs a
handful of sweeps instead of thousands — this is the hot path of the
adaptive controller, which refits the convergence model on a trailing
window every few steps of a live run (repro_torch.core.adaptive / §6).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


def _soft(x: np.ndarray, t: float) -> np.ndarray:
    return np.sign(x) * np.maximum(np.abs(x) - t, 0.0)


@dataclasses.dataclass
class LassoFit:
    coef: np.ndarray        # in original (unstandardized) feature space
    intercept: float
    lam: float
    n_iter: int
    # standardization stats (kept for diagnostics)
    x_mean: np.ndarray
    x_scale: np.ndarray

    def predict(self, X: np.ndarray) -> np.ndarray:
        return X @ self.coef + self.intercept


def _standardize(X: np.ndarray, y: np.ndarray):
    x_mean = X.mean(0)
    x_scale = X.std(0)
    x_scale[x_scale < 1e-12] = 1.0
    Xs = (X - x_mean) / x_scale
    y_mean = y.mean()
    return Xs, y - y_mean, x_mean, x_scale, float(y_mean)


def _cd_solve(G: np.ndarray, c: np.ndarray, lam: float, w: np.ndarray,
              max_iter: int, tol: float) -> Tuple[np.ndarray, int]:
    """Cyclic coordinate descent on the Gram system; ``w`` is updated in
    place and returned.  Each coordinate update is O(d) via the cached
    gradient ``Gw`` — independent of the number of observations."""
    d = len(c)
    col_sq = np.diagonal(G).copy()
    Gw = G @ w
    it = 0
    for it in range(1, max_iter + 1):
        w_max_delta = 0.0
        for j in range(d):
            cj = col_sq[j]
            if cj == 0.0:
                continue
            wj_old = w[j]
            rho = c[j] - Gw[j] + cj * wj_old
            mag = abs(rho) - lam
            wj_new = (mag / cj if rho > 0.0 else -mag / cj) if mag > 0.0 \
                else 0.0
            if wj_new != wj_old:
                delta = wj_new - wj_old
                Gw += G[:, j] * delta
                w[j] = wj_new
                if abs(delta) > w_max_delta:
                    w_max_delta = abs(delta)
        if w_max_delta < tol:
            break
    return w, it


def lasso_fit(X: np.ndarray, y: np.ndarray, lam: float,
              max_iter: int = 2000, tol: float = 1e-8,
              w0: Optional[np.ndarray] = None) -> LassoFit:
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    n, d = X.shape
    Xs, yc, x_mean, x_scale, y_mean = _standardize(X, y)
    G = (Xs.T @ Xs) / n
    c = (Xs.T @ yc) / n
    w = np.zeros(d) if w0 is None else np.asarray(w0, np.float64).copy()
    w, it = _cd_solve(G, c, lam, w, max_iter, tol)
    coef = w / x_scale
    intercept = float(y_mean - x_mean @ coef)
    return LassoFit(coef=coef, intercept=intercept, lam=lam, n_iter=it,
                    x_mean=x_mean, x_scale=x_scale)


def lambda_grid(X: np.ndarray, y: np.ndarray, n: int = 30,
                eps: float = 1e-4) -> np.ndarray:
    Xs = (X - X.mean(0))
    scale = Xs.std(0)
    scale[scale < 1e-12] = 1.0
    Xs = Xs / scale
    yc = y - y.mean()
    lam_max = float(np.max(np.abs(Xs.T @ yc)) / len(y))
    lam_max = max(lam_max, 1e-12)
    return np.geomspace(lam_max, lam_max * eps, n)


def lasso_cv(X: np.ndarray, y: np.ndarray, k: int = 5,
             lams: Optional[Sequence[float]] = None,
             seed: int = 0, max_iter: int = 1000) -> LassoFit:
    """K-fold cross-validated Lasso (mirrors sklearn LassoCV).

    The lambda grid runs from large to small and each fold's fits are
    warm-started along the path, so the whole CV costs a few dozen sweeps."""
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    n = len(y)
    if lams is None:
        lams = lambda_grid(X, y)
    k = min(k, n)
    rng = np.random.RandomState(seed)
    idx = rng.permutation(n)
    folds = np.array_split(idx, k)
    errs = np.zeros(len(lams))
    for fi in range(k):
        test = folds[fi]
        train = np.concatenate([folds[fj] for fj in range(k) if fj != fi])
        Xtr, ytr = X[train], y[train]
        ntr, d = Xtr.shape
        Xs, yc, x_mean, x_scale, y_mean = _standardize(Xtr, ytr)
        G = (Xs.T @ Xs) / ntr
        c = (Xs.T @ yc) / ntr
        w = np.zeros(d)
        for li, lam in enumerate(lams):      # descending: warm starts help
            w, _ = _cd_solve(G, c, float(lam), w, max_iter, 1e-8)
            coef = w / x_scale
            intercept = y_mean - x_mean @ coef
            pred = X[test] @ coef + intercept
            errs[li] += float(np.mean((pred - y[test]) ** 2))
    best = int(np.argmin(errs))
    return lasso_fit(X, y, float(lams[best]), max_iter=2 * max_iter)


def r2_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true = np.asarray(y_true, np.float64)
    y_pred = np.asarray(y_pred, np.float64)
    ss_res = float(np.sum((y_true - y_pred) ** 2))
    ss_tot = float(np.sum((y_true - y_true.mean()) ** 2))
    if ss_tot == 0.0:
        return 1.0 if ss_res == 0.0 else 0.0
    return 1.0 - ss_res / ss_tot
