"""Convergence model g(i, m): objective value after i iterations on m machines.

Implements §3.2.2 + §4 of the paper:
  * fit log(P(i,m) - P*) with LassoCV over the feature library
  * leave-one-m-out cross validation (§4.1, Fig 4)
  * forward prediction over an iteration window (§4.2, Fig 5)
The model is metric-agnostic (footnote 4): any positive gap (primal
suboptimality, duality gap, LM train-loss - floor) works.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.features import FeatureLibrary
from repro_torch.core.lasso import LassoFit, lasso_cv, r2_score

GAP_FLOOR = 1e-12


@dataclasses.dataclass
class ConvergenceData:
    """Observations: objective P(i, m) for iterations i on m machines."""

    i: np.ndarray       # (n,) iteration index (>= 1)
    m: np.ndarray       # (n,) machine count
    value: np.ndarray   # (n,) objective value P(i, m)
    p_star: float       # optimal value P*

    @classmethod
    def from_curves(cls, curves: Dict[int, np.ndarray], p_star: float,
                    start_iter: int = 1,
                    stop_gap: Optional[float] = None) -> "ConvergenceData":
        """curves: {m: array of P over iterations}.

        ``stop_gap`` truncates each curve once the gap reaches the target —
        mirroring the paper's runs, which terminate at suboptimality 1e-4
        (points at machine precision would otherwise poison the log-gap fit).
        """
        i_all, m_all, v_all = [], [], []
        for m, vals in sorted(curves.items()):
            vals = np.asarray(vals, np.float64)
            if stop_gap is not None:
                gaps = vals - p_star
                below = np.nonzero(gaps <= stop_gap)[0]
                if len(below):
                    vals = vals[: below[0] + 1]
            its = np.arange(start_iter, start_iter + len(vals))
            i_all.append(its)
            m_all.append(np.full(len(vals), m))
            v_all.append(vals)
        return cls(np.concatenate(i_all), np.concatenate(m_all),
                   np.concatenate(v_all), float(p_star))

    def gap(self) -> np.ndarray:
        return np.maximum(self.value - self.p_star, GAP_FLOOR)

    def mask(self, keep: np.ndarray) -> "ConvergenceData":
        return ConvergenceData(self.i[keep], self.m[keep], self.value[keep],
                               self.p_star)


@dataclasses.dataclass
class ConvergenceModel:
    library: FeatureLibrary = dataclasses.field(default_factory=FeatureLibrary)
    fit_: Optional[LassoFit] = None
    p_star: float = 0.0

    # ------------------------------------------------------------------
    def fit(self, data: ConvergenceData, cv_folds: int = 5,
            seed: int = 0) -> "ConvergenceModel":
        X = self.library(data.i, data.m)
        y = np.log(data.gap())
        self.fit_ = lasso_cv(X, y, k=cv_folds, seed=seed)
        self.p_star = data.p_star
        return self

    def predict_log_gap(self, i, m) -> np.ndarray:
        assert self.fit_ is not None, "call fit() first"
        i = np.atleast_1d(np.asarray(i, np.float64))
        m = np.broadcast_to(np.atleast_1d(np.asarray(m, np.float64)), i.shape)
        return self.fit_.predict(self.library(i, m))

    def predict(self, i, m) -> np.ndarray:
        """g(i, m): predicted objective value."""
        return self.p_star + np.exp(self.predict_log_gap(i, m))

    def r2(self, data: ConvergenceData) -> float:
        pred = self.predict_log_gap(data.i, data.m)
        return r2_score(np.log(data.gap()), pred)

    def active_features(self, tol: float = 1e-10) -> Dict[str, float]:
        assert self.fit_ is not None
        return {n: float(c) for n, c in zip(self.library.names, self.fit_.coef)
                if abs(c) > tol}

    # ------------------------------------------------------------------
    # §4.1: predict a held-out degree of parallelism
    # ------------------------------------------------------------------
    def loo_m(self, data: ConvergenceData,
              seed: int = 0) -> Dict[int, Tuple[float, "ConvergenceModel"]]:
        """Leave-one-m-out: for each m, fit on the others, report held-out R²
        (in log-gap space) and the fitted model."""
        out: Dict[int, Tuple[float, ConvergenceModel]] = {}
        for m_hold in sorted(set(data.m.astype(int))):
            train = data.mask(data.m != m_hold)
            test = data.mask(data.m == m_hold)
            model = ConvergenceModel(self.library).fit(train, seed=seed)
            pred = model.predict_log_gap(test.i, test.m)
            out[int(m_hold)] = (r2_score(np.log(test.gap()), pred), model)
        return out

    # ------------------------------------------------------------------
    # §4.2: forward prediction (fit on a trailing window, predict ahead)
    # ------------------------------------------------------------------
    def forward_prediction(self, data: ConvergenceData, window: int = 50,
                           ahead: int = 1,
                           seed: int = 0) -> Dict[int, np.ndarray]:
        """For each m: walk the curve; at iteration t >= window fit on
        [t-window, t] and predict t+ahead.  Returns {m: (n_pred, 3) array of
        (iter_predicted, true_value, predicted_value)}."""
        results: Dict[int, np.ndarray] = {}
        for m_val in sorted(set(data.m.astype(int))):
            sel = data.m == m_val
            its = data.i[sel]
            vals = data.value[sel]
            order = np.argsort(its)
            its, vals = its[order], vals[order]
            rows = []
            for t_idx in range(window, len(its) - ahead):
                w_i = its[t_idx - window: t_idx + 1]
                w_v = vals[t_idx - window: t_idx + 1]
                sub = ConvergenceData(w_i, np.full(len(w_i), m_val), w_v,
                                      data.p_star)
                try:
                    model = ConvergenceModel(self.library).fit(sub, cv_folds=3,
                                                               seed=seed)
                except Exception:
                    continue
                i_pred = its[t_idx + ahead]
                pred = float(model.predict(i_pred, m_val)[0])
                rows.append((i_pred, vals[t_idx + ahead], pred))
            if rows:
                results[int(m_val)] = np.asarray(rows)
        return results
