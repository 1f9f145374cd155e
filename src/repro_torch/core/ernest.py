"""Ernest system model f(m): time per BSP iteration vs machine count.

    f(m) = th0 + th1 * (size/m) + th2 * log(m) + th3 * m   (+ optional terms)

fit with NNLS (all terms contribute non-negative time), exactly as in
Ernest [NSDI'16] / Hemingway §3.2.1.  Extra terms cover second-order methods
(superlinear compute) and all-to-all collectives.

On this CPU-only container the "measured" response can be wall-clock (for
the convex BSP simulator) or the dry-run roofline step-time (for the LM
meshes); the model is agnostic — see DESIGN.md §3.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence, Tuple

import numpy as np

from repro_torch.core.nnls import nnls

TermFn = Callable[[np.ndarray, np.ndarray], np.ndarray]  # (m, size) -> value

TERMS: Dict[str, TermFn] = {
    "const": lambda m, size: np.ones_like(m, dtype=np.float64),
    "size_over_m": lambda m, size: size / m,
    "log_m": lambda m, size: np.log(m + 1.0),
    "m": lambda m, size: m.astype(np.float64),
    # extensions (§3.2.1 last paragraph)
    "m^2": lambda m, size: m.astype(np.float64) ** 2,
    "size_over_sqrt_m": lambda m, size: size / np.sqrt(m),
    "size": lambda m, size: size.astype(np.float64),
    "sqrt_m": lambda m, size: np.sqrt(m),
}

DEFAULT_TERMS: Tuple[str, ...] = ("const", "size_over_m", "log_m", "m")


@dataclasses.dataclass
class ErnestModel:
    term_names: Tuple[str, ...] = DEFAULT_TERMS
    theta: np.ndarray | None = None

    def design(self, m: np.ndarray, size: np.ndarray) -> np.ndarray:
        m = np.asarray(m, np.float64)
        size = np.asarray(size, np.float64)
        return np.stack([TERMS[t](m, size) for t in self.term_names], axis=1)

    def fit(self, m: Sequence[float], size: Sequence[float],
            time: Sequence[float]) -> "ErnestModel":
        X = self.design(np.asarray(m), np.asarray(size))
        self.theta = nnls(X, np.asarray(time, np.float64))
        return self

    def predict(self, m, size) -> np.ndarray:
        assert self.theta is not None, "call fit() first"
        scalar = np.isscalar(m)
        m_arr = np.atleast_1d(np.asarray(m, np.float64))
        s_arr = np.broadcast_to(np.asarray(size, np.float64), m_arr.shape)
        out = self.design(m_arr, s_arr) @ self.theta
        return float(out[0]) if scalar else out

    def percent_errors(self, m, size, time) -> np.ndarray:
        pred = self.predict(np.asarray(m), np.asarray(size))
        time = np.asarray(time, np.float64)
        return np.abs(pred - time) / np.maximum(np.abs(time), 1e-12) * 100.0

    def coefficients(self) -> Dict[str, float]:
        assert self.theta is not None
        return dict(zip(self.term_names, map(float, self.theta)))
