"""Feature library phi_j(i, m) for the convergence model g(i, m).

The paper (§3.2.2) fits log(P(i,m) - P*) with a linear model over
"fractional, polynomial, and logarithmic" features of (i, m).  Theoretical
rates motivate the library, e.g. CoCoA's (1 - c0/m)^i c1 gives
log-suboptimality ≈ i*log(1 - c0/m) + log c1 ≈ -c0 * (i/m) + log c1,
so `i/m` (and friends) must be present; Lasso picks the active subset.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence, Tuple

import numpy as np

FeatureFn = Callable[[np.ndarray, np.ndarray], np.ndarray]

# name -> phi(i, m); i >= 1, m >= 1 expected (shifted inside for safety)
DEFAULT_FEATURES: Dict[str, FeatureFn] = {
    "i": lambda i, m: i,
    "i/m": lambda i, m: i / m,
    "i/m^2": lambda i, m: i / m ** 2,
    "i/sqrt(m)": lambda i, m: i / np.sqrt(m),
    "i*log(m+1)": lambda i, m: i * np.log(m + 1.0),
    "i*log(m+1)/m": lambda i, m: i * np.log(m + 1.0) / m,
    "log(i+1)": lambda i, m: np.log(i + 1.0),
    "sqrt(i)": lambda i, m: np.sqrt(i),
    "sqrt(i/m)": lambda i, m: np.sqrt(i / m),
    "1/i": lambda i, m: 1.0 / np.maximum(i, 1.0),
    "m": lambda i, m: m,
    "log(m+1)": lambda i, m: np.log(m + 1.0),
    "1/m": lambda i, m: 1.0 / m,
    "log(i+1)*log(m+1)": lambda i, m: np.log(i + 1.0) * np.log(m + 1.0),
    "1/(i/m+1)": lambda i, m: 1.0 / (i / m + 1.0),
}


@dataclasses.dataclass(frozen=True)
class FeatureLibrary:
    names: Tuple[str, ...] = tuple(DEFAULT_FEATURES)

    def __call__(self, i: np.ndarray, m: np.ndarray) -> np.ndarray:
        """(n,) iteration counts and machine counts -> (n, d) design matrix."""
        i = np.asarray(i, np.float64)
        m = np.asarray(m, np.float64)
        cols = [DEFAULT_FEATURES[n](i, m) for n in self.names]
        return np.stack(cols, axis=1)

    def subset(self, names: Sequence[str]) -> "FeatureLibrary":
        unknown = set(names) - set(DEFAULT_FEATURES)
        if unknown:
            raise KeyError(f"unknown features {unknown}")
        return FeatureLibrary(tuple(names))
