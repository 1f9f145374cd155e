"""Experiment design for cheap model fitting (§6 "Training time/resources").

Greedy cost-aware D-optimal selection over a candidate grid of (m, size)
configurations: repeatedly pick the candidate maximizing the information
gain per unit cost,

    argmax_c  [logdet(M + x_c x_c^T) - logdet(M)] / cost(c),

where M is the current information matrix of the Ernest design.  This is
the greedy analogue of Ernest's convex experiment-design program and keeps
the number of profiling runs (and machine-hours) small.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.ernest import ErnestModel


@dataclasses.dataclass(frozen=True)
class Candidate:
    m: int
    size: float

    def cost(self) -> float:
        # machine-hours proxy: m machines for time ~ size/m + overhead
        return self.m * (self.size / self.m + 1.0)


def greedy_d_optimal(
    candidates: Sequence[Candidate],
    budget: float,
    model: Optional[ErnestModel] = None,
    ridge: float = 1e-6,
    cost_fn: Optional[Callable[[Candidate], float]] = None,
) -> List[Candidate]:
    """Pick candidates until the cost budget is exhausted."""
    model = model or ErnestModel()
    cost_fn = cost_fn or (lambda c: c.cost())
    d = len(model.term_names)
    M = np.eye(d) * ridge
    chosen: List[Candidate] = []
    remaining = list(candidates)
    spent = 0.0
    sign, logdet = np.linalg.slogdet(M)
    while remaining:
        best_gain, best_idx = -np.inf, -1
        for idx, c in enumerate(remaining):
            cost = cost_fn(c)
            if spent + cost > budget:
                continue
            x = model.design(np.asarray([c.m]), np.asarray([c.size]))[0]
            _, new_logdet = np.linalg.slogdet(M + np.outer(x, x))
            gain = (new_logdet - logdet) / max(cost, 1e-9)
            if gain > best_gain:
                best_gain, best_idx = gain, idx
        if best_idx < 0:
            break
        c = remaining.pop(best_idx)
        x = model.design(np.asarray([c.m]), np.asarray([c.size]))[0]
        M += np.outer(x, x)
        _, logdet = np.linalg.slogdet(M)
        spent += cost_fn(c)
        chosen.append(c)
    return chosen


def default_candidate_grid(max_m: int = 64,
                           sizes: Tuple[float, ...] = (0.0125, 0.025, 0.05, 0.1)
                           ) -> List[Candidate]:
    """Ernest-style: small data fractions on small machine counts."""
    ms: List[int] = []
    m = 1
    while m <= max_m:
        ms.append(m)
        m *= 2
    return [Candidate(m=m, size=s) for m in ms for s in sizes]
