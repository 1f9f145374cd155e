"""Hemingway: h(t, m) = g(t / f(m), m) — combined model + planner (§3.1).

Answers the paper's two query types over a registry of candidate algorithms:
  * ``fastest_to_epsilon``: given error target eps, pick (algorithm, m)
    minimizing wall-clock time
  * ``best_within_budget``: given a latency budget, pick (algorithm, m)
    minimizing the achieved objective
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.convergence import ConvergenceModel
from repro_torch.core.ernest import ErnestModel


@dataclasses.dataclass
class CombinedModel:
    """One algorithm's (system, convergence) model pair."""

    system: ErnestModel
    convergence: ConvergenceModel
    data_size: float = 1.0
    max_iters: int = 100_000

    def h(self, t, m) -> np.ndarray:
        """Objective value at wall-clock time t on m machines."""
        t = np.atleast_1d(np.asarray(t, np.float64))
        f_m = max(float(self.system.predict(m, self.data_size)), 1e-12)
        iters = np.maximum(t / f_m, 1.0)
        return self.convergence.predict(iters, float(m))

    def iters_to_epsilon(self, eps: float, m: int) -> Optional[int]:
        """Smallest i with predicted gap <= eps.  Fitted g's need not be
        monotone far outside the data, so scan a geometric iteration grid
        for the first crossing, then refine by bisection on that bracket."""
        grid = np.unique(np.geomspace(1, self.max_iters, 256).astype(int))
        gaps = self.convergence.predict(grid.astype(np.float64), m) \
            - self.convergence.p_star
        below = np.nonzero(gaps <= eps)[0]
        if len(below) == 0:
            return None
        j = below[0]
        if j == 0:
            return int(grid[0])
        lo, hi = int(grid[j - 1]), int(grid[j])
        gap = lambda i: float(
            self.convergence.predict(np.asarray([i], np.float64), m)[0]
            - self.convergence.p_star)
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if gap(mid) <= eps:
                hi = mid
            else:
                lo = mid
        return hi

    def time_to_epsilon(self, eps: float, m: int) -> Optional[float]:
        iters = self.iters_to_epsilon(eps, m)
        if iters is None:
            return None
        return iters * float(self.system.predict(m, self.data_size))


@dataclasses.dataclass
class PlanDecision:
    algorithm: str
    m: int
    predicted_time: Optional[float] = None
    predicted_value: Optional[float] = None
    table: Optional[Dict[Tuple[str, int], float]] = None


@dataclasses.dataclass
class NoFeasiblePlan:
    """Typed infeasibility result for the planner queries.

    Returned (not raised) when no (algorithm, m) satisfies the query, so
    callers that schedule many workloads — the fleet scheduler above all —
    can treat "this job cannot be satisfied" as data: record the reason,
    queue or reject the workload, and keep planning the rest of the fleet.
    ``table`` carries whatever partial predictions were computed, the same
    shape as ``PlanDecision.table``.
    """

    query: str
    reason: str
    table: Optional[Dict[Tuple[str, int], float]] = None

    def __bool__(self) -> bool:   # `if plan:` reads as "is it feasible?"
        return False


PlanResult = Union[PlanDecision, NoFeasiblePlan]


class Planner:
    """The ML-optimizer front end (Fig 2)."""

    def __init__(self, models: Dict[str, CombinedModel]):
        self.models = dict(models)

    def fastest_to_epsilon(self, eps: float,
                           m_grid: Sequence[int]) -> PlanResult:
        table: Dict[Tuple[str, int], float] = {}
        best: Optional[PlanDecision] = None
        for name, model in self.models.items():
            for m in m_grid:
                t = model.time_to_epsilon(eps, int(m))
                if t is None:
                    continue
                table[(name, int(m))] = t
                if best is None or t < best.predicted_time:
                    best = PlanDecision(name, int(m), predicted_time=t)
        if best is None:
            return NoFeasiblePlan(
                query="fastest_to_epsilon",
                reason=f"no (algorithm, m) reaches eps={eps} within "
                       f"max_iters over {len(self.models)} model(s), "
                       f"m_grid={list(m_grid)}",
                table=table)
        best.table = table
        return best

    def best_within_budget(self, t_budget: float,
                           m_grid: Sequence[int]) -> PlanResult:
        table: Dict[Tuple[str, int], float] = {}
        best: Optional[PlanDecision] = None
        for name, model in self.models.items():
            for m in m_grid:
                v = float(model.h(t_budget, int(m))[0])
                table[(name, int(m))] = v
                if not np.isfinite(v):
                    continue
                if best is None or v < best.predicted_value:
                    best = PlanDecision(name, int(m), predicted_value=v)
        if best is None:
            return NoFeasiblePlan(
                query="best_within_budget",
                reason=f"no finite prediction within budget {t_budget}s "
                       f"({len(self.models)} model(s), m_grid={list(m_grid)})",
                table=table)
        best.table = table
        return best
