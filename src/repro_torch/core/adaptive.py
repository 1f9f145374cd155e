"""Adaptive parallelism controller (§6 "Adaptive algorithms").

During a training run the controller ingests (iteration, m, objective)
observations, periodically refits the convergence model on a trailing
window, and — combined with the Ernest system model and a re-shard cost —
recommends growing/shrinking the data-parallel degree.  The elastic trainer
(repro.runtime.elastic) executes the recommendation by re-sharding onto a
new mesh from the latest checkpoint.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.convergence import ConvergenceData, ConvergenceModel
from repro_torch.core.ernest import ErnestModel
from repro_torch.core.features import FeatureLibrary


@dataclasses.dataclass
class Observation:
    iteration: int
    m: int
    value: float


@dataclasses.dataclass
class ResizeDecision:
    resize: bool
    target_m: int
    reason: str
    predicted_remaining_current: Optional[float] = None
    predicted_remaining_target: Optional[float] = None


class AdaptiveController:
    def __init__(
        self,
        system: ErnestModel,
        *,
        target_gap: float,
        p_star: float,
        m_options: Sequence[int],
        data_size: float = 1.0,
        refit_every: int = 25,
        window: int = 200,
        reshard_cost_s: float = 30.0,
        min_observations: int = 30,
        library: Optional[FeatureLibrary] = None,
        hysteresis: float = 0.9,
    ):
        self.system = system
        self.target_gap = target_gap
        self.p_star = p_star
        self.m_options = sorted(set(int(m) for m in m_options))
        self.data_size = data_size
        self.refit_every = refit_every
        self.window = window
        self.reshard_cost_s = reshard_cost_s
        self.min_observations = min_observations
        self.library = library or FeatureLibrary()
        self.hysteresis = hysteresis
        self.observations: List[Observation] = []
        self.model: Optional[ConvergenceModel] = None
        self._since_refit = 0
        self.decisions: List[ResizeDecision] = []

    # ------------------------------------------------------------------
    def set_m_options(self, m_options: Sequence[int]) -> None:
        """Replace the candidate cluster sizes (elastic capacity changed)."""
        self.m_options = sorted(set(int(m) for m in m_options))

    # ------------------------------------------------------------------
    def observe(self, iteration: int, m: int, value: float) -> Optional[ResizeDecision]:
        self.observations.append(Observation(iteration, m, value))
        self._since_refit += 1
        if (len(self.observations) < self.min_observations
                or self._since_refit < self.refit_every):
            return None
        self._since_refit = 0
        self._refit()
        return self._decide(iteration, m, value)

    # ------------------------------------------------------------------
    def _refit(self) -> None:
        obs = self.observations[-self.window:]
        data = ConvergenceData(
            i=np.asarray([o.iteration for o in obs], np.float64),
            m=np.asarray([o.m for o in obs], np.float64),
            value=np.asarray([o.value for o in obs], np.float64),
            p_star=self.p_star,
        )
        try:
            self.model = ConvergenceModel(self.library).fit(data, cv_folds=3)
        except Exception:
            self.model = None

    def _remaining_time(self, now_iter: int, now_value: float, m: int) -> Optional[float]:
        """Predicted seconds until gap <= target on m machines, from now."""
        assert self.model is not None
        f_m = float(self.system.predict(m, self.data_size))
        # find iterations needed (on m machines) for predicted gap <= target
        lo, hi = now_iter + 1, now_iter + 200_000

        def pred_gap(i: int) -> float:
            # a non-monotone or degenerate fit can predict exploding gaps;
            # treat any non-finite prediction as "never reaches the target"
            with np.errstate(over="ignore", invalid="ignore"):
                g = float(self.model.predict(
                    np.asarray([i], np.float64), m)[0] - self.p_star)
            return g if np.isfinite(g) else np.inf

        if pred_gap(hi) > self.target_gap:
            return None
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if pred_gap(mid) <= self.target_gap:
                hi = mid
            else:
                lo = mid
        return (hi - now_iter) * f_m

    def _decide(self, iteration: int, m: int, value: float) -> Optional[ResizeDecision]:
        if self.model is None:
            return None
        current = self._remaining_time(iteration, value, m)
        best_m, best_t = m, current
        for m_opt in self.m_options:
            if m_opt == m:
                continue
            t = self._remaining_time(iteration, value, m_opt)
            if t is None:
                continue
            t_total = t + self.reshard_cost_s
            if best_t is None or t_total < (best_t if best_m != m
                                            else best_t * self.hysteresis):
                best_m, best_t = m_opt, t_total
        if best_m != m:
            d = ResizeDecision(
                resize=True, target_m=best_m,
                reason=f"predicted remaining {best_t:.1f}s on m={best_m} vs "
                       f"{'inf' if current is None else f'{current:.1f}s'} on m={m}",
                predicted_remaining_current=current,
                predicted_remaining_target=best_t)
        else:
            d = ResizeDecision(resize=False, target_m=m, reason="stay",
                               predicted_remaining_current=current)
        self.decisions.append(d)
        return d
