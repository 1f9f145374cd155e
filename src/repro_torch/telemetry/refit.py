"""Streaming model refits + residual-based drift detection.

Hemingway's models (Ernest ``f(m)``, the convergence model ``g(i, m)``,
the serve ``CapacityPlanner``) are fit once from an offline profiling
pass.  This module makes them *streaming*: each wrapper keeps a sliding
window of live observations from the telemetry bus, watches the model's
normalized prediction error

    r_t = |actual_t - predicted_t| / max(|predicted_t|, eps)

averaged over the last ``window`` points, and when the mean residual
crosses ``threshold`` it raises a typed ``DriftDetected`` event and
re-fits the model from the trailing window — emitting a ``RefitEvent``
that records the residual before and after the refit, so callers can
assert the refit actually helped.

Nothing here imports serve/fleet modules at import time; the wrappers
are handed their model objects, which keeps the bus dependency-free and
cycle-free.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from dataclasses import dataclass
from typing import Deque, List, Optional, Tuple

import numpy as np

from .events import CkptCostEvent, DriftDetected, RefitEvent


@dataclass(frozen=True)
class DriftConfig:
    """Knobs for the residual-based drift detector."""

    window: int = 16  # sliding window of normalized residuals
    threshold: float = 0.3  # mean |err|/|pred| that counts as drift
    min_points: int = 6  # don't judge before this many observations
    cooldown: int = 24  # steps to stay quiet after firing
    eps: float = 1e-9  # normalization floor


class DriftDetector:
    """Sliding-window normalized prediction error vs a threshold."""

    def __init__(self, model_name: str, cfg: Optional[DriftConfig] = None):
        self.model_name = model_name
        self.cfg = cfg or DriftConfig()
        self._errs: Deque[float] = deque(maxlen=self.cfg.window)
        self._quiet_until = -1

    def residual(self) -> float:
        if not self._errs:
            return 0.0
        return float(np.mean(self._errs))

    def observe(self, step: int, predicted: float, actual: float) -> Optional[DriftDetected]:
        err = abs(actual - predicted) / max(abs(predicted), self.cfg.eps)
        self._errs.append(err)
        if len(self._errs) < self.cfg.min_points or step < self._quiet_until:
            return None
        resid = self.residual()
        if resid <= self.cfg.threshold:
            return None
        self._quiet_until = step + self.cfg.cooldown
        return DriftDetected(
            step=step,
            model=self.model_name,
            residual=resid,
            threshold=self.cfg.threshold,
            window=self.cfg.window,
        )

    def reset(self) -> None:
        self._errs.clear()


class StreamingErnest:
    """Windowed re-fit of an ErnestModel from live (m, size, time) points.

    The wrapped model is re-fit *in place* (``ErnestModel.fit`` mutates
    ``theta`` and returns ``self``), so handing this the controller's own
    model instance propagates refits to every consumer automatically.
    """

    def __init__(
        self,
        model,
        cfg: Optional[DriftConfig] = None,
        *,
        window: int = 64,
        refit_every: int = 0,
        name: str = "ernest",
    ):
        self.model = model
        self.name = name
        self.detector = DriftDetector(name, cfg)
        self._obs: Deque[Tuple[int, float, float]] = deque(maxlen=window)
        self.refit_every = refit_every
        self._since_fit = 0

    def _refit(self, step: int) -> Optional[RefitEvent]:
        if len(self._obs) < 2:
            return None
        m = np.array([o[0] for o in self._obs], dtype=float)
        size = np.array([o[1] for o in self._obs], dtype=float)
        t = np.array([o[2] for o in self._obs], dtype=float)
        if len(set(m.tolist())) < 2:
            return None  # NNLS needs variation in m to identify terms
        before = self.detector.residual()
        self.model.fit(m, size, t)
        pred = np.asarray(self.model.predict(m, size), dtype=float)
        after = float(np.mean(np.abs(t - pred) / np.maximum(np.abs(pred), self.detector.cfg.eps)))
        self._since_fit = 0
        return RefitEvent(
            step=step,
            model=self.name,
            n_obs=len(self._obs),
            residual_before=before,
            residual_after=after,
        )

    def observe(self, step: int, m: int, size: float, actual_s: float) -> List:
        """Feed one live measurement; returns drift/refit events raised."""
        pred = float(np.asarray(self.model.predict(np.array([m]), np.array([size])))[0])
        self._obs.append((m, size, actual_s))
        self._since_fit += 1
        out: List = []
        drift = self.detector.observe(step, pred, actual_s)
        if drift is not None:
            out.append(drift)
            refit = self._refit(step)
            if refit is not None:
                out.append(refit)
                self.detector.reset()
        elif self.refit_every and self._since_fit >= self.refit_every:
            refit = self._refit(step)
            if refit is not None:
                out.append(refit)
        return out


class StreamingCost:
    """Windowed estimate of an operation's measured wall-time vs an
    assumed planning constant.

    Planners (the fleet scheduler, ``AdaptiveController``) price every
    restore/re-shard with a fixed assumed constant.  This wrapper ingests
    the *measured* wall-times the fault-tolerance machinery actually
    reports (``ckpt_cost`` events), and when the drift detector sees the
    assumption is persistently wrong it re-fits the estimate to the
    trailing-window mean — ``estimate_s`` then answers with the learned
    cost instead of the assumption, and the refit event records how far
    off the assumption was.
    """

    def __init__(
        self,
        name: str,
        assumed_s: float,
        cfg: Optional[DriftConfig] = None,
        *,
        window: int = 32,
    ):
        self.name = name
        self.assumed_s = float(assumed_s)
        self.detector = DriftDetector(name, cfg)
        self._obs: Deque[float] = deque(maxlen=window)
        self.learned: Optional[float] = None

    @property
    def estimate_s(self) -> float:
        """The learned cost once refit; the assumed constant until then."""
        return self.learned if self.learned is not None else self.assumed_s

    def observe(self, step: int, measured_s: float, *, op: str = "restore", workload: str = "") -> List:
        """Feed one measured wall-time; returns [CkptCostEvent, drift?, refit?]."""
        self._obs.append(float(measured_s))
        out: List = [
            CkptCostEvent(
                step=step,
                op=op,
                wall_s=float(measured_s),
                assumed_s=self.estimate_s,
                workload=workload,
            )
        ]
        drift = self.detector.observe(step, self.estimate_s, measured_s)
        if drift is not None:
            out.append(drift)
            before = drift.residual
            self.learned = float(np.mean(self._obs))
            after = float(
                np.mean([abs(o - self.learned) / max(abs(self.learned), self.detector.cfg.eps) for o in self._obs])
            )
            out.append(
                RefitEvent(
                    step=step,
                    model=self.name,
                    n_obs=len(self._obs),
                    residual_before=before,
                    residual_after=after,
                )
            )
            self.detector.reset()
        return out


class StreamingCapacity:
    """Windowed re-fit of a CapacityPlanner's f(batch) step model."""

    def __init__(
        self,
        planner,
        cfg: Optional[DriftConfig] = None,
        *,
        window: int = 128,
        name: str = "capacity",
    ):
        self.planner = planner
        self.name = name
        self.detector = DriftDetector(name, cfg)
        self._obs: Deque[Tuple[int, float]] = deque(maxlen=window)

    def _refit(self, step: int) -> Optional[RefitEvent]:
        from repro_torch.serve.planner import ServeObservation  # lazy: avoids an import cycle

        batches = {b for b, _ in self._obs}
        if len(batches) < 2:
            return None
        before = self.detector.residual()
        self.planner.observations = [ServeObservation(int(b), float(s)) for b, s in self._obs]
        self.planner.fit()
        errs = [
            abs(s - self.planner.step_time(b)) / max(abs(self.planner.step_time(b)), 1e-9)
            for b, s in self._obs
        ]
        after = float(np.mean(errs))
        return RefitEvent(
            step=step,
            model=self.name,
            n_obs=len(self._obs),
            residual_before=before,
            residual_after=after,
        )

    def observe(self, step: int, batch: int, step_s: float) -> List:
        self._obs.append((batch, step_s))
        if self.planner.step_model.theta is None:
            return []  # planner not fit yet — accumulate only
        pred = float(self.planner.step_time(batch))
        out: List = []
        drift = self.detector.observe(step, pred, step_s)
        if drift is not None:
            out.append(drift)
            refit = self._refit(step)
            if refit is not None:
                out.append(refit)
                self.detector.reset()
        return out


class StreamingConvergence:
    """Windowed re-fit of an AnalyticConvergence-style gap model.

    The analytic model is ``gap(i, m) = gap0 * exp(-rate * i / m**alpha)``
    (plateau ``p_star`` added back on top).  With ``alpha`` and ``p_star``
    held fixed, ``log gap = log gap0 - rate * (i / m**alpha)`` is linear
    in ``(1, i/m**alpha)`` — a two-parameter least-squares refit from the
    trailing window of (iteration, m, objective) points.
    """

    def __init__(
        self,
        model,
        cfg: Optional[DriftConfig] = None,
        *,
        window: int = 64,
        name: str = "convergence",
    ):
        self.model = model  # duck-typed: .p_star, .gap0, .rate, .alpha, .predict
        self.name = name
        self.detector = DriftDetector(name, cfg)
        self._obs: Deque[Tuple[float, int, float]] = deque(maxlen=window)

    def _refit(self, step: int) -> Optional[RefitEvent]:
        pts = [(i, m, v) for i, m, v in self._obs if v - self.model.p_star > 1e-12]
        if len(pts) < 4:
            return None
        before = self.detector.residual()
        x = np.array([i / (m**self.model.alpha) for i, m, _ in pts])
        y = np.log([v - self.model.p_star for _, _, v in pts])
        A = np.stack([np.ones_like(x), -x], axis=1)
        coef, *_ = np.linalg.lstsq(A, y, rcond=None)
        gap0 = float(np.exp(coef[0]))
        rate = max(float(coef[1]), 1e-9)
        self.model = dataclasses.replace(self.model, gap0=gap0, rate=rate)
        errs = []
        for i, m, v in pts:
            p = float(np.asarray(self.model.predict(i, m))[0])
            errs.append(abs(v - p) / max(abs(p), 1e-9))
        after = float(np.mean(errs))
        return RefitEvent(
            step=step,
            model=self.name,
            n_obs=len(pts),
            residual_before=before,
            residual_after=after,
        )

    def observe(self, step: int, iteration: float, m: int, objective: float) -> List:
        self._obs.append((iteration, m, objective))
        pred = float(np.asarray(self.model.predict(iteration, m))[0])
        out: List = []
        drift = self.detector.observe(step, pred, objective)
        if drift is not None:
            out.append(drift)
            refit = self._refit(step)
            if refit is not None:
                out.append(refit)
                self.detector.reset()
        return out
