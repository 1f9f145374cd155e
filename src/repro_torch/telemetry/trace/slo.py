"""SLO error-budget + burn-rate monitoring over latency objectives.

An ``SLOMonitor`` watches one objective — join-to-first-token steps,
per-token decode latency, fleet tick p95 — as a stream of observations.
Each observation is *good* (under ``target``) or *bad*; the allowed bad
fraction is the error budget.  When the bad fraction over the rolling
window exceeds ``burn_threshold`` times the budget, the monitor emits a
typed ``SloAlertEvent``: the classic SRE fast-burn page.

Why this beats the drift detector to the punch: the
``DriftDetector`` needs a *window mean* of normalized residuals to cross
its threshold (``min_points`` sustained observations), while a burn-rate
monitor fires as soon as a couple of bad points land in a short window.
On the golden 2x-slowdown scenario the SLO alert lands several steps
before drift — early warning the ``CapacityPlanner`` and the fleet
autoscaler consume (extra headroom) while the refit loop catches up.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Iterable, List, Optional

from ..events import Event, SloAlertEvent


@dataclass(frozen=True)
class SloConfig:
    """Tunables for one SLO objective.

    ``budget`` is the allowed bad fraction (0.05 = 95% of observations
    must meet ``target``); ``burn_threshold`` is how many times the
    sustainable burn rate triggers an alert (2x = classic fast burn)."""

    target: float
    budget: float = 0.05
    window: int = 16
    burn_threshold: float = 2.0
    min_points: int = 4
    cooldown: int = 16

    def __post_init__(self):
        if self.target <= 0.0:
            raise ValueError(f"target must be positive, got {self.target}")
        if not 0.0 < self.budget < 1.0:
            raise ValueError(f"budget must be in (0, 1), got {self.budget}")


class SLOMonitor:
    """Rolling error-budget accountant for one latency objective."""

    def __init__(self, cfg: SloConfig, *, name: str = "slo", objective: str = "latency"):
        self.cfg = cfg
        self.name = name
        self.objective = objective
        self._window: Deque[bool] = deque(maxlen=cfg.window)
        self._seen = 0
        self._bad = 0
        self._last_alert_step: Optional[int] = None
        self.alerts: List[SloAlertEvent] = []

    # -- accounting ----------------------------------------------------------

    @property
    def burn_rate(self) -> float:
        """Window bad-fraction divided by the budget (1.0 = sustainable)."""
        if not self._window:
            return 0.0
        bad = sum(self._window)
        return (bad / len(self._window)) / self.cfg.budget

    def budget_remaining(self) -> float:
        """Lifetime error budget left, 1.0 (untouched) down to 0.0 (spent)."""
        if not self._seen:
            return 1.0
        consumed = (self._bad / self._seen) / self.cfg.budget
        return max(0.0, 1.0 - consumed)

    # -- observation ---------------------------------------------------------

    def observe(self, step: int, value: float) -> Optional[SloAlertEvent]:
        """Feed one measurement; returns an alert iff one fires this step."""
        bad = float(value) > self.cfg.target
        self._window.append(bad)
        self._seen += 1
        self._bad += int(bad)
        if len(self._window) < self.cfg.min_points:
            return None
        if self.burn_rate < self.cfg.burn_threshold:
            return None
        if self._last_alert_step is not None and step - self._last_alert_step < self.cfg.cooldown:
            return None
        self._last_alert_step = step
        alert = SloAlertEvent(
            step=int(step),
            slo=self.name,
            objective=self.objective,
            target=self.cfg.target,
            burn_rate=self.burn_rate,
            budget=self.cfg.budget,
            window_bad=int(sum(self._window)),
            window=len(self._window),
            budget_remaining=self.budget_remaining(),
        )
        self.alerts.append(alert)
        return alert


def monitor_serve_events(
    events: Iterable[Event],
    *,
    per_token: Optional[SloConfig] = None,
    join_first_token: Optional[SloConfig] = None,
    name: str = "serve",
) -> List[SloAlertEvent]:
    """Replay a serve event stream through SLO monitors; return alerts.

    * ``per_token`` watches ``serve_step`` decode/verify latency per
      committed token (seconds);
    * ``join_first_token`` watches request join-to-first-token in steps,
      read from ``span`` events the scheduler emits at admission
      (``scheduler.join`` spans carry ``wait_steps``).
    """
    alerts: List[SloAlertEvent] = []
    tok = SLOMonitor(per_token, name=name, objective="per_token_latency") if per_token else None
    join = (
        SLOMonitor(join_first_token, name=name, objective="join_to_first_token")
        if join_first_token
        else None
    )
    for ev in events:
        kind = getattr(ev, "kind", None)
        if tok is not None and kind == "serve_step" and ev.op in ("decode", "verify"):
            committed = max(int(ev.committed), 1)
            a = tok.observe(int(ev.step), float(ev.step_s) / committed)
            if a is not None:
                alerts.append(a)
        elif join is not None and kind == "span" and ev.component == "scheduler.join":
            wait = ev.attrs.get("wait_steps")
            if wait is not None:
                a = join.observe(int(ev.step), float(wait))
                if a is not None:
                    alerts.append(a)
    return alerts
