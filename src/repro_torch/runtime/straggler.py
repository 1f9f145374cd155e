"""Straggler detection + mitigation decisions.

BSP steps run at the speed of the slowest participant.  The monitor keeps
an EWMA + variance of step times; a step slower than
``mean + threshold_sigmas * std`` (and slower than ``min_ratio`` x mean) is
flagged.  After ``consecutive`` flags it recommends mitigation:

  * "rebalance"  — shrink the slow host's data shard (the driver reshards
                   via the elastic path)
  * "hot_spare"  — swap the slow host for a standby and restore from the
                   latest checkpoint
  * "sync_relax" — switch the trainer to local-SGD (H>1) so one slow host
                   only hurts its own shard between syncs

The decision layer is driver-level by design: Hemingway's own Ernest model
supplies the expected step time, so "slow" is defined against the model's
prediction, not just history (a cluster-wide slowdown is not a straggler).

The port's copy of ``repro/runtime/straggler.py`` (pure Python).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional


@dataclasses.dataclass
class StragglerEvent:
    step: int
    step_time: float
    expected: float
    action: str
    host: int = -1   # slowest host when per-host times were supplied and
    #                  one host stands out; -1 = cluster-wide (no target)


class StragglerMonitor:
    def __init__(self, threshold_sigmas: float = 3.0, min_ratio: float = 1.5,
                 consecutive: int = 3, ewma: float = 0.05,
                 expected_time: Optional[float] = None,
                 host_ratio: float = 1.3):
        self.threshold_sigmas = threshold_sigmas
        self.min_ratio = min_ratio
        self.consecutive = consecutive
        self.ewma = ewma
        self.expected_time = expected_time  # Ernest prediction, if available
        self.host_ratio = host_ratio  # outlier-host attribution threshold
        self.mean: Optional[float] = None
        self.var: float = 0.0
        self._flags = 0
        self.events: List[StragglerEvent] = []

    def reset(self, expected_time: Optional[float] = None) -> None:
        """Re-anchor after a legitimate step-time level shift (resize): new
        EWMA baseline, optionally a fresh Ernest expectation for the new m."""
        self.mean = None
        self.var = 0.0
        self._flags = 0
        self.expected_time = expected_time

    def _attribute(self, host_times: Optional[Dict[int, float]]) -> int:
        """Name the straggling host — only when one host is genuinely the
        outlier (a cluster-wide slowdown has no target to mitigate)."""
        if not host_times or len(host_times) < 2:
            return -1
        ordered = sorted(host_times.items(), key=lambda kv: kv[1])
        worst_host, worst = ordered[-1]
        runner_up = ordered[-2][1]
        if worst > self.host_ratio * max(runner_up, 1e-12):
            return worst_host
        return -1

    def observe(self, step: int, step_time: float,
                host_times: Optional[Dict[int, float]] = None
                ) -> Optional[StragglerEvent]:
        if self.mean is None:
            self.mean = step_time
            return None
        std = math.sqrt(max(self.var, 1e-12))
        baseline = self.expected_time or self.mean
        slow = (step_time > self.mean + self.threshold_sigmas * std
                and step_time > self.min_ratio * baseline)
        # update stats with non-outlier steps only
        if not slow:
            delta = step_time - self.mean
            self.mean += self.ewma * delta
            self.var = (1 - self.ewma) * (self.var + self.ewma * delta * delta)
            self._flags = 0
            return None
        self._flags += 1
        if self._flags < self.consecutive:
            return None
        self._flags = 0
        ratio = step_time / baseline
        action = ("hot_spare" if ratio > 4.0
                  else "rebalance" if ratio > 2.0 else "sync_relax")
        ev = StragglerEvent(step, step_time, baseline, action,
                            host=self._attribute(host_times))
        self.events.append(ev)
        return ev
