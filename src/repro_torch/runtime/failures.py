"""Failure injection + restart policy (node-failure tolerance).

In a real deployment the runtime watches for missing heartbeats /
NCCL-equivalent timeouts; in this single-process harness `FailureInjector`
deterministically raises ``SimulatedFailure`` at configured steps and the
driver's recovery path (catch -> restore latest checkpoint -> rebuild mesh
-> continue) is exactly the code a real restart would execute.

The port's copy of ``repro/runtime/failures.py`` (pure Python), held by
tests/test_torch_chaos.py.
"""
from __future__ import annotations

import dataclasses
from typing import Set


class SimulatedFailure(RuntimeError):
    def __init__(self, step: int, kind: str = "node_lost"):
        super().__init__(f"simulated {kind} at step {step}")
        self.step = step
        self.kind = kind


@dataclasses.dataclass
class FailureInjector:
    fail_at_steps: Set[int] = dataclasses.field(default_factory=set)
    kinds: str = "node_lost"
    fired: Set[int] = dataclasses.field(default_factory=set)

    @classmethod
    def at(cls, *steps: int) -> "FailureInjector":
        return cls(fail_at_steps=set(steps))

    def schedule(self, step: int) -> None:
        """Arm a failure at ``step`` mid-run — the chaos loop translates
        trace preemption events into injector schedules so recovery runs
        through the same catch/restore path a real heartbeat loss would."""
        self.fail_at_steps.add(step)

    def check(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFailure(step, self.kinds)


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 5
    backoff_s: float = 0.0
    restarts_used: int = 0

    def should_restart(self) -> bool:
        if self.restarts_used >= self.max_restarts:
            return False
        self.restarts_used += 1
        return True
