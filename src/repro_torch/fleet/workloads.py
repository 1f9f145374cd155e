"""Fleet workloads: training jobs and serving deployments, model-costed.

The fleet scheduler never executes a workload to find out what it needs —
it asks the workload's Hemingway model, exactly the way the paper's
ML-optimizer answers "how many processors" for a single job:

  * ``TrainingJob`` carries a ``core.hemingway.CombinedModel``; admission,
    sizing, and deadline checks all go through
    ``CombinedModel.time_to_epsilon`` / ``Planner.fastest_to_epsilon``
    (which returns a typed ``NoFeasiblePlan`` when the target is
    unreachable — the scheduler records it instead of crashing).
  * ``ServeDeployment`` carries a fitted ``serve.planner.CapacityPlanner``
    plus a diurnal/bursty ``RequestTrace``; replica targets come from
    ``CapacityPlanner.plan`` and achieved latency from the same step
    model the planner fitted.

Progress is tracked in *work fractions* (the standard malleable-job
model): a job that has completed fraction p at parallelism m needs
``(1 - p) * time_to_epsilon(eps, m)`` more seconds, so the scheduler can
resize mid-run and the accounting stays consistent.

The port's copy of ``repro/fleet/workloads.py``, unchanged but for its
imports: the request traces draw from Python's ``random`` and the models
are numpy, so the port's draws and plans are the reference's bits.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.ernest import ErnestModel
from repro_torch.core.hemingway import (
    CombinedModel,
    NoFeasiblePlan,
    Planner,
    PlanResult,
)
from repro_torch.serve.planner import CapacityPlanner, decision_batch


# ---------------------------------------------------------------------------
# Request-rate traces (the serving load)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RequestTrace:
    """Deterministic per-tick request rate (QPS) for one deployment.

    Generated once from a seed (diurnal sine + seeded bursts) or loaded
    from JSON; the fleet simulator replays it, never re-draws it."""

    seed: int
    tick_s: float
    qps: List[float]

    @classmethod
    def diurnal(cls, seed: int, ticks: int, tick_s: float, *,
                base_qps: float, peak_qps: float, peak_frac: float = 0.58,
                burst_prob: float = 0.04, burst_mult: float = 1.8,
                burst_ticks: int = 3) -> "RequestTrace":
        """One day of load: a sine with its peak at ``peak_frac`` of the
        horizon, plus short seeded bursts (traffic spikes)."""
        rng = random.Random(seed)
        qps: List[float] = []
        burst_left, burst_scale = 0, 1.0
        for t in range(ticks):
            phase = 2.0 * math.pi * (t / ticks - peak_frac)
            diurnal = base_qps + (peak_qps - base_qps) * 0.5 * (
                1.0 + math.cos(phase))
            if burst_left > 0:
                burst_left -= 1
            elif rng.random() < burst_prob:
                burst_left = burst_ticks
                burst_scale = rng.uniform(1.2, burst_mult)
            scale = burst_scale if burst_left > 0 else 1.0
            qps.append(round(diurnal * scale, 6))
        return cls(seed=seed, tick_s=tick_s, qps=qps)

    # ------------------------------------------------------------------
    def qps_at(self, tick: int) -> float:
        return self.qps[min(tick, len(self.qps) - 1)]

    def forecast(self, tick: int, window: int) -> float:
        """Max demand over the next ``window`` ticks — the scheduler plans
        capacity against the near-term peak, not the instant."""
        lo = min(tick, len(self.qps) - 1)
        hi = min(tick + max(window, 1), len(self.qps))
        return max(self.qps[lo:hi])

    def to_json(self) -> Dict[str, Any]:
        return {"seed": self.seed, "tick_s": self.tick_s, "qps": self.qps}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "RequestTrace":
        return cls(seed=int(d["seed"]), tick_s=float(d["tick_s"]),
                   qps=[float(q) for q in d["qps"]])


# ---------------------------------------------------------------------------
# Analytic model builders (deterministic, no curve-fitting noise)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AnalyticConvergence:
    """Closed-form g(i, m) with the paper's communication-avoiding shape:
    gap(i, m) = gap0 * exp(-rate * i / m**alpha).  ``alpha`` < 1 means
    more machines need proportionally more iterations (Fig 1b), which is
    what gives time-to-epsilon its interior optimum over m.

    Implements the slice of the ConvergenceModel interface CombinedModel
    uses (``predict`` + ``p_star``), so the canonical fleet scenarios are
    bit-stable across machines; fitted ConvergenceModels drop in
    unchanged (see ``repro_torch.quickstart`` for the fitted path)."""

    p_star: float
    gap0: float
    rate: float
    alpha: float = 0.35

    def predict(self, i, m: float) -> np.ndarray:
        i = np.atleast_1d(np.asarray(i, np.float64))
        with np.errstate(over="ignore"):
            return self.p_star + self.gap0 * np.exp(
                -self.rate * i / float(m) ** self.alpha)


def training_model(*, compute_s: float, floor_s: float = 0.5,
                   log_s: float = 0.3, per_m_s: float = 0.05,
                   gap0: float = 1.0, rate: float = 2.5e-3,
                   alpha: float = 0.35, p_star: float = 0.0,
                   m_fit_grid: Sequence[int] = (1, 2, 4, 8, 16),
                   max_iters: int = 200_000) -> CombinedModel:
    """A CombinedModel from analytic curves: f(m) is a real ErnestModel
    NNLS-fitted on the BSP cost family (compute/m + log-tree comm + per-task
    + floor), g(i, m) is :class:`AnalyticConvergence`."""
    ms = np.asarray(m_fit_grid, np.float64)
    t_iter = (compute_s / ms + log_s * np.log(ms + 1.0)
              + per_m_s * ms + floor_s)
    system = ErnestModel().fit(ms, np.ones_like(ms), t_iter)
    conv = AnalyticConvergence(p_star=p_star, gap0=gap0, rate=rate,
                               alpha=alpha)
    return CombinedModel(system, conv, data_size=1.0, max_iters=max_iters)


def serve_capacity_planner(*, dispatch_s: float, per_seq_s: float,
                           log_b_s: float = 0.0,
                           fleet_overhead_s: float = 1e-3,
                           batch_grid: Sequence[int] = (1, 2, 4, 8, 16),
                           ) -> CapacityPlanner:
    """A fitted CapacityPlanner from an analytic step model
    t(b) = dispatch + per_seq*b + log_b*log b — the same three Ernest terms
    the planner fits from live telemetry, here supplied noise-free."""
    planner = CapacityPlanner(fleet_overhead_s_per_log_m=fleet_overhead_s)
    for b in batch_grid:
        for _ in range(2):   # NNLS wants a few rows; exact duplicates fine
            planner.observe(b, dispatch_s + per_seq_s * b
                            + log_b_s * math.log(b))
    return planner.fit()


# ---------------------------------------------------------------------------
# Training jobs
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TrainingJob:
    """A deadline-constrained training run, costed by its CombinedModel.

    The scheduler owns all mutable state below the config block; an
    optional ``executor`` implementing the chaos-loop contract
    (``m``/``resize``/``outer_step``/``checkpoint``/``restore`` — e.g.
    ``optim.simcluster.SSPLocalSGD`` or ``launch.train.TrainerExecutor``,
    which re-shards through ``elastic.rescale_training_state``) is driven
    alongside the modeled progress so resizes exercise the real elastic
    path."""

    name: str
    model: CombinedModel
    eps: float
    arrival_s: float
    deadline_s: float            # absolute (seconds since fleet start)
    m_options: Tuple[int, ...]
    ckpt_every_s: float = 1800.0
    executor: Optional[Any] = None
    # what one restore/re-shard of this job ACTUALLY costs (the async
    # sharded checkpoint + live-migration path both reduce to placing
    # shards from the last manifest onto a mesh, so one number prices
    # both ops).  None = the scheduler's assumed config constants are
    # accurate, which keeps pre-existing golden scenarios bit-identical.
    actual_recovery_s: Optional[float] = None

    # -- scheduler-owned state -----------------------------------------
    state: str = "pending"       # pending -> queued -> running -> done
    #                              (or infeasible, with no_plan set)
    m: int = 0
    progress: float = 0.0        # completed work fraction in [0, 1]
    pace_factor: float = 1.0     # streaming-refit multiplier on remaining
    #                              time (>1: the cluster is delivering work
    #                              slower than the model assumed; set by the
    #                              scheduler's drift detector, never drawn)
    ckpt_progress: float = 0.0   # last checkpointed fraction
    since_ckpt_s: float = 0.0
    penalty_s: float = 0.0       # pending restore/reshard seconds to pay
    finish_s: Optional[float] = None
    no_plan: Optional[NoFeasiblePlan] = None
    objective: Optional[float] = None   # executor's trajectory, if attached
    _t_eps_cache: Dict[int, Optional[float]] = dataclasses.field(
        default_factory=dict, repr=False)

    # ------------------------------------------------------------------
    def planner(self) -> Planner:
        return Planner({self.name: self.model})

    def time_to_eps(self, m: int) -> Optional[float]:
        # pure in (eps, m) for a fixed model, and on the scheduler's
        # per-tick hot path — the bisection runs once per (job, m)
        m = int(m)
        if m not in self._t_eps_cache:
            self._t_eps_cache[m] = self.model.time_to_epsilon(self.eps, m)
        return self._t_eps_cache[m]

    def remaining_s(self, m: int) -> Optional[float]:
        t = self.time_to_eps(m)
        if t is None:
            return None
        return (1.0 - self.progress) * t * self.pace_factor + self.penalty_s

    def admission_plan(self) -> PlanResult:
        """The Hemingway query behind admission: fastest (m, t) per option.
        Returns the typed NoFeasiblePlan when the target is unreachable."""
        return self.planner().fastest_to_epsilon(self.eps, self.m_options)

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Compact per-tick state for the run log."""
        s: Dict[str, Any] = {"state": self.state, "m": self.m,
                             "prog": round(self.progress, 9)}
        if self.objective is not None:
            s["obj"] = round(self.objective, 9)
        return s


# ---------------------------------------------------------------------------
# Serving deployments
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ServeDeployment:
    """A latency-SLO serving deployment under a time-varying load trace.

    Replica targets come from ``CapacityPlanner.plan`` (the serve-side
    fastest-to-epsilon analogue); per-tick achieved latency comes from the
    same fitted step model at the current effective replica count, with a
    utilization-dependent tail factor so under-provisioning surfaces as a
    p95 violation rather than silently queueing forever."""

    name: str
    planner: CapacityPlanner
    trace: RequestTrace
    slo_p95_s: float
    gen_tokens: int
    batch_grid: Tuple[int, ...]
    replica_options: Tuple[int, ...]
    p95_margin: float = 1.5      # plan p50 target = slo_p95 / margin
    tail_k: float = 0.45         # p95 ~= p50 * (1 + tail_k * utilization^2)

    # -- scheduler-owned state -----------------------------------------
    replicas: int = 0
    scale_down_votes: int = 0
    latencies: List[float] = dataclasses.field(default_factory=list)

    # ------------------------------------------------------------------
    @property
    def target_p50_s(self) -> float:
        return self.slo_p95_s / self.p95_margin

    def desired_replicas(self, qps: float) -> PlanResult:
        return self.planner.plan(
            target_p50_s=self.target_p50_s, qps=max(qps, 1e-9),
            gen_tokens=self.gen_tokens, batch_grid=self.batch_grid,
            m_grid=self.replica_options)

    def capacity_qps(self, effective_m: float, batch: int) -> float:
        return self.planner.tokens_per_s(batch, effective_m) / self.gen_tokens

    def tick_latency(self, effective_m: float, qps: float) -> float:
        """Modeled p95 latency this tick at ``effective_m`` replicas."""
        effective_m = max(effective_m, 1e-6)
        best = self.planner.best_latency_within_fleet(
            m=effective_m, qps=max(qps, 1e-9), gen_tokens=self.gen_tokens,
            batch_grid=self.batch_grid)
        if best:
            batch = decision_batch(best)
            p50 = best.predicted_time
        else:
            # overloaded: run flat out at max batch; latency inflates with
            # the overload ratio (queueing blow-up, still finite + smooth)
            batch = max(self.batch_grid)
            p50 = self.planner.p50_latency_s(batch, self.gen_tokens,
                                             effective_m)
        util = min(qps / max(self.capacity_qps(effective_m, batch), 1e-9),
                   4.0)
        return p50 * (1.0 + self.tail_k * min(util, 1.0) ** 2
                      + max(util - 1.0, 0.0) ** 2)

    # ------------------------------------------------------------------
    def p95_latency(self) -> float:
        if not self.latencies:
            return 0.0
        lat = sorted(self.latencies)
        idx = min(len(lat) - 1, math.ceil(0.95 * len(lat)) - 1)
        return lat[max(idx, 0)]

    def slo_met(self) -> bool:
        return self.p95_latency() <= self.slo_p95_s

    def observe_router(self, events) -> int:
        """Feed a routed deployment's telemetry (RouterEvent + replica-
        tagged serve_step rows) into this deployment's planner: affinity-hit
        rate and measured per-replica throughput then show up in snapshots
        and in ``measured_effective_m``."""
        return self.planner.ingest(events)

    def measured_effective_m(self) -> float:
        """Measured effective replica count from router telemetry (affinity-
        cold replicas count fractionally); falls back to the provisioned
        count when no routed run has been observed."""
        m = self.planner.measured_effective_replicas()
        return m if m > 0 else float(self.replicas)

    def snapshot(self, qps: float, lat_s: float) -> Dict[str, Any]:
        snap = {"m": self.replicas, "qps": round(qps, 6),
                "lat_s": round(lat_s, 9),
                "ok": bool(lat_s <= self.slo_p95_s)}
        # only present after router telemetry was observed, so golden-trace
        # fixtures recorded without a router replay byte-identically
        if self.planner.router_dispatches:
            snap["affinity"] = round(self.planner.affinity_hit_rate, 6)
        return snap
