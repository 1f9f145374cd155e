"""Model-driven multi-tenant placement: the fleet scheduler.

One scheduler tick is the Hemingway decision loop lifted to a fleet:

  1. **Reconcile** chaos: hosts that left drop out of allocations (training
     rolls back to its last checkpoint and shrinks; serving re-acquires),
     preempted hosts keep their allocation but lose in-flight work.
  2. **Serve first** (SLO priority): each deployment's replica target comes
     from ``CapacityPlanner.plan`` against the near-term forecast; scale-ups
     may preempt training hosts, scale-downs wait out a patience window.
  3. **Admit training**: ``Planner.fastest_to_epsilon`` over the job's
     m-options; a typed ``NoFeasiblePlan`` (target unreachable, or no m
     meets the deadline) marks the job infeasible *as data*.  Among
     deadline-feasible sizes the scheduler picks the cheapest in
     host-seconds — minimize fleet cost subject to the deadline.
  4. **Resize training**: the same remaining-time-vs-reshard-cost tradeoff
     ``core.adaptive.AdaptiveController`` applies during a single run,
     re-evaluated fleet-wide; decisions are recorded as
     ``core.adaptive.ResizeDecision`` and executed through the job's
     executor (``SSPLocalSGD`` re-partitions; ``launch.train``'s
     ``TrainerExecutor`` goes through ``elastic.rescale_training_state``).
  5. **Account**: modeled progress (work fractions, BSP pace = slowest
     host), per-tick serve latency, cumulative host-seconds.

Everything iterates in sorted order and draws no entropy, so a tick
sequence is a pure function of (chaos trace, request traces, config) —
the replay guarantee ``simulate.FleetRunLog`` is built on.

The port's copy of ``repro/fleet/scheduler.py``, unchanged but for its
imports (the port's ``core``, ``telemetry`` and ``runtime.chaos``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence

from collections import deque

from repro_torch.core.adaptive import ResizeDecision
from repro_torch.core.hemingway import NoFeasiblePlan
from repro_torch.fleet.cluster import FleetCluster
from repro_torch.fleet.workloads import ServeDeployment, TrainingJob
from repro_torch.runtime.chaos import ChaosEvent
from repro_torch.telemetry import (
    DriftConfig,
    DriftDetector,
    Event,
    RefitEvent,
    SpanEvent,
    StreamingCost,
)
from repro_torch.telemetry.trace import SloConfig, SLOMonitor, det_id


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    tick_s: float = 300.0
    serve_headroom: float = 1.15      # capacity target = forecast * headroom
    forecast_ticks: int = 3           # plan against the next-N-ticks peak
    scale_down_patience: int = 3      # consecutive lower targets before down
    reshard_cost_s: float = 120.0     # paid by a job on every resize
    restore_cost_s: float = 240.0     # paid on checkpoint restore
    resize_cooldown_ticks: int = 6    # no-flap guard between job resizes
    resize_hysteresis: float = 0.85   # resize only for >15% host-second win
    shrink_safety: float = 0.7        # shrink only into <70% of the slack:
    #                                   progress pays slack back 1:1, so a
    #                                   comfortable shrink never needs a
    #                                   deadline rescue later (no flapping)
    # opt-in streaming refit of each running job's pace model: watch the
    # modeled vs measured per-tick work rate, and when the normalized
    # residual drifts past the threshold, refit the job's pace factor from
    # the trailing window and force a replanning pass (None = off, which
    # keeps pre-drift golden traces bit-identical)
    drift: Optional[DriftConfig] = None
    # opt-in hierarchical trace spans over *modeled* time: one root span per
    # tick with per-job and per-deployment children (predicted vs delivered
    # work), riding the run log's bus outside rows/signatures — default off
    # so pre-span golden traces stay bit-identical
    spans: bool = False
    # opt-in per-deployment SLO burn-rate monitoring: each deployment's
    # modeled tick latency streams through an SLOMonitor (target = its own
    # slo_p95_s; the config below carries the budget/window tunables), and a
    # fast-burn alert grants the autoscaler extra headroom for a few ticks —
    # early warning that lands several ticks before the drift detector's
    # windowed refit (None = off, same golden-trace guarantee)
    slo: Optional[SloConfig] = None
    # opt-in measured-recovery-cost refit: every restore/re-shard a job
    # actually pays feeds a per-job StreamingCost, and once the detector
    # sees the assumed reshard/restore constants are persistently wrong
    # the learned cost replaces them in resize planning — the feedback
    # loop that lets a cheap async-checkpoint/migration path flip resize
    # decisions the stop-the-world assumption would veto (None = off,
    # which keeps pre-measurement golden traces bit-identical)
    measured: Optional[DriftConfig] = None


# A fired SLO alert boosts the deployment's autoscaling headroom by this
# factor for this many ticks: capacity tops up on the burn signal instead
# of waiting for the (slower) drift refit to reprice the pace model.
SLO_BOOST = 1.25
SLO_BOOST_TICKS = 6


class FleetScheduler:
    def __init__(self, cluster: FleetCluster, jobs: Sequence[TrainingJob],
                 deployments: Sequence[ServeDeployment],
                 cfg: Optional[FleetConfig] = None):
        self.cluster = cluster
        self.cfg = cfg or FleetConfig()
        self.jobs = {j.name: j for j in jobs}
        self.deployments = {d.name: d for d in deployments}
        if set(self.jobs) & set(self.deployments):
            raise ValueError("workload names must be unique across kinds")
        self.resize_decisions: List[ResizeDecision] = []
        self._last_resize: Dict[str, int] = {}
        self.cost_host_s = 0.0
        # streaming pace refit (cfg.drift opt-in): per-job detector + pace
        # window; typed drift/refit events buffer here until the simulator
        # drains them onto the run log's bus after each tick
        self._drift: Dict[str, DriftDetector] = {}
        self._pace_window: Dict[str, deque] = {}
        self._needs_replan: set = set()
        self.pending_events: List[Event] = []
        # measured-recovery-cost estimators (cfg.measured opt-in): one per
        # job; restore AND re-shard observations share it, because both
        # ops reduce to the same place-shards-from-manifest move
        self._recovery_cost: Dict[str, StreamingCost] = {}
        # SLO burn-rate monitors (cfg.slo opt-in): one per deployment,
        # created lazily with the deployment's own p95 target; a fired
        # alert boosts that deployment's autoscale headroom until the
        # recorded expiry tick
        self._slo: Dict[str, SLOMonitor] = {}
        self._slo_boost_until: Dict[str, int] = {}
        # trace identity for cfg.spans: derived from the scheduler config
        # only, so same-scenario runs produce identical span ids; each
        # workload gets its own lane (export maps it to a Perfetto track)
        self._trace_id = det_id("trace", "fleet", self.cfg.tick_s)
        self._lane = {n: i + 1 for i, n in enumerate(
            sorted(self.jobs) + sorted(self.deployments))}

    def drain_events(self) -> List[Event]:
        out, self.pending_events = self.pending_events, []
        return out

    # ------------------------------------------------------------------
    # One tick
    # ------------------------------------------------------------------
    def tick(self, step: int, events: List[ChaosEvent],
             lost: Dict[str, List[int]],
             preempted: Dict[str, List[int]]) -> Dict[str, Any]:
        now_s = step * self.cfg.tick_s
        decisions: List[str] = []

        self._reconcile(step, lost, preempted, decisions)
        self._autoscale_serve(step, now_s, decisions)
        self._admit_training(step, now_s, decisions)
        self._resize_training(step, now_s, decisions)
        self._account_training(step, now_s, decisions)
        serve_row = self._account_serve(step, preempted, decisions)
        if self.cfg.spans:
            self._emit_tick_spans(step, now_s, serve_row)

        self.cost_host_s += self.cluster.n_allocated() * self.cfg.tick_s
        return {
            "step": step,
            "events": [f"{e.kind}:{e.host}" for e in events],
            "decisions": decisions,
            "serve": serve_row,
            "jobs": {n: j.snapshot() for n, j in sorted(self.jobs.items())},
            "free": len(self.cluster.free_hosts()),
            "cost_hh": round(self.cost_host_s / 3600.0, 6),
        }

    # ------------------------------------------------------------------
    # 1. chaos reconciliation
    # ------------------------------------------------------------------
    def _reconcile(self, step: int, lost: Dict[str, List[int]],
                   preempted: Dict[str, List[int]],
                   decisions: List[str]) -> None:
        for owner in sorted(set(lost) | set(preempted)):
            if owner in self.deployments:
                dep = self.deployments[owner]
                if owner in lost:
                    dep.replicas = len(self.cluster.owned(owner))
                    decisions.append(
                        f"lost:{owner}:{sorted(lost[owner])}")
                # preempted replicas return fresh: capacity dip is priced
                # into this tick's latency (exclude list), nothing to do
            elif owner in self.jobs:
                self._reconcile_job(step, self.jobs[owner],
                                    lost.get(owner, []),
                                    preempted.get(owner, []), decisions)

    # ------------------------------------------------------------------
    # measured recovery costs (cfg.measured opt-in)
    # ------------------------------------------------------------------
    def _planned_recovery_s(self, job: TrainingJob, assumed: float) -> float:
        """The recovery cost resize planning prices in: the per-job learned
        estimate once the measured-cost refit has fired, the assumed config
        constant until then (and always when ``cfg.measured`` is off)."""
        est = self._recovery_cost.get(job.name)
        if est is not None and est.learned is not None:
            return est.estimate_s
        return assumed

    def _charge_recovery(self, step: int, job: TrainingJob, op: str,
                         assumed: float, decisions: List[str]) -> None:
        """Charge the job what a recovery ACTUALLY costs, and (opt-in) feed
        the measurement into its streaming cost estimator so planning stops
        trusting the assumed constant once it is persistently wrong."""
        actual = (job.actual_recovery_s if job.actual_recovery_s is not None
                  else assumed)
        job.penalty_s += actual
        if self.cfg.measured is None:
            return
        est = self._recovery_cost.get(job.name)
        if est is None:
            est = self._recovery_cost[job.name] = StreamingCost(
                f"recovery:{job.name}", self.cfg.reshard_cost_s,
                self.cfg.measured)
        events = est.observe(step, actual, op=op, workload=job.name)
        self.pending_events.extend(events)
        if any(isinstance(e, RefitEvent) for e in events):
            decisions.append(f"recost:{job.name}:{est.estimate_s:.0f}s")

    def _rollback(self, step: int, job: TrainingJob,
                  decisions: List[str]) -> None:
        job.progress = job.ckpt_progress
        self._charge_recovery(step, job, "restore", self.cfg.restore_cost_s,
                              decisions)
        job.since_ckpt_s = 0.0
        if job.executor is not None:
            job.executor.restore()

    def _reconcile_job(self, step: int, job: TrainingJob, lost: List[int],
                       preempted: List[int], decisions: List[str]) -> None:
        if job.state != "running":
            return
        if lost:
            survivors = sorted(self.cluster.owned(job.name),
                               key=lambda h: (self.cluster.host_multiplier(h),
                                              h))
            self._rollback(step, job, decisions)
            # only sizes the model says can still reach eps are acceptable
            # landing spots; otherwise requeue and let admission re-plan
            fits = [m for m in job.m_options if m <= len(survivors)
                    and job.remaining_s(m) is not None]
            if fits:
                target = max(fits)
                self.cluster.release(job.name, survivors[target:])
                job.m = target
                if job.executor is not None:
                    job.executor.resize(target)
                decisions.append(f"shrink:{job.name}:m={target}:lost_host")
            else:
                self.cluster.release_all(job.name)
                job.state, job.m = "queued", 0
                decisions.append(f"evict:{job.name}:lost_host")
        elif preempted:
            # capacity survives (host returns fresh) but in-flight BSP work
            # since the last checkpoint is gone
            self._rollback(step, job, decisions)
            decisions.append(
                f"restore:{job.name}:preempt{sorted(preempted)}")

    # ------------------------------------------------------------------
    # 2. serve autoscaling (SLO priority)
    # ------------------------------------------------------------------
    def _autoscale_serve(self, step: int, now_s: float,
                         decisions: List[str]) -> None:
        """Capacity-based autoscaling: the target is in *effective* replica
        units, so a straggling replica or a cluster-wide slowdown shows up
        as missing capacity and is topped up the same tick (new hosts are
        priced at their own degraded speed)."""
        for name in sorted(self.deployments):
            dep = self.deployments[name]
            headroom = self.cfg.serve_headroom
            if step < self._slo_boost_until.get(name, 0):
                # a recent fast-burn alert: over-provision until it expires
                headroom *= SLO_BOOST
            forecast = (dep.trace.forecast(step, self.cfg.forecast_ticks)
                        * headroom)
            plan = dep.desired_replicas(forecast)
            if plan:
                target = float(plan.m)
            else:
                target = float(max(dep.replica_options))
                decisions.append(f"noplan:{name}:{plan.query}")
            eff = self.cluster.effective_replicas(name)
            if eff + 1e-9 < target:
                need = self._hosts_for_capacity(target - eff)
                shortfall = need - len(self.cluster.free_hosts())
                if shortfall > 0:
                    self._preempt_training_for(shortfall, step, now_s, name,
                                               decisions)
                    need = self._hosts_for_capacity(target - eff)
                grant = min(need, len(self.cluster.free_hosts()))
                if grant > 0:
                    old = dep.replicas
                    self.cluster.allocate(name, grant)
                    dep.replicas = len(self.cluster.owned(name))
                    decisions.append(
                        f"scale_up:{name}:{old}->{dep.replicas}")
                if grant < need:
                    decisions.append(f"deficit:{name}:{need - grant}")
                dep.scale_down_votes = 0
                continue
            # scale down: drop the slowest owned hosts while the remaining
            # effective capacity still covers the target (with patience)
            drop = self._droppable_hosts(name, eff, target)
            if drop:
                dep.scale_down_votes += 1
                if dep.scale_down_votes >= self.cfg.scale_down_patience:
                    old = dep.replicas
                    self.cluster.release(name, drop)
                    dep.replicas = len(self.cluster.owned(name))
                    decisions.append(
                        f"scale_down:{name}:{old}->{dep.replicas}")
                    dep.scale_down_votes = 0
            else:
                dep.scale_down_votes = 0

    def _hosts_for_capacity(self, missing: float) -> int:
        """How many free hosts (in allocation order, at their current
        degraded speeds) cover ``missing`` effective replicas; if the whole
        free pool is short, the remainder is priced at the cluster-wide
        pace (what a preempted-then-allocated host would run at)."""
        covered, need = 0.0, 0
        for h in self.cluster.free_hosts():
            if covered + 1e-9 >= missing:
                return need
            covered += 1.0 / self.cluster.host_multiplier(h)
            need += 1
        if covered + 1e-9 < missing:
            need += math.ceil((missing - covered) * self.cluster.sim.slowdown
                              - 1e-9)
        return need

    def _droppable_hosts(self, name: str, eff: float,
                         target: float) -> List[int]:
        """Largest suffix of slowest hosts droppable without dipping below
        the capacity target (slowest-first: they cost a full host of fleet
        budget but contribute the least capacity)."""
        owned = sorted(self.cluster.owned(name),
                       key=lambda h: (-self.cluster.host_multiplier(h), -h))
        drop: List[int] = []
        remaining = eff
        for h in owned[:-1] if len(owned) > 1 else []:
            contribution = 1.0 / self.cluster.host_multiplier(h)
            if remaining - contribution + 1e-9 < target:
                break
            remaining -= contribution
            drop.append(h)
        return drop

    def _preempt_training_for(self, k: int, step: int, now_s: float,
                              dep_name: str, decisions: List[str]) -> None:
        """Free hosts for serving (until k more are free) by shrinking —
        then evicting — the training jobs with the most deadline slack."""
        goal = len(self.cluster.free_hosts()) + k
        while len(self.cluster.free_hosts()) < goal:
            victims = sorted(
                (j for j in self.jobs.values() if j.state == "running"),
                key=lambda j: (-self._slack(j, now_s), j.name))
            if not victims:
                return
            job = victims[0]
            # never shrink onto an m the model says cannot reach eps: the
            # job would hold hosts forever making no progress — evict it
            # (requeue) instead and let admission re-plan
            lower = [m for m in job.m_options if m < job.m
                     and job.remaining_s(m) is not None]
            if lower:
                target = max(lower)
                self._execute_resize(step, job, target, f"serve:{dep_name}",
                                     decisions)
                # a forced shrink is still a resize: start its cooldown so
                # the no-flap guard covers the follow-up grow as well
                self._last_resize[job.name] = step
                decisions.append(
                    f"preempt:{job.name}:m={target}:serve={dep_name}")
            else:
                self.cluster.release_all(job.name)
                self._rollback(step, job, decisions)
                job.state, job.m = "queued", 0
                decisions.append(f"evict:{job.name}:serve={dep_name}")

    def _slack(self, job: TrainingJob, now_s: float) -> float:
        rem = job.remaining_s(job.m) if job.m else job.remaining_s(
            min(job.m_options))
        if rem is None:
            return float("-inf")
        return (job.deadline_s - now_s) - rem

    # ------------------------------------------------------------------
    # 3. training admission (NoFeasiblePlan-aware)
    # ------------------------------------------------------------------
    def _admit_training(self, step: int, now_s: float,
                        decisions: List[str]) -> None:
        pending = sorted(
            (j for j in self.jobs.values()
             if j.state in ("pending", "queued") and j.arrival_s <= now_s),
            key=lambda j: (j.arrival_s, j.name))
        for job in pending:
            if job.state == "pending":
                job.state = "queued"
                decisions.append(f"queue:{job.name}")
            plan = job.admission_plan()
            if isinstance(plan, NoFeasiblePlan):
                job.state, job.no_plan = "infeasible", plan
                decisions.append(f"infeasible:{job.name}:{plan.query}")
                continue
            slack = job.deadline_s - now_s
            remaining = {m: (1.0 - job.progress) * t + job.penalty_s
                         for (_, m), t in sorted(plan.table.items())}
            feasible = {m: t for m, t in remaining.items() if t <= slack}
            if not feasible:
                fastest = min(remaining.values())
                job.no_plan = NoFeasiblePlan(
                    query="fleet_admission",
                    reason=f"fastest remaining {fastest:.0f}s on "
                           f"m={min(remaining, key=remaining.get)} exceeds "
                           f"deadline slack {slack:.0f}s",
                    table={(job.name, m): t for m, t in remaining.items()})
                job.state = "infeasible"
                decisions.append(f"infeasible:{job.name}:fleet_admission")
                continue
            free = len(self.cluster.free_hosts())
            affordable = {m: t for m, t in feasible.items() if m <= free}
            if not affordable:
                continue   # stays queued; retried next tick
            target = min(affordable, key=lambda m: (m * affordable[m], m))
            self.cluster.allocate(job.name, target)
            job.state, job.m = "running", target
            job.since_ckpt_s = 0.0
            if job.executor is not None:
                job.executor.resize(target)
                job.executor.checkpoint()
            self._last_resize[job.name] = step
            decisions.append(f"admit:{job.name}:m={target}")

    # ------------------------------------------------------------------
    # 4. training resize (the AdaptiveController tradeoff, fleet-wide)
    # ------------------------------------------------------------------
    def _resize_training(self, step: int, now_s: float,
                         decisions: List[str]) -> None:
        for name in sorted(self.jobs):
            job = self.jobs[name]
            if job.state != "running":
                continue
            slack = job.deadline_s - now_s
            free = len(self.cluster.free_hosts())
            rem_cur = job.remaining_s(job.m)
            # rem_cur None = the current m cannot reach eps at all: the
            # most at-risk state there is (progress is frozen)
            at_risk = rem_cur is None or rem_cur > slack
            in_cooldown = (step - self._last_resize.get(name, -10 ** 9)
                           < self.cfg.resize_cooldown_ticks)
            # rescues and drift-triggered replans don't wait out no-flap
            replan = name in self._needs_replan
            self._needs_replan.discard(name)
            if in_cooldown and not (at_risk or replan):
                continue
            candidates: Dict[int, float] = {}
            # price a resize with the measured recovery cost once it has
            # been learned (cfg.measured), the assumed constant otherwise
            reshard_s = self._planned_recovery_s(job, self.cfg.reshard_cost_s)
            for m in job.m_options:
                if m != job.m and m > job.m + free:
                    continue
                rem = job.remaining_s(m)
                if rem is None:
                    continue
                candidates[m] = rem + (reshard_s if m != job.m else 0.0)
            if not candidates:
                continue
            # shrinking trades slack for cost; demand a safety margin so a
            # later deadline rescue (and its reshard cost) never follows
            meeting = {m: t for m, t in candidates.items()
                       if t <= (slack * self.cfg.shrink_safety
                                if m < job.m else slack)}
            pool = meeting or candidates
            # minimize host-seconds among deadline-feasible sizes; if none
            # is feasible, minimize lateness instead (max useful speed)
            if meeting:
                target = min(pool, key=lambda m: (m * pool[m], m))
            else:
                target = min(pool, key=lambda m: (pool[m], m))
            if target == job.m:
                continue
            deadline_rescue = at_risk and candidates[target] <= slack
            cheaper = (rem_cur is not None and target * candidates[target]
                       < self.cfg.resize_hysteresis * job.m * rem_cur)
            if not (deadline_rescue or cheaper):
                continue
            why = "deadline" if deadline_rescue else "cost"
            self.resize_decisions.append(ResizeDecision(
                resize=True, target_m=target,
                reason=f"{job.name}: predicted remaining "
                       f"{candidates[target]:.0f}s on m={target} vs "
                       f"{'inf' if rem_cur is None else f'{rem_cur:.0f}s'} "
                       f"on m={job.m} ({why})",
                predicted_remaining_current=rem_cur,
                predicted_remaining_target=candidates[target]))
            old = job.m
            self._execute_resize(step, job, target, why, decisions)
            self._last_resize[name] = step
            decisions.append(f"resize:{name}:{old}->{target}:{why}")

    def _execute_resize(self, step: int, job: TrainingJob, target: int,
                        why: str, decisions: List[str]) -> None:
        if target > job.m:
            self.cluster.allocate(job.name, target - job.m)
        else:
            # BSP runs at the slowest member: a shrink keeps the fastest
            # hosts or the remaining-time model it was priced with is wrong
            keep = sorted(self.cluster.owned(job.name),
                          key=lambda h: (self.cluster.host_multiplier(h), h))
            self.cluster.release(job.name, keep[target:])
        job.m = target
        self._charge_recovery(step, job, "reshard", self.cfg.reshard_cost_s,
                              decisions)
        if job.executor is not None:
            # the chaos executor contract: checkpoint, then re-shard onto
            # the new parallelism (SSPLocalSGD re-partitions; the LM
            # TrainerExecutor routes through elastic.rescale_training_state)
            job.executor.checkpoint()
            job.executor.resize(target)

    # ------------------------------------------------------------------
    # 5. progress + 6. serve accounting
    # ------------------------------------------------------------------
    def _account_training(self, step: int, now_s: float,
                          decisions: List[str]) -> None:
        for name in sorted(self.jobs):
            job = self.jobs[name]
            if job.state != "running":
                continue
            pace = self.cluster.bsp_pace(name)   # >= 1: slowest-host drag
            work_s = self.cfg.tick_s / pace
            if self.cfg.drift is not None:
                self._observe_pace(step, job, pace, decisions)
            paid = min(job.penalty_s, work_s)
            job.penalty_s -= paid
            work_s -= paid
            t_full = job.time_to_eps(job.m)
            if t_full is None:
                continue
            job.progress = min(job.progress + work_s / t_full, 1.0)
            job.since_ckpt_s += self.cfg.tick_s
            if job.executor is not None:
                job.objective = float(job.executor.outer_step())
            if job.progress >= 1.0:
                job.state = "done"
                job.finish_s = now_s + self.cfg.tick_s
                self.cluster.release_all(name)
                job.m = 0
                decisions.append(f"complete:{name}")
            elif job.since_ckpt_s >= job.ckpt_every_s:
                job.ckpt_progress = job.progress
                job.since_ckpt_s = 0.0
                if job.executor is not None:
                    job.executor.checkpoint()

    def _observe_pace(self, step: int, job: TrainingJob, pace: float,
                      decisions: List[str]) -> None:
        """Streaming refit of the job's pace model (cfg.drift opt-in).

        The remaining-time model assumes the cluster delivers
        ``tick_s / pace_factor`` seconds of useful work per tick; the
        measured delivery is ``tick_s / pace``.  When the normalized
        residual between the two drifts past the threshold (a sustained
        slowdown, not a one-tick blip), refit ``pace_factor`` to the
        trailing-window mean pace — which rescales ``remaining_s`` for
        every m — emit the typed drift/refit events, and force a
        replanning pass through ``_resize_training`` next tick."""
        name = job.name
        cfgd = self.cfg.drift
        det = self._drift.get(name)
        if det is None:
            det = self._drift[name] = DriftDetector(f"pace:{name}", cfgd)
            self._pace_window[name] = deque(maxlen=cfgd.window)
        window = self._pace_window[name]
        window.append(pace)
        predicted = self.cfg.tick_s / job.pace_factor
        actual = self.cfg.tick_s / pace
        drift = det.observe(step, predicted, actual)
        if drift is None:
            return
        self.pending_events.append(drift)
        decisions.append(f"drift:{name}")
        # refit from the new regime only: the trailing run of window points
        # whose own residual (vs the stale model) exceeds the threshold —
        # averaging in pre-drift points would split the difference between
        # regimes and under-correct
        recent = list(window)
        for i in range(len(recent) - 1, -1, -1):
            err = abs(self.cfg.tick_s / recent[i] - predicted) / predicted
            if err <= cfgd.threshold:
                recent = recent[i + 1:]
                break
        recent = recent or list(window)
        new_factor = sum(recent) / len(recent)
        after = sum(
            abs(self.cfg.tick_s / p - self.cfg.tick_s / new_factor)
            / (self.cfg.tick_s / new_factor)
            for p in recent
        ) / len(recent)
        job.pace_factor = new_factor
        self.pending_events.append(RefitEvent(
            step=step, model=f"pace:{name}", n_obs=len(recent),
            residual_before=drift.residual, residual_after=after))
        det.reset()
        self._needs_replan.add(name)

    def _account_serve(self, step: int,
                       preempted: Dict[str, List[int]],
                       decisions: List[str]) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for name in sorted(self.deployments):
            dep = self.deployments[name]
            demand = dep.trace.qps_at(step)
            eff = self.cluster.effective_replicas(
                name, exclude=preempted.get(name, []))
            if eff <= 0.0:
                lat = 4.0 * dep.slo_p95_s   # nothing serving: hard breach
            else:
                lat = dep.tick_latency(eff, demand)
            dep.latencies.append(lat)
            if self.cfg.slo is not None:
                self._observe_slo(step, name, dep, lat, decisions)
            out[name] = dep.snapshot(demand, lat)
        return out

    def _observe_slo(self, step: int, name: str, dep, lat: float,
                     decisions: List[str]) -> None:
        """Stream this tick's modeled latency through the deployment's SLO
        burn-rate monitor (cfg.slo opt-in).  A fast-burn alert — a couple
        of bad points in a short window — fires ticks before the drift
        detector's windowed residual mean can, so the alert both rides the
        bus (``CapacityPlanner.ingest`` consumes it) and grants the
        autoscaler ``SLO_BOOST`` extra headroom for ``SLO_BOOST_TICKS``."""
        mon = self._slo.get(name)
        if mon is None:
            moncfg = dataclasses.replace(self.cfg.slo, target=dep.slo_p95_s)
            mon = self._slo[name] = SLOMonitor(
                moncfg, name=name, objective="tick_p95_latency")
        alert = mon.observe(step, lat)
        if alert is not None:
            self.pending_events.append(alert)
            self._slo_boost_until[name] = step + 1 + SLO_BOOST_TICKS
            decisions.append(
                f"slo_alert:{name}:burn={alert.burn_rate:.2f}")

    # ------------------------------------------------------------------
    # 7. trace spans over modeled time (cfg.spans opt-in)
    # ------------------------------------------------------------------
    def _emit_tick_spans(self, step: int, now_s: float,
                        serve_row: Dict[str, Any]) -> None:
        """One modeled-time span tree per tick: a ``fleet.tick`` root of
        ``tick_s`` wall, a ``fleet.train`` child per running job (measured
        dur = the useful work the cluster delivered, ``tick_s / pace``;
        predicted = what the pace model promised, ``tick_s / pace_factor``
        — attribution's ratio column localizes pace drift per job), and a
        ``fleet.serve`` child per deployment (dur = modeled tick latency,
        predicted = its p95 target).  Ids derive from (config, step, name)
        only, so same-scenario runs emit byte-identical span streams."""
        tick_id = det_id(self._trace_id, "tick", step)
        spans = [SpanEvent(
            trace_id=self._trace_id, span_id=tick_id, name="tick",
            t0=now_s, dur=self.cfg.tick_s, component="fleet.tick",
            step=step, replica=0,
            attrs={"free": len(self.cluster.free_hosts())})]
        for name in sorted(self.jobs):
            job = self.jobs[name]
            if job.state != "running" or job.m == 0:
                continue
            pace = self.cluster.bsp_pace(name)
            spans.append(SpanEvent(
                trace_id=self._trace_id,
                span_id=det_id(tick_id, "train", name),
                parent_id=tick_id, name=f"train:{name}", t0=now_s,
                dur=self.cfg.tick_s / pace,
                predicted_s=self.cfg.tick_s / job.pace_factor,
                component="fleet.train", step=step,
                replica=self._lane[name],
                attrs={"m": job.m, "progress": round(job.progress, 9)}))
        for name, row in sorted(serve_row.items()):
            dep = self.deployments[name]
            spans.append(SpanEvent(
                trace_id=self._trace_id,
                span_id=det_id(tick_id, "serve", name),
                parent_id=tick_id, name=f"serve:{name}", t0=now_s,
                dur=float(row["lat_s"]), predicted_s=dep.slo_p95_s,
                component="fleet.serve", step=step,
                replica=self._lane[name],
                attrs={"m": row["m"], "qps": row["qps"],
                       "ok": row["ok"]}))
        self.pending_events.extend(spans)
