"""Fleet event loop + the replayable FleetRunLog artifact.

``run_fleet_sim(seed)`` is the canonical entry point (mirrors
``runtime.chaos.run_chaos_sim``): build the day scenario deterministically
from one seed, drive ``FleetScheduler`` tick by tick through the chaos
trace, and emit a ``FleetRunLog`` that serializes to JSON and **replays
bit-identically** from its embedded trace + meta — same guarantee, and
the same golden-fixture testing pattern, as the chaos layer.

The canonical 24h scenario (``build_day_scenario``): 288 five-minute
ticks on 24 hosts; two serving deployments under diurnal/bursty request
traces (a big midday-peaking "chat" and a smaller evening "search") and
three training jobs arriving through the day, with seeded chaos
(stragglers, slowdowns, preemptions, membership churn) layered on top.

The port's copy of ``repro/fleet/simulate.py``, unchanged but for its
imports: a log saved by either package loads and replays in the other to
the same ``signature()``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.fleet.cluster import FleetCluster
from repro_torch.fleet.scheduler import FleetConfig, FleetScheduler
from repro_torch.fleet.workloads import (
    RequestTrace,
    ServeDeployment,
    TrainingJob,
    serve_capacity_planner,
    training_model,
)
from repro_torch.runtime.chaos import ChaosEvent, ChaosRunLog, ChaosTrace
from repro_torch.telemetry import DriftConfig, warn_deprecated
from repro_torch.telemetry.trace import SloConfig

# Default burn-rate tunables for --slo runs: the per-deployment target is
# substituted by the scheduler (each deployment's own slo_p95_s); a short
# window with min_points=2 fires on the second breached tick, several
# ticks before the drift detector's windowed residual mean can react.
DEFAULT_FLEET_SLO = SloConfig(target=1.0, budget=0.05, window=8,
                              burn_threshold=2.0, min_points=2, cooldown=12)


# ---------------------------------------------------------------------------
# Run log
# ---------------------------------------------------------------------------
class FleetRunLog(ChaosRunLog):
    """ChaosRunLog's trace+rows+meta JSON artifact, with fleet semantics:
    the signature covers scheduler decisions, allocations, and the modeled
    serve/training outcomes.  Rows ride the telemetry bus as typed
    ``FleetTickEvent``s (kind ``fleet_tick``); scheduler drift/refit
    events share the same tracker but stay out of ``rows``/signatures."""

    EVENT_KIND = "fleet_tick"
    LOG_TYPE = "fleet"

    def signature(self) -> List[tuple]:
        """The full sequence in-process replay must reproduce exactly: per
        tick, every scheduler decision plus the allocation/latency/progress
        outcome (floats included — same machine, same bits)."""
        out = []
        for r in self.rows:
            serve = tuple((n, s["m"], s["lat_s"])
                          for n, s in sorted(r["serve"].items()))
            jobs = tuple((n, s["state"], s["m"], s["prog"])
                         for n, s in sorted(r["jobs"].items()))
            out.append((r["step"], tuple(r["decisions"]), serve, jobs,
                        r["free"], r["cost_hh"]))
        return out

    def control_signature(self) -> List[tuple]:
        """The machine-portable slice of the signature: decisions,
        allocations, and states only — no floats, so it compares exactly
        against a golden fixture recorded on another machine (modeled
        quantities are compared to tolerance in tests/test_fleet.py)."""
        out = []
        for r in self.rows:
            serve = tuple((n, s["m"], s["ok"])
                          for n, s in sorted(r["serve"].items()))
            jobs = tuple((n, s["state"], s["m"])
                         for n, s in sorted(r["jobs"].items()))
            out.append((r["step"], tuple(r["decisions"]), serve, jobs,
                        r["free"]))
        return out

    def n_decisions(self) -> int:
        return sum(len(r["decisions"]) for r in self.rows)

    def decisions(self, prefix: str = "") -> List[Tuple[int, str]]:
        return [(r["step"], d) for r in self.rows for d in r["decisions"]
                if d.startswith(prefix)]

    def fleet_cost_host_hours(self) -> float:
        warn_deprecated("FleetRunLog.fleet_cost_host_hours()",
                        'events("fleet_tick")[-1].cost_hh')
        rows = self.rows
        return rows[-1]["cost_hh"] if rows else 0.0


# ---------------------------------------------------------------------------
# Simulator
# ---------------------------------------------------------------------------
class FleetSimulator:
    """Drives scheduler ticks through a chaos trace; no entropy of its own."""

    def __init__(self, trace: ChaosTrace, jobs, deployments,
                 cfg: Optional[FleetConfig] = None):
        self.trace = trace
        self.cluster = FleetCluster(trace)
        self.scheduler = FleetScheduler(self.cluster, jobs, deployments, cfg)

    def run(self, steps: Optional[int] = None) -> FleetRunLog:
        steps = self.trace.steps if steps is None else steps
        sched = self.scheduler
        log = FleetRunLog(trace=self.trace, meta={
            "tick_s": sched.cfg.tick_s, "n_hosts": self.trace.n_hosts})
        for step in range(steps):
            events, lost, preempted = self.cluster.advance(step)
            log.append(**sched.tick(step, events, lost, preempted))
            # drift/refit events ride the same bus, outside rows/signature
            for ev in sched.drain_events():
                log.emit(ev)
        log.meta["summary"] = self.summary()
        return log

    def summary(self) -> Dict[str, Any]:
        sched = self.scheduler
        serve = {}
        for name, dep in sorted(sched.deployments.items()):
            serve[name] = {
                "p95_s": round(dep.p95_latency(), 9),
                "slo_p95_s": dep.slo_p95_s,
                "slo_met": bool(dep.slo_met()),
                "final_replicas": dep.replicas,
            }
        jobs = {}
        for name, job in sorted(sched.jobs.items()):
            jobs[name] = {
                "state": job.state,
                "progress": round(job.progress, 9),
                "finish_s": job.finish_s,
                "deadline_s": job.deadline_s,
                "met_deadline": bool(job.state == "done"
                                     and job.finish_s is not None
                                     and job.finish_s <= job.deadline_s),
                "no_plan": (None if job.no_plan is None
                            else {"query": job.no_plan.query,
                                  "reason": job.no_plan.reason}),
            }
        return {"serve": serve, "jobs": jobs,
                "cost_host_hours": round(sched.cost_host_s / 3600.0, 6),
                "n_resize_decisions": len(sched.resize_decisions)}


# ---------------------------------------------------------------------------
# The canonical 24h scenario
# ---------------------------------------------------------------------------
DAY_TICKS = 288
DAY_TICK_S = 300.0
DAY_HOSTS = 24


def build_day_scenario(seed: int, *, ticks: int = DAY_TICKS,
                       tick_s: float = DAY_TICK_S,
                       n_hosts: int = DAY_HOSTS,
                       trace: Optional[ChaosTrace] = None):
    """(trace, jobs, deployments, cfg) for the canonical diurnal day.

    Deterministic in ``seed``; a recorded trace can be passed back in for
    replay.  Preemptions are guaranteed: if the seeded draw produced none,
    one is injected mid-day (the scenario exists to exercise them)."""
    if trace is None:
        trace = ChaosTrace.generate(seed, ticks, n_hosts, warmup=12)
        # the seeded draw rarely preempts *busy* hosts (the allocator hands
        # out low ids first, the draw is uniform), so the scenario injects
        # two guaranteed preemptions where the work is: one on an early
        # serve replica, one on an early training host
        trace.events.extend([
            ChaosEvent(step=min(60, ticks - 1), kind="preempt", host=4),
            ChaosEvent(step=min(200, ticks - 1), kind="preempt", host=1),
        ])
        trace.events.sort(key=lambda e: (e.step, e.host, e.kind))

    hour = 3600.0
    jobs = [
        # overnight-scale run, arrives early, comfortable deadline
        TrainingJob(
            name="job_convex", eps=1e-2, arrival_s=0.5 * hour,
            deadline_s=20.0 * hour, m_options=(2, 4, 8),
            model=training_model(compute_s=36.0, rate=3.2e-3),
            ckpt_every_s=6 * tick_s),
        # mid-morning arrival, tighter deadline -> wants a bigger m
        TrainingJob(
            name="job_lm", eps=1e-2, arrival_s=4.0 * hour,
            deadline_s=18.0 * hour, m_options=(2, 4, 8),
            model=training_model(compute_s=52.0, rate=2.6e-3),
            ckpt_every_s=6 * tick_s),
        # small afternoon job; fits in the evening trough
        TrainingJob(
            name="job_sweep", eps=1e-2, arrival_s=9.0 * hour,
            deadline_s=23.5 * hour, m_options=(1, 2, 4),
            model=training_model(compute_s=14.0, rate=6.0e-3),
            ckpt_every_s=6 * tick_s),
    ]
    deployments = [
        ServeDeployment(
            name="serve_chat",
            planner=serve_capacity_planner(dispatch_s=0.018,
                                           per_seq_s=0.0042,
                                           log_b_s=0.002),
            trace=RequestTrace.diurnal(seed * 7919 + 1, ticks, tick_s,
                                       base_qps=2.0, peak_qps=11.0,
                                       peak_frac=0.55),
            slo_p95_s=4.5, gen_tokens=64,
            batch_grid=(1, 2, 4, 8), replica_options=tuple(range(1, 13))),
        ServeDeployment(
            name="serve_search",
            planner=serve_capacity_planner(dispatch_s=0.012,
                                           per_seq_s=0.0030,
                                           log_b_s=0.001),
            trace=RequestTrace.diurnal(seed * 7919 + 2, ticks, tick_s,
                                       base_qps=1.0, peak_qps=6.0,
                                       peak_frac=0.80),
            slo_p95_s=2.5, gen_tokens=32,
            batch_grid=(1, 2, 4, 8), replica_options=tuple(range(1, 9))),
    ]
    cfg = FleetConfig(tick_s=tick_s)
    return trace, jobs, deployments, cfg


# ---------------------------------------------------------------------------
# The drift scenario: a sustained cluster slowdown mid-run
# ---------------------------------------------------------------------------
DRIFT_TICKS = 192
DRIFT_TICK_S = 300.0
DRIFT_HOSTS = 16


def build_drift_scenario(seed: int, *, ticks: int = DRIFT_TICKS,
                         tick_s: float = DRIFT_TICK_S,
                         n_hosts: int = DRIFT_HOSTS,
                         trace: Optional[ChaosTrace] = None,
                         drift: bool = True):
    """(trace, jobs, deployments, cfg) for the streaming-refit scenario.

    An otherwise-quiet cluster takes a sustained 2x cluster-wide slowdown
    for the middle third of the run.  The one training job's deadline is
    sized so its admitted (cheapest) m=2 meets it comfortably at modeled
    pace but misses it at 2x.  With the streaming refit on the detector
    fires within a few ticks of onset, ``pace_factor`` is refit from the
    new-regime window (rescaling ``remaining_s`` for every m), and the
    forced replanning pass rescues the deadline immediately (m=2 -> 8 at
    seed 0).  With ``drift=False`` the same scenario runs open-loop: the
    stale model only notices via lagging *progress* ~40 ticks later, and
    its panicked late resizes no longer make the deadline — the control
    arm the tests compare against."""
    if trace is None:
        # background chaos off: the scenario isolates the drift signal
        trace = ChaosTrace.generate(seed, ticks, n_hosts, p_straggler=0.0,
                                    p_slowdown=0.0, p_preempt=0.0,
                                    p_membership=0.0, warmup=12)
        trace.events.append(ChaosEvent(
            step=ticks // 3, kind="slowdown", host=-1, magnitude=2.0,
            duration=ticks // 3))
        trace.events.sort(key=lambda e: (e.step, e.host, e.kind))

    horizon = ticks * tick_s
    jobs = [
        TrainingJob(
            name="job_drift", eps=1e-2, arrival_s=0.0,
            deadline_s=0.70 * horizon, m_options=(2, 4, 8),
            model=training_model(compute_s=36.0, rate=3.2e-3),
            ckpt_every_s=6 * tick_s),
    ]
    deployments = [
        ServeDeployment(
            name="serve_bg",
            planner=serve_capacity_planner(dispatch_s=0.012,
                                           per_seq_s=0.0030,
                                           log_b_s=0.001),
            trace=RequestTrace.diurnal(seed * 7919 + 3, ticks, tick_s,
                                       base_qps=1.0, peak_qps=3.0,
                                       burst_prob=0.0),
            slo_p95_s=2.5, gen_tokens=32,
            batch_grid=(1, 2, 4, 8), replica_options=tuple(range(1, 5))),
    ]
    drift_cfg = DriftConfig(window=8, threshold=0.25, min_points=4,
                            cooldown=16) if drift else None
    cfg = FleetConfig(tick_s=tick_s, drift=drift_cfg)
    return trace, jobs, deployments, cfg


# ---------------------------------------------------------------------------
# The migration scenario: measured recovery costs flip a resize decision
# ---------------------------------------------------------------------------
MIG_TICKS = 96
MIG_TICK_S = 300.0
MIG_HOSTS = 12


def build_migration_scenario(seed: int, *, ticks: int = MIG_TICKS,
                             tick_s: float = MIG_TICK_S,
                             n_hosts: int = MIG_HOSTS,
                             trace: Optional[ChaosTrace] = None,
                             measured: bool = True):
    """(trace, jobs, deployments, cfg) for the measured-recovery-cost loop.

    The scheduler's planning constants still price a restore/re-shard as a
    stop-the-world 1800s event, but the job actually recovers in 40s (the
    async sharded checkpoint + live migration path:
    ``actual_recovery_s=40``).  Four early injected preemptions make the
    job pay — and, with ``measured=True``, *measure* — real restores; the
    drift detector sees the 1800s assumption is ~45x off and refits the
    per-job recovery estimate to the measured 40s.

    The deadline forces admission at m=4 (m=2 alone cannot make it from a
    standing start).  Mid-run, once most of the work is done, shrinking to
    m=2 becomes the cheaper host-second plan — but only if a re-shard
    costs 40s; priced at the assumed 1800s the shrink never clears the
    hysteresis + shrink-safety bar.  So the measured arm emits a
    ``resize:job_mig:4->2:cost`` decision and finishes cheaper; the
    control arm (``measured=False``, *same physics*: it also pays only
    40s per recovery) plans with the stale constant and holds m=4 to the
    end.  The flip is the acceptance artifact: a resize decision that
    exists in one arm and not the other, caused only by measurement."""
    if trace is None:
        # background chaos off: every recovery in the log is an injected,
        # deterministic one (same schedule for both arms)
        trace = ChaosTrace.generate(seed, ticks, n_hosts, p_straggler=0.0,
                                    p_slowdown=0.0, p_preempt=0.0,
                                    p_membership=0.0, warmup=4)
        # four preemptions on hosts the training job owns (serve_bg holds
        # at most hosts 0-1; job_mig is admitted onto the next four):
        # enough restore observations for min_points=3 plus one post-refit
        trace.events.extend([
            ChaosEvent(step=6, kind="preempt", host=3),
            ChaosEvent(step=12, kind="preempt", host=4),
            ChaosEvent(step=18, kind="preempt", host=3),
            ChaosEvent(step=24, kind="preempt", host=4),
        ])
        trace.events.sort(key=lambda e: (e.step, e.host, e.kind))

    # t_eps(4) ~= 14500s (~48 ticks); t_eps(2) ~= 1.56x that, so a
    # deadline of 1.2 * t_eps(4) rules m=2 out at admission
    model = training_model(compute_s=36.0, floor_s=0.05, log_s=0.02,
                           per_m_s=0.005, rate=4.7e-3)
    jobs = [
        TrainingJob(
            name="job_mig", eps=1e-2, arrival_s=0.0,
            deadline_s=17400.0, m_options=(2, 4, 8),
            model=model, ckpt_every_s=6 * tick_s,
            actual_recovery_s=40.0),
    ]
    deployments = [
        ServeDeployment(
            name="serve_bg",
            planner=serve_capacity_planner(dispatch_s=0.012,
                                           per_seq_s=0.0030,
                                           log_b_s=0.001),
            trace=RequestTrace.diurnal(seed * 7919 + 5, ticks, tick_s,
                                       base_qps=1.0, peak_qps=2.0,
                                       burst_prob=0.0),
            slo_p95_s=2.5, gen_tokens=32,
            batch_grid=(1, 2, 4, 8), replica_options=(1, 2)),
    ]
    measured_cfg = DriftConfig(window=8, threshold=0.3, min_points=3,
                               cooldown=8) if measured else None
    cfg = FleetConfig(tick_s=tick_s, reshard_cost_s=1800.0,
                      restore_cost_s=1800.0, measured=measured_cfg)
    return trace, jobs, deployments, cfg


_SCENARIOS = {
    "day": (build_day_scenario, DAY_TICKS, DAY_TICK_S, DAY_HOSTS),
    "drift": (build_drift_scenario, DRIFT_TICKS, DRIFT_TICK_S, DRIFT_HOSTS),
    "migrate": (build_migration_scenario, MIG_TICKS, MIG_TICK_S, MIG_HOSTS),
}


def run_fleet_sim(seed: int, *, ticks: Optional[int] = None,
                  tick_s: Optional[float] = None,
                  n_hosts: Optional[int] = None,
                  trace: Optional[ChaosTrace] = None,
                  scenario: str = "day",
                  drift: bool = False,
                  spans: bool = False,
                  slo: bool = False,
                  measured: bool = False) -> FleetRunLog:
    """One deterministic fleet run; everything derives from ``seed``.

    ``scenario`` picks the builder ("day" or "drift") and its defaults;
    ``drift`` turns the scheduler's streaming pace refit on, ``spans``
    the modeled-time trace spans, and ``slo`` the per-deployment burn-
    rate monitors (all off by default everywhere, so pre-existing
    goldens stay bit-identical)."""
    build, d_ticks, d_tick_s, d_hosts = _SCENARIOS[scenario]
    ticks = d_ticks if ticks is None else ticks
    tick_s = d_tick_s if tick_s is None else tick_s
    n_hosts = d_hosts if n_hosts is None else n_hosts
    kwargs = dict(ticks=ticks, tick_s=tick_s, n_hosts=n_hosts, trace=trace)
    if scenario == "drift":
        kwargs["drift"] = drift
    if scenario == "migrate":
        kwargs["measured"] = measured
    trace, jobs, deployments, cfg = build(seed, **kwargs)
    if drift and cfg.drift is None:
        cfg = dataclasses.replace(cfg, drift=DriftConfig())
    if spans and not cfg.spans:
        cfg = dataclasses.replace(cfg, spans=True)
    if slo and cfg.slo is None:
        cfg = dataclasses.replace(cfg, slo=DEFAULT_FLEET_SLO)
    # the horizon is the *requested* one, not the trace's: a recorded trace
    # longer (or shorter) than --ticks must not silently change the run
    log = FleetSimulator(trace, jobs, deployments, cfg).run(steps=ticks)
    log.meta.update(seed=seed, ticks=ticks, scenario=scenario, drift=drift)
    # only recorded when on: logs from before these opt-ins existed (and
    # runs with them off) keep byte-identical meta blocks
    if spans:
        log.meta["spans"] = True
    if slo:
        log.meta["slo"] = True
    if measured:
        log.meta["measured"] = True
    return log


def replay(run_log: FleetRunLog) -> FleetRunLog:
    """Re-run a recorded fleet run from its embedded trace + meta; the
    result must match ``run_log.signature()`` exactly."""
    meta = run_log.meta
    return run_fleet_sim(int(meta["seed"]), ticks=int(meta["ticks"]),
                         tick_s=float(meta["tick_s"]),
                         n_hosts=int(meta["n_hosts"]),
                         trace=run_log.trace,
                         scenario=meta.get("scenario", "day"),
                         drift=bool(meta.get("drift", False)),
                         spans=bool(meta.get("spans", False)),
                         slo=bool(meta.get("slo", False)),
                         measured=bool(meta.get("measured", False)))
