"""Deterministic fault-injecting cluster simulator + the closed control loop.

Hemingway §6 argues the system must *adapt during a run*: refit the
convergence and Ernest models online and resize the cluster.  This module
composes the previously-passive pieces — ``StragglerMonitor``,
``FailureInjector``, ``AdaptiveController``, the elastic re-shard path —
into one production-shaped loop, driven by a **replayable event trace**:

    ChaosTrace (seeded events) ──► ClusterSim (per-host speed state)
        │ simulated BSP step times / preemptions
        ▼
    StragglerMonitor ──mitigations──►┐
    FailureInjector  ──restores────► ChaosLoop ──► executor (SSP local-SGD
    AdaptiveController ─ResizeDecision─┘            or the LM Trainer)

Every step of the run (events, mitigations, decisions, objective, m, H,
wall-clock) is appended to a ``ChaosRunLog`` that serializes to JSON.  The
loop draws NO entropy of its own: given the same trace and executor seed it
replays **bit-identically**, which is what makes the adaptive layer
testable — golden run logs are regression tests (tests/test_chaos.py).

This is the port's copy of ``repro/runtime/chaos.py``: the loop, the trace
and the simulator unchanged (pure Python), the executor the port's
``SSPLocalSGD`` on the local-SGD kernel, and ``run_chaos_sim`` on the CUDA
device unless the caller names another.

Event kinds (all drawn by ``ChaosTrace.generate`` from one ``random.Random``
seed, or hand-written / loaded from JSON):

  * ``straggler_on``  — host's speed multiplier jumps to ``magnitude`` for
                        ``duration`` steps (auto ``straggler_off``)
  * ``straggler_off`` — explicit recovery
  * ``slowdown``      — cluster-wide transient multiplier (network weather);
                        NOT a straggler: every host slows together
  * ``preempt``       — host killed; surfaces as ``SimulatedFailure`` through
                        the FailureInjector, the loop restores from the last
                        checkpoint and the host returns fresh
  * ``leave`` / ``join`` — capacity shrinks/grows; the controller's m options
                        are re-clamped, and a run above capacity is forced
                        down through the same resize path
"""
from __future__ import annotations

import dataclasses
import json
import math
import random
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.adaptive import AdaptiveController
from repro_torch.core.ernest import ErnestModel
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim.problems import ERMProblem, synthetic_mnist
from repro_torch.optim.simcluster import CommModel, SSPIndexSource, SSPLocalSGD
from repro_torch.runtime.failures import FailureInjector, SimulatedFailure
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.telemetry import (
    Event,
    MemorySink,
    RunMeta,
    Tracker,
    from_legacy,
    read_events,
    warn_deprecated,
)
from repro_torch.telemetry.refit import StreamingCost, StreamingErnest

EVENT_KINDS = ("straggler_on", "straggler_off", "slowdown", "preempt",
               "join", "leave")


# ---------------------------------------------------------------------------
# Event trace
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    step: int
    kind: str
    host: int = -1             # -1: cluster-wide (slowdown)
    magnitude: float = 1.0     # speed multiplier (>1 = slower)
    duration: int = 0          # steps until auto-recovery (0 = until event)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ChaosEvent":
        return cls(step=int(d["step"]), kind=str(d["kind"]),
                   host=int(d.get("host", -1)),
                   magnitude=float(d.get("magnitude", 1.0)),
                   duration=int(d.get("duration", 0)))


@dataclasses.dataclass
class ChaosTrace:
    """A replayable schedule of cluster events."""

    seed: int
    n_hosts: int
    steps: int
    events: List[ChaosEvent] = dataclasses.field(default_factory=list)

    # ------------------------------------------------------------------
    @classmethod
    def generate(cls, seed: int, steps: int, n_hosts: int, *,
                 p_straggler: float = 0.03, p_slowdown: float = 0.015,
                 p_preempt: float = 0.008, p_membership: float = 0.004,
                 warmup: int = 20) -> "ChaosTrace":
        """Draw a deterministic event schedule from one PRNG seed.

        ``warmup`` keeps the first steps quiet so the monitor can establish
        a baseline before anything goes wrong."""
        rng = random.Random(seed)
        events: List[ChaosEvent] = []
        busy_until = [0] * n_hosts   # one outstanding fault per host
        for step in range(warmup, steps):
            r = rng.random()
            host = rng.randrange(n_hosts)
            if r < p_straggler:
                if busy_until[host] <= step:
                    dur = rng.randint(6, 20)
                    events.append(ChaosEvent(step, "straggler_on", host,
                                             magnitude=rng.uniform(1.6, 6.0),
                                             duration=dur))
                    busy_until[host] = step + dur
            elif r < p_straggler + p_slowdown:
                events.append(ChaosEvent(step, "slowdown", -1,
                                         magnitude=rng.uniform(1.3, 2.0),
                                         duration=rng.randint(3, 8)))
            elif r < p_straggler + p_slowdown + p_preempt:
                if busy_until[host] <= step:
                    events.append(ChaosEvent(step, "preempt", host))
                    busy_until[host] = step + 1
            elif r < p_straggler + p_slowdown + p_preempt + p_membership:
                kind = "leave" if rng.random() < 0.5 else "join"
                events.append(ChaosEvent(step, kind, host))
        return cls(seed=seed, n_hosts=n_hosts, steps=steps, events=events)

    # ------------------------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        return {"seed": self.seed, "n_hosts": self.n_hosts,
                "steps": self.steps,
                "events": [e.to_dict() for e in self.events]}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "ChaosTrace":
        return cls(seed=int(d["seed"]), n_hosts=int(d["n_hosts"]),
                   steps=int(d["steps"]),
                   events=[ChaosEvent.from_dict(e) for e in d["events"]])

    def save(self, path) -> None:
        Path(path).write_text(json.dumps(self.to_json(), indent=1))

    @classmethod
    def load(cls, path) -> "ChaosTrace":
        return cls.from_json(json.loads(Path(path).read_text()))


# ---------------------------------------------------------------------------
# Cluster state machine
# ---------------------------------------------------------------------------
class ClusterSim:
    """Replays a ChaosTrace into per-host speed state + BSP step times.

    Wall-clock composition matches DESIGN.md §3 / simcluster.CommModel:
    compute scales 1/m but runs at the pace of the slowest *synchronizing*
    host; mitigation hooks (``rebalance``, ``hot_spare``) change per-host
    shard weights / multipliers exactly the way the real driver actions
    would."""

    def __init__(self, trace: ChaosTrace, comm=None):
        self.trace = trace
        self.comm = comm or CommModel()
        self.speed: Dict[int, float] = {h: 1.0 for h in range(trace.n_hosts)}
        self.shard_weight: Dict[int, float] = dict.fromkeys(self.speed, 1.0)
        self.slowdown: float = 1.0
        # (kind, host) -> expire step; keyed so an overlapping newer event
        # EXTENDS the fault instead of being cancelled by the older expiry
        self._expiry: Dict[tuple, int] = {}
        self._by_step: Dict[int, List[ChaosEvent]] = {}
        for ev in trace.events:
            self._by_step.setdefault(ev.step, []).append(ev)
        self._next_host = trace.n_hosts

    # ------------------------------------------------------------------
    @property
    def capacity(self) -> int:
        return len(self.speed)

    def hosts(self) -> List[int]:
        return sorted(self.speed)

    # ------------------------------------------------------------------
    def advance(self, step: int) -> List[ChaosEvent]:
        """Apply expirations + this step's events; returns applied events."""
        for key, exp_step in list(self._expiry.items()):
            if exp_step <= step:
                kind, host = key
                if kind == "straggler_on" and host in self.speed:
                    self.speed[host] = 1.0
                elif kind == "slowdown":
                    self.slowdown = 1.0
                del self._expiry[key]

        applied = []
        for ev in self._by_step.get(step, []):
            if ev.kind == "straggler_on":
                if ev.host not in self.speed:
                    continue
                self.speed[ev.host] = ev.magnitude
                if ev.duration:
                    self._expiry[(ev.kind, ev.host)] = step + ev.duration
                else:   # persists until straggler_off: drop any old expiry
                    self._expiry.pop((ev.kind, ev.host), None)
            elif ev.kind == "straggler_off":
                if ev.host in self.speed:
                    self.speed[ev.host] = 1.0
                    self._expiry.pop(("straggler_on", ev.host), None)
            elif ev.kind == "slowdown":
                self.slowdown = ev.magnitude
                if ev.duration:
                    self._expiry[(ev.kind, -1)] = step + ev.duration
                else:
                    self._expiry.pop((ev.kind, -1), None)
            elif ev.kind == "preempt":
                if ev.host not in self.speed:
                    continue
                # host comes back fresh after the restore the loop performs
                self.speed[ev.host] = 1.0
                self.shard_weight[ev.host] = 1.0
            elif ev.kind == "leave":
                if self.capacity > 1 and ev.host in self.speed:
                    del self.speed[ev.host]
                    del self.shard_weight[ev.host]
                else:
                    continue
            elif ev.kind == "join":
                h = self._next_host
                self._next_host += 1
                self.speed[h] = 1.0
                self.shard_weight[h] = 1.0
            applied.append(ev)
        return applied

    # ------------------------------------------------------------------
    def assigned_hosts(self, m: int) -> List[int]:
        """BSP workers run on the first m live hosts (stable order)."""
        return self.hosts()[:m]

    def host_times(self, m: int, base_compute_s: float) -> Dict[int, float]:
        """Per-host compute seconds this step (before the barrier)."""
        out = {}
        for h in self.assigned_hosts(m):
            out[h] = (base_compute_s / m * self.speed[h]
                      * self.shard_weight[h] * self.slowdown)
        return out

    def step_time(self, m: int, base_compute_s: float, d: int,
                  sync_mask: Optional[Dict[int, bool]] = None) -> float:
        """BSP barrier time: slowest synchronizing host + comm model.

        Hosts excluded from the barrier by SSP relaxation (sync_mask False)
        do not hold up the step."""
        times = self.host_times(m, base_compute_s)
        syncing = [t for h, t in times.items()
                   if sync_mask is None or sync_mask.get(h, True)]
        compute = max(syncing) if syncing else max(times.values())
        return compute + self.comm.iteration_comm(m, 4.0 * d) * self.slowdown

    # ------------------------------------------------------------------
    # Mitigation hooks (the real driver actions, simulated)
    # ------------------------------------------------------------------
    def rebalance(self, host: int) -> None:
        """Shrink the slow host's shard so its step time renormalizes."""
        if host in self.speed and self.speed[host] > 0:
            self.shard_weight[host] = 1.0 / self.speed[host]

    def hot_spare(self, host: int) -> None:
        """Swap the slow host for a fresh standby."""
        if host in self.speed:
            self.speed[host] = 1.0
            self.shard_weight[host] = 1.0


# ---------------------------------------------------------------------------
# Run log (the replayable output artifact)
# ---------------------------------------------------------------------------
class ChaosRunLog:
    """Replayable run artifact: a view over a telemetry ``Tracker``.

    ``append(**row)`` adapts the legacy row shape into a typed
    ``ChaosStepEvent`` and emits it on the tracker; the ``rows`` property
    reconstructs the legacy dicts bit-for-bit, so golden fixtures and the
    ``to_json``/``from_json`` wire format are unchanged.  Drift/refit
    events from the streaming-model layer land on the *same* tracker but
    are kind-filtered out of ``rows`` (and hence out of signatures)."""

    EVENT_KIND = "chaos_step"
    LOG_TYPE = "chaos"

    def __init__(self, trace: ChaosTrace,
                 rows: Optional[List[Dict[str, Any]]] = None,
                 meta: Optional[Dict[str, Any]] = None,
                 tracker: Optional[Tracker] = None):
        self.trace = trace
        self.meta: Dict[str, Any] = dict(meta) if meta else {}
        self.tracker = tracker if tracker is not None else Tracker([MemorySink()])
        for row in rows or []:
            self.append(**row)

    def append(self, **row) -> None:
        self.tracker.emit(from_legacy(self.EVENT_KIND, row))

    def emit(self, event: Event) -> Event:
        """Emit a non-row event (drift, refit, ...) onto the run's bus."""
        return self.tracker.emit(event)

    # ------------------------------------------------------------------
    @property
    def rows(self) -> List[Dict[str, Any]]:
        return [e.to_legacy() for e in self.tracker.events(self.EVENT_KIND)]

    def events(self, kind: Optional[str] = None) -> List[Event]:
        """Typed events on the run's bus (all kinds unless filtered)."""
        return self.tracker.events(kind)

    # ------------------------------------------------------------------
    def signature(self) -> List[tuple]:
        """The (m, objective, decision) sequence replay must reproduce."""
        return [(r["m"], r["objective"],
                 r.get("decision"), r.get("mitigation")) for r in self.rows]

    def n_mitigations(self) -> int:
        return sum(1 for r in self.rows if r.get("mitigation"))

    def n_resizes(self) -> int:
        return sum(1 for r in self.rows
                   if r.get("decision", "").startswith("resize"))

    def final_wall_clock(self) -> float:
        warn_deprecated(f"{type(self).__name__}.final_wall_clock()",
                        'events("chaos_step")[-1].wall_s')
        rows = self.rows
        return rows[-1]["wall_s"] if rows else 0.0

    # ------------------------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        return {"trace": self.trace.to_json(), "meta": self.meta,
                "rows": self.rows}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "ChaosRunLog":
        return cls(trace=ChaosTrace.from_json(d["trace"]),
                   rows=list(d["rows"]), meta=dict(d.get("meta", {})))

    def save(self, path) -> None:
        Path(path).write_text(json.dumps(self.to_json(), indent=1))

    @classmethod
    def load(cls, path) -> "ChaosRunLog":
        return cls.from_json(json.loads(Path(path).read_text()))

    # ------------------------------------------------------------------
    def to_jsonl(self, path) -> int:
        """Dump the full event stream (with a ``run_meta`` header row that
        makes the file self-contained for replay) as JSONL."""
        header = RunMeta(log_type=self.LOG_TYPE, trace=self.trace.to_json(),
                         meta=dict(self.meta))
        return self.tracker.to_jsonl(path, header=header)

    @classmethod
    def from_jsonl(cls, path) -> "ChaosRunLog":
        events = read_events(path)
        if not events or events[0].kind != "run_meta":
            raise ValueError(f"{path}: missing run_meta header row")
        header = events[0]
        log = cls(trace=ChaosTrace.from_json(header.trace),
                  meta=dict(header.meta))
        for e in events[1:]:
            log.tracker.emit(e)
        return log


# ---------------------------------------------------------------------------
# The closed loop
# ---------------------------------------------------------------------------
class ChaosLoop:
    """Drives an executor through a ChaosTrace under closed-loop control.

    The executor contract (duck-typed; see ``optim.simcluster.SSPLocalSGD``
    and ``launch.train.TrainerExecutor``):

      * ``m`` (int attribute) — current data-parallel degree
      * ``outer_step(sync_mask: Dict[host, bool]) -> float`` — one outer
        iteration, returns the objective (primal value / train loss)
      * ``resize(m) -> None``      — re-shard to m workers (from checkpoint)
      * ``relax(local_steps) -> None`` — sync_relax mitigation: switch to
        H local steps between syncs (staleness-aware local-SGD)
      * ``checkpoint() -> None`` / ``restore() -> None``

    All wall-clock is *modeled* (ClusterSim + costs below); all trajectory
    is *real* (the executor actually optimizes).  Determinism: the loop adds
    no entropy, so one (trace, executor seed) pair fixes the whole run.
    """

    def __init__(self, sim: ClusterSim, executor,
                 controller: AdaptiveController,
                 monitor: Optional[StragglerMonitor] = None,
                 injector: Optional[FailureInjector] = None, *,
                 base_compute_s: float = 1.0, d: int = 32,
                 ckpt_every: int = 10, restore_cost_s: float = 5.0,
                 relax_local_steps: int = 2, staleness_bound: int = 4,
                 system_refit: Optional[StreamingErnest] = None,
                 measured_costs: Optional[StreamingCost] = None):
        self.sim = sim
        self.executor = executor
        self.controller = controller
        self.monitor = monitor or StragglerMonitor(consecutive=3,
                                                   min_ratio=1.5)
        self.injector = injector or FailureInjector()
        self.base_compute_s = base_compute_s
        self.d = d
        self.ckpt_every = ckpt_every
        self.restore_cost_s = restore_cost_s
        self.relax_local_steps = relax_local_steps
        self.staleness_bound = staleness_bound
        # opt-in streaming f(m) refit: feed measured step times to a
        # StreamingErnest wrapping the controller's own system model (fit()
        # mutates in place, so refits flow straight into resize planning);
        # drift/refit events land on the run log's bus, not in its rows
        self.system_refit = system_refit
        # opt-in measured recovery costs: when set AND the executor reports
        # real restore/re-shard wall-times (duck-typed ``last_recovery_s``,
        # e.g. launch.train.TrainerExecutor reading its CheckpointManager's
        # timings), the loop charges the measured cost instead of the
        # assumed constant and feeds it to the estimator — once the refit
        # fires, the learned cost also replaces the controller's
        # ``reshard_cost_s`` in resize planning.  Default off: the golden
        # convex runs keep their assumed-constant wall model bit-identical.
        self.measured_costs = measured_costs
        self._base_m_options = list(controller.m_options)
        self._relaxed: Dict[int, int] = {}   # host -> step relaxation began
        self.wall_s = 0.0

    # ------------------------------------------------------------------
    def _sync_mask(self, step: int) -> Dict[int, bool]:
        """SSP: relaxed hosts sit out the barrier except every B-th step."""
        mask = {}
        for h in self.sim.assigned_hosts(self.executor.m):
            began = self._relaxed.get(h)
            if began is None:
                mask[h] = True
            else:
                mask[h] = (step - began) % self.staleness_bound == 0
        return mask

    def _clamp_m_options(self) -> List[int]:
        opts = [o for o in self._base_m_options if o <= self.sim.capacity]
        if not opts:
            opts = [1]
        self.controller.set_m_options(opts)
        return opts

    def _recovery_cost_s(self, step: int, op: str, log: ChaosRunLog) -> float:
        """The wall-clock a restore/re-shard costs this run: the executor's
        measured wall time when measured-cost feedback is on (and the
        executor reports one), the assumed constant otherwise."""
        assumed = (self.controller.reshard_cost_s if op == "reshard"
                   else self.restore_cost_s)
        if self.measured_costs is None:
            return assumed
        last = getattr(self.executor, "last_recovery_s", None)
        measured = last(op) if callable(last) else None
        if measured is None:
            return assumed
        for ev in self.measured_costs.observe(step, measured, op=op):
            log.emit(ev)
        if self.measured_costs.learned is not None:
            # propagate into planning: the controller prices resizes with
            # the learned cost from here on
            self.controller.reshard_cost_s = self.measured_costs.estimate_s
        return measured

    def _reset_monitor(self, m: int) -> None:
        """After a resize the step-time level legitimately shifts; re-anchor
        "slow" against the system model's prediction for the new m."""
        expected = None
        if self.controller.system.theta is not None:
            expected = float(self.controller.system.predict(
                m, self.controller.data_size))
        self.monitor.reset(expected_time=expected)

    # ------------------------------------------------------------------
    def run(self, steps: Optional[int] = None) -> ChaosRunLog:
        trace = self.sim.trace
        steps = trace.steps if steps is None else steps
        log = ChaosRunLog(trace=trace, meta={
            "m0": self.executor.m, "ckpt_every": self.ckpt_every,
            "base_compute_s": self.base_compute_s})
        objective = math.inf
        self.executor.checkpoint()
        for step in range(steps):
            assigned_before = set(self.sim.assigned_hosts(self.executor.m))
            events = self.sim.advance(step)
            row: Dict[str, Any] = {
                "step": step, "m": self.executor.m,
                "events": [f"{e.kind}:{e.host}" for e in events]}

            # a preemption of an *assigned* host flows through the injector,
            # exercising the same catch -> restore path a real heartbeat
            # timeout would take (an idle host dying costs nothing)
            for e in events:
                if e.kind == "preempt" and e.host in assigned_before:
                    self.injector.schedule(step)

            # sync_relax is a MITIGATION, not a mode: once a relaxed host
            # is healthy again (fault expired, hot-spared, preempted-fresh,
            # or gone), it rejoins every barrier; when no host is relaxed
            # the executor returns to full-sync H=1
            recovered = [h for h in self._relaxed
                         if self.sim.speed.get(h, 1.0) <= 1.0]
            if recovered:
                for h in recovered:
                    del self._relaxed[h]
                if not self._relaxed:
                    self.executor.relax(1)

            # membership changes re-clamp the controller's options; a run
            # above capacity is forced down through the same resize path
            if any(e.kind in ("join", "leave") for e in events):
                opts = self._clamp_m_options()
                if self.executor.m > self.sim.capacity:
                    target = max(opts)
                    self.executor.restore()
                    self.executor.resize(target)
                    self.wall_s += self._recovery_cost_s(step, "restore", log)
                    self._reset_monitor(target)
                    row["m"] = self.executor.m
                    row["decision"] = f"resize:{target}:capacity"

            # preemption -> SimulatedFailure -> restore from checkpoint
            try:
                self.injector.check(step)
            except SimulatedFailure as e:
                self.executor.restore()
                self.wall_s += self._recovery_cost_s(step, "restore", log)
                self._reset_monitor(self.executor.m)
                row.update(objective=objective, restore=f"{e.kind}@{e.step}",
                           step_s=0.0, wall_s=round(self.wall_s, 9))
                log.append(**row)
                continue

            mask = self._sync_mask(step)
            mask_list = [mask.get(h, True)
                         for h in self.sim.assigned_hosts(self.executor.m)]
            objective = self.executor.outer_step(mask_list)
            step_s = self.sim.step_time(self.executor.m, self.base_compute_s,
                                        self.d, sync_mask=mask)
            self.wall_s += step_s
            row.update(objective=objective, step_s=round(step_s, 9))

            if self.system_refit is not None:
                for ev in self.system_refit.observe(
                        step, self.executor.m, self.controller.data_size,
                        step_s):
                    log.emit(ev)

            # straggler detection + mitigation
            host_times = self.sim.host_times(self.executor.m,
                                             self.base_compute_s)
            ev = self.monitor.observe(step, step_s, host_times=host_times)
            if ev is not None:
                if ev.host < 0:
                    # cluster-wide slowdown: every host slowed together, so
                    # there is no host to mitigate — flag it and ride it out
                    row["flag"] = f"cluster:{ev.action}"
                else:
                    row["mitigation"] = f"{ev.action}:{ev.host}"
                    if ev.action == "sync_relax":
                        self._relaxed.setdefault(ev.host, step)
                        self.executor.relax(self.relax_local_steps)
                    elif ev.action == "rebalance":
                        self.sim.rebalance(ev.host)
                    elif ev.action == "hot_spare":
                        self.sim.hot_spare(ev.host)
                        self.executor.restore()
                        self.wall_s += self._recovery_cost_s(step, "restore",
                                                             log)

            # convergence-model refit + resize decision
            decision = self.controller.observe(step, self.executor.m,
                                               objective)
            if decision is not None and decision.resize:
                target = min(decision.target_m, self.sim.capacity)
                if target != self.executor.m:
                    self.executor.checkpoint()
                    self.executor.resize(target)
                    self.wall_s += self._recovery_cost_s(step, "reshard", log)
                    self._reset_monitor(target)
                    row["decision"] = f"resize:{target}"

            if step > 0 and step % self.ckpt_every == 0:
                self.executor.checkpoint()
            row["wall_s"] = round(self.wall_s, 9)
            log.append(**row)
        log.meta["final_m"] = self.executor.m
        log.meta["final_objective"] = objective
        return log


# ---------------------------------------------------------------------------
# Canonical convex-simulator run (examples/chaos_train.py + golden tests)
# ---------------------------------------------------------------------------
def default_system_model():
    """The analytic f(m) both chaos drivers plan against: strong compute
    scaling (the regime where growing m pays), fitted the same way
    launch/dryrun.py fits its f(m) sweep."""
    ms = np.asarray([1, 2, 4, 8], np.float64)
    t_iter = 1.0 / ms + 0.01 * np.log(ms + 1.0) + 0.002 * ms
    return ErnestModel().fit(ms, np.ones_like(ms), t_iter)


def run_chaos_sim(seed: int, *, steps: int = 160, n_hosts: int = 4,
                  m0: int = 2, m_options: Sequence[int] = (1, 2, 4),
                  trace: Optional[ChaosTrace] = None,
                  n: int = 512, d: int = 32, device: DeviceLike = None,
                  indices: Optional[SSPIndexSource] = None) -> ChaosRunLog:
    """One closed-loop elastic run on the convex BSP simulator, on
    ``device`` (the card when None).

    Deterministic end to end: the trace comes from ``seed`` (or is passed
    in for replay), the SSP executor's data + minibatch draws come from the
    same seed (or its rows from ``indices``), and the loop adds no
    entropy."""
    device = resolve_device(device)
    if trace is None:
        trace = ChaosTrace.generate(seed, steps, n_hosts)
    X, y = synthetic_mnist(n=n, d=d, effective_rank=min(16, d), seed=seed)
    problem = ERMProblem(torch.from_numpy(X).to(device), torch.from_numpy(y).to(device),
                         lam=1e-2, loss="smooth_hinge")
    # lr0 tuned so convergence is *gradual* over the run — the regime where
    # adapting m mid-run pays (instant convergence leaves nothing to adapt)
    executor = SSPLocalSGD(problem, m0, lr0=0.01, seed=seed, indices=indices)

    # p_star: a cheap deterministic reference lower bound for the gap
    controller = AdaptiveController(
        default_system_model(), target_gap=0.02,
        p_star=executor.reference_floor(),
        m_options=m_options, refit_every=20, window=120,
        reshard_cost_s=2.0, min_observations=30)

    sim = ClusterSim(trace)
    loop = ChaosLoop(sim, executor, controller,
                     base_compute_s=1.0, d=d, ckpt_every=10,
                     restore_cost_s=3.0)
    log = loop.run()
    log.meta.update(seed=seed, n=n, d=d, m_options=list(m_options))
    return log


def replay(run_log: ChaosRunLog, *, device: DeviceLike = None) -> ChaosRunLog:
    """Re-run a recorded chaos run from its embedded trace + seed on
    ``device``; the result must match ``run_log.signature()`` exactly."""
    meta = run_log.meta
    return run_chaos_sim(
        int(meta["seed"]), trace=run_log.trace, m0=int(meta["m0"]),
        m_options=tuple(meta.get("m_options", (1, 2, 4))),
        n=int(meta.get("n", 512)), d=int(meta.get("d", 32)), device=device)
