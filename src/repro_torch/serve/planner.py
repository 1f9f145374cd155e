"""Hemingway capacity planning for the serving fleet.

Hemingway picks the algorithm and cluster size m from a fitted system model
f(m) (paper §3.2.1; Ernest, NSDI'16).  Serving is the same shaped problem:
the per-step decode latency is a smooth function of the batching operating
point b, and fleet capacity is a function of the replica count m.  This
module fits two ``ErnestModel`` instances on serve telemetry —

* ``step_model``: decode step seconds vs. active batch b, terms
  ``theta0 + theta1*b + theta2*log b`` (dispatch floor + per-sequence work +
  batching sublinearity), fitted by the same NNLS as training f(m);
* a fleet overhead term ``log m`` models load-balancer fan-out when
  extrapolating one replica's throughput to m replicas —

and answers the serving versions of the paper's two queries:

* ``plan`` (fastest-to-epsilon analogue): minimum replica count m and
  max-batch b that sustain a target QPS within a p50 latency SLO;
* ``best_latency_within_fleet`` (best-within-budget analogue): the lowest
  achievable p50 given a fixed fleet of m replicas.

Decisions are returned as ``repro_torch.core.hemingway.PlanDecision`` records with
``algorithm = "continuous@b<batch>"`` so the serve planner composes with the
training planner's reporting.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.ernest import ErnestModel
from repro_torch.core.hemingway import NoFeasiblePlan, PlanDecision, PlanResult

STEP_TERMS: Tuple[str, ...] = ("const", "m", "log_m")


def decision_batch(decision: PlanDecision) -> int:
    """Recover the batch operating point from a capacity ``PlanDecision``.

    Single point of truth for the ``continuous@b<batch>`` algorithm-label
    format ``plan``/``best_latency_within_fleet`` emit — consumers (the
    fleet simulator above all) must not parse the label themselves."""
    return int(decision.algorithm.rsplit("@b", 1)[1])


@dataclasses.dataclass
class ServeObservation:
    batch: int
    step_s: float


class CapacityPlanner:
    def __init__(self, fleet_overhead_s_per_log_m: float = 0.0):
        self.observations: List[ServeObservation] = []
        self.step_model = ErnestModel(term_names=STEP_TERMS)
        self.fleet_overhead = fleet_overhead_s_per_log_m
        # speculative-decode acceptance: tokens committed per occupied slot
        # per step (1.0 = plain one-token decode).  Measured, not assumed —
        # the engine's verify telemetry carries the committed counts.
        self._committed_tokens = 0.0
        self._slot_steps = 0.0
        # chunked-prefill throughput (tokens/s across chunk calls)
        self._prefill_tokens = 0.0
        self._prefill_s = 0.0
        # per-replica accounting from a routed (multi-engine) deployment:
        # replica index -> accumulators.  Populated by replica-tagged
        # serve_step rows (replica >= 0) and router dispatch events.
        self._replica: Dict[int, Dict[str, float]] = {}
        self._router_dispatches = 0
        self._router_hits = 0
        self._router_routable = 0
        self._router_spills = 0
        # SLO burn-rate alerts from trace.slo.SLOMonitor: an early-warning
        # signal that the live system is missing its objectives *before*
        # the drift detector accumulates enough residuals to fire.
        self._slo_alerts: List = []

    def _replica_acc(self, idx: int) -> Dict[str, float]:
        return self._replica.setdefault(
            idx,
            {
                "decode_tokens": 0.0,
                "busy_s": 0.0,
                "dispatches": 0.0,
                "affinity_hits": 0.0,
                "spills": 0.0,
            },
        )

    # ------------------------------------------------------------------
    def observe(self, batch: int, step_s: float) -> None:
        self.observations.append(ServeObservation(int(batch), float(step_s)))

    def ingest(self, events, *, n_layers: int = 1, overhead_s: float = 0.0) -> int:
        """THE telemetry entrypoint: feed typed bus events, dispatch on kind.

        * ``serve_step`` — decode and draft-verify steps feed the f(b) step
          model plus the measured accepted-tokens-per-slot-step multiplier;
          chunked-prefill steps feed the prefill throughput estimate.
        * ``tune`` — autotuner results for the paged decode kernel seed the
          step model from measured kernel timings: one decode step is
          approximated as ``n_layers * kernel + overhead_s``.
        * ``slo_alert`` — burn-rate alerts from the SLO monitor are kept
          (``slo_alerts`` / ``last_slo_alert_step``) so a planner refit can
          be triggered by budget burn before model drift is detectable.
        * ``router`` — dispatch decisions from a multi-replica router feed
          the affinity-hit rate and per-replica dispatch counts; combined
          with replica-tagged ``serve_step`` rows (``replica >= 0``) the
          planner measures each replica's *effective* throughput — a
          replica that mostly serves cold prompts decodes fewer tokens per
          busy second than an affinity-hot one.

        Other kinds are ignored, so an entire run log can be replayed in.
        Returns the number of events that contributed observations."""
        n = 0
        for ev in events:
            kind = getattr(ev, "kind", None)
            if kind == "serve_step":
                replica = int(getattr(ev, "replica", -1))
                if ev.op == "prefill":
                    self._prefill_tokens += float(ev.prefill_tokens)
                    self._prefill_s += float(ev.step_s)
                    n += 1
                elif ev.batch > 0:
                    self.observe(ev.batch, ev.step_s)
                    self._committed_tokens += float(ev.committed)
                    self._slot_steps += float(ev.batch)
                    if replica >= 0:
                        acc = self._replica_acc(replica)
                        acc["decode_tokens"] += float(ev.committed)
                        acc["busy_s"] += float(ev.step_s)
                    n += 1
            elif kind == "router":
                acc = self._replica_acc(int(ev.replica))
                acc["dispatches"] += 1
                self._router_dispatches += 1
                if ev.prompt_pages > 0:
                    self._router_routable += 1
                if ev.matched_pages > 0:
                    acc["affinity_hits"] += 1
                    self._router_hits += 1
                if ev.reason == "spill":
                    acc["spills"] += 1
                    self._router_spills += 1
                n += 1
            elif kind == "tune":
                if ev.family == "flash_decode_paged" and ev.shape.get("b", 0) > 0:
                    step_s = n_layers * ev.us_per_call * 1e-6 + overhead_s
                    self.observe(int(ev.shape["b"]), step_s)
                    n += 1
            elif kind == "slo_alert":
                self._slo_alerts.append(ev)
                n += 1
        return n

    # ------------------------------------------------------------------
    # SLO burn-rate alerts (trace.slo.SLOMonitor)
    # ------------------------------------------------------------------
    @property
    def slo_alerts(self) -> List:
        """Burn-rate alerts ingested so far, in arrival order."""
        return list(self._slo_alerts)

    @property
    def last_slo_alert_step(self) -> int:
        """Step of the most recent SLO alert (-1 when none ingested)."""
        if not self._slo_alerts:
            return -1
        return max(int(a.step) for a in self._slo_alerts)

    def observe_telemetry(self, telemetry: Sequence[Dict]) -> None:
        """Thin legacy wrapper over :meth:`ingest` for ``ServeEngine``
        row dicts ({batch, step_s, ...}).  Rows from pre-speculation
        engines (no ``kind`` key) are ingested as plain one-token decode
        steps."""
        from repro_torch.telemetry import from_legacy

        self.ingest(from_legacy("serve_step", row) for row in telemetry)

    @property
    def accepted_per_slot_step(self) -> float:
        """Measured tokens committed per occupied slot per step (>= 1 with
        speculation accepting drafts; exactly 1 without)."""
        if not self._slot_steps:
            return 1.0
        return self._committed_tokens / self._slot_steps

    @property
    def prefill_tokens_per_s(self) -> float:
        """Measured chunked-prefill throughput (0.0 when never observed)."""
        if not self._prefill_s:
            return 0.0
        return self._prefill_tokens / self._prefill_s

    # ------------------------------------------------------------------
    # multi-replica (router) accounting
    # ------------------------------------------------------------------
    @property
    def router_dispatches(self) -> int:
        """Router dispatch decisions ingested so far (0 = no router ran)."""
        return self._router_dispatches

    @property
    def affinity_hit_rate(self) -> float:
        """Fraction of *routable* dispatches (>= 1 full prompt page) that
        landed on a replica already holding cached prefix pages."""
        if not self._router_routable:
            return 0.0
        return self._router_hits / self._router_routable

    def replica_stats(self) -> Dict[int, Dict[str, float]]:
        """Per-replica measured accounting: dispatches, affinity hits,
        spills, decode tokens, busy seconds, and tokens/busy-second."""
        out: Dict[int, Dict[str, float]] = {}
        for idx in sorted(self._replica):
            acc = dict(self._replica[idx])
            busy = acc["busy_s"]
            acc["tok_per_s"] = acc["decode_tokens"] / busy if busy else 0.0
            out[idx] = acc
        return out

    def measured_effective_replicas(self) -> float:
        """Effective replica count from measured per-replica throughput:
        each replica contributes its tokens/busy-second relative to the
        fastest one, so a fleet whose replicas all run affinity-hot counts
        ~N while a skewed fleet counts fewer.  The measured analogue of the
        fractional ``m`` accepted by :meth:`tokens_per_s`; 0.0 until
        replica-tagged rows have been ingested."""
        rates = [s["tok_per_s"] for s in self.replica_stats().values()]
        peak = max(rates, default=0.0)
        if peak <= 0.0:
            return 0.0
        return sum(r / peak for r in rates)

    def observe_tuned_kernels(
        self, rows: Sequence[Dict], *, n_layers: int = 1, overhead_s: float = 0.0
    ) -> int:
        """Thin legacy wrapper over :meth:`ingest` for
        ``repro.kernels.tune.decode_step_rows`` dicts ({batch, step_s}):
        each row becomes a ``tune`` event for the paged decode kernel.
        Returns the number of rows ingested."""
        from repro_torch.telemetry import TuneEvent

        return self.ingest(
            (
                TuneEvent(
                    family="flash_decode_paged",
                    shape={"b": int(row["batch"])},
                    dtype="",
                    backend="",
                    config={},
                    us_per_call=float(row["step_s"]) * 1e6,
                )
                for row in rows
                if row["batch"] > 0
            ),
            n_layers=n_layers,
            overhead_s=overhead_s,
        )

    def fit(self) -> "CapacityPlanner":
        if len({o.batch for o in self.observations}) < 2:
            raise ValueError("need observations at >= 2 distinct batch sizes")
        b = np.asarray([o.batch for o in self.observations], np.float64)
        t = np.asarray([o.step_s for o in self.observations], np.float64)
        self.step_model.fit(b, np.ones_like(b), t)
        return self

    # ------------------------------------------------------------------
    def step_time(self, batch: int) -> float:
        return float(self.step_model.predict(float(batch), 1.0))

    def tokens_per_s(self, batch: int, m: float = 1) -> float:
        """Fleet decode throughput at operating point (b, m).  ``m`` may be
        fractional: the fleet simulator models degraded replicas (stragglers,
        cluster slowdowns) as an effective replica count.  The measured
        speculative-acceptance multiplier scales per-step tokens: a step
        commits ``batch * accepted_per_slot_step`` tokens, not ``batch``."""
        t = self.step_time(batch) + self.fleet_overhead * np.log(m + 1.0)
        return m * batch * self.accepted_per_slot_step / t

    def p50_latency_s(self, batch: int, gen_tokens: int, m: float = 1) -> float:
        """Per-request latency to decode ``gen_tokens`` at full batch b
        (``gen_tokens / accepted_per_slot_step`` steps with speculation)."""
        t = self.step_time(batch) + self.fleet_overhead * np.log(m + 1.0)
        return gen_tokens / self.accepted_per_slot_step * t

    # ------------------------------------------------------------------
    def plan(
        self,
        *,
        target_p50_s: float,
        qps: float,
        gen_tokens: int,
        batch_grid: Sequence[int],
        m_grid: Sequence[int],
    ) -> PlanResult:
        """Smallest fleet (m, then b) sustaining ``qps`` requests/s of
        ``gen_tokens``-token responses with p50 <= ``target_p50_s``."""
        table: Dict[Tuple[str, int], float] = {}
        best: Optional[PlanDecision] = None
        for m in sorted(int(x) for x in m_grid):
            for b in sorted(int(x) for x in batch_grid):
                lat = self.p50_latency_s(b, gen_tokens, m)
                cap_qps = self.tokens_per_s(b, m) / gen_tokens
                table[(f"continuous@b{b}", m)] = lat
                feasible = lat <= target_p50_s and cap_qps >= qps
                if feasible and best is None:
                    best = PlanDecision(f"continuous@b{b}", m, predicted_time=lat)
        if best is None:
            return NoFeasiblePlan(
                query="capacity_plan",
                reason=(
                    f"no (m, batch) meets p50<={target_p50_s}s at {qps} qps "
                    f"(m_grid={sorted(int(x) for x in m_grid)}, "
                    f"batch_grid={sorted(int(x) for x in batch_grid)})"
                ),
                table=table,
            )
        best.table = table
        return best

    def best_latency_within_fleet(
        self,
        *,
        m: int,
        qps: float,
        gen_tokens: int,
        batch_grid: Sequence[int],
    ) -> PlanResult:
        """Best-within-budget analogue: lowest p50 a fixed fleet of ``m``
        replicas can offer while still sustaining ``qps``."""
        table: Dict[Tuple[str, int], float] = {}
        best: Optional[PlanDecision] = None
        for b in sorted(int(x) for x in batch_grid):
            lat = self.p50_latency_s(b, gen_tokens, m)
            cap_qps = self.tokens_per_s(b, m) / gen_tokens
            table[(f"continuous@b{b}", m)] = lat
            if cap_qps < qps:
                continue
            if best is None or lat < best.predicted_time:
                best = PlanDecision(f"continuous@b{b}", m, predicted_time=lat)
        if best is None:
            return NoFeasiblePlan(
                query="best_latency_within_fleet",
                reason=(
                    f"fleet of m={m} cannot sustain {qps} qps at any "
                    f"batch in {sorted(int(x) for x in batch_grid)}"
                ),
                table=table,
            )
        best.table = table
        return best
