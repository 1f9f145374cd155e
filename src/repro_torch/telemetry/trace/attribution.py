"""Attribution: roll a span trace up into predicted-vs-measured rows.

Hemingway's models forecast *aggregate* pace; when the forecast misses,
this module says **where**.  Each instrumented component becomes one row
comparing the model's prediction against the measured span time:

* spans that carry ``predicted_s`` (decode/verify steps priced by the
  fitted ``CapacityPlanner``, fleet jobs priced by the pace model)
  contribute directly;
* kernel rows come from the autotuner cache: a ``tune`` event for the
  paged decode kernel predicts a decode step as
  ``n_layers * us_per_call * 1e-6``, compared against the measured
  decode spans at the same batch.

``ratio = measured / predicted`` localizes drift — a healthy component
sits near 1.0, the component hosting a 2x slowdown sits near 2.0 while
everything else stays flat.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from ..events import Event, SpanEvent, TuneEvent
from .export import span_roots


@dataclass
class ComponentRow:
    """One attribution line: a component's measured vs predicted time."""

    component: str
    n: int
    measured_s: float
    predicted_s: Optional[float] = None  # None: no model priced this scope
    share: float = 0.0  # fraction of total measured span time

    @property
    def ratio(self) -> Optional[float]:
        if self.predicted_s is None or self.predicted_s <= 0.0:
            return None
        return self.measured_s / self.predicted_s


@dataclass
class Attribution:
    """The rolled-up report plus reconciliation against engine wall time."""

    rows: List[ComponentRow] = field(default_factory=list)
    total_measured_s: float = 0.0  # sum over root spans
    n_spans: int = 0

    def row(self, component: str) -> Optional[ComponentRow]:
        for r in self.rows:
            if r.component == component:
                return r
        return None

    def reconcile(self, engine_busy_s: float, *, tol: float = 0.05) -> bool:
        """Do root span durations agree with measured engine wall time?

        The engine instruments the same scopes its ``serve_step`` events
        time, so the two totals must match within ``tol`` (default the
        acceptance bound, 5%)."""
        if engine_busy_s <= 0.0:
            return self.total_measured_s == 0.0
        return abs(self.total_measured_s - engine_busy_s) / engine_busy_s <= tol

    def worst_ratio(self) -> Optional[ComponentRow]:
        """The component whose measured/predicted ratio diverges most
        from 1.0 — where the drift lives."""
        priced = [r for r in self.rows if r.ratio is not None]
        if not priced:
            return None
        return max(priced, key=lambda r: abs(math.log(max(r.ratio, 1e-12))))


def attribute(
    events: Sequence[Event],
    *,
    planner=None,
    n_layers: int = 1,
    kernel_family: str = "flash_decode_paged",
) -> Attribution:
    """Roll spans (and tune-cache kernel rows) into an Attribution.

    ``planner`` (a fitted ``CapacityPlanner``) prices decode/verify spans
    that carry a ``batch`` attr but no inline ``predicted_s``.  ``tune``
    events present in the stream produce ``kernel/`` rows comparing the
    autotuned kernel cost (scaled by ``n_layers``) against measured
    decode spans at the same batch."""
    spans = [e for e in events if isinstance(e, SpanEvent)]
    tunes = [e for e in events if isinstance(e, TuneEvent)]

    def _predict(s: SpanEvent) -> Optional[float]:
        if s.predicted_s is not None:
            return s.predicted_s
        if planner is not None and s.component in ("engine.decode", "engine.verify"):
            batch = s.attrs.get("batch")
            if batch:
                try:
                    return float(planner.step_time(int(batch)))
                except Exception:
                    return None
        return None

    meas: Dict[str, float] = {}
    pred: Dict[str, float] = {}
    pred_n: Dict[str, int] = {}
    counts: Dict[str, int] = {}
    for s in spans:
        meas[s.component] = meas.get(s.component, 0.0) + s.dur
        counts[s.component] = counts.get(s.component, 0) + 1
        p = _predict(s)
        if p is not None:
            pred[s.component] = pred.get(s.component, 0.0) + p
            pred_n[s.component] = pred_n.get(s.component, 0) + 1

    total = sum(r.dur for r in span_roots(spans))
    rows: List[ComponentRow] = []
    for comp in sorted(meas, key=lambda c: -meas[c]):
        predicted: Optional[float] = None
        if comp in pred:
            # scale the priced subtotal up to the full span count so a
            # partially-priced component still compares like-for-like
            predicted = pred[comp] * counts[comp] / pred_n[comp]
        rows.append(
            ComponentRow(
                component=comp,
                n=counts[comp],
                measured_s=meas[comp],
                predicted_s=predicted,
                share=meas[comp] / total if total > 0 else 0.0,
            )
        )

    # kernel rows from the tune cache: predicted decode step at batch b
    # vs the measured mean decode span at that batch
    by_batch: Dict[int, List[float]] = {}
    for s in spans:
        if s.component == "engine.decode" and s.attrs.get("batch"):
            by_batch.setdefault(int(s.attrs["batch"]), []).append(s.dur)
    seen_kernel: Dict[int, TuneEvent] = {}
    for t in tunes:
        b = int(t.shape.get("b", t.shape.get("batch", 0)) or 0)
        if t.family == kernel_family and b > 0:
            seen_kernel[b] = t  # last tune wins, matches cache semantics
    for b in sorted(seen_kernel):
        durs = by_batch.get(b)
        if not durs:
            continue
        t = seen_kernel[b]
        rows.append(
            ComponentRow(
                component=f"kernel/{kernel_family}@b{b}",
                n=len(durs),
                measured_s=sum(durs) / len(durs),
                predicted_s=n_layers * t.us_per_call * 1e-6,
                share=0.0,  # informational row: not part of the span total
            )
        )

    return Attribution(rows=rows, total_measured_s=total, n_spans=len(spans))


def format_attribution(attr: Attribution) -> str:
    """Render the attribution report as an aligned text table."""
    header = (
        f"{'component':<32} {'n':>6} {'measured_s':>11} {'predicted_s':>12} "
        f"{'ratio':>6} {'share':>7}"
    )
    lines = [header, "-" * len(header)]
    for r in attr.rows:
        pred = f"{r.predicted_s:>12.4f}" if r.predicted_s is not None else f"{'-':>12}"
        ratio = f"{r.ratio:>6.2f}" if r.ratio is not None else f"{'-':>6}"
        lines.append(
            f"{r.component:<32} {r.n:>6} {r.measured_s:>11.4f} {pred} {ratio} {r.share:>6.1%}"
        )
    lines.append(f"total (root spans): {attr.total_measured_s:.4f}s over {attr.n_spans} spans")
    # drift is the *slow* direction only: a component comfortably under its
    # predicted budget (e.g. serve latency below its SLO target) is healthy
    slow = [r for r in attr.rows if r.ratio is not None and r.ratio > 1.5]
    if slow:
        worst = max(slow, key=lambda r: r.ratio)
        lines.append(
            f"drift suspect: {worst.component} measured/predicted = {worst.ratio:.2f}x"
        )
    return "\n".join(lines)
