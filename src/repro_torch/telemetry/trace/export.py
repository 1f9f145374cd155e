"""Trace export: Perfetto/Chrome ``trace_event`` JSON + text renderings.

``to_perfetto`` maps ``SpanEvent``s onto complete (``"ph": "X"``) trace
events — the JSON object format both ``chrome://tracing`` and the
Perfetto UI load directly.  Replicas map to Chrome "threads" so a routed
deployment renders as one lane per replica.  Serialization is fully
deterministic (stable sort, sorted keys), so byte-identical span streams
produce byte-identical files.

``format_tree`` and ``flame_summary`` are the terminal-friendly views
used by ``python -m repro_torch.telemetry trace``.  The default
``process_name`` stays the reference's, so that the same spans give the
reference's file byte for byte.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence

from .. import io as tio
from ..events import Event, SpanEvent

_US = 1e6  # trace_event timestamps are microseconds


def _spans(events: Sequence[Event]) -> List[SpanEvent]:
    return [e for e in events if isinstance(e, SpanEvent)]


def _sort_key(s: SpanEvent):
    # stable, content-only ordering: start time, longest-first (parents
    # before their children at the same t0), then ID as the tiebreak
    return (s.replica, s.t0, -s.dur, s.span_id)


def to_perfetto(events: Sequence[Event], *, process_name: str = "repro.serve") -> Dict[str, Any]:
    """Render spans as a Chrome/Perfetto ``trace_event`` JSON object."""
    spans = sorted(_spans(events), key=_sort_key)
    rows: List[Dict[str, Any]] = []
    tids = sorted({max(s.replica, 0) for s in spans}) or [0]
    rows.append(
        {
            "ph": "M",
            "name": "process_name",
            "pid": 0,
            "tid": 0,
            "args": {"name": process_name},
        }
    )
    for tid in tids:
        rows.append(
            {
                "ph": "M",
                "name": "thread_name",
                "pid": 0,
                "tid": tid,
                "args": {"name": f"replica{tid}"},
            }
        )
    for s in spans:
        args: Dict[str, Any] = {
            "span_id": s.span_id,
            "parent_id": s.parent_id,
            "trace_id": s.trace_id,
            "step": s.step,
        }
        if s.predicted_s is not None:
            args["predicted_s"] = s.predicted_s
        for k in sorted(s.attrs):
            args[k] = s.attrs[k]
        rows.append(
            {
                "ph": "X",
                "name": s.name,
                "cat": s.component,
                "ts": round(s.t0 * _US, 3),
                "dur": round(s.dur * _US, 3),
                "pid": 0,
                "tid": max(s.replica, 0),
                "args": args,
            }
        )
    return {"traceEvents": rows, "displayTimeUnit": "ms"}


def write_perfetto(path, events: Sequence[Event], *, process_name: str = "repro.serve") -> int:
    """Atomically write the Perfetto JSON; returns the span count."""
    payload = to_perfetto(events, process_name=process_name)
    tio.atomic_write_text(path, json.dumps(payload, sort_keys=True, indent=1) + "\n")
    return sum(1 for r in payload["traceEvents"] if r["ph"] == "X")


def validate_perfetto(payload: Any) -> List[str]:
    """Schema-check a trace_event payload; returns a list of problems."""
    errs: List[str] = []
    if not isinstance(payload, dict) or "traceEvents" not in payload:
        return ["payload is not a dict with a traceEvents list"]
    rows = payload["traceEvents"]
    if not isinstance(rows, list):
        return ["traceEvents is not a list"]
    seen_ids = set()
    n_spans = 0
    for i, r in enumerate(rows):
        if not isinstance(r, dict):
            errs.append(f"row {i}: not an object")
            continue
        ph = r.get("ph")
        if ph not in ("X", "M"):
            errs.append(f"row {i}: unsupported ph {ph!r}")
            continue
        for key in ("name", "pid", "tid"):
            if key not in r:
                errs.append(f"row {i}: missing {key!r}")
        if ph != "X":
            continue
        n_spans += 1
        for key in ("ts", "dur"):
            v = r.get(key)
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                errs.append(f"row {i}: {key} not numeric")
            elif v < 0:
                errs.append(f"row {i}: {key} negative ({v})")
        args = r.get("args", {})
        sid = args.get("span_id")
        if not sid:
            errs.append(f"row {i}: args.span_id missing")
        elif sid in seen_ids:
            errs.append(f"row {i}: duplicate span_id {sid}")
        else:
            seen_ids.add(sid)
    if n_spans == 0:
        errs.append("no complete (ph=X) span rows")
    # parent links must resolve within the file
    for i, r in enumerate(rows):
        if isinstance(r, dict) and r.get("ph") == "X":
            pid = r.get("args", {}).get("parent_id", "")
            if pid and pid not in seen_ids:
                errs.append(f"row {i}: parent_id {pid} not in file")
    return errs


def format_tree(
    events: Sequence[Event],
    *,
    max_roots: int = 20,
    max_children: int = 12,
) -> str:
    """Indented span tree: one block per root span, children nested."""
    spans = sorted(_spans(events), key=_sort_key)
    if not spans:
        return "(no spans)"
    by_id = {s.span_id: s for s in spans}
    children: Dict[str, List[SpanEvent]] = {}
    roots: List[SpanEvent] = []
    for s in spans:
        if s.parent_id and s.parent_id in by_id:
            children.setdefault(s.parent_id, []).append(s)
        else:
            roots.append(s)
    lines: List[str] = []

    def _fmt(s: SpanEvent, depth: int) -> None:
        pred = f"  pred={s.predicted_s * 1e3:.3f}ms" if s.predicted_s is not None else ""
        rep = f" r{s.replica}" if s.replica >= 0 else ""
        lines.append(
            f"{'  ' * depth}{s.name:<{max(24 - 2 * depth, 8)}}"
            f" {s.dur * 1e3:9.3f}ms{pred}  [{s.component}{rep} step={s.step}]"
        )
        kids = children.get(s.span_id, [])
        for c in kids[:max_children]:
            _fmt(c, depth + 1)
        if len(kids) > max_children:
            lines.append(f"{'  ' * (depth + 1)}... {len(kids) - max_children} more children")

    shown = roots[:max_roots]
    for r in shown:
        _fmt(r, 0)
    if len(roots) > max_roots:
        lines.append(f"... {len(roots) - max_roots} more root spans")
    lines.append(f"{len(spans)} spans, {len(roots)} roots")
    return "\n".join(lines)


def flame_summary(events: Sequence[Event], *, width: int = 40) -> str:
    """Per-component aggregate bars — a flat 'flame' view of where time went.

    Only root-relative *self* time would need the full tree; for the
    flat summary each component's total span time is enough because the
    instrumented scopes per component do not nest within themselves."""
    spans = _spans(events)
    if not spans:
        return "(no spans)"
    totals: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    child_total: Dict[str, float] = {}
    by_id = {s.span_id: s for s in spans}
    for s in spans:
        totals[s.component] = totals.get(s.component, 0.0) + s.dur
        counts[s.component] = counts.get(s.component, 0) + 1
        if s.parent_id and s.parent_id in by_id:
            p = by_id[s.parent_id]
            child_total[p.span_id] = child_total.get(p.span_id, 0.0) + s.dur
    # self time per component = own dur minus time covered by children
    self_totals: Dict[str, float] = {}
    for s in spans:
        self_totals[s.component] = self_totals.get(s.component, 0.0) + max(
            0.0, s.dur - child_total.get(s.span_id, 0.0)
        )
    total_self = sum(self_totals.values()) or 1.0
    lines = [f"{'component':<24} {'n':>6} {'self_s':>10} {'share':>7}"]
    for comp in sorted(self_totals, key=lambda c: -self_totals[c]):
        share = self_totals[comp] / total_self
        bar = "#" * max(1, int(round(share * width))) if self_totals[comp] > 0 else ""
        lines.append(
            f"{comp:<24} {counts[comp]:>6} {self_totals[comp]:>10.4f} {share:>6.1%} {bar}"
        )
    return "\n".join(lines)


def load_perfetto(path) -> Dict[str, Any]:
    """Read a Perfetto JSON file back (for validation round trips)."""
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def span_roots(events: Sequence[Event]) -> List[SpanEvent]:
    """Spans with no in-stream parent (the top-level scopes)."""
    spans = _spans(events)
    ids = {s.span_id for s in spans}
    return [s for s in spans if not s.parent_id or s.parent_id not in ids]


def total_span_time(events: Sequence[Event], component: Optional[str] = None) -> float:
    """Sum of root span durations (or all spans of one component)."""
    if component is not None:
        return sum(s.dur for s in _spans(events) if s.component == component)
    return sum(s.dur for s in span_roots(events))
