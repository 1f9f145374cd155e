"""Typed, versioned event schema for the telemetry bus.

Every measurement in the repo — kernel tune results, serve engine step
timings, chaos training steps, fleet scheduler ticks, and the streaming
model-refit lifecycle — is one of the frozen dataclasses below.  Each
event carries:

* ``kind``      — registry key, serialized as ``"kind"``;
* ``schema_version`` — serialized as ``"v"``; readers reject rows from a
  *newer* schema than they understand and accept older ones;
* ``step``      — monotonic step / tick index within a run.

``from_legacy(kind, row)`` adapts the four pre-bus ad-hoc row shapes
into events, and ``Event.to_legacy()`` reproduces the original dict
bit-for-bit so golden-trace fixtures replay unchanged.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, ClassVar, Dict, List, Optional, Type

SCHEMA_VERSION = 1


class SchemaError(ValueError):
    """A serialized row does not match the event schema."""


_REGISTRY: Dict[str, Type["Event"]] = {}


def register(cls: Type["Event"]) -> Type["Event"]:
    """Class decorator: register an Event subclass under its ``kind``."""
    if not cls.kind:
        raise ValueError(f"{cls.__name__} must define a non-empty kind")
    if cls.kind in _REGISTRY:
        raise ValueError(f"duplicate event kind {cls.kind!r}")
    _REGISTRY[cls.kind] = cls
    return cls


def registered_kinds() -> List[str]:
    return sorted(_REGISTRY)


@dataclass(frozen=True)
class Event:
    """Base class for all telemetry events."""

    kind: ClassVar[str] = ""
    schema_version: ClassVar[int] = SCHEMA_VERSION

    def to_dict(self) -> dict:
        """Serialize to a JSON-ready dict with ``kind`` and ``v`` header."""
        d = {"kind": self.kind, "v": self.schema_version}
        for f in dataclasses.fields(self):
            d[f.name] = getattr(self, f.name)
        return d

    def to_legacy(self) -> dict:
        """Reproduce the pre-bus row shape.  Default: fields as-is."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


def from_dict(d: dict) -> Event:
    """Deserialize a dict produced by ``Event.to_dict`` (or a JSONL row)."""
    if not isinstance(d, dict) or "kind" not in d:
        raise SchemaError(f"not an event row: {d!r}")
    kind = d["kind"]
    cls = _REGISTRY.get(kind)
    if cls is None:
        raise SchemaError(f"unknown event kind {kind!r}")
    v = d.get("v", 1)
    if v > cls.schema_version:
        raise SchemaError(f"event kind {kind!r} has schema v{v}, reader understands v{cls.schema_version}")
    names = {f.name for f in dataclasses.fields(cls)}
    required = {
        f.name
        for f in dataclasses.fields(cls)
        if f.default is dataclasses.MISSING and f.default_factory is dataclasses.MISSING
    }
    payload = {k: val for k, val in d.items() if k in names}
    missing = required - set(payload)
    if missing:
        raise SchemaError(f"event kind {kind!r} missing fields {sorted(missing)}")
    extra = {k for k in d if k not in names and k not in ("kind", "v")}
    if extra and "extra" in names:
        payload.setdefault("extra", {})
        payload["extra"] = {**{k: d[k] for k in sorted(extra)}, **payload["extra"]}
    return cls(**payload)


def from_legacy(kind: str, row: dict) -> Event:
    """Adapt one of the four legacy row shapes to a typed event."""
    cls = _REGISTRY.get(kind)
    if cls is None:
        raise SchemaError(f"unknown event kind {kind!r}")
    hook = getattr(cls, "from_legacy_row", None)
    if hook is None:
        raise SchemaError(f"event kind {kind!r} has no legacy adapter")
    return hook(row)


# ---------------------------------------------------------------------------
# kernel tune results (legacy: ConfigCache entry dicts)
# ---------------------------------------------------------------------------


@register
@dataclass(frozen=True)
class TuneEvent(Event):
    """One autotuner sweep result: best config + timing for a kernel shape."""

    kind: ClassVar[str] = "tune"

    family: str
    shape: Dict[str, Any]
    dtype: str
    backend: str
    config: Dict[str, Any]
    us_per_call: float
    swept: int = 0
    pruned: int = 0
    step: int = 0

    @classmethod
    def from_legacy_row(cls, row: dict) -> "TuneEvent":
        return cls(
            family=row["family"],
            shape=dict(row["shape"]),
            dtype=row["dtype"],
            backend=row["backend"],
            config=dict(row["config"]),
            us_per_call=row["us_per_call"],
            swept=row.get("candidates_swept", 0),
            pruned=row.get("candidates_pruned", 0),
        )

    def to_legacy(self) -> dict:
        return {
            "family": self.family,
            "shape": dict(self.shape),
            "dtype": self.dtype,
            "backend": self.backend,
            "config": dict(self.config),
            "us_per_call": self.us_per_call,
            "candidates_swept": self.swept,
            "candidates_pruned": self.pruned,
        }


# ---------------------------------------------------------------------------
# serve engine step telemetry (legacy: ServeEngine.telemetry dicts)
# ---------------------------------------------------------------------------


@register
@dataclass(frozen=True)
class ServeStepEvent(Event):
    """One serve-engine step: a prefill chunk, a decode step, or a
    speculative verify step.  ``op`` holds what the legacy rows called
    ``kind`` (that name is taken by the bus header)."""

    kind: ClassVar[str] = "serve_step"

    step: int
    step_s: float
    op: str  # "prefill" | "decode" | "verify"
    batch: int = 0
    committed: int = 0
    drafted: int = 0
    prefill_tokens: int = 0
    t_s: float = 0.0
    # emitting replica in a multi-engine (routed) deployment; -1 for a
    # standalone engine.  Additive field with a default: older rows parse
    # unchanged, and ``to_legacy`` never emits it (the pre-bus row shape
    # predates multi-replica serving).
    replica: int = -1

    @classmethod
    def from_legacy_row(cls, row: dict) -> "ServeStepEvent":
        op = row.get("kind", "decode")
        batch = int(row.get("batch", 0))
        return cls(
            step=int(row.get("step", 0)),
            step_s=float(row["step_s"]),
            op=op,
            batch=batch,
            committed=int(row.get("committed", batch if op != "prefill" else 0)),
            drafted=int(row.get("drafted", 0)),
            prefill_tokens=int(row.get("prefill_tokens", 0)),
            t_s=float(row.get("t_s", 0.0)),
        )

    def to_legacy(self) -> dict:
        if self.op == "prefill":
            return {
                "step": self.step,
                "batch": 0,
                "step_s": self.step_s,
                "kind": "prefill",
                "prefill_tokens": self.prefill_tokens,
            }
        row = {
            "step": self.step,
            "batch": self.batch,
            "step_s": self.step_s,
            "kind": self.op,
            "committed": self.committed,
        }
        if self.op == "verify":
            row["drafted"] = self.drafted
        return row


# ---------------------------------------------------------------------------
# router dispatch decisions (multi-replica serving; no legacy shape)
# ---------------------------------------------------------------------------


@register
@dataclass(frozen=True)
class RouterEvent(Event):
    """One routing decision: which replica got a request and why.

    ``reason`` is the dispatch rule that fired: ``"affinity"`` (longest
    cached-prefix owner won), ``"load"`` (no replica had cached pages;
    least-loaded won), or ``"spill"`` (the affinity winner was overloaded
    and the request overflowed to the least-loaded replica)."""

    kind: ClassVar[str] = "router"

    step: int  # arrival step of the dispatched request
    rid: int  # router-global request id
    replica: int  # chosen replica index
    matched_pages: int  # cached full prefix pages on the chosen replica
    best_affinity: int  # best cached-prefix match across ALL replicas
    reason: str  # "affinity" | "load" | "spill"
    prompt_pages: int = 0  # full pages in the request's prompt
    loads: List[int] = field(default_factory=list)  # pending tokens/replica


# ---------------------------------------------------------------------------
# chaos training steps (legacy: ChaosRunLog rows)
# ---------------------------------------------------------------------------

_CHAOS_OPTIONAL = (
    "objective",
    "restore",
    "step_s",
    "wall_s",
    "mitigation",
    "flag",
    "decision",
)


@register
@dataclass(frozen=True)
class ChaosStepEvent(Event):
    """One chaos-loop training step (or restore pause)."""

    kind: ClassVar[str] = "chaos_step"

    step: int
    m: int
    events: List[str] = field(default_factory=list)
    objective: Optional[float] = None
    restore: Optional[bool] = None
    step_s: Optional[float] = None
    wall_s: Optional[float] = None
    mitigation: Optional[str] = None
    flag: Optional[str] = None
    decision: Optional[str] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_legacy_row(cls, row: dict) -> "ChaosStepEvent":
        known = {"step", "m", "events", *_CHAOS_OPTIONAL}
        return cls(
            step=row["step"],
            m=row["m"],
            events=list(row.get("events", [])),
            **{k: row[k] for k in _CHAOS_OPTIONAL if k in row},
            extra={k: row[k] for k in row if k not in known},
        )

    def to_legacy(self) -> dict:
        row: Dict[str, Any] = {"step": self.step, "m": self.m, "events": list(self.events)}
        for k in _CHAOS_OPTIONAL:
            v = getattr(self, k)
            if v is not None:
                row[k] = v
        row.update(self.extra)
        return row


# ---------------------------------------------------------------------------
# fleet scheduler ticks (legacy: FleetRunLog rows)
# ---------------------------------------------------------------------------


@register
@dataclass(frozen=True)
class FleetTickEvent(Event):
    """One fleet-scheduler tick: decisions plus per-tenant snapshots."""

    kind: ClassVar[str] = "fleet_tick"

    step: int
    events: List[str] = field(default_factory=list)
    decisions: List[str] = field(default_factory=list)
    serve: Dict[str, Any] = field(default_factory=dict)
    jobs: Dict[str, Any] = field(default_factory=dict)
    free: int = 0
    cost_hh: float = 0.0
    extra: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_legacy_row(cls, row: dict) -> "FleetTickEvent":
        known = {"step", "events", "decisions", "serve", "jobs", "free", "cost_hh"}
        return cls(
            step=row["step"],
            events=list(row.get("events", [])),
            decisions=list(row.get("decisions", [])),
            serve=row.get("serve", {}),
            jobs=row.get("jobs", {}),
            free=row.get("free", 0),
            cost_hh=row.get("cost_hh", 0.0),
            extra={k: row[k] for k in row if k not in known},
        )

    def to_legacy(self) -> dict:
        row: Dict[str, Any] = {
            "step": self.step,
            "events": list(self.events),
            "decisions": list(self.decisions),
            "serve": self.serve,
            "jobs": self.jobs,
            "free": self.free,
            "cost_hh": self.cost_hh,
        }
        row.update(self.extra)
        return row


# ---------------------------------------------------------------------------
# hierarchical trace spans + SLO burn-rate alerts (no legacy shape)
# ---------------------------------------------------------------------------


@register
@dataclass(frozen=True)
class SpanEvent(Event):
    """One timed scope in a hierarchical trace.

    ``trace_id``/``span_id``/``parent_id`` are deterministic hex digests
    derived from the run seed plus a monotonic per-tracer sequence — no
    wall-clock or randomness feeds the IDs, so traces from the same seed
    replay with bit-identical structure.  ``t0``/``dur`` are seconds
    relative to the tracer epoch; with the default wall clock they carry
    measured time, with an injected deterministic clock (modeled fleet
    time, or ``CountingClock`` in tests) the whole span stream — file
    bytes included — is reproducible.  ``predicted_s`` optionally holds
    the model's forecast for the scope (ErnestModel / CapacityPlanner /
    tune-cache kernel cost) so attribution can compare predicted vs
    measured per component."""

    kind: ClassVar[str] = "span"

    trace_id: str
    span_id: str
    name: str
    t0: float
    dur: float
    parent_id: str = ""
    component: str = ""
    step: int = 0
    replica: int = -1
    predicted_s: Optional[float] = None
    attrs: Dict[str, Any] = field(default_factory=dict)


@register
@dataclass(frozen=True)
class SloAlertEvent(Event):
    """A service-level objective is burning error budget too fast.

    Emitted by ``trace.slo.SLOMonitor`` when the bad-event fraction over
    the rolling window exceeds ``burn_threshold`` times the allowed
    budget.  ``burn_rate`` of 1.0 means the budget is being consumed
    exactly at the sustainable rate; 2x+ is the classic fast-burn page."""

    kind: ClassVar[str] = "slo_alert"

    step: int
    slo: str  # monitor name, e.g. "serve_bg" or "per_token"
    objective: str  # "join_to_first_token" | "per_token_latency" | ...
    target: float  # threshold a good observation must stay under
    burn_rate: float  # window bad-fraction / budget
    budget: float  # allowed bad fraction (error budget)
    window_bad: int  # bad observations in the rolling window
    window: int  # rolling window size
    budget_remaining: float = 1.0  # lifetime error budget left (0..1)


# ---------------------------------------------------------------------------
# checkpoint / migration costs (no legacy shape)
# ---------------------------------------------------------------------------


@register
@dataclass(frozen=True)
class CkptCostEvent(Event):
    """One measured checkpoint/restore/re-shard/migration wall-time.

    Emitted wherever the fault-tolerance machinery actually runs — the
    ``CheckpointManager`` writer thread, the chaos loop's restore path,
    ``serve.migrate``'s replica handoff, and the fleet scheduler's
    modeled recoveries — so planners can refit their *assumed* recovery
    constants from *measured* cost (``assumed_s`` records what the
    planner believed at the time, when known)."""

    kind: ClassVar[str] = "ckpt_cost"

    step: int
    op: str  # "save" | "restore" | "reshard" | "migrate"
    wall_s: float
    assumed_s: Optional[float] = None
    workload: str = ""  # job/deployment name, or "" for a standalone run
    nbytes: int = 0
    n_shards: int = 0
    replica: int = -1


# ---------------------------------------------------------------------------
# streaming-refit lifecycle
# ---------------------------------------------------------------------------


@register
@dataclass(frozen=True)
class DriftDetected(Event):
    """Normalized prediction error of a model exceeded its threshold."""

    kind: ClassVar[str] = "drift"

    step: int
    model: str
    residual: float
    threshold: float
    window: int


@register
@dataclass(frozen=True)
class RefitEvent(Event):
    """A streaming model was re-fit from a trailing observation window."""

    kind: ClassVar[str] = "refit"

    step: int
    model: str
    n_obs: int
    residual_before: float
    residual_after: float


@register
@dataclass(frozen=True)
class RunMeta(Event):
    """JSONL header event making an event log self-contained for replay."""

    kind: ClassVar[str] = "run_meta"

    log_type: str
    trace: Optional[Dict[str, Any]] = None
    meta: Dict[str, Any] = field(default_factory=dict)
    step: int = -1
