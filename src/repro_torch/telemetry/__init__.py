"""The port's telemetry bus: copies of ``repro.telemetry``'s events, tracker
and io modules (pure Python, no JAX), enough for the serve engine's
``serve_step`` events and the capacity planner.

Left for later slices: the streaming refits (``refit.py``), span tracing
(``trace/``) and the reference's ``log_from_device`` bridge from jit-compiled
JAX code (see ROADMAP.md).
"""

from .events import (
    SCHEMA_VERSION,
    ChaosStepEvent,
    CkptCostEvent,
    DriftDetected,
    Event,
    FleetTickEvent,
    RefitEvent,
    RouterEvent,
    RunMeta,
    SchemaError,
    ServeStepEvent,
    SloAlertEvent,
    SpanEvent,
    TuneEvent,
    from_dict,
    from_legacy,
    registered_kinds,
)
from .io import (
    append_jsonl,
    atomic_write_bytes,
    atomic_write_json,
    atomic_write_text,
    file_lock,
    read_jsonl,
)
from .tracker import (
    JSONLSink,
    MemorySink,
    P2Quantile,
    Sink,
    StatsSink,
    Tracker,
    default_tracker,
    read_events,
    reset_deprecation_warnings,
    set_default_tracker,
    warn_deprecated,
)

__all__ = [
    "SCHEMA_VERSION",
    "ChaosStepEvent",
    "CkptCostEvent",
    "DriftDetected",
    "Event",
    "FleetTickEvent",
    "JSONLSink",
    "MemorySink",
    "P2Quantile",
    "RefitEvent",
    "RouterEvent",
    "RunMeta",
    "SchemaError",
    "ServeStepEvent",
    "Sink",
    "SloAlertEvent",
    "SpanEvent",
    "StatsSink",
    "Tracker",
    "TuneEvent",
    "append_jsonl",
    "atomic_write_bytes",
    "atomic_write_json",
    "atomic_write_text",
    "default_tracker",
    "file_lock",
    "from_dict",
    "from_legacy",
    "read_events",
    "read_jsonl",
    "registered_kinds",
    "reset_deprecation_warnings",
    "set_default_tracker",
    "warn_deprecated",
]
