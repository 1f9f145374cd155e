"""The port's telemetry bus: copies of ``repro.telemetry``'s events, tracker,
io and streaming-refit modules, its span tracing (``trace/``: spans, the
Perfetto export, attribution, SLO burn rate) and its CLI (``python -m
repro_torch.telemetry summarize|trace``), all pure Python and numpy, no JAX.
They carry the serve engine's ``serve_step`` events and spans, the router's
dispatch events, migration's ``ckpt_cost``, the capacity planner and the
chaos loop's drift and refit events.

Not copied: the reference's ``log_from_device``, its bridge from
jit-compiled JAX code to the bus, which the port has no use for.
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
from .refit import (
    DriftConfig,
    DriftDetector,
    StreamingCapacity,
    StreamingConvergence,
    StreamingCost,
    StreamingErnest,
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
    "DriftConfig",
    "DriftDetected",
    "DriftDetector",
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
    "StreamingCapacity",
    "StreamingConvergence",
    "StreamingCost",
    "StreamingErnest",
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
