"""repro_torch.telemetry.trace — hierarchical spans, attribution, SLO burn
rate: a copy of ``repro.telemetry.trace`` (pure Python, no JAX), its
arithmetic, names and ID scheme unchanged.

Layered on the telemetry bus: ``SpanTracer`` emits deterministic-ID
``SpanEvent``s from instrumented scopes across the serve and fleet
stacks; ``attribution`` rolls a trace into per-component
predicted-vs-measured rows; ``export`` renders Perfetto JSON and text
trees; ``slo`` turns latency streams into error-budget burn alerts.
"""

from .attribution import Attribution, ComponentRow, attribute, format_attribution
from .export import (
    flame_summary,
    format_tree,
    load_perfetto,
    span_roots,
    to_perfetto,
    total_span_time,
    validate_perfetto,
    write_perfetto,
)
from .slo import SloConfig, SLOMonitor, monitor_serve_events
from .spans import CountingClock, SpanHandle, SpanTracer, det_id

__all__ = [
    "Attribution",
    "ComponentRow",
    "attribute",
    "format_attribution",
    "flame_summary",
    "format_tree",
    "load_perfetto",
    "span_roots",
    "to_perfetto",
    "total_span_time",
    "validate_perfetto",
    "write_perfetto",
    "SloConfig",
    "SLOMonitor",
    "monitor_serve_events",
    "CountingClock",
    "SpanHandle",
    "SpanTracer",
    "det_id",
]
