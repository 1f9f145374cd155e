"""Hierarchical span tracing on top of the telemetry bus.

A ``SpanTracer`` opens nested timed scopes and emits one ``SpanEvent``
per scope onto a ``Tracker`` when the scope closes.  Two properties make
traces replayable:

* **Deterministic identity** — ``trace_id`` and every ``span_id`` are
  blake2b digests of the run seed plus a monotonic per-tracer sequence
  number.  No wall-clock, PID, or randomness feeds the IDs, so two runs
  from the same seed produce the same span tree, span for span.
* **Injectable clock** — timestamps come from ``clock()`` (default
  ``time.perf_counter``).  Inject a ``CountingClock`` (or a modeled
  virtual clock, as the fleet simulator does) and the *values* are
  deterministic too, making whole trace files byte-identical across
  replays.

Spans nest via an explicit stack: the innermost open span is the parent
of the next one opened.  Events are emitted in close order (children
before parents), which every reader here handles.
"""

from __future__ import annotations

import hashlib
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from ..events import SpanEvent
from ..tracker import MemorySink, Tracker


def det_id(*parts: Any) -> str:
    """16-hex-char blake2b digest of the given parts — a deterministic ID."""
    h = hashlib.blake2b("/".join(str(p) for p in parts).encode(), digest_size=8)
    return h.hexdigest()


class CountingClock:
    """Deterministic fake clock: advances a fixed tick per reading.

    Used by tests (and ``--trace-clock steps``) to make span *values*
    reproducible, turning byte-identical trace files into a testable
    invariant instead of a best-effort claim."""

    def __init__(self, tick: float = 1e-3, t: float = 0.0):
        self.tick = float(tick)
        self.t = float(t)

    def __call__(self) -> float:
        self.t += self.tick
        return self.t


@dataclass
class _Frame:
    """One open span on the tracer stack."""

    span_id: str
    parent_id: str
    name: str
    component: str
    step: int
    t0: float
    predicted_s: Optional[float] = None
    attrs: Dict[str, Any] = field(default_factory=dict)


class SpanHandle:
    """Yielded by ``SpanTracer.span`` so the body can annotate the span."""

    def __init__(self, frame: _Frame):
        self._frame = frame

    @property
    def span_id(self) -> str:
        return self._frame.span_id

    def set(self, **attrs: Any) -> "SpanHandle":
        self._frame.attrs.update(attrs)
        return self

    def predict(self, predicted_s: Optional[float]) -> "SpanHandle":
        self._frame.predicted_s = predicted_s
        return self


class SpanTracer:
    """Emit nested ``SpanEvent``s with deterministic identity.

    One tracer corresponds to one trace (one engine run, one router, one
    fleet sim).  ``replica`` tags every span it emits; a router assigns
    it after construction via ``set_trace``."""

    def __init__(
        self,
        tracker: Optional[Tracker] = None,
        *,
        trace: Tuple[Any, ...] = ("run",),
        replica: int = -1,
        clock: Optional[Callable[[], float]] = None,
    ):
        self.tracker = tracker if tracker is not None else Tracker([MemorySink()])
        self.clock: Callable[[], float] = clock if clock is not None else time.perf_counter
        self.replica = replica
        self.trace_id = det_id("trace", *trace)
        self._seq = 0
        self._stack: List[_Frame] = []
        self._epoch: Optional[float] = None

    def set_trace(self, *trace: Any, replica: Optional[int] = None) -> None:
        """Re-key the trace identity (e.g. once a router assigns a replica).

        Only legal before the first span is opened — re-keying mid-trace
        would orphan already-emitted spans."""
        if self._seq or self._stack:
            raise RuntimeError("cannot re-key a trace after spans were emitted")
        self.trace_id = det_id("trace", *trace)
        if replica is not None:
            self.replica = replica

    # -- time ----------------------------------------------------------------

    def now(self) -> float:
        """Seconds since the tracer epoch (first clock reading = 0)."""
        t = float(self.clock())
        if self._epoch is None:
            self._epoch = t
        return t - self._epoch

    # -- span API ------------------------------------------------------------

    @property
    def depth(self) -> int:
        return len(self._stack)

    def _next_id(self) -> str:
        sid = det_id(self.trace_id, self._seq)
        self._seq += 1
        return sid

    @contextmanager
    def span(
        self,
        name: str,
        *,
        step: int = 0,
        component: str = "",
        predicted_s: Optional[float] = None,
        **attrs: Any,
    ) -> Iterator[SpanHandle]:
        """Open a timed scope; the ``SpanEvent`` is emitted on exit."""
        parent = self._stack[-1].span_id if self._stack else ""
        frame = _Frame(
            span_id=self._next_id(),
            parent_id=parent,
            name=name,
            component=component or name,
            step=step,
            t0=self.now(),
            predicted_s=predicted_s,
            attrs=dict(attrs),
        )
        self._stack.append(frame)
        try:
            yield SpanHandle(frame)
        finally:
            self._stack.pop()
            self._emit(frame, self.now() - frame.t0)

    def emit_span(
        self,
        name: str,
        *,
        dur: float,
        t0: Optional[float] = None,
        step: int = 0,
        component: str = "",
        predicted_s: Optional[float] = None,
        **attrs: Any,
    ) -> SpanEvent:
        """Emit a span with explicit timing (no scope entered).

        For pre-measured or modeled durations — a queue wait that spans
        earlier steps, a fleet tick on the virtual clock.  Parents to the
        innermost open span, like ``span``."""
        frame = _Frame(
            span_id=self._next_id(),
            parent_id=self._stack[-1].span_id if self._stack else "",
            name=name,
            component=component or name,
            step=step,
            t0=self.now() - dur if t0 is None else t0,
            predicted_s=predicted_s,
            attrs=dict(attrs),
        )
        return self._emit(frame, dur)

    def _emit(self, frame: _Frame, dur: float) -> SpanEvent:
        ev = SpanEvent(
            trace_id=self.trace_id,
            span_id=frame.span_id,
            parent_id=frame.parent_id,
            name=frame.name,
            component=frame.component,
            step=frame.step,
            replica=self.replica,
            t0=frame.t0,
            dur=dur,
            predicted_s=frame.predicted_s,
            attrs=frame.attrs,
        )
        self.tracker.emit(ev)
        return ev
