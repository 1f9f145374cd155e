"""Tracker facade + composable sinks.

A ``Tracker`` is the single write API for telemetry: every subsystem
calls ``tracker.emit(event)`` and the attached sinks decide what happens
— keep it in memory (``MemorySink``), append it to a JSONL file with an
atomic write (``JSONLSink``), or fold it into running aggregates
(``StatsSink``).  Sinks are tiny and composable; a tracker with a
memory sink is the in-process default so existing run logs keep their
``rows``-style readers as thin views over the event stream.

A copy of ``repro.telemetry.tracker`` for the port, without
``log_from_device`` (the reference's bridge from jit-compiled JAX code to the
bus, which the port has no use for).
"""

from __future__ import annotations

import json
import warnings
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Sequence

from . import io as tio
from .events import Event, from_dict


class Sink:
    """Interface for event consumers attached to a Tracker."""

    def write(self, event: Event) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self.flush()

    def __enter__(self) -> "Sink":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


class MemorySink(Sink):
    """Keep events in memory (optionally a bounded ring)."""

    def __init__(self, maxlen: Optional[int] = None):
        self._events: deque = deque(maxlen=maxlen)

    def write(self, event: Event) -> None:
        self._events.append(event)

    def events(self, kind: Optional[str] = None) -> List[Event]:
        if kind is None:
            return list(self._events)
        return [e for e in self._events if e.kind == kind]

    def __len__(self) -> int:
        return len(self._events)


class JSONLSink(Sink):
    """Buffer events and flush them to a JSONL file via atomic append."""

    def __init__(self, path, flush_every: int = 64):
        self.path = path
        self.flush_every = max(1, int(flush_every))
        self._buf: List[str] = []
        self.written = 0

    def write(self, event: Event) -> None:
        self._buf.append(json.dumps(event.to_dict(), sort_keys=True))
        if len(self._buf) >= self.flush_every:
            self.flush()

    def flush(self) -> None:
        if self._buf:
            self.written += tio.append_jsonl(self.path, self._buf)
            self._buf = []


class P2Quantile:
    """Streaming quantile estimate via the P² algorithm (Jain & Chlamtac).

    Five markers track the target quantile without buffering the stream;
    below five observations the estimate is exact (sorted lookup).  Each
    ``observe`` is O(1), so a sink can afford one estimator per numeric
    field per kind."""

    def __init__(self, p: float):
        if not 0.0 < p < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {p}")
        self.p = p
        self._n = 0
        self._q: List[float] = []  # marker heights
        self._pos: List[float] = []  # marker positions (1-based)

    def observe(self, x: float) -> None:
        x = float(x)
        self._n += 1
        if self._n <= 5:
            self._q.append(x)
            self._q.sort()
            if self._n == 5:
                self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
            return
        q, pos, p = self._q, self._pos, self.p
        if x < q[0]:
            q[0] = x
            k = 0
        elif x >= q[4]:
            q[4] = x
            k = 3
        else:
            k = 0
            while k < 3 and x >= q[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            pos[i] += 1.0
        n = pos[4]
        # desired positions for the five markers at stream length n
        desired = [
            1.0,
            1.0 + (n - 1) * p / 2.0,
            1.0 + (n - 1) * p,
            1.0 + (n - 1) * (1.0 + p) / 2.0,
            n,
        ]
        for i in (1, 2, 3):
            d = desired[i] - pos[i]
            if (d >= 1.0 and pos[i + 1] - pos[i] > 1.0) or (d <= -1.0 and pos[i - 1] - pos[i] < -1.0):
                d = 1.0 if d >= 0 else -1.0
                # parabolic (piecewise-quadratic) prediction of the new height
                qi = q[i] + d / (pos[i + 1] - pos[i - 1]) * (
                    (pos[i] - pos[i - 1] + d) * (q[i + 1] - q[i]) / (pos[i + 1] - pos[i])
                    + (pos[i + 1] - pos[i] - d) * (q[i] - q[i - 1]) / (pos[i] - pos[i - 1])
                )
                if not q[i - 1] < qi < q[i + 1]:
                    # parabola escaped the bracket: fall back to linear
                    j = i + (1 if d > 0 else -1)
                    qi = q[i] + d * (q[j] - q[i]) / (pos[j] - pos[i])
                q[i] = qi
                pos[i] += d

    def value(self) -> float:
        if self._n == 0:
            return float("nan")
        if self._n <= 5:
            # exact while the sample fits in the marker buffer
            s = sorted(self._q)
            idx = self.p * (len(s) - 1)
            lo = int(idx)
            hi = min(lo + 1, len(s) - 1)
            return s[lo] + (idx - lo) * (s[hi] - s[lo])
        return self._q[2]

    @property
    def n(self) -> int:
        return self._n


#: percentiles every StatsSink tracks per numeric field
STATS_PERCENTILES = (0.5, 0.95, 0.99)


class StatsSink(Sink):
    """Fold events into per-kind counts and numeric-field aggregates.

    Besides min/mean/max, each numeric field carries streaming
    p50/p95/p99 estimates (P² — constant memory, no buffering), so
    ``summarize`` and SLO reports see real latency percentiles."""

    def __init__(self):
        self.counts: Dict[str, int] = {}
        self._sums: Dict[str, Dict[str, float]] = {}
        self._mins: Dict[str, Dict[str, float]] = {}
        self._maxs: Dict[str, Dict[str, float]] = {}
        self._quant: Dict[str, Dict[str, Dict[float, P2Quantile]]] = {}

    def write(self, event: Event) -> None:
        k = event.kind
        self.counts[k] = self.counts.get(k, 0) + 1
        sums = self._sums.setdefault(k, {})
        mins = self._mins.setdefault(k, {})
        maxs = self._maxs.setdefault(k, {})
        quant = self._quant.setdefault(k, {})
        for name, v in event.to_dict().items():
            if name in ("kind", "v") or isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            sums[name] = sums.get(name, 0.0) + v
            mins[name] = min(mins.get(name, v), v)
            maxs[name] = max(maxs.get(name, v), v)
            est = quant.setdefault(name, {p: P2Quantile(p) for p in STATS_PERCENTILES})
            for q in est.values():
                q.observe(v)

    def summary(self) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        for k, n in sorted(self.counts.items()):
            fields = {}
            for name, s in sorted(self._sums[k].items()):
                fields[name] = {
                    "mean": s / n,
                    "min": self._mins[k][name],
                    "max": self._maxs[k][name],
                }
                for p, est in self._quant[k][name].items():
                    fields[name][f"p{int(p * 100)}"] = est.value()
            out[k] = {"count": n, "fields": fields}
        return out


class Tracker:
    """The one emit API.  Fans each event out to every attached sink."""

    def __init__(self, sinks: Optional[Sequence[Sink]] = None):
        if sinks is None:
            sinks = [MemorySink()]
        self.sinks: List[Sink] = list(sinks)

    # -- write side ---------------------------------------------------------

    def emit(self, event: Event) -> Event:
        for s in self.sinks:
            s.write(event)
        return event

    def emit_many(self, events: Iterable[Event]) -> int:
        n = 0
        for e in events:
            self.emit(e)
            n += 1
        return n

    def flush(self) -> None:
        for s in self.sinks:
            s.flush()

    def close(self) -> None:
        for s in self.sinks:
            s.close()

    def __enter__(self) -> "Tracker":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # -- read side (delegates to the first capable sink) --------------------

    def _memory(self) -> Optional[MemorySink]:
        for s in self.sinks:
            if isinstance(s, MemorySink):
                return s
        return None

    def events(self, kind: Optional[str] = None) -> List[Event]:
        mem = self._memory()
        if mem is None:
            return []
        return mem.events(kind)

    def summary(self) -> Dict[str, Dict[str, Any]]:
        for s in self.sinks:
            if isinstance(s, StatsSink):
                return s.summary()
        stats = StatsSink()
        for e in self.events():
            stats.write(e)
        return stats.summary()

    def to_jsonl(self, path, header: Optional[Event] = None) -> int:
        """Dump buffered events (plus optional header) to a JSONL file."""
        events: List[Event] = list(self.events())
        if header is not None:
            events = [header] + events
        return tio.append_jsonl(path, [json.dumps(e.to_dict(), sort_keys=True) for e in events])


def read_events(path) -> List[Event]:
    """Parse a JSONL event log back into typed events.

    A torn *trailing* line (a writer died mid-append between flush
    boundaries) is skipped with a warning instead of raising — every
    complete row before it is still returned.  Malformed JSON anywhere
    else in the file is still an error: that is corruption, not a torn
    tail."""
    with open(path, "r", encoding="utf-8") as f:
        lines = f.read().splitlines()
    out: List[Event] = []
    last = len(lines) - 1
    for i, line in enumerate(lines):
        s = line.strip()
        if not s:
            continue
        try:
            d = json.loads(s)
        except json.JSONDecodeError:
            if i == last:
                warnings.warn(
                    f"{path}: skipping torn trailing line ({len(s)} bytes)",
                    RuntimeWarning,
                    stacklevel=2,
                )
                continue
            raise
        out.append(from_dict(d))
    return out


_DEFAULT: Optional[Tracker] = None


def default_tracker() -> Tracker:
    """Process-wide tracker for emitters with no explicit bus wired in."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Tracker([MemorySink(maxlen=4096)])
    return _DEFAULT


def set_default_tracker(tracker: Optional[Tracker]) -> Optional[Tracker]:
    global _DEFAULT
    prev = _DEFAULT
    _DEFAULT = tracker
    return prev


# ---------------------------------------------------------------------------
# one-release deprecation shim helper
# ---------------------------------------------------------------------------

_WARNED: set = set()


def warn_deprecated(old: str, new: str) -> None:
    """Warn once per process that ``old`` is deprecated in favor of ``new``."""
    if old in _WARNED:
        return
    _WARNED.add(old)
    warnings.warn(
        f"{old} is deprecated and will be removed next release; use {new} instead",
        DeprecationWarning,
        stacklevel=3,
    )


def reset_deprecation_warnings() -> None:
    """Test hook: make every deprecation warn again."""
    _WARNED.clear()
