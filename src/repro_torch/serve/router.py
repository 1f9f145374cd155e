"""Prefix-affinity router over N serve-engine replicas: the port of
``repro/serve/router.py`` (DESIGN.md §13), its dispatch rules, events and
names unchanged.

A fleet of replicas multiplies throughput only if requests land where their
KV pages already live: the prefix cache is per-replica state, so a
round-robin fleet pays a cold prefill for every request whose prompt head a
*different* replica already holds.  The router therefore dispatches each
request to the replica owning the **longest cached prefix** of its prompt
(probed side-effect-free with ``PrefixCache.peek`` — only the chosen replica
perturbs its LRU state), with two corrections:

* **load-aware tiebreak** — among replicas tied at the best affinity (and
  among all replicas when nobody has cached pages), the least-loaded wins,
  measured in ``Scheduler.pending_tokens`` (outstanding prompt + generation
  positions, the unit decode steps are actually spent on); remaining ties
  break to the lowest replica index, keeping dispatch fully deterministic;
* **overflow spill** — an affinity winner whose load exceeds the fleet
  minimum by more than ``spill_slack`` tokens forfeits the request to the
  least-loaded replica: re-prefilling a prefix is cheaper than queueing
  behind a hot spot (the classic consistent-hashing-with-bounded-loads
  escape hatch).

Requests are dispatched at their *arrival step*, not at submit time, so
affinity decisions see the cache state earlier requests actually built.
Every decision is a typed ``RouterEvent`` on the router's telemetry bus;
``CapacityPlanner.ingest`` learns per-replica effective throughput and
affinity-hit rates from the combined router + engine streams.

Determinism and bit-identity: dispatch depends only on (trace, replica
count, spill_slack) — ``peek`` and ``pending_tokens`` are pure functions of
prior dispatches.  And because a dense-arch engine's per-request token
stream is independent of batch composition (see serve/engine.py), routing a
trace across N same-seed replicas yields **bit-identical** per-request
outputs to one engine serving the whole trace — the property
tests/test_router.py and the CI router smoke assert.

In the port the replicas of a fleet may share one ``LM`` (the serve CLI's
do): an engine's weights are read-only, so sharing them changes no bit.  On
the card the same holds across replicas whose slots differ: the engine runs
its row-wise steps over fixed row blocks, its decode steps at the fixed
``max_batch`` shape and its paged decode's rows each independent of the
others (``repro_torch.serve.engine``), which tests/test_torch_router.py and
``chip_smoke.py``'s main path 12 hold.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import Request
from repro_torch.telemetry import Event, MemorySink, RouterEvent, Tracker
from repro_torch.telemetry.trace import SpanTracer


@dataclasses.dataclass
class RoutedRequest:
    """Router-side handle: one submitted request and where it went."""

    rid: int  # router-global id (engine-local rids differ)
    prompt: np.ndarray
    max_new_tokens: int
    arrival_step: int
    frontend_embeds: Optional[np.ndarray] = None
    replica: int = -1  # chosen replica; -1 while still queued
    request: Optional[Request] = None  # engine-side record once dispatched

    @property
    def generated(self) -> List[int]:
        return [] if self.request is None else self.request.generated


class Router:
    """Dispatch a request trace across ``replicas`` lock-stepped engines."""

    def __init__(
        self,
        engines: List[ServeEngine],
        *,
        spill_slack: int = 512,
        trace: bool = False,
        trace_clock=None,
    ):
        if not engines:
            raise ValueError("router needs at least one engine")
        if spill_slack < 0:
            raise ValueError(f"spill_slack must be >= 0, got {spill_slack}")
        page_sizes = {e.page_size for e in engines}
        if len(page_sizes) != 1:
            raise ValueError(
                f"replicas disagree on page_size: {sorted(page_sizes)}; "
                "prefix affinity compares page-granular matches"
            )
        self.engines = engines
        self.page_size = engines[0].page_size
        self.spill_slack = spill_slack
        for i, eng in enumerate(engines):
            eng.replica_id = i
            if eng.spans is not None:
                # re-key each engine's trace identity to its fleet position
                # (the engine was built with replica_id=-1); spans emitted
                # from here on carry the replica tag
                eng.spans.set_trace(
                    "serve", eng.cfg.name, eng.seed, i, replica=i
                )
        self.requests: List[RoutedRequest] = []
        self._queue: List[RoutedRequest] = []
        self.step_count = 0
        self.tracker = Tracker([MemorySink()])
        # router-side dispatch spans ride the router bus, so all_events()
        # interleaves them with replica span trees under distinct trace_ids
        self.spans: Optional[SpanTracer] = (
            SpanTracer(
                self.tracker,
                trace=("router", engines[0].seed, len(engines)),
                clock=trace_clock,
            )
            if trace
            else None
        )

    # ------------------------------------------------------------------
    def submit(
        self,
        prompt: np.ndarray,
        max_new_tokens: int,
        arrival_step: int = 0,
        frontend_embeds: Optional[np.ndarray] = None,
    ) -> RoutedRequest:
        """Queue a request; it is *dispatched* when its arrival step is
        reached, so the affinity probe sees the caches earlier requests
        built rather than the cold state at submit time."""
        rr = RoutedRequest(
            rid=len(self.requests),
            prompt=np.asarray(prompt, np.int32).reshape(-1),
            max_new_tokens=max_new_tokens,
            arrival_step=arrival_step,
            frontend_embeds=frontend_embeds,
        )
        self.requests.append(rr)
        self._queue.append(rr)
        self._queue.sort(key=lambda r: (r.arrival_step, r.rid))
        return rr

    # ------------------------------------------------------------------
    def _dispatch(self, rr: RoutedRequest) -> None:
        if self.spans is None:
            return self._dispatch_inner(rr)
        with self.spans.span(
            "dispatch",
            step=self.step_count,
            component="router.dispatch",
            rid=rr.rid,
        ) as h:
            self._dispatch_inner(rr)
            h.set(replica=rr.replica)
        return None

    def _dispatch_inner(self, rr: RoutedRequest) -> None:
        loads = [eng.scheduler.pending_tokens for eng in self.engines]
        matches = [
            eng.prefix.peek(rr.prompt) if eng.prefix is not None else 0
            for eng in self.engines
        ]
        best = max(matches)
        idxs = range(len(self.engines))
        least_loaded = min(idxs, key=lambda i: (loads[i], i))
        if best > 0:
            winner = min(
                (i for i in idxs if matches[i] == best),
                key=lambda i: (loads[i], i),
            )
            if loads[winner] - loads[least_loaded] > self.spill_slack:
                replica, reason = least_loaded, "spill"
            else:
                replica, reason = winner, "affinity"
        else:
            replica, reason = least_loaded, "load"
        rr.replica = replica
        rr.request = self.engines[replica].submit(
            rr.prompt,
            rr.max_new_tokens,
            arrival_step=rr.arrival_step,
            frontend_embeds=rr.frontend_embeds,
        )
        self.tracker.emit(
            RouterEvent(
                step=self.step_count,
                rid=rr.rid,
                replica=replica,
                matched_pages=matches[replica],
                best_affinity=best,
                reason=reason,
                prompt_pages=len(rr.prompt) // self.page_size,
                loads=loads,
            )
        )

    # ------------------------------------------------------------------
    def step(self) -> int:
        """Dispatch every request whose arrival step has been reached, then
        advance all replicas one engine step in lockstep.  Returns the total
        number of requests that contributed decode tokens this step."""
        while self._queue and self._queue[0].arrival_step <= self.step_count:
            self._dispatch(self._queue.pop(0))
        n = sum(eng.step() for eng in self.engines)
        self.step_count += 1
        return n

    @property
    def drained(self) -> bool:
        return not self._queue and all(e.scheduler.drained for e in self.engines)

    def run(self, max_steps: int = 100_000) -> Dict:
        while not self.drained:
            if self.step_count >= max_steps:
                raise RuntimeError(f"trace did not drain in {max_steps} steps")
            self.step()
        return self.stats()

    # ------------------------------------------------------------------
    def events(self, kind: Optional[str] = "router") -> List[Event]:
        """Typed router events (pass ``kind=None`` for all)."""
        return self.tracker.events(kind)

    def all_events(self) -> List[Event]:
        """Router events plus every replica's serve_step events (replica-
        tagged), the combined stream ``CapacityPlanner.ingest`` consumes."""
        evs: List[Event] = list(self.tracker.events())
        for eng in self.engines:
            evs.extend(eng.events())
        return evs

    def to_jsonl(self, path) -> int:
        """Dump the combined router + replica event stream as JSONL."""
        tr = Tracker([MemorySink()])
        for ev in self.all_events():
            tr.emit(ev)
        return tr.to_jsonl(path)

    # ------------------------------------------------------------------
    def stats(self) -> Dict:
        evs = self.events("router")
        dispatched = len(evs)
        hits = sum(1 for e in evs if e.matched_pages > 0)
        routable = sum(1 for e in evs if e.prompt_pages > 0)
        per_replica = [0] * len(self.engines)
        for e in evs:
            per_replica[e.replica] += 1
        out: Dict = {
            "replicas": len(self.engines),
            "dispatched": dispatched,
            "affinity_hits": hits,
            # hit rate over requests that *could* hit (>= 1 full prompt
            # page); short prompts never have shareable pages
            "affinity_hit_rate": hits / routable if routable else 0.0,
            "spills": sum(1 for e in evs if e.reason == "spill"),
            "dispatch_per_replica": per_replica,
            "requests_finished": sum(
                e.stats()["requests_finished"] for e in self.engines
            ),
            "decode_tokens": sum(
                e.stats()["decode_tokens"] for e in self.engines
            ),
        }
        return out
