"""Continuous-batching request scheduler.

Keeps a FIFO admission queue and a fixed set of ``max_batch`` decode slots.
Requests join the running decode batch the moment a slot and enough pages
are available (*join-on-arrival*) and release their slot and pages the step
they finish (*evict-on-finish*) — the decode batch never drains and restarts.
Time is measured in decode steps, which keeps traces deterministic and
testable.

The scheduler owns all page accounting (allocation, prefix sharing, freeing);
the engine owns the tensors.  Idle slots keep page table rows pointing at the
scratch page and ``length = 0`` so the fixed-shape batched decode step stays
legal regardless of occupancy.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, List, Optional

import numpy as np

from repro_torch.serve.paging import PagePool
from repro_torch.serve.prefix import PrefixCache


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"  # admitted; prompt entering pages chunk by chunk
    RUNNING = "running"
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (P,) int32
    max_new_tokens: int
    arrival_step: int = 0
    frontend_embeds: Optional[np.ndarray] = None  # (F, d) float32
    # -- filled in by the scheduler / engine -------------------------------
    state: RequestState = RequestState.QUEUED
    slot: int = -1
    page_ids: List[int] = dataclasses.field(default_factory=list)
    n_shared_pages: int = 0
    prefill_skipped: bool = False
    full_entry: Any = None  # FullPromptEntry backing a skipped prefill
    generated: List[int] = dataclasses.field(default_factory=list)
    logits_trace: Optional[List[np.ndarray]] = None
    admitted_step: int = -1
    finished_step: int = -1
    prefill_s: float = 0.0
    prefill_pos: int = 0  # next absolute position to prefill (chunked path)
    first_token_step: int = -1  # step the first token was emitted

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


class Scheduler:
    def __init__(
        self,
        max_batch: int,
        pool: PagePool,
        prefix_cache: Optional[PrefixCache] = None,
        n_frontend_tokens: int = 0,
        prefill_chunk: Optional[int] = None,
    ):
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be a positive token budget, "
                f"got {prefill_chunk}"
            )
        self.max_batch = max_batch
        self.pool = pool
        self.prefix = prefix_cache
        self.n_frontend_tokens = n_frontend_tokens
        self.prefill_chunk = prefill_chunk
        self.queue: List[Request] = []
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.finished: List[Request] = []
        # optional SpanTracer (set by the owning engine when tracing is on):
        # admissions emit scheduler.join spans carrying the queue wait,
        # page accounting emits pages.alloc / pages.evict spans
        self.tracer: Optional[Any] = None

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        # admission backpressure: a request whose lifetime can never fit in
        # the pool must be rejected up front — queueing it would deadlock the
        # FIFO head forever (pages free up, but never enough).
        need = self.pool.pages_for(self.total_tokens(req))
        if need > self.pool.num_pages - 1:  # scratch page is pinned
            raise ValueError(
                f"request rid={req.rid} needs {need} pages but the pool only "
                f"has {self.pool.num_pages - 1} allocatable pages; it can "
                f"never be admitted"
            )
        self.queue.append(req)
        self.queue.sort(key=lambda r: (r.arrival_step, r.rid))

    @property
    def active(self) -> List[Request]:
        return [r for r in self.slots if r is not None]

    @property
    def decoding(self) -> List[Request]:
        """Slots contributing a token to this step's decode batch."""
        return [r for r in self.slots
                if r is not None and r.state is RequestState.RUNNING]

    @property
    def prefilling(self) -> List[Request]:
        """Admitted requests still streaming their prompt in, FIFO."""
        reqs = [r for r in self.slots
                if r is not None and r.state is RequestState.PREFILLING]
        return sorted(reqs, key=lambda r: (r.admitted_step, r.rid))

    # ------------------------------------------------------------------
    def plan_prefill(self) -> List[tuple]:
        """Token-budget plan for this step's chunked prefill work: FIFO over
        PREFILLING requests, each assignment ``(req, n_tokens)`` consumes up
        to one chunk (``prefill_chunk`` positions) and the step's total
        assigned tokens never exceed the ``prefill_chunk`` budget — prefill
        progress shares the step with the running decode batch instead of
        stalling it for a whole prompt."""
        if self.prefill_chunk is None:
            return []
        budget = self.prefill_chunk
        plan: List[tuple] = []
        for req in self.prefilling:
            if budget <= 0:
                break
            remaining = len(req.prompt) - req.prefill_pos
            take = min(remaining, self.prefill_chunk, budget)
            if take > 0:
                plan.append((req, take))
                budget -= take
        return plan

    @property
    def drained(self) -> bool:
        return not self.queue and all(s is None for s in self.slots)

    @property
    def pending_tokens(self) -> int:
        """Outstanding work in cache positions: unprefilled prompt tokens
        plus remaining generation, summed over queued and active requests.
        The router's load signal — comparable across replicas because it is
        denominated in decode-step work, not request counts."""
        total = 0
        for req in self.queue:
            total += self.total_tokens(req)
        for req in self.slots:
            if req is None:
                continue
            if req.state is RequestState.PREFILLING:
                total += len(req.prompt) - req.prefill_pos
            total += req.max_new_tokens - len(req.generated)
        return total

    def total_tokens(self, req: Request) -> int:
        """Cache positions this request may occupy over its lifetime.
        Frontend tokens occupy positions only when embeddings are supplied."""
        n_front = self.n_frontend_tokens if req.frontend_embeds is not None else 0
        return len(req.prompt) + n_front + req.max_new_tokens

    # ------------------------------------------------------------------
    def admit_ready(self, now: int) -> List[Request]:
        """Admit arrived requests (FIFO) while slots and pages last.  Returns
        the newly admitted requests with slot and page_ids assigned; the
        engine must then prefill them and write their pages."""
        admitted: List[Request] = []
        while self.queue and self.queue[0].arrival_step <= now:
            free_slots = [i for i, s in enumerate(self.slots) if s is None]
            if not free_slots:
                break
            req = self.queue[0]
            if not self._allocate(req):
                break  # head-of-line blocks until pages free up
            self.queue.pop(0)
            req.slot = free_slots[0]
            req.state = RequestState.RUNNING
            req.admitted_step = now
            self.slots[req.slot] = req
            admitted.append(req)
            if self.tracer is not None:
                # queue wait is denominated in engine steps (the scheduler
                # clock), not wall seconds, so it rides as an attr on a
                # zero-duration join marker; the SLO monitor reads it as
                # the join-to-first-token objective's input
                self.tracer.emit_span(
                    "join",
                    dur=0.0,
                    step=now,
                    component="scheduler.join",
                    rid=req.rid,
                    slot=req.slot,
                    wait_steps=now - req.arrival_step,
                    shared_pages=req.n_shared_pages,
                )
        return admitted

    def _allocate(self, req: Request) -> bool:
        """Reserve pages for the request's whole lifetime (prompt + frontend
        + max_new_tokens), reusing shared prefix pages where possible."""
        if self.tracer is not None:
            with self.tracer.span(
                "page_alloc", component="pages.alloc", rid=req.rid
            ) as h:
                ok = self._allocate_inner(req)
                h.set(ok=ok, pages=len(req.page_ids), shared=req.n_shared_pages)
            return ok
        return self._allocate_inner(req)

    def _allocate_inner(self, req: Request) -> bool:
        shared: List[int] = []
        use_prefix = self.prefix is not None and req.frontend_embeds is None
        if use_prefix:
            entry = self.prefix.match_full(req.prompt, self.pool)
            if entry is not None:
                shared = list(entry.page_ids)
                req.prefill_skipped = True
                req.full_entry = entry
            else:
                shared = self.prefix.match(req.prompt, self.pool)
        need = self.pool.pages_for(self.total_tokens(req)) - len(shared)
        if need > self.pool.free_pages and self.prefix is not None:
            self.prefix.release_lru(self.pool, min_free=need)
        if need > self.pool.free_pages:
            if shared:
                self.pool.free(shared)
            req.prefill_skipped = False
            req.full_entry = None
            return False
        req.page_ids = shared + self.pool.alloc(need)
        req.n_shared_pages = len(shared)
        if shared:
            self.prefix.hits += 1
            self.prefix.pages_shared += len(shared)
        if req.prefill_skipped:
            self.prefix.prefills_skipped += 1
        return True

    # ------------------------------------------------------------------
    def finish(self, req: Request, now: int) -> None:
        """Evict-on-finish: release the slot and all page references."""
        req.state = RequestState.FINISHED
        req.finished_step = now
        self.slots[req.slot] = None
        if self.tracer is not None:
            with self.tracer.span(
                "page_evict",
                step=now,
                component="pages.evict",
                rid=req.rid,
                pages=len(req.page_ids),
            ):
                self.pool.free(req.page_ids)
        else:
            self.pool.free(req.page_ids)
        req.page_ids = []
        self.finished.append(req)
