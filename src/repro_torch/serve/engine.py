"""Continuous-batching serve engine over the paged KV cache (the counterpart
of ``repro/serve/engine.py``).

One fixed-shape batched decode step serves every request: each decode slot
contributes one token per step, idle slots point at the scratch page, and
requests join (after a prefill writes their pages) or leave between steps
without draining the batch.  Greedy decoding only.  Time is measured in
decode steps; a request's ``arrival_step`` gates its admission, which keeps
traces deterministic.  Per-step ``serve_step`` events feed the
``CapacityPlanner`` (``repro_torch.serve.planner``).

Ported: submit, admission with monolithic prefill, prefix reuse (shared pages
and whole-prompt skip, which restores a Mamba model's state), join-on-arrival,
the batched decode step, finish and release, ``run``, ``stats`` and
``events``; and the reference's two step-loop extensions (attention-only
archs, DESIGN.md §11), each bitwise the plain one-token engine in tokens and
logits (below):

* **chunked prefill** (``prefill_chunk=C``): prompts stream into their pages
  at most C tokens an engine step (the copied ``Scheduler.plan_prefill``
  schedule) through ``LM.prefill_chunk``; while a request is PREFILLING its
  host page-table row stays at the scratch page, so decode and verify steps
  never see it, and its last chunk registers its prefix pages and arms its
  slot;
* **speculative decode** (``speculate=k``): the n-gram / prefix-cache
  proposer (``repro_torch.serve.speculate``) drafts up to k tokens a slot,
  and when drafting is dense one verify step checks them all, committing
  the longest prefix that greedy one-token decode would have emitted.

For archs with recurrent layers both knobs raise, as in the reference, whose
Mamba state has no positional form.

The sharded data plane (``mesh=`` and ``rules=``, the reference's
``repro/serve/engine.py:209-219``): the engine's ``Runtime`` carries the mesh,
and its ``ShardingPlan`` (``repro_torch.serve.sharding``) gives the rank's
model (built one matrix at a time from ``seed``, or sliced from a whole
``lm``; a rank's model given as ``lm`` is served as it is), checks the
rank's paged cache and traces its dispatches.  Every rank runs this engine
whole: the host loop, the scheduler and the prefix cache are the same on
each, tokens, lengths and page tables stay replicated, and the logits each
step reads are the same bits on every rank.

Span tracing (``trace=True``, the reference's ``repro/serve/engine.py:193-232``)
puts a ``SpanTracer`` on the engine's bus: ``engine.step`` around each step,
``engine.prefill`` around a monolithic prefill (``skipped=True`` for a
whole-prompt hit), ``engine.prefill_chunk``, ``engine.decode`` and
``engine.verify``, and the scheduler's ``scheduler.join``, ``pages.alloc``
and ``pages.evict``.  Each engine span closes after the host has read the
scope's logits, which waits for the device's work, and lies inside the
window its ``serve_step`` event times, so span and step times reconcile;
tracing off, a scope is a no-op context and the step does nothing more.
IDs are deterministic (``("serve", arch, seed, replica_id)``); ``trace_clock``
(a ``CountingClock``) makes the timestamps so too.  ``replica_id`` (set by a
``Router``) tags the spans and the ``serve_step`` events.

A frontend arch's request (internvl2's patches, musicgen's conditioning
frames) carries ``frontend_embeds`` (F, d), F = ``n_frontend_tokens``
(``repro/serve/engine.py:240-345``): its F positions go before the prompt's
and count in ``max_seq``, its monolithic prefill takes them (never chunked),
and it registers no prefix: its pages hold positions that depend on the
embeddings, which the prefix cache's keys do not see.

DeepSeek-V2's MLA layers keep page-major latent pools ("ckv", "kpe") in
place of K/V, and its MoE layers run the reference's dropless eval
(``repro_torch.models.moe``), which keeps a token's output independent of
the other tokens of its dispatch, so the rules below hold for it too.

A Mamba model's layers keep slot-major state and no page pools; the
scheduler allocates pages for its requests all the same, which keeps the
prefix cache's keys, and its decode step launches no paged attention.  A
prefill over a padded prompt keeps the state after the last real position
(``repro_torch.models.mamba``), so the rules below hold for its state too.

Prefix-reuse exactness.  A request that shares a prompt head reads pages
written by another request's prefill, so each position's K/V must not depend
on what follows it in the prompt.  Two things could make it depend:

* the flash forward's blocking: the engine pins key tiles of 16 positions
  from position 0 (``block_k = 16``), and the attention kernel and its plain
  version keep every row's sums in a fixed order, independent of the number
  of rows;
* the row-wise steps (norms, projections, rope, MLP): a matrix product's
  library kernel, and with it the order of each row's sums, may change with
  the number of rows M (measured on this project's CPU build of PyTorch for
  bf16 products at M = 41 against 96; on the card cuBLAS picks its
  algorithm, split-K among it, by shape), and so may a reduction's split.
  So the model runs them over blocks of ``prefill_rows`` positions
  (``Runtime.prefill_rows``: 1024, or ``max_seq`` when that is less), and the
  engine pads each prompt to whole blocks: every call sees one fixed shape,
  and a position lies at the same row of the same block in every prompt.
  Only the real positions' K/V and logits are kept; causality keeps the
  padding out of every real position's result.  A prompt costs at most one
  block more than its own length.

Decode steps run at the fixed shape ``max_batch`` anyway.

Chunked prefill keeps those blocks (``LM.prefill_chunk``): a chunk's
row-wise steps run over the row blocks its positions fall in, each position
at the row where the monolithic prefill puts it, so a chunk of C tokens pays
for a whole block (one more at each block edge it crosses); K3 runs the chunk's
queries over the gathered page row with ``q_offset`` at its start, the key
tiles from position 0 as in the monolithic call; MLA re-expands K/V from the
gathered latent row over the same row blocks.

A verify step keeps the decode step's shapes.  The engine folds it draft
index major: slot s's row t is row ``t * max_batch + s``, so each draft
index is one block of ``max_batch`` rows with slot s at row s, where its
decode step puts it, and the model runs every row-wise step (the MoE's
dispatch and the head included) over those blocks
(``Runtime.decode_rows``).  The paged decode (K2) runs once over the whole
fold, each row's result independent of the batch, at the
``pages_per_program`` of the decode step at ``max_batch``
(``decode_pages_per_program``): K2's splits, and so its bits, follow that
value.  Padded rows get length 0 and an all-scratch page-table row.
"""
from __future__ import annotations

import dataclasses
import time
from contextlib import nullcontext
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import ArchConfig, get_config, get_smoke_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import LM
from repro_torch.models.runtime import DEFAULT_PAGES_PER_PROGRAM, PREFILL_ROWS, Runtime
from repro_torch.serve.cache import (
    init_paged_cache,
    max_pages_per_seq,
    restore_state,
    snapshot_state,
    write_prefill,
)
from repro_torch.serve.paging import SCRATCH_PAGE, PagePool
from repro_torch.serve.prefix import PrefixCache
from repro_torch.serve.scheduler import Request, RequestState, Scheduler
from repro_torch.serve.sharding import ShardingPlan
from repro_torch.serve.speculate import NgramProposer
from repro_torch.telemetry import Event, MemorySink, ServeStepEvent, Tracker
from repro_torch.telemetry.trace import SpanTracer

def random_lm(cfg: ArchConfig, device: DeviceLike, seed: int) -> LM:
    """``cfg``'s LM on ``device`` (the card when None) with random weights
    from a generator on that device seeded with ``seed``."""
    device = resolve_device(device)
    lm = LM(cfg, device)
    return lm.init_params(torch.Generator(device=device).manual_seed(seed))


class ServeEngine:
    def __init__(
        self,
        arch: str,
        *,
        smoke: bool = True,
        max_batch: int = 8,
        page_size: int = 16,
        max_seq: int = 256,
        num_pages: Optional[int] = None,
        seed: int = 0,
        collect_logits: bool = False,
        paged_impl: str = "kernel",
        prefill_chunk: Optional[int] = None,
        speculate: int = 0,
        lm: Optional[LM] = None,
        device: DeviceLike = None,
        replica_id: int = -1,
        trace: bool = False,
        trace_clock: Optional[Callable[[], float]] = None,
        mesh=None,
        rules=None,
    ):
        """``lm`` is an already-built model to serve (its config and device
        are used, and its weights are shared, not copied); otherwise a model
        for ``arch`` is built on ``device`` (the card when None) with random
        weights from a generator seeded with ``seed``.  ``paged_impl`` is the
        paged decode's (``Runtime.paged_impl``): ``"kernel"`` runs K2 on the
        card and its plain version on the CPU.  ``num_pages`` sizes the page
        pool (default: every slot's full row, plus the scratch page).
        ``replica_id``, ``trace`` and ``trace_clock``: the reference's span
        tracing and replica tag (module docstring).  ``mesh`` (a
        ``DeviceMesh`` with axes ("data", "model")) and ``rules`` run the
        sharded data plane (module docstring)."""
        self.cfg = lm.cfg if lm is not None else self.config_for(arch, smoke)
        if speculate < 0:
            raise ValueError(f"speculate must be >= 0, got {speculate}")
        if (prefill_chunk is not None or speculate) and any(
                spec.mixer != "attn" for spec in self.cfg.period):
            raise ValueError(
                "chunked prefill / speculative decode require attention-only "
                f"architectures; {self.cfg.name} has recurrent-state layers "
                "whose slot-major cache has no paged/positional form")
        self.seed = seed
        self.device = lm.device if lm is not None else resolve_device(device)
        # block_q = block_k = 16, fixed prefill row blocks and decode row
        # blocks of max_batch pin the blocking, so that prefix positions'
        # K/V, shared prefix pages, chunks and verify rows are bitwise
        # independent of what follows them and of the step's shape (module
        # docstring)
        self.rt = Runtime(block_q=16, block_k=16, page_size=page_size, paged_impl=paged_impl,
                          prefill_rows=min(PREFILL_ROWS, max_seq), decode_rows=max_batch,
                          mesh=mesh, rules=rules)
        self.plan = ShardingPlan.for_runtime(self.rt)
        if self.plan is None:
            self.lm = lm if lm is not None else random_lm(self.cfg, self.device, seed)
        elif lm is None:
            self.lm = self.plan.shard_params(self.cfg, self.device, seed=seed)
        elif lm.shard is None:
            self.lm = self.plan.shard_params(lm.cfg, source=lm)
        elif lm.shard.world == self.plan.world and lm.shard.rank == self.plan.model_rank:
            self.lm = lm
        else:
            raise ValueError(f"lm holds rank {lm.shard.rank} of {lm.shard.world}'s slice, the "
                             f"mesh puts this engine at rank {self.plan.model_rank} of "
                             f"{self.plan.world}")
        whole_cfg = self.lm.cfg if self.lm.shard is None else self.lm.shard.whole
        self.cfg = self.lm.cfg
        self.max_batch = max_batch
        self.page_size = page_size
        self.max_seq = max_seq
        self.pages_per_seq = max_pages_per_seq(max_seq, page_size)
        if num_pages is None:
            num_pages = 1 + max_batch * self.pages_per_seq
        self.pool = PagePool(num_pages, page_size)
        self.prefix = PrefixCache(page_size)
        self.prefill_chunk = prefill_chunk
        self.speculate = speculate
        self.proposer = NgramProposer(prefix_cache=self.prefix) if speculate else None
        self.scheduler = Scheduler(max_batch, self.pool, prefix_cache=self.prefix,
                                   n_frontend_tokens=self.cfg.n_frontend_tokens,
                                   prefill_chunk=prefill_chunk)
        self.collect_logits = collect_logits
        self.cache = init_paged_cache(self.lm, num_pages=num_pages, page_size=page_size,
                                      max_batch=max_batch)
        self.page_tables = np.full((max_batch, self.pages_per_seq), SCRATCH_PAGE, np.int32)
        # device mirror of page_tables: rows change only on join / release
        self.page_tables_dev = torch.from_numpy(self.page_tables.copy()).to(self.device)
        self.lengths = np.zeros(max_batch, np.int32)
        self.next_tokens = np.zeros(max_batch, np.int64)
        self.tracker = Tracker([MemorySink()])
        self._t_s = 0.0
        self.spans: Optional[SpanTracer] = (
            SpanTracer(self.tracker, trace=("serve", self.cfg.name, seed, replica_id),
                       replica=replica_id, clock=trace_clock) if trace else None)
        self.scheduler.tracer = self.spans
        self._decode = self.lm.decode_step_paged
        self._chunk = self.lm.prefill_chunk
        if self.plan is not None:
            self.cache = self.plan.shard_cache(self.cache, whole_cfg)
            self.page_tables_dev = self.plan.put_replicated(self.page_tables_dev)
            self._decode = self.plan.decode_fn(self.lm, tracer=self.spans)
            self._chunk = self.plan.prefill_chunk_fn(self.lm, tracer=self.spans)
        self.replica_id = replica_id
        self.step_count = 0
        self.prefills_run = 0
        # the pages_per_program the last verify step's paged decode ran at
        self.verify_pages_per_program: Optional[int] = None
        self._rid = 0

    @staticmethod
    def config_for(arch: str, smoke: bool) -> ArchConfig:
        return get_smoke_config(arch) if smoke else get_config(arch)

    def _sp(self, name: str, **attrs):
        """Span scope when tracing is on, else a free no-op context."""
        if self.spans is None:
            return nullcontext()
        return self.spans.span(name, step=self.step_count, **attrs)

    def decode_pages_per_program(self) -> Tuple[int, bool, Dict[str, int]]:
        """(pages_per_program, tuned, shape): the paged decode's blocking for
        the decode step's shape (all ``max_batch`` slots, the whole page-table
        row), the tuner's cache entry for it on this device when there is
        one, else ``DEFAULT_PAGES_PER_PROGRAM``.  Decode and verify steps
        both run at it, whatever a verify step's batch."""
        from repro_torch.kernels.flash_decode.ops import latent_shape
        from repro_torch.kernels.tune import lookup

        cfg = self.cfg
        if cfg.mla is not None:
            m = cfg.mla
            shape = latent_shape(self.max_batch, cfg.n_heads, m.kv_lora_rank,
                                 m.qk_rope_head_dim, self.page_size, self.pages_per_seq)
        else:
            hk = cfg.n_kv_heads
            shape = {"b": self.max_batch, "hk": hk, "g": cfg.n_heads // hk,
                     "d": cfg.head_dim, "page": self.page_size, "npp": self.pages_per_seq}
        entry = lookup("flash_decode_paged", shape, self.lm.dtype, self.device.type)
        if entry is None:
            return DEFAULT_PAGES_PER_PROGRAM, False, shape
        return int(entry["pages_per_program"]), True, shape

    def _step_runtime(self) -> Runtime:
        """The runtime of a decode or verify step: ``self.rt`` with the
        decode step's pages_per_program pinned (attention archs)."""
        if not any(spec.mixer == "attn" for spec in self.cfg.period):
            return self.rt
        return dataclasses.replace(self.rt,
                                   pages_per_program=self.decode_pages_per_program()[0])

    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int, arrival_step: int = 0,
               frontend_embeds: Optional[np.ndarray] = None) -> Request:
        """Queue a request.  A frontend arch's request needs
        ``frontend_embeds`` (n_frontend_tokens, d_model), which another
        arch's does not take."""
        cfg = self.cfg
        if frontend_embeds is not None:
            frontend_embeds = np.asarray(frontend_embeds, np.float32)
        want = (cfg.n_frontend_tokens, cfg.d_model) if cfg.frontend != "none" else None
        got = None if frontend_embeds is None else frontend_embeds.shape
        if got != want:
            raise ValueError(f"{cfg.name}: frontend_embeds of shape {got}, expected {want}")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        total = len(prompt) + self._n_front(frontend_embeds) + max_new_tokens
        if total > self.max_seq:
            raise ValueError(
                f"prompt+generation needs {total} positions > max_seq={self.max_seq}")
        req = Request(rid=self._rid, prompt=prompt, max_new_tokens=max_new_tokens,
                      arrival_step=arrival_step, frontend_embeds=frontend_embeds)
        if self.collect_logits:
            req.logits_trace = []
        self._rid += 1
        self.scheduler.submit(req)
        return req

    # ------------------------------------------------------------------
    def _n_front(self, frontend_embeds: Optional[np.ndarray]) -> int:
        return 0 if frontend_embeds is None else self.cfg.n_frontend_tokens

    def _prefill(self, prompt: np.ndarray, frontend_embeds: Optional[np.ndarray] = None):
        """Prefill over whole row blocks (module docstring), the frontend's
        positions first: returns (last real position's logits on the host as
        float32, cache)."""
        rows, n_front = self.rt.prefill_rows, self._n_front(frontend_embeds)
        tokens = np.zeros(-(-(n_front + len(prompt)) // rows) * rows - n_front, np.int64)
        tokens[:len(prompt)] = prompt
        fe = None if frontend_embeds is None else torch.from_numpy(frontend_embeds)[None]
        logits, cache = self.lm.prefill(torch.from_numpy(tokens)[None].to(self.device), fe,
                                        n_valid=len(prompt), rt=self.rt)
        self.prefills_run += 1
        return logits[0].float().cpu().numpy(), cache

    def _register_prompt(self, req: Request, logits: np.ndarray) -> None:
        """Publish a prefilled prompt's pages (and, page-aligned, the whole
        prompt) to the prefix cache."""
        n_prompt_pages = -(-len(req.prompt) // self.page_size)
        self.prefix.register(req.prompt, req.page_ids[:n_prompt_pages], self.pool)
        self.prefix.register_full(
            req.prompt, req.page_ids[: len(req.prompt) // self.page_size], logits,
            snapshot_state(self.cache, req.slot), self.pool)

    def _admit(self, req: Request) -> None:
        """Prefill (or reuse a stored prefill) and seed the decode slot."""
        slot = req.slot
        if req.prefill_skipped:
            with self._sp("prefill", component="engine.prefill", rid=req.rid,
                          tokens=len(req.prompt), skipped=True):
                logits = req.full_entry.last_logits
                self.cache = restore_state(self.cache, req.full_entry.state, slot)
        else:
            t0 = time.perf_counter()
            with self._sp("prefill", component="engine.prefill", rid=req.rid,
                          tokens=len(req.prompt)):
                logits, pre_cache = self._prefill(req.prompt, req.frontend_embeds)
            req.prefill_s = time.perf_counter() - t0
            self.cache = write_prefill(self.cache, pre_cache, slot=slot,
                                       page_ids=req.page_ids, page_size=self.page_size,
                                       skip_pages=req.n_shared_pages,
                                       n_tokens=self._n_front(req.frontend_embeds)
                                       + len(req.prompt))
            if req.frontend_embeds is None:
                self._register_prompt(req, logits)
        self._activate(req, logits)

    def _activate(self, req: Request, logits: np.ndarray) -> None:
        """Seed the first token from prefill logits and arm the decode slot."""
        slot = req.slot
        tok = int(np.argmax(logits))
        req.generated.append(tok)
        if req.logits_trace is not None:
            req.logits_trace.append(np.asarray(logits, np.float32).copy())
        req.state = RequestState.RUNNING
        req.first_token_step = self.step_count
        self.lengths[slot] = self._n_front(req.frontend_embeds) + len(req.prompt)
        row = self._table_row(req)
        self.page_tables[slot] = row
        self.page_tables_dev[slot] = torch.from_numpy(row).to(self.device)
        self.next_tokens[slot] = tok

    def _table_row(self, req: Request) -> np.ndarray:
        row = np.full(self.pages_per_seq, SCRATCH_PAGE, np.int32)
        row[: len(req.page_ids)] = req.page_ids
        return row

    # ------------------------------------------------------------------
    def _use_chunked(self, req: Request) -> bool:
        """Chunked prefill applies when there is new prompt to stream in:
        skipped prefills are free, a frontend's embeddings take the
        monolithic prefill, and an all-shared prompt head takes it too, so
        that the last position's logits exist."""
        return (self.prefill_chunk is not None and req.frontend_embeds is None
                and not req.prefill_skipped
                and req.n_shared_pages * self.page_size < len(req.prompt))

    def _prefill_chunk_step(self, req: Request, n_tokens: int) -> None:
        """Run one chunk of ``req``'s prompt through the paged stack.  While
        PREFILLING the slot's host page-table row stays at SCRATCH (decode
        and verify steps never see it); the real row goes to the chunk call
        alone.  The last chunk registers the prompt's pages and arms the
        slot."""
        s0 = req.prefill_pos
        chunk = np.zeros(self.prefill_chunk, np.int64)
        chunk[:n_tokens] = req.prompt[s0: s0 + n_tokens]
        t0 = time.perf_counter()
        with self._sp("prefill_chunk", component="engine.prefill_chunk", rid=req.rid,
                      tokens=n_tokens, s0=s0):
            logits, self.cache = self._chunk(
                torch.from_numpy(chunk)[None].to(self.device), n_tokens, self.cache,
                torch.from_numpy(self._table_row(req))[None].to(self.device), s0=s0,
                rt=self.rt)
            logits = logits[0].float().cpu().numpy()
        dt = time.perf_counter() - t0
        req.prefill_s += dt
        req.prefill_pos += n_tokens
        self._emit("prefill", batch=0, step_s=dt, prefill_tokens=n_tokens)
        if req.prefill_pos >= len(req.prompt):
            self._register_prompt(req, logits)
            self._activate(req, logits)

    def _release_slot(self, slot: int) -> None:
        self.lengths[slot] = 0
        self.next_tokens[slot] = 0
        self.page_tables[slot] = SCRATCH_PAGE
        self.page_tables_dev[slot] = SCRATCH_PAGE

    def _finish_if_done(self, req: Request) -> None:
        if req.state is RequestState.RUNNING and req.done:
            slot = req.slot
            self.scheduler.finish(req, self.step_count)
            self._release_slot(slot)

    # ------------------------------------------------------------------
    def step(self) -> int:
        """One engine step: admit arrived requests, advance chunked prefill
        within its token budget, then run one batched decode (or draft
        verify) step and retire finished requests.  Returns the number of
        requests that contributed decode tokens."""
        with self._sp("step", component="engine.step"):
            return self._step_inner()

    def _step_inner(self) -> int:
        for req in self.scheduler.admit_ready(self.step_count):
            if self._use_chunked(req):
                req.state = RequestState.PREFILLING
                req.prefill_pos = req.n_shared_pages * self.page_size
            else:
                self._admit(req)
                self._finish_if_done(req)  # max_new_tokens == 1
        for req, take in self.scheduler.plan_prefill():
            self._prefill_chunk_step(req, take)
            self._finish_if_done(req)
        decoding = self.scheduler.decoding
        if not decoding:
            self.step_count += 1
            return 0
        drafts = self._propose_drafts(decoding) if self.speculate else None
        if drafts is not None:
            self._verify_step(decoding, drafts)
            self.step_count += 1
            return len(decoding)
        t0 = time.perf_counter()
        with self._sp("decode", component="engine.decode", batch=len(decoding)):
            logits, self.cache = self._decode(
                torch.from_numpy(self.next_tokens).to(self.device),
                torch.from_numpy(self.lengths).to(self.device),
                self.cache, self.page_tables_dev, rt=self._step_runtime())
            logits_np = logits.float().cpu().numpy()
        dt = time.perf_counter() - t0
        self._emit("decode", batch=len(decoding), step_s=dt, committed=len(decoding))
        for req in decoding:
            slot = req.slot
            tok = int(np.argmax(logits_np[slot]))
            req.generated.append(tok)
            if req.logits_trace is not None:
                req.logits_trace.append(logits_np[slot].copy())
            self.lengths[slot] += 1
            self.next_tokens[slot] = tok
            self._finish_if_done(req)
        self.step_count += 1
        return len(decoding)

    # ------------------------------------------------------------------
    def _propose_drafts(self, decoding) -> Optional[Dict[int, np.ndarray]]:
        """Draft tokens per slot, or None for a plain decode step.  A slot's
        drafts are capped at ``remaining - 1``, so no speculative write lands
        past the position the plain engine's last decode step uses.  A verify
        step runs ``max_batch * (k + 1)`` rows where a decode step runs
        ``max_batch``, so it is taken only when drafting is dense: two
        full-depth drafts' worth of tokens a decoding slot (the reference's
        gate)."""
        drafts: Dict[int, np.ndarray] = {}
        total = 0
        for req in decoding:
            cap = min(self.speculate, req.max_new_tokens - len(req.generated) - 1)
            if cap > 0:
                ctx = np.concatenate([req.prompt, np.asarray(req.generated, np.int32)])
                d = self.proposer.propose(ctx, cap, slot=req.slot)
            else:
                d = np.empty(0, np.int32)
            drafts[req.slot] = d
            total += len(d)
        gate = len(decoding) * min(self.speculate, 2)
        return drafts if total >= max(gate, 1) else None

    def _verify_step(self, decoding, drafts: Dict[int, np.ndarray]) -> None:
        """One batched draft-verify step over ``max_batch * (k + 1)`` rows,
        folded draft index major (row ``t * max_batch + s`` is slot s's
        pending token for t = 0, else its draft t, at length L + t, with the
        slot's page-table row), then the longest accepted prefix committed
        per slot.  Row t's logits are the model's after the pending token and
        drafts 1..t: bitwise the decode step's whenever those drafts are what
        it would have committed, which is the accept condition.  Padded rows
        get length 0 and an all-scratch page-table row, so they neither read
        nor write a live page."""
        t_rows, b = self.speculate + 1, self.max_batch
        toks = np.zeros(b * t_rows, np.int64)
        lens = np.zeros(b * t_rows, np.int32)
        pts = np.full((b * t_rows, self.pages_per_seq), SCRATCH_PAGE, np.int32)
        for req in decoding:
            s, d = req.slot, drafts[req.slot]
            rows = s + b * np.arange(len(d) + 1)
            toks[rows] = np.concatenate([[self.next_tokens[s]], d])
            lens[rows] = self.lengths[s] + np.arange(len(d) + 1)
            pts[rows] = self.page_tables[s]
        rt = self._step_runtime()
        self.verify_pages_per_program = rt.pages_per_program
        t0 = time.perf_counter()
        with self._sp("verify", component="engine.verify", batch=len(decoding),
                      rows=b * t_rows):
            logits, self.cache = self._decode(
                torch.from_numpy(toks).to(self.device), torch.from_numpy(lens).to(self.device),
                self.cache, torch.from_numpy(pts).to(self.device), rt=rt)
            logits_np = logits.float().cpu().numpy()
        dt = time.perf_counter() - t0
        total_committed = total_drafted = 0
        for req in decoding:
            s, d = req.slot, drafts[req.slot]
            rows = logits_np[s::b]  # (k + 1, V): draft index t at row t
            committed = [int(np.argmax(rows[0]))]
            for i in range(len(d)):
                if int(d[i]) != committed[i]:
                    break
                committed.append(int(np.argmax(rows[i + 1])))
            self.proposer.record(len(d), len(committed) - 1)
            for i, tok in enumerate(committed):
                req.generated.append(tok)
                if req.logits_trace is not None:
                    req.logits_trace.append(rows[i].copy())
            self.lengths[s] += len(committed)
            self.next_tokens[s] = committed[-1]
            total_committed += len(committed)
            total_drafted += len(d)
            self._finish_if_done(req)
        self._emit("verify", batch=len(decoding), step_s=dt, committed=total_committed,
                   drafted=total_drafted)

    def run(self, max_steps: int = 100_000) -> Dict:
        """Drive steps until every submitted request has finished."""
        while not self.scheduler.drained:
            if self.step_count >= max_steps:
                raise RuntimeError(f"trace did not drain in {max_steps} steps")
            self.step()
        return self.stats()

    # ------------------------------------------------------------------
    def _emit(self, op: str, *, batch: int, step_s: float, committed: int = 0,
              drafted: int = 0, prefill_tokens: int = 0) -> None:
        self._t_s += step_s
        self.tracker.emit(ServeStepEvent(step=self.step_count, step_s=step_s, op=op,
                                         batch=batch, committed=committed, drafted=drafted,
                                         prefill_tokens=prefill_tokens, t_s=self._t_s,
                                         replica=self.replica_id))

    def events(self, kind: Optional[str] = None) -> List[Event]:
        """Typed events on the engine's bus (``serve_step`` rows and, when
        tracing, ``span`` rows)."""
        return self.tracker.events(kind)

    # ------------------------------------------------------------------
    def stats(self) -> Dict:
        evs = self.events("serve_step")
        steps = [e for e in evs if e.batch > 0]
        tok = sum(e.committed for e in steps)
        busy = sum(e.step_s for e in steps)
        batch_tok = sum(e.batch for e in steps)
        out: Dict = {
            "requests_finished": len(self.scheduler.finished),
            "decode_steps": len(steps),
            "decode_tokens": tok,
            "decode_tok_per_s": tok / busy if busy else 0.0,
            "mean_batch": batch_tok / len(steps) if steps else 0.0,
            "pages_in_use": self.pool.pages_in_use,
            "free_pages": self.pool.free_pages,
            "prefills_run": self.prefills_run,
            "prefix_hits": self.prefix.hits,
            "prefix_pages_shared": self.prefix.pages_shared,
            "prefills_skipped": self.prefix.prefills_skipped,
        }
        if self.prefill_chunk is not None:
            chunks = [e for e in evs if e.op == "prefill"]
            out["prefill_chunks"] = len(chunks)
            out["prefill_chunk_tokens"] = sum(e.prefill_tokens for e in chunks)
        if self.proposer is not None:
            out["verify_steps"] = sum(1 for e in steps if e.op == "verify")
            out["draft_proposed"] = self.proposer.proposed_tokens
            out["draft_accepted"] = self.proposer.accepted_tokens
            out["spec_accept_rate"] = self.proposer.accept_rate
        joins = [r.first_token_step - r.arrival_step for r in self.scheduler.finished
                 if r.first_token_step >= 0]
        if joins:
            out["join_to_first_token_p50"] = float(np.percentile(joins, 50))
            out["join_to_first_token_p99"] = float(np.percentile(joins, 99))
        return out
