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
``events``.  Not yet: chunked prefill and speculative decode
(``prefill_chunk`` / ``speculate`` raise; for archs with recurrent layers
they raise as in the reference, whose Mamba state has no positional form),
the sharded data plane and span tracing (ROADMAP.md).

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
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import ArchConfig, get_config, get_smoke_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import LM
from repro_torch.models.runtime import PREFILL_ROWS, Runtime
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
from repro_torch.telemetry import Event, MemorySink, ServeStepEvent, Tracker

NOT_PORTED = "not ported yet: see ROADMAP.md (the serve slice's later modules)"


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
        seed: int = 0,
        collect_logits: bool = False,
        paged_impl: str = "kernel",
        prefill_chunk: Optional[int] = None,
        speculate: int = 0,
        lm: Optional[LM] = None,
        device: DeviceLike = None,
    ):
        """``lm`` is an already-built model to serve (its config and device
        are used, and its weights are shared, not copied); otherwise a model
        for ``arch`` is built on ``device`` (the card when None) with random
        weights from a generator seeded with ``seed``.  ``paged_impl`` is the
        paged decode's (``Runtime.paged_impl``): ``"kernel"`` runs K2 on the
        card and its plain version on the CPU."""
        self.cfg = lm.cfg if lm is not None else self.config_for(arch, smoke)
        if (prefill_chunk is not None or speculate) and any(
                spec.mixer != "attn" for spec in self.cfg.period):
            raise ValueError(
                "chunked prefill / speculative decode require attention-only "
                f"architectures; {self.cfg.name} has recurrent-state layers "
                "whose slot-major cache has no paged/positional form")
        if prefill_chunk is not None:
            raise NotImplementedError(f"chunked prefill is {NOT_PORTED}")
        if speculate:
            raise NotImplementedError(f"speculative decode is {NOT_PORTED}")
        self.seed = seed
        self.device = lm.device if lm is not None else resolve_device(device)
        # block_q = block_k = 16 and fixed prefill row blocks pin the
        # blocking, so that prefix positions' K/V, and so shared prefix
        # pages, are bitwise independent of what follows them (module
        # docstring)
        self.rt = Runtime(block_q=16, block_k=16, page_size=page_size, paged_impl=paged_impl,
                          prefill_rows=min(PREFILL_ROWS, max_seq))
        self.lm = lm if lm is not None else random_lm(self.cfg, self.device, seed)
        self.max_batch = max_batch
        self.page_size = page_size
        self.max_seq = max_seq
        self.pages_per_seq = max_pages_per_seq(max_seq, page_size)
        num_pages = 1 + max_batch * self.pages_per_seq
        self.pool = PagePool(num_pages, page_size)
        self.prefix = PrefixCache(page_size)
        self.scheduler = Scheduler(max_batch, self.pool, prefix_cache=self.prefix,
                                   n_frontend_tokens=self.cfg.n_frontend_tokens)
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
        self.step_count = 0
        self.prefills_run = 0
        self._rid = 0

    @staticmethod
    def config_for(arch: str, smoke: bool) -> ArchConfig:
        return get_smoke_config(arch) if smoke else get_config(arch)

    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int, arrival_step: int = 0,
               frontend_embeds: Optional[np.ndarray] = None) -> Request:
        if frontend_embeds is not None:
            raise NotImplementedError(f"frontend embeddings are {NOT_PORTED}")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        total = len(prompt) + max_new_tokens
        if total > self.max_seq:
            raise ValueError(
                f"prompt+generation needs {total} positions > max_seq={self.max_seq}")
        req = Request(rid=self._rid, prompt=prompt, max_new_tokens=max_new_tokens,
                      arrival_step=arrival_step)
        if self.collect_logits:
            req.logits_trace = []
        self._rid += 1
        self.scheduler.submit(req)
        return req

    # ------------------------------------------------------------------
    def _prefill(self, prompt: np.ndarray):
        """Prefill over whole row blocks (module docstring): returns (last
        real position's logits on the host as float32, cache)."""
        rows = self.rt.prefill_rows
        tokens = np.zeros(-(-len(prompt) // rows) * rows, np.int64)
        tokens[:len(prompt)] = prompt
        logits, cache = self.lm.prefill(torch.from_numpy(tokens)[None].to(self.device),
                                        n_valid=len(prompt), rt=self.rt)
        self.prefills_run += 1
        return logits[0].float().cpu().numpy(), cache

    def _admit(self, req: Request) -> None:
        """Prefill (or reuse a stored prefill) and seed the decode slot."""
        slot = req.slot
        if req.prefill_skipped:
            logits = req.full_entry.last_logits
            self.cache = restore_state(self.cache, req.full_entry.state, slot)
        else:
            t0 = time.perf_counter()
            logits, pre_cache = self._prefill(req.prompt)
            req.prefill_s = time.perf_counter() - t0
            self.cache = write_prefill(self.cache, pre_cache, slot=slot,
                                       page_ids=req.page_ids, page_size=self.page_size,
                                       skip_pages=req.n_shared_pages,
                                       n_tokens=len(req.prompt))
            n_prompt_pages = -(-len(req.prompt) // self.page_size)
            self.prefix.register(req.prompt, req.page_ids[:n_prompt_pages], self.pool)
            self.prefix.register_full(
                req.prompt, req.page_ids[: len(req.prompt) // self.page_size], logits,
                snapshot_state(self.cache, slot), self.pool)
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
        self.lengths[slot] = len(req.prompt)
        row = np.full(self.pages_per_seq, SCRATCH_PAGE, np.int32)
        row[: len(req.page_ids)] = req.page_ids
        self.page_tables[slot] = row
        self.page_tables_dev[slot] = torch.from_numpy(row).to(self.device)
        self.next_tokens[slot] = tok

    def _release_slot(self, slot: int) -> None:
        self.lengths[slot] = 0
        self.next_tokens[slot] = 0
        self.page_tables[slot] = SCRATCH_PAGE
        self.page_tables_dev[slot] = SCRATCH_PAGE

    # ------------------------------------------------------------------
    def step(self) -> int:
        """One engine step: admit arrived requests, then run one batched
        decode step and retire finished requests.  Returns the number of
        requests that contributed decode tokens."""
        for req in self.scheduler.admit_ready(self.step_count):
            self._admit(req)
            if req.done:  # max_new_tokens == 1: prefill already finished it
                slot = req.slot
                self.scheduler.finish(req, self.step_count)
                self._release_slot(slot)
        decoding = self.scheduler.decoding
        if not decoding:
            self.step_count += 1
            return 0
        t0 = time.perf_counter()
        logits, self.cache = self.lm.decode_step_paged(
            torch.from_numpy(self.next_tokens).to(self.device),
            torch.from_numpy(self.lengths).to(self.device),
            self.cache, self.page_tables_dev, rt=self.rt)
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
            if req.done:
                self.scheduler.finish(req, self.step_count)
                self._release_slot(slot)
        self.step_count += 1
        return len(decoding)

    def run(self, max_steps: int = 100_000) -> Dict:
        """Drive steps until every submitted request has finished."""
        while not self.scheduler.drained:
            if self.step_count >= max_steps:
                raise RuntimeError(f"trace did not drain in {max_steps} steps")
            self.step()
        return self.stats()

    # ------------------------------------------------------------------
    def _emit(self, op: str, *, batch: int, step_s: float, committed: int = 0) -> None:
        self._t_s += step_s
        self.tracker.emit(ServeStepEvent(step=self.step_count, step_s=step_s, op=op,
                                         batch=batch, committed=committed, t_s=self._t_s))

    def events(self, kind: Optional[str] = None) -> List[Event]:
        """Typed events on the engine's bus (``serve_step`` rows)."""
        return self.tracker.events(kind)

    # ------------------------------------------------------------------
    def stats(self) -> Dict:
        steps = [e for e in self.events("serve_step") if e.batch > 0]
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
        joins = [r.first_token_step - r.arrival_step for r in self.scheduler.finished
                 if r.first_token_step >= 0]
        if joins:
            out["join_to_first_token_p50"] = float(np.percentile(joins, 50))
            out["join_to_first_token_p99"] = float(np.percentile(joins, 99))
        return out
