"""Serving CLI of the port: continuous batching over the paged KV cache,
and the static batch through the ``Server`` facade.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b --continuous
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b --smoke \\
      --continuous --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b --continuous \\
      --tune-cache results/tune_cache_torch.json
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b --smoke \\
      --continuous --device cpu --prefill-chunk 8 --speculate 3
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b --smoke \\
      --device cpu --router --replicas 2 --migrate-at 3 --trace trace.json \\
      --trace-clock steps --router-log router.jsonl
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b --smoke \
      --batch 4 --prompt-len 16 --gen 16 --device cpu

runs the reference's ``--continuous`` path (``repro/launch/serve.py``): a
mixed-length 8-request trace with staggered arrivals and a shared prompt head
through one engine, the served / join / join-to-first-token lines, the fitted
f(b) step model and a capacity plan, and the prefix-reuse check, which serves
one prefix-sharing prompt on the warm engine and the same prompt on a cold
engine and exits 1 unless their logits match bit for bit.

``--prefill-chunk TOKENS`` streams prompts into their pages at most TOKENS a
step (``-1``: the tuner's ``prefill_chunk`` entry for the preset's sweep
shape, else ``DEFAULT_PREFILL_CHUNK``) and ``--speculate K`` drafts up to K
tokens a slot for one verify step (``repro/launch/serve.py:187-204,
456-502``).  With either, the trace is replayed through a plain engine
sharing the served model's weights, and the CLI prints ``chunked+speculative
vs one-token baseline: bit_identical=yes|NO`` and exits 1 on NO.  With
``--speculate`` the port adds the reference's document-extension workload
(``tests/test_serve_speculative.py:60-84``) to both engines: a stored
page-aligned document whose prefix a follow-up request extends, which drafts
from the prefix cache, as random weights give the mixed trace nothing to
draft from.

``--tune-cache PATH`` (``repro/launch/serve.py:506-514``) seeds the capacity
planner's f(b) step model with the autotuner's measured paged-decode kernel
times from PATH, scaled to ``n_layers x kernel``, before the engine's own
step events, and points the process's tuner cache at PATH, so the engine's
paged decode (K2) runs at the ``pages_per_program`` tuned for its decode
shape, verify steps included; the value used is printed.  The planner
counts every ``flash_decode_paged`` entry of the file, so give it one
holding this model's shapes only.

``--router`` (``repro/launch/serve.py:261-355``) replays the trace through a
prefix-affinity ``Router`` over ``--replicas N`` engines (0: the fitted
capacity plan's m, else 2) with ``--spill-slack`` tokens of slack, prints the
dispatches, affinity hits and per-replica planner stats, and prints
``routed fleet vs single engine: bit_identical=yes|NO``, exiting 1 on NO;
``--router-log PATH`` writes the router's and replicas' events as JSONL
(``python -m repro_torch.telemetry summarize|trace PATH`` reads it).
``--migrate-at STEP`` hands replica ``--migrate-replica R`` off to a fresh
engine at router step STEP with its requests in flight
(``repro_torch.serve.migrate``) and prints the handoff's requests, pages,
MB and ms.  ``--trace PATH`` traces every engine's and the router's spans,
writes them as a Perfetto/chrome://tracing JSON (the router's fleet when
``--router``), exits 1 if the file fails the schema check, prints the
attribution report (``--tune-cache``'s kernel rows joined in) and, with
``--trace-clock wall``, the spans' decode, verify and chunk time against
the engines' own step times, exiting 1 past 5%; ``--trace-clock steps``
counts clock ticks instead, so that two runs write the same file byte for
byte.  ``--migrate-at`` implies ``--router``; ``--router`` or ``--trace``
implies ``--continuous``.

Without ``--continuous`` the CLI runs the reference's static batch
(``repro/launch/serve.py:439-456``): ``--batch`` random prompts of
``--prompt-len`` tokens from ``--seed``, ``--gen`` tokens each, through
``Server.generate`` (every request admitted at step 0 and decoded by the
continuous engine), and prints the tokens' shape, the prefill ms and the
decode tokens/s.

A frontend arch (internvl2-76b, musicgen-medium) gets synthetic embeddings,
as in the reference: the trace's requests each carry theirs
(``_mixed_trace_specs``), and the static batch draws (batch, F, d) of them
after the prompts (``repro/launch/serve.py:445-448``).  Its ``--continuous``
run serves the trace, then stops with a ``ValueError`` at the prefix-reuse
check, whose prompts carry no embeddings: the reference's CLI stops at the
same place, its prefill's assert.

``--tp K`` (K >= 2; ``repro/launch/serve.py:38-45, 270-300``) serves
tensor-parallel over K ranks, one process each (``torch.multiprocessing``
spawn, rendezvous through a file in a fresh temporary directory): each rank
joins the process group (``nccl`` when every rank has a card of its own,
``gloo`` when ranks share one or run on the CPU, with ``--device cpu``;
``repro_torch.launch.mesh``), builds a (1, K) mesh and its slice of the
model (``repro_torch.serve.sharding``: drawn one matrix at a time from
``--seed``, each matrix the unsharded model's), and runs the whole CLI on
it: every engine of the run (the single one, the cold one, the baseline,
the router's replicas) is a K-way engine sharing the rank's weights, so the
routed fleet is compared against a single engine on the same mesh, as in
the reference.  Rank 0 alone prints and writes files, and prints
``tensor parallel: K-way over mesh {...}, backend ...``; at the end the
ranks' token streams are checked to be the same (a hash), exiting 1
otherwise.  Each rank reports its kernel launches, the engines' prefills
and steps, the single engine's token streams and every step's logits, its
decode step times and peak memory; ``main`` returns rank 0's summary with
every rank's report under ``reports``.  A rank on the CPU runs one thread.

Differences from the reference's CLI: ``--smoke`` is off by default, so the
default is the full config; without ``--device cpu`` it runs on the card or
raises; the cold and the baseline engines, the router's replicas and the
migration's destination all share the warm engine's weights instead of
building copies of their own (29.5 GB each at qwen3-14b's full width), and
run the same ``--paged-impl``; ``--tp`` spawns a process a rank where the
reference forces host devices in one process.  ``--tp K`` serves every arch
of the catalog whose heads, experts and widths divide K (MLA over the
rank's heads, the MoE FFN on its expert-parallel path), and ``--tp K
--router --replicas N --migrate-at S`` hands a tensor-parallel replica off
(``repro/launch/serve.py:271-326``): every rank snapshots its replica at
step S, the cache gathered over "model" into whole leaves, and restores it
onto a fresh K-way engine, each rank keeping its block
(``repro_torch.serve.migrate``).
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import os
import sys
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import LM
from repro_torch.serve import CapacityPlanner, ServeEngine
from repro_torch.serve.engine import random_lm

# One trace request: (prompt, gen_tokens, arrival_step, frontend_embeds).
TraceSpec = Tuple[np.ndarray, int, int, Optional[np.ndarray]]


class Server:
    """Batch-synchronous facade (``repro/launch/serve.py:54-107``): every
    request is admitted at step 0 and decoded by the continuous engine.
    ``lm``, the port's addition, is an already-built model to serve (its
    weights shared); else the engine builds ``arch``'s with random weights
    from ``seed`` on ``device`` (the card when None).  A ``mesh`` (and
    optionally ``rules``) runs the sharded data plane
    (``repro_torch.serve.sharding``): called on every rank of the mesh's
    group, each serving with its slice of the model."""

    def __init__(self, arch: str, smoke: bool = True, max_seq: int = 128, mesh=None,
                 rules=None, seed: int = 0, page_size: int = 16, lm: Optional[LM] = None,
                 device=None):
        if rules is not None and mesh is None:
            raise ValueError("sharding rules without a mesh")
        self.mesh = mesh
        self.rules = rules
        self.arch = arch
        self.smoke = smoke
        self.max_seq = max_seq
        self.seed = seed
        self.page_size = page_size
        self.device = device
        self._lm = lm
        self._engine: Optional[ServeEngine] = None
        self.cfg = lm.cfg if lm is not None else ServeEngine.config_for(arch, smoke)

    def _make_engine(self, batch: int) -> ServeEngine:
        if self._engine is None or self._engine.max_batch != batch:
            lm = self._lm if self._engine is None else self._engine.lm
            self._engine = ServeEngine(self.arch, smoke=self.smoke, max_batch=batch,
                                       page_size=self.page_size, max_seq=self.max_seq,
                                       seed=self.seed, lm=lm, device=self.device,
                                       mesh=self.mesh, rules=self.rules)
        return self._engine

    def generate(self, prompts: np.ndarray, gen_tokens: int,
                 frontend_embeds: Optional[np.ndarray] = None, greedy: bool = True) -> Dict:
        """prompts: (B, P) int32; a frontend arch's ``frontend_embeds``
        (B, F, d).  Returns the generated tokens (B, gen_tokens),
        ``prefill_s`` (the requests' prefill seconds, summed), ``decode_s``
        (this call's decode steps' seconds) and ``decode_tok_per_s``."""
        if not greedy:
            raise ValueError("only greedy decoding is supported")
        b, _ = prompts.shape
        eng = self._make_engine(b)
        n_before = len(eng.events("serve_step"))  # the engine may be reused across calls
        reqs = [eng.submit(np.asarray(prompts[i], np.int32), gen_tokens,
                           frontend_embeds=None if frontend_embeds is None else frontend_embeds[i])
                for i in range(b)]
        eng.run()
        tokens = np.stack([np.asarray(r.generated, np.int32) for r in reqs])
        this_call = [e for e in eng.events("serve_step")[n_before:] if e.batch > 0]
        t_decode = sum(e.step_s for e in this_call)
        n_tok = sum(e.batch for e in this_call)
        return {"tokens": tokens, "prefill_s": sum(r.prefill_s for r in reqs),
                "decode_s": t_decode,
                "decode_tok_per_s": n_tok / t_decode if t_decode else 0.0}


def _mixed_trace_specs(cfg, page_size: int, n_requests: int,
                       seed: int) -> List[TraceSpec]:
    """Mixed prompt lengths, bursty arrivals, one shared prompt head —
    generated independently of any engine so the same trace can be replayed
    through a single engine and a routed fleet.  The RNG draw order is
    load-bearing: it pins the traces existing goldens/smoke output use."""
    rng = np.random.RandomState(seed)
    ps = page_size
    shared_head = rng.randint(0, cfg.vocab_size, 2 * ps).astype(np.int32)
    specs: List[TraceSpec] = []
    for i in range(n_requests):
        if i % 3 == 0:  # every third request shares the prompt head
            tail = rng.randint(0, cfg.vocab_size,
                               3 + rng.randint(0, ps)).astype(np.int32)
            prompt = np.concatenate([shared_head, tail])
        else:
            plen = int(rng.choice([7, 12, 21, 30]))
            prompt = rng.randint(0, cfg.vocab_size, plen).astype(np.int32)
        gen = int(rng.choice([4, 6, 8]))
        arrival = (i // 2) * 2  # bursty: pairs arrive together
        fe = None
        if cfg.n_frontend_tokens:
            fe = (rng.randn(cfg.n_frontend_tokens, cfg.d_model)
                  * 0.02).astype(np.float32)
        specs.append((prompt, gen, arrival, fe))
    return specs


def _verify_prefix_reuse(eng: ServeEngine, seed: int) -> Tuple[bool, ServeEngine]:
    """Serve one prefix-sharing prompt on the warm engine and the same prompt
    on a cold engine sharing its weights; logits must match bit for bit.
    Returns (passed, the cold engine).  Raises ``ValueError`` for a frontend
    arch, which needs embeddings with every prompt: these prompts carry none
    (the reference's check fails there at its prefill's assert)."""
    if eng.cfg.frontend != "none":
        raise ValueError(
            f"{eng.cfg.name}: the prefix-reuse check serves prompts without frontend "
            f"embeddings, and a {eng.cfg.frontend} arch needs them with every prompt; "
            "the reference's --continuous CLI stops here too")
    rng = np.random.RandomState(seed + 1)
    ps = eng.page_size
    head = rng.randint(0, eng.cfg.vocab_size, 2 * ps).astype(np.int32)
    pA = np.concatenate([head, rng.randint(0, eng.cfg.vocab_size, 5).astype(np.int32)])
    pB = np.concatenate([head, rng.randint(0, eng.cfg.vocab_size, 9).astype(np.int32)])
    eng.collect_logits = True
    eng.submit(pA, 4)
    eng.run()
    rB = eng.submit(pB, 4)
    eng.run()
    cold = ServeEngine("", max_batch=eng.max_batch, page_size=ps, max_seq=eng.max_seq,
                       seed=eng.seed, collect_logits=True, paged_impl=eng.rt.paged_impl,
                       lm=eng.lm, mesh=eng.rt.mesh, rules=eng.rt.rules)
    rB_cold = cold.submit(pB, 4)
    cold.run()
    shared = rB.n_shared_pages
    exact = len(rB.logits_trace) == len(rB_cold.logits_trace) and all(
        np.array_equal(a, b) for a, b in zip(rB.logits_trace, rB_cold.logits_trace))
    print(f"prefix reuse: shared_pages={shared} "
          f"bit_identical={'yes' if exact else 'NO'}")
    return shared > 0 and exact, cold


def _document_extension(eng: ServeEngine, seed: int) -> List:
    """The reference's speculation workload
    (``tests/test_serve_speculative.py:60-84``) at the engine's page size: a
    two-page prompt generates two pages more, the page-aligned document is
    served as a prompt (which stores it whole in the prefix cache, a draft
    source), then a follow-up request continues the document's head.  The
    reference's follow-up prompt runs one token into the generated part,
    whose logits a prefill chunk then computes where the document's came
    from a decode step: other products, other bits, and at full width in
    bf16 that flipped a draft (PERF.md).  Here the follow-up prompt is the
    head itself, so its first token comes from the stored prefill's logits
    and every later one from decode-shaped steps, as the document's did.
    Returns the three requests."""
    ps = eng.page_size
    head = np.random.RandomState(seed + 3).randint(0, eng.cfg.vocab_size,
                                                   2 * ps).astype(np.int32)
    doc_req = eng.submit(head, 2 * ps)
    eng.run()
    stored = eng.submit(np.concatenate([head, np.asarray(doc_req.generated, np.int32)]), 1)
    eng.run()
    follow = eng.submit(head.copy(), 3 * ps // 2)
    eng.run()
    return [doc_req, stored, follow]


def _resolve_prefill_chunk(value: Optional[int], smoke: bool, backend: str) -> Optional[int]:
    """``--prefill-chunk -1``: the tuner's chunk for the preset's sweep
    shape on ``backend``, else ``DEFAULT_PREFILL_CHUNK``."""
    if value is None or value >= 0:
        return value
    import torch

    from repro_torch.kernels.flash_decode.ops import DEFAULT_PREFILL_CHUNK
    from repro_torch.kernels.tune import SWEEP_SHAPES, lookup

    preset = "smoke" if smoke else "full"
    entry = lookup("prefill_chunk", SWEEP_SHAPES[preset]["prefill_chunk"], torch.bfloat16,
                   backend)
    chunk = int(entry["chunk"]) if entry else DEFAULT_PREFILL_CHUNK
    print(f"prefill chunk: auto -> {chunk} ({'tuned' if entry else 'untuned default'})")
    return chunk


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (default: the full architecture)")
    ap.add_argument("--continuous", action="store_true",
                    help="mixed-length trace with join-on-arrival + prefix-reuse "
                         "verification + capacity plan (without it: the static batch)")
    ap.add_argument("--batch", type=int, default=4, help="static batch: prompts")
    ap.add_argument("--prompt-len", type=int, default=16, help="static batch: prompt tokens")
    ap.add_argument("--gen", type=int, default=16, help="static batch: tokens to generate")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paged-impl", default="kernel", choices=["kernel", "stream", "gather"],
                    help="paged decode: the K2 kernel (its plain version on the CPU), or "
                         "its plain versions stream / gather (bit-identical to each other)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the kernels' "
                         "plain versions)")
    ap.add_argument("--prefill-chunk", type=int, default=None, metavar="TOKENS",
                    help="chunked prefill: stream prompts in at most TOKENS a step (-1: the "
                         "tuner's prefill_chunk entry, else the default)")
    ap.add_argument("--speculate", type=int, default=0, metavar="K",
                    help="speculative decode: draft up to K tokens a slot, verified in one "
                         "step")
    ap.add_argument("--tune-cache", default=None, metavar="PATH",
                    help="seed the capacity planner with measured paged-decode kernel "
                         "timings from this autotuner config cache, and run paged decode "
                         "at its tuned pages_per_program")
    ap.add_argument("--router", action="store_true",
                    help="replay the trace through a prefix-affinity router over N replicas "
                         "and assert bit-identical outputs (implies --continuous)")
    ap.add_argument("--replicas", type=int, default=0, metavar="N",
                    help="replica count for --router (0 = the fitted capacity planner's "
                         "min-replicas answer)")
    ap.add_argument("--spill-slack", type=int, default=512, metavar="TOKENS",
                    help="router overflow spill: an affinity winner more than this many "
                         "pending tokens above the fleet minimum forfeits the request")
    ap.add_argument("--migrate-at", type=int, default=None, metavar="STEP",
                    help="live migration drill: at router step STEP, hand one replica off "
                         "to a freshly built engine and keep serving (implies --router)")
    ap.add_argument("--migrate-replica", type=int, default=0, metavar="R",
                    help="which replica --migrate-at hands off (default 0)")
    ap.add_argument("--router-log", default=None, metavar="PATH",
                    help="dump the combined router + replica event stream as JSONL")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="hierarchical span tracing: write a Perfetto/chrome://tracing JSON "
                         "span tree and print the attribution report (implies --continuous)")
    ap.add_argument("--trace-clock", default="wall", choices=["wall", "steps"],
                    help="span timestamp source: wall (measured; reconciled against the "
                         "engines' step times) or steps (a tick clock; same-seed runs write "
                         "byte-identical trace files)")
    ap.add_argument("--tp", type=int, default=1, metavar="K",
                    help="tensor parallelism: serve over K ranks, one process each, every "
                         "engine K-way (K >= 2)")
    args = ap.parse_args(argv)
    if args.tp < 1:
        ap.error(f"--tp must be >= 1, got {args.tp}")
    if args.migrate_at is not None:
        args.router = True
    if args.router or args.trace:
        args.continuous = True
    return args


def main(argv: Optional[Sequence[str]] = None, cfg: Optional[ArchConfig] = None,
         lm: Optional[LM] = None, mesh=None) -> Dict:
    """Run the ``--continuous`` path, or without it the static batch
    (``static_batch``).  ``cfg``, when given, is the config to
    serve in place of ``--arch`` / ``--smoke`` (a caller's cut one, such as
    a full-width model at fewer layers), with random weights from
    ``--seed``; ``lm``, when given, is an already-built model to serve in
    their place (a caller's, whose weights are then not built again).
    Returns the stats, the fitted planner, the plan, the warm
    and cold engines (``engines``), the plain engine the chunked or
    speculative run was replayed through (``baseline``) and whether the
    replay gave the same tokens (``bit_identical``; both None without the
    knobs), the tuned
    kernel rows seeded and the paged decode's ``pages_per_program``, the
    router run's results (``routed``, ``_run_router``'s; None without
    ``--router``) and the trace's (``trace``, ``_export_trace``'s; None
    without ``--trace``); exits 1 if the prefix-reuse check, the replay
    check, the routed fleet's check or a trace check fails.  With ``--tp
    K`` it runs ``tensor_parallel`` (the ranks) and returns its summary;
    ``mesh`` is the rank's mesh there, every engine serving on it, the
    single engine keeping every step's logits for the rank's report."""
    return run(parse_args(argv), cfg, lm, mesh)


def run(args: argparse.Namespace, cfg: Optional[ArchConfig] = None, lm: Optional[LM] = None,
        mesh=None) -> Dict:
    """``main`` on parsed arguments."""
    if args.tp > 1 and mesh is None:
        if lm is not None:
            raise ValueError("--tp builds each rank's slice of the model: pass cfg, not lm")
        return tensor_parallel(args, cfg)
    if mesh is not None and lm is None:
        lm = _rank_model(args, cfg, mesh)
    if not args.continuous:
        return static_batch(args, cfg, lm, mesh)
    tune_cache = None
    if args.tune_cache:
        from repro_torch.kernels import tune

        tune_cache = tune.set_default_cache(args.tune_cache)
    if lm is None and cfg is not None:
        lm = random_lm(cfg, args.device, args.seed)
    device = lm.device if lm is not None else resolve_device(args.device)
    prefill_chunk = _resolve_prefill_chunk(args.prefill_chunk, args.smoke, device.type)
    geometry = dict(max_batch=args.max_batch, page_size=args.page_size,
                    max_seq=64 + args.page_size * 2, seed=args.seed, paged_impl=args.paged_impl,
                    mesh=mesh)
    clock = _trace_clock_factory(args)
    eng = ServeEngine(args.arch, smoke=args.smoke, prefill_chunk=prefill_chunk,
                      speculate=args.speculate, lm=lm, device=args.device,
                      trace=bool(args.trace), trace_clock=clock(),
                      collect_logits=mesh is not None, **geometry)
    specs = _mixed_trace_specs(eng.cfg, eng.page_size, args.requests, args.seed)
    reqs = [eng.submit(prompt, gen, arrival_step=arrival, frontend_embeds=fe)
            for prompt, gen, arrival, fe in specs]
    stats = eng.run()
    done = [r for r in reqs if r.finished_step >= 0]
    print(f"served {len(done)}/{len(reqs)} requests in {eng.step_count} steps "
          f"(mean batch {stats['mean_batch']:.2f}, "
          f"{stats['decode_tok_per_s']:.1f} tok/s, "
          f"prefix hits {stats.get('prefix_hits', 0)})")
    joins = sum(1 for r in reqs if r.admitted_step > 0)
    print(f"join-on-arrival: {joins} requests joined a running batch")
    if "join_to_first_token_p50" in stats:
        print(f"join-to-first-token: p50 {stats['join_to_first_token_p50']:.1f}"
              f" p99 {stats['join_to_first_token_p99']:.1f} steps")

    base = identical = None
    if prefill_chunk is not None or args.speculate:
        if args.speculate:
            reqs += _document_extension(eng, args.seed)
            stats = eng.stats()
        if prefill_chunk is not None:
            print(f"chunked prefill: {stats['prefill_chunks']} chunk steps / "
                  f"{stats['prefill_chunk_tokens']} prompt tokens at budget {prefill_chunk}")
        if args.speculate:
            print(f"speculation: accept rate {stats['spec_accept_rate']:.2f} "
                  f"({stats['draft_accepted']}/{stats['draft_proposed']} drafted tokens, "
                  f"{stats['verify_steps']} verify steps)")
        base = ServeEngine("", lm=eng.lm, **geometry)
        base_reqs = _serve_replay(base, specs, args.seed, args.speculate)
        identical = len(base_reqs) == len(reqs) and all(
            r.generated == b.generated for r, b in zip(reqs, base_reqs))
        print(f"chunked+speculative vs one-token baseline: "
              f"bit_identical={'yes' if identical else 'NO'}")
        if not identical:
            print("FAIL: chunked/speculative outputs diverge from baseline")
            sys.exit(1)

    planner = CapacityPlanner()
    tune_rows, ppp, tune_evs = 0, None, []
    if tune_cache is not None:
        from repro_torch.kernels import tune

        n_layers = eng.cfg.n_layers
        tune_evs = tune.tune_events(tune_cache)
        tune_rows = planner.ingest(tune_evs, n_layers=n_layers)
        print(f"capacity plan: seeded with {tune_rows} measured kernel row(s) "
              f"from {args.tune_cache} (x{n_layers} layers)")
        if any(spec.mixer == "attn" for spec in eng.cfg.period):
            ppp = _decode_pages_per_program(eng)
    planner.ingest(eng.events("serve_step"))
    plan = fitted = None
    try:
        planner.fit()
    except ValueError as e:
        print(f"capacity plan: insufficient telemetry ({e})")
    else:
        fitted = planner
        t1, t8 = planner.step_time(1), planner.step_time(8)
        print(f"f(b) step model: t(1)={t1*1e3:.1f} ms  t(8)={t8*1e3:.1f} ms  "
              f"coeffs={planner.step_model.coefficients()}")
        plan = planner.plan(target_p50_s=max(10 * t8 * 8, 1e-3), qps=2.0,
                            gen_tokens=8, batch_grid=[1, 2, 4, 8],
                            m_grid=[1, 2, 4, 8, 16])
        if plan:
            print(f"capacity plan: {plan.algorithm} on m={plan.m} replicas "
                  f"(predicted p50 {plan.predicted_time*1e3:.1f} ms)")
        else:
            print(f"capacity plan: no feasible operating point ({plan.reason})")

    routed = None
    if args.router:
        n_replicas = args.replicas
        if n_replicas <= 0:
            n_replicas = plan.m if plan else 2
            print(f"router: --replicas 0 -> planner min-replicas answer m={n_replicas}")

        def make_engine(i: int) -> ServeEngine:
            return ServeEngine("", lm=eng.lm, prefill_chunk=prefill_chunk,
                               speculate=args.speculate, replica_id=i, trace=bool(args.trace),
                               trace_clock=clock(), **geometry)

        routed = _run_router(args, specs, reqs, n_replicas, make_engine, clock)

    traced = None
    if args.trace:
        trace_events = (routed["router"].all_events() if routed is not None
                        else list(eng.events()))
        busy = sum(e.step_s for e in trace_events if getattr(e, "kind", "") == "serve_step")
        traced = _export_trace(args, list(trace_events) + list(tune_evs), fitted, busy,
                               eng.cfg.n_layers)

    ok, cold = _verify_prefix_reuse(eng, args.seed)
    if not ok:
        print("FAIL: prefix-reuse verification")
        sys.exit(1)
    return {"stats": stats, "served": len(done), "requests": len(specs), "planner": planner,
            "plan": plan, "engines": (eng, cold), "baseline": base,
            "bit_identical": identical, "tune_rows": tune_rows, "pages_per_program": ppp,
            "routed": routed, "trace": traced, "served_requests": reqs}


def _rank_model(args: argparse.Namespace, cfg: Optional[ArchConfig], mesh) -> LM:
    """The rank's slice of the served model, drawn from ``--seed`` one
    matrix at a time (``ShardingPlan.shard_params``)."""
    from repro_torch.dist.partitioning import Rules
    from repro_torch.serve.sharding import ShardingPlan

    cfg = cfg if cfg is not None else ServeEngine.config_for(args.arch, args.smoke)
    plan = ShardingPlan(mesh=mesh, rules=Rules.for_serving(mesh))
    return plan.shard_params(cfg, args.device, seed=args.seed)


def tensor_parallel(args: argparse.Namespace, cfg: Optional[ArchConfig] = None) -> Dict:
    """``--tp K``: spawn K ranks (``torch.multiprocessing``, the ``spawn``
    start method), each running ``_rank_main``; wait for all of them.  A
    rank that fails stops the others; its exit code is the CLI's (a rank's
    exception is raised here).  Returns rank 0's report (``_rank_report``)
    with every rank's under ``reports``, in rank order."""
    import torch
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="repro_torch_tp_") as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        ctx = mp.start_processes(_rank_main, args=(args, cfg, init_file, tmp),
                                 nprocs=args.tp, join=False, start_method="spawn")
        try:
            while not ctx.join():
                pass
        except mp.ProcessExitedException as e:
            sys.exit(e.exit_code if e.exit_code and e.exit_code > 0 else 1)
        reports = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                   for r in range(args.tp)]
    return dict(reports[0], reports=reports)


def _rank_main(rank: int, args: argparse.Namespace, cfg: Optional[ArchConfig], init_file: str,
               out_dir: str) -> None:
    """One rank of ``--tp K``: join the group, build the (1, K) mesh, run
    the CLI on it (rank 0 printing and writing files), check that every
    rank's token streams are the same, and write its report to
    ``out_dir/rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_debug_mesh, mesh_shape

    world = args.tp
    if args.device is not None and torch.device(args.device).type == "cpu":
        torch.set_num_threads(1)
    device, backend = init_distributed(rank, world, init_file, args.device, verbose=rank == 0)
    mesh = make_debug_mesh(1, world)
    if rank:  # rank 0 alone prints and writes files
        args.trace = args.router_log = None
    quiet = contextlib.redirect_stdout(io.StringIO()) if rank else contextlib.nullcontext()
    with quiet:
        print(f"tensor parallel: {world}-way over mesh {mesh_shape(mesh)}, backend {backend}")
        result = run(args, cfg, None, mesh)
        engines = _result_engines(result)
        digest = _token_digest(engines)
        lo_hi = torch.tensor([digest, -digest], dtype=torch.int64, device=device)
        dist.all_reduce(lo_hi, op=dist.ReduceOp.MAX)
        same = int(lo_hi[0]) == digest == -int(lo_hi[1])
        print(f"ranks' token streams: {'the same' if same else 'DIFFER'} on all {world} ranks "
              f"(hash {digest & 0xFFFFFFFFFFFF:012x})")
    summary = {"rank": rank, "world": world, "backend": backend, "device": str(device),
               "mesh": mesh_shape(mesh), "served": result.get("served"),
               "bit_identical": result.get("bit_identical"),
               "routed_bit_identical": (result["routed"] or {}).get("bit_identical")
               if "routed" in result else None,
               "ranks_same": same, "digest": digest,
               "migration": _migration_summary(result)}
    torch.save(_rank_report(result, engines, device, summary),
               os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    if not same:
        sys.exit(1)


def _migration_summary(result: Dict) -> Optional[Dict]:
    """The handoff's numbers (``migrate_replica``'s, engines left out), or
    None without one."""
    info = (result.get("routed") or {}).get("migration")
    if info is None:
        return None
    return {k: v for k, v in info.items() if k not in ("source", "destination")}


def _result_engines(result: Dict) -> List[ServeEngine]:
    """Every engine a CLI run built: the single and cold engines, the
    baseline and the router's replicas."""
    engines = [e for e in result.get("engines", ()) if e is not None]
    if result.get("baseline") is not None:
        engines.append(result["baseline"])
    if result.get("routed"):
        engines += list(result["routed"]["router"].engines) + list(result["routed"]["replaced"])
    return engines


def _token_digest(engines: List[ServeEngine]) -> int:
    """A 63-bit hash of every finished request's token stream, engine by
    engine in order."""
    h = hashlib.sha256()
    for eng in engines:
        for req in sorted(eng.scheduler.finished, key=lambda r: r.rid):
            h.update(np.asarray([req.rid, *req.generated], np.int64).tobytes())
        h.update(b"|")
    return int.from_bytes(h.digest()[:8], "little") >> 1


def _rank_report(result: Dict, engines: List[ServeEngine], device, summary: Dict) -> Dict:
    """One rank's report: its summary, its kernel launches, each engine's
    prefills and decode / verify steps, the single engine's token streams
    and each request's logits (steps x vocab, float32), the decode steps'
    times (s) and the peak memory."""
    import torch

    from repro_torch.kernels import launch_counts

    steps = [e for eng in engines for e in eng.events("serve_step")]
    return dict(summary, launches=launch_counts(),
                prefills=sum(eng.prefills_run for eng in engines),
                decode_steps=sum(e.op == "decode" and e.batch > 0 for e in steps),
                verify_steps=sum(e.op == "verify" for e in steps),
                chunk_steps=sum(e.op == "prefill" for e in steps),
                n_layers=engines[0].cfg.n_layers, n_engines=len(engines),
                tokens=[list(r.generated) for r in result.get("served_requests", [])],
                logits=[np.stack(r.logits_trace) for r in result.get("served_requests", [])],
                decode_step_s=[e.step_s for e in steps if e.op == "decode"],
                peak_memory_gb=(torch.cuda.max_memory_allocated(device) / 1e9
                                if device.type == "cuda" else None))


def static_batch(args: argparse.Namespace, cfg: Optional[ArchConfig] = None,
                 lm: Optional[LM] = None, mesh=None) -> Dict:
    """The CLI without ``--continuous`` (``repro/launch/serve.py:439-456``):
    ``args.batch`` prompts of ``args.prompt_len`` random tokens from
    ``args.seed`` through ``Server.generate`` (on ``mesh`` when given).
    Returns its result and the server."""
    if lm is None and cfg is not None:
        lm = random_lm(cfg, args.device, args.seed)
    server = Server(args.arch, smoke=args.smoke, max_seq=args.prompt_len + args.gen + 8,
                    page_size=args.page_size, lm=lm, device=args.device, mesh=mesh)
    rng = np.random.RandomState(args.seed)
    served = server.cfg
    prompts = rng.randint(0, served.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    fe = None
    if served.n_frontend_tokens:
        fe = rng.randn(args.batch, served.n_frontend_tokens,
                       served.d_model).astype(np.float32) * 0.02
    res = server.generate(prompts, args.gen, fe)
    print(f"generated {res['tokens'].shape} tokens; prefill {res['prefill_s'] * 1e3:.0f} ms, "
          f"decode {res['decode_tok_per_s']:.1f} tok/s")
    return dict(res, server=server, prompts=prompts, frontend_embeds=fe,
                engines=(server._engine,))


def _serve_replay(eng: ServeEngine, specs: List[TraceSpec], seed: int, speculate: int) -> List:
    """The served workload again on ``eng``: the trace, then with
    ``speculate`` the document extension."""
    reqs = [eng.submit(prompt, gen, arrival_step=arrival, frontend_embeds=fe)
            for prompt, gen, arrival, fe in specs]
    eng.run()
    return reqs + (_document_extension(eng, seed) if speculate else [])


def _trace_clock_factory(args):
    """Per-engine trace clock: a fresh ``CountingClock`` for ``--trace-clock
    steps`` (span values deterministic, so same-seed runs write byte-identical
    trace files), ``None`` (the wall clock) otherwise."""
    if args.trace and args.trace_clock == "steps":
        from repro_torch.telemetry.trace import CountingClock

        return lambda: CountingClock()
    return lambda: None


def _export_trace(args, events, planner, busy_s: float, n_layers: int) -> Dict:
    """Write the Perfetto trace and print the attribution report, its decode
    and verify spans priced by ``planner`` (a fitted ``CapacityPlanner``, or
    None) (``repro/launch/serve.py:224-258``); exits 1 if the file fails the
    schema check or, on the wall clock, if the spans of the engine ops that
    ``serve_step`` events time (decode, verify, chunked prefill: a
    monolithic prefill is booked on its request, not the step stream) differ
    from those events' time by more than 5%.  Returns the span count and
    the reconciliation's relative difference (None on the step clock)."""
    from repro_torch.telemetry.trace import (
        attribute,
        format_attribution,
        load_perfetto,
        validate_perfetto,
        write_perfetto,
    )

    n = write_perfetto(args.trace, events)
    errs = validate_perfetto(load_perfetto(args.trace))
    if errs:
        print(f"FAIL: trace schema: {errs[:5]}")
        sys.exit(1)
    print(f"trace: {n} spans -> {args.trace} (Perfetto/chrome://tracing)")
    attr = attribute(events, planner=planner, n_layers=n_layers)
    print(format_attribution(attr))
    engine_ops = ("engine.decode", "engine.verify", "engine.prefill_chunk")
    span_busy = sum(r.measured_s for r in attr.rows if r.component in engine_ops)
    out = {"spans": n, "reconcile": None}
    if args.trace_clock == "steps":
        print("trace: deterministic step clock (wall reconciliation n/a)")
        return out
    if busy_s > 0:
        rel = abs(span_busy - busy_s) / busy_s
        out["reconcile"] = rel
        print(f"trace: span/engine wall reconciliation "
              f"{span_busy:.3f}s vs {busy_s:.3f}s ({rel:.2%})")
        if rel > 0.05:
            print("FAIL: trace spans do not reconcile with engine wall time")
            sys.exit(1)
    return out


def _run_router(args, specs: List[TraceSpec], reference, n_replicas: int, make_engine,
                clock) -> Dict:
    """Replay the trace through a prefix-affinity router over ``n_replicas``
    engines from ``make_engine(i)`` (``repro/launch/serve.py:261-355``), with
    ``--migrate-at``'s handoff, and exit 1 unless every request's tokens are
    the single engine's (``reference``, its requests in trace order).
    Returns the router, whether the tokens matched, its stats, the
    migration's (None without one) and the engines the handoff replaced."""
    from repro_torch.serve import Router
    from repro_torch.serve.migrate import migrate_replica

    engines = [make_engine(i) for i in range(n_replicas)]
    router = Router(engines, spill_slack=args.spill_slack, trace=bool(args.trace),
                    trace_clock=clock())
    routed = [router.submit(prompt, gen, arrival_step=arrival, frontend_embeds=fe)
              for prompt, gen, arrival, fe in specs]
    info, replaced = None, []
    if args.migrate_at is not None:
        while not router.drained:
            if router.step_count >= 100_000:
                raise RuntimeError("trace did not drain in 100000 steps")
            if router.step_count == args.migrate_at:
                info = migrate_replica(router, args.migrate_replica,
                                       lambda: make_engine(args.migrate_replica))
                replaced.append(info["source"])
                print(f"migration: replica {info['replica']} handed off at "
                      f"step {args.migrate_at} — {info['in_flight']} "
                      f"requests in flight, {info['pages_in_use']} pages, "
                      f"{info['nbytes'] / 1e6:.2f} MB cache in "
                      f"{info['wall_s'] * 1e3:.0f} ms")
            router.step()
        if info is None:
            print(f"migration: trace drained before step {args.migrate_at} "
                  f"(no handoff performed)")
        rstats = router.stats()
    else:
        rstats = router.run()
    print(f"router: {rstats['dispatched']} requests over "
          f"{n_replicas} replicas {rstats['dispatch_per_replica']}, "
          f"affinity hit rate {rstats['affinity_hit_rate']:.2f} "
          f"({rstats['affinity_hits']} hits, {rstats['spills']} spills)")
    identical = all(rr.generated == ref.generated for rr, ref in zip(routed, reference))
    print(f"routed fleet vs single engine: bit_identical={'yes' if identical else 'NO'}")

    planner = CapacityPlanner()
    planner.ingest(router.all_events())
    for idx, s in planner.replica_stats().items():
        print(f"  replica {idx}: {int(s['dispatches'])} dispatched, "
              f"{int(s['affinity_hits'])} affinity hits, "
              f"{int(s['decode_tokens'])} tokens @ {s['tok_per_s']:.1f} tok/s")
    print(f"measured effective replicas: "
          f"{planner.measured_effective_replicas():.2f}/{n_replicas}")
    if args.router_log:
        n = router.to_jsonl(args.router_log)
        print(f"router log: {n} events -> {args.router_log}")
    if not identical:
        print("FAIL: routed outputs diverge from the single-engine reference")
        sys.exit(1)
    return {"router": router, "bit_identical": identical, "stats": rstats,
            "migration": info, "replaced": replaced}


def _decode_pages_per_program(eng: ServeEngine) -> int:
    """Print and return the ``pages_per_program`` the engine's paged decode
    ran at, decode and verify steps alike (``decode_pages_per_program``)."""
    ppp, tuned, shape = eng.decode_pages_per_program()
    sig = " ".join(f"{k}={v}" for k, v in shape.items())
    print(f"paged decode: pages_per_program={ppp} at {sig} "
          f"({'tuned' if tuned else 'default: no cache entry'})")
    return ppp


if __name__ == "__main__":
    main()
