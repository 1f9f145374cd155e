"""Live serving-state migration: a drain-free replica handoff, the port of
``repro/serve/migrate.py`` (DESIGN.md §15).

Resizing a serving fleet without this layer means draining: stop routing to
the replica, wait for every in-flight request to finish, then drop it.
Migration instead moves the replica's *entire* serving state between engine
steps:

* the paged cache (every layer's page-major K/V or MLA latent pools, and a
  Mamba layer's slot-major state), copied to host memory in one snapshot;
* the page tables, per-slot lengths and pending tokens;
* the ``PagePool`` free list **in order** and its per-page refcounts, so
  allocation order (and so page ids, and everything keyed on them)
  continues bit-identically;
* the ``PrefixCache`` hash chains, full-prompt entries (with their logits
  and, for a Mamba model, the slot-major state after the prompt) and LRU
  orders, so a migrated replica keeps winning the router's affinity probes;
* the scheduler's admission queue, occupied slots and finished list, every
  ``Request`` rebuilt field for field on the destination;
* the speculative proposer's counters and per-slot source memory.

The engine mutates state only inside ``step()``, so a snapshot taken between
steps is consistent.  The restored engine's next step is bitwise the step
the source would have taken.  ``migrate_replica`` swaps the restored engine
into a live ``Router`` at a step boundary and re-points the router's request
handles; the handoff's wall time rides the router's bus as a ``ckpt_cost``
event (``op="migrate"``).

The port's snapshot leaves are CPU tensors copied from the device
(``.to("cpu", copy=True)``), in the leaves' own dtypes (numpy has no bf16,
where the reference keeps ml_dtypes arrays); restore copies them onto the
destination's device and rebuilds its device mirror of the page tables.
Restoring launches no kernel.

What does NOT migrate: the model (the destination must serve the same
``LM`` object: the reference instead rebuilds weights from the seed and
rejects another seed, which the port rejects too), and telemetry (each
engine keeps its own event stream).  The destination must resolve the same
paged-decode ``pages_per_program`` as the source, as K2's splits, and so
its bits, follow it; and run the same ``paged_impl``.

A tensor-parallel engine (``mesh=`` over K ranks) snapshots the whole
cache, as the reference's ``device_get`` does (``migrate.py:209-210``):
each leaf's rank blocks (KV pools split along their heads, Mamba states
along their channels; MLA's latent pools are whole) gathered over "model"
into the whole leaf, an exact gather, and so do the prefix cache's Mamba
state entries; every rank of the group takes part, at the same step, as
all of them run the same host loop.  ``snapshot_nbytes`` counts the whole
leaves.  ``restore_engine`` keeps the destination plan's block of each
leaf (``ShardingPlan.slice_cache``, then ``shard_cache``'s check), so a
handoff at the same K continues bit for bit.  As in the reference, whose
``_geometry`` has no mesh, a snapshot can cross to another K: the
destination then serves another ``LM`` (another rank's slices, or the
whole model), which must be the same whole config (the snapshot's
``model`` field), its weights from the same ``seed``; the token streams are
then the identity surface (the sums over "model" round differently).
"""
from __future__ import annotations

import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.prefix import FullPromptEntry, _chain_key
from repro_torch.serve.scheduler import Request, RequestState
from repro_torch.telemetry import CkptCostEvent

SNAPSHOT_FORMAT = 1

# every geometry field that shapes the decode computation or the step
# schedule; a mismatch on any of them makes "bit-identical continuation"
# unsatisfiable, so restore refuses rather than silently diverging.  The
# reference's nine, then the port's: the served model itself, the paged
# decode's implementation and its pages_per_program.
_GEOMETRY_FIELDS = (
    "arch",
    "seed",
    "max_batch",
    "page_size",
    "max_seq",
    "num_pages",
    "prefill_chunk",
    "speculate",
    "collect_logits",
    "lm",
    "paged_impl",
    "pages_per_program",
)


class MigrationError(RuntimeError):
    """A snapshot cannot be restored onto the given destination engine."""


def _geometry(engine: ServeEngine) -> Dict[str, Any]:
    return {
        "arch": engine.cfg.name,
        "seed": engine.seed,
        "max_batch": engine.max_batch,
        "page_size": engine.page_size,
        "max_seq": engine.max_seq,
        "num_pages": engine.pool.num_pages,
        "prefill_chunk": engine.prefill_chunk,
        "speculate": engine.speculate,
        "collect_logits": engine.collect_logits,
        "lm": engine.lm,
        "paged_impl": engine.rt.paged_impl,
        "pages_per_program": engine._step_runtime().pages_per_program,
        # compared only where they apply: "lm" is compared by identity at
        # the same "model" world, else the whole model's config
        "world": 1 if engine.plan is None else engine.plan.world,
        "model": _whole_config(engine),
    }


def _whole_config(engine: ServeEngine):
    return engine.lm.cfg if engine.lm.shard is None else engine.lm.shard.whole


def _host_whole(engine: ServeEngine, tree, slot_major: bool = False):
    """Host copies of ``tree``'s leaves, whole: a tensor-parallel engine's
    gathered over "model" (``ShardingPlan.gather_cache``)."""
    if engine.plan is None or engine.plan.world == 1:
        return _host_copy(tree)
    return engine.plan.gather_cache(tree, _whole_config(engine), engine.rt.model_group(),
                                    engine.device, slot_major=slot_major)


def _placed(engine: ServeEngine, tree, slot_major: bool = False):
    """``tree``'s whole leaves as the destination holds them: its plan's
    blocks (views; the caller copies)."""
    if engine.plan is None or engine.plan.world == 1:
        return tree
    return engine.plan.slice_cache(tree, _whole_config(engine), slot_major=slot_major)


def _host_copy(tree):
    """The cache's or a state snapshot's leaves as CPU tensors of their own."""
    return [{name: None if leaf is None else leaf.to("cpu", copy=True)
             for name, leaf in layer.items()} for layer in tree]


# ---------------------------------------------------------------------------
# request (de)serialization
# ---------------------------------------------------------------------------


def _pack_request(req: Request) -> Dict[str, Any]:
    return {
        "rid": req.rid,
        "prompt": req.prompt.copy(),
        "max_new_tokens": req.max_new_tokens,
        "arrival_step": req.arrival_step,
        "frontend_embeds": None if req.frontend_embeds is None
        else np.asarray(req.frontend_embeds).copy(),
        "state": req.state.value,
        "slot": req.slot,
        "page_ids": list(req.page_ids),
        "n_shared_pages": req.n_shared_pages,
        "prefill_skipped": req.prefill_skipped,
        # full_entry is a live reference into the prefix cache; carry its
        # chain key and re-link after the cache itself is restored
        "full_entry_key": _chain_key(req.prompt) if req.full_entry is not None else None,
        "generated": list(req.generated),
        "logits_trace": None if req.logits_trace is None
        else [np.asarray(a).copy() for a in req.logits_trace],
        "admitted_step": req.admitted_step,
        "finished_step": req.finished_step,
        "prefill_s": req.prefill_s,
        "prefill_pos": req.prefill_pos,
        "first_token_step": req.first_token_step,
    }


def _unpack_request(d: Dict[str, Any], full: Dict[str, FullPromptEntry]) -> Request:
    req = Request(rid=d["rid"], prompt=np.asarray(d["prompt"], np.int32),
                  max_new_tokens=d["max_new_tokens"], arrival_step=d["arrival_step"],
                  frontend_embeds=d["frontend_embeds"])
    req.state = RequestState(d["state"])
    req.slot = d["slot"]
    req.page_ids = list(d["page_ids"])
    req.n_shared_pages = d["n_shared_pages"]
    req.prefill_skipped = d["prefill_skipped"]
    if d["full_entry_key"] is not None:
        req.full_entry = full[d["full_entry_key"]]
    req.generated = list(d["generated"])
    if d["logits_trace"] is not None:
        req.logits_trace = [a.copy() for a in d["logits_trace"]]
    req.admitted_step = d["admitted_step"]
    req.finished_step = d["finished_step"]
    req.prefill_s = d["prefill_s"]
    req.prefill_pos = d["prefill_pos"]
    req.first_token_step = d["first_token_step"]
    return req


# ---------------------------------------------------------------------------
# snapshot
# ---------------------------------------------------------------------------


def snapshot_engine(engine: ServeEngine) -> Dict[str, Any]:
    """Consistent host-side snapshot of one engine's full serving state.

    Must be called between engine steps (the engine mutates state only
    inside ``step()``); the result is host data — CPU tensors, numpy arrays
    and builtin containers, and a reference to the served ``LM`` for the
    geometry check — safe to hold across the source engine's teardown.
    On a tensor-parallel engine every rank calls it at the same step: the
    cache's leaves are gathered over "model" into whole leaves.
    """
    p = engine.prefix
    prefix = {
        "pages": list(p._pages.items()),
        "parent": dict(p._parent),
        "nchildren": dict(p._nchildren),
        "full": [(k, {"page_ids": list(e.page_ids),
                      "last_logits": np.asarray(e.last_logits).copy(),
                      "state": None if e.state is None else _host_whole(
                          engine, e.state, slot_major=True),
                      "tokens": None if e.tokens is None else e.tokens.copy()})
                 for k, e in p._full.items()],
        "hits": p.hits,
        "pages_shared": p.pages_shared,
        "prefills_skipped": p.prefills_skipped,
        "draft_hit": p._draft_hit,
    }
    proposer = None
    if engine.proposer is not None:
        pr = engine.proposer
        proposer = {"proposals": pr.proposals, "proposed_tokens": pr.proposed_tokens,
                    "accepted_tokens": pr.accepted_tokens,
                    "last_source": dict(pr._last_source)}
    sched = engine.scheduler
    return {
        "format": SNAPSHOT_FORMAT,
        "geometry": _geometry(engine),
        "step_count": engine.step_count,
        "rid": engine._rid,
        "lengths": engine.lengths.copy(),
        "next_tokens": engine.next_tokens.copy(),
        "page_tables": engine.page_tables.copy(),
        "cache": _host_whole(engine, engine.cache),
        "pool": {"free": list(engine.pool._free), "refcount": list(engine.pool._refcount)},
        "prefix": prefix,
        "proposer": proposer,
        "scheduler": {
            "queue": [_pack_request(r) for r in sched.queue],
            "slots": [None if r is None else _pack_request(r) for r in sched.slots],
            "finished": [_pack_request(r) for r in sched.finished],
        },
    }


def snapshot_nbytes(snap: Dict[str, Any]) -> int:
    """The paged cache's bytes (its whole leaves): it dominates the
    payload, so that is what gets reported (request and prefix metadata
    are noise next to it)."""
    return sum(leaf.numel() * leaf.element_size()
               for layer in snap["cache"] for leaf in layer.values())


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------


def _check_compatible(engine: ServeEngine, snap: Dict[str, Any]) -> None:
    if snap.get("format") != SNAPSHOT_FORMAT:
        raise MigrationError(f"snapshot format {snap.get('format')!r} != {SNAPSHOT_FORMAT}")
    dst = _geometry(engine)
    bad = []
    for k in _GEOMETRY_FIELDS:
        if k == "lm" and snap["geometry"]["world"] != dst["world"]:
            if snap["geometry"]["model"] != dst["model"]:
                bad.append("model: the destination serves another model than the snapshot's")
        elif k == "lm":
            if snap["geometry"]["lm"] is not dst["lm"]:
                bad.append("lm: the destination serves another model than the snapshot's")
        elif snap["geometry"][k] != dst[k]:
            bad.append(f"{k}: snapshot={snap['geometry'][k]!r} dest={dst[k]!r}")
    if bad:
        raise MigrationError(
            "destination engine geometry does not match the snapshot "
            "(bit-identical continuation impossible): " + "; ".join(bad))
    if engine.step_count or engine._rid or engine.scheduler.queue or any(
            s is not None for s in engine.scheduler.slots):
        raise MigrationError(
            "destination engine must be fresh (it has served traffic; "
            "restoring over live state would leak pages)")


def restore_engine(engine: ServeEngine, snap: Dict[str, Any]) -> Dict[int, Request]:
    """Install ``snap`` onto a fresh, geometry-identical engine.

    Returns ``{rid: Request}`` over every restored request (queued, active
    and finished) so callers holding handles into the source engine — the
    ``Router`` — can re-point them at the destination's objects.
    """
    _check_compatible(engine, snap)
    device = engine.device
    engine.cache = [{name: leaf.to(device, copy=True).contiguous()
                     for name, leaf in layer.items()}
                    for layer in _placed(engine, snap["cache"])]
    if engine.plan is not None:
        engine.cache = engine.plan.shard_cache(engine.cache, _whole_config(engine))
    engine.page_tables = snap["page_tables"].copy()
    engine.page_tables_dev = torch.from_numpy(engine.page_tables.copy()).to(device)
    engine.lengths = snap["lengths"].copy()
    engine.next_tokens = snap["next_tokens"].copy()
    engine.step_count = snap["step_count"]
    engine._rid = snap["rid"]

    pool = engine.pool
    pool._free = deque(snap["pool"]["free"])
    pool._refcount = list(snap["pool"]["refcount"])

    p, ps = engine.prefix, snap["prefix"]
    p._pages = OrderedDict(ps["pages"])
    p._parent = dict(ps["parent"])
    p._nchildren = dict(ps["nchildren"])
    p._full = OrderedDict(
        (k, FullPromptEntry(tuple(e["page_ids"]), e["last_logits"].copy(),
                            None if e["state"] is None else _host_copy(
                                _placed(engine, e["state"], slot_major=True)),
                            None if e["tokens"] is None else e["tokens"].copy()))
        for k, e in ps["full"])
    p.hits = ps["hits"]
    p.pages_shared = ps["pages_shared"]
    p.prefills_skipped = ps["prefills_skipped"]
    p._draft_hit = ps["draft_hit"]
    full = dict(p._full)

    if snap["proposer"] is not None and engine.proposer is not None:
        pr, prs = engine.proposer, snap["proposer"]
        pr.proposals = prs["proposals"]
        pr.proposed_tokens = prs["proposed_tokens"]
        pr.accepted_tokens = prs["accepted_tokens"]
        pr._last_source = dict(prs["last_source"])

    sched, ss = engine.scheduler, snap["scheduler"]
    rid_map: Dict[int, Request] = {}

    def build(d: Dict[str, Any]) -> Request:
        req = _unpack_request(d, full)
        rid_map[req.rid] = req
        return req

    sched.queue = [build(d) for d in ss["queue"]]
    sched.slots = [None if d is None else build(d) for d in ss["slots"]]
    sched.finished = [build(d) for d in ss["finished"]]
    return rid_map


# ---------------------------------------------------------------------------
# router-level handoff
# ---------------------------------------------------------------------------


def migrate_replica(router, replica: int, make_engine: Callable[[], ServeEngine], *,
                    assumed_s: Optional[float] = None) -> Dict[str, Any]:
    """Hand replica ``replica`` off to a freshly built engine, live.

    Call between router steps.  The source engine is snapshotted, the
    destination (from ``make_engine``; must match the source's geometry and
    serve its ``LM``) restored, swapped into the router, and every
    ``RoutedRequest`` handle pointing at the old engine re-bound: in-flight
    streams continue on the destination bit-identically.  Emits a
    ``ckpt_cost`` event (``op="migrate"``) on the router bus and returns the
    measured handoff stats the launch CLI prints, with the wall time's parts
    (``snapshot_s``: the state to the host; ``build_s``: ``make_engine``;
    ``restore_s``: the state onto the destination and the handles re-bound),
    the source and the destination.
    """
    if not 0 <= replica < len(router.engines):
        raise ValueError(
            f"replica {replica} out of range for a {len(router.engines)}-replica fleet")
    src = router.engines[replica]
    t0 = time.perf_counter()
    snap = snapshot_engine(src)
    t1 = time.perf_counter()
    dst = make_engine()
    t2 = time.perf_counter()
    rid_map = restore_engine(dst, snap)
    dst.replica_id = replica
    if dst.spans is not None:
        dst.spans.set_trace("serve", dst.cfg.name, dst.seed, replica, replica=replica)
    router.engines[replica] = dst
    in_flight = 0
    for rr in router.requests:
        if rr.replica == replica and rr.request is not None:
            rr.request = rid_map[rr.request.rid]
            if rr.request.state is not RequestState.FINISHED:
                in_flight += 1
    wall_s = time.perf_counter() - t0
    nbytes = snapshot_nbytes(snap)
    n_shards = sum(len(layer) for layer in snap["cache"])
    router.tracker.emit(CkptCostEvent(step=router.step_count, op="migrate", wall_s=wall_s,
                                      assumed_s=assumed_s, workload=dst.cfg.name,
                                      nbytes=nbytes, n_shards=n_shards, replica=replica))
    return {"replica": replica, "wall_s": wall_s, "snapshot_s": t1 - t0, "build_s": t2 - t1,
            "restore_s": wall_s - (t2 - t0), "nbytes": nbytes, "n_shards": n_shards,
            "requests": len(rid_map), "in_flight": in_flight,
            "pages_in_use": dst.pool.pages_in_use, "source": src, "destination": dst}


__all__: List[str] = [
    "MigrationError",
    "migrate_replica",
    "restore_engine",
    "snapshot_engine",
    "snapshot_nbytes",
]
