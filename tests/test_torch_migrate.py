"""Port parity: live serving-state migration (``repro_torch.serve.migrate``)
against the JAX package's ``repro.serve.migrate``, for qwen3-14b,
falcon-mamba-7b and deepseek-v2-236b at their smoke sizes, on the
reference test's geometry (max_batch 2, page 8, max_seq 64) and trace
(tests/test_migrate.py: mixed lengths, staggered arrivals, a shared head on
every third request).

Identity surfaces:

* against the reference: a fleet of 2 replicas in float32 (the port's
  sharing one LM converted from the reference engine's weights), replica 0
  handed off to a fresh engine at router step 1, 2 or 5, gives every
  request the reference fleet's token stream (the reference's own handoff,
  at step 3, gives its unmigrated tokens: tests/test_migrate.py); the
  handoff's ``ckpt_cost`` event has the reference's ``op``, ``step``,
  ``replica`` and ``workload``, and both catch requests in flight;
* the port's own guarantee, in bf16: an engine restored from a
  between-steps snapshot continues bit for bit (tokens and every logit),
  also mid chunked prefill and during speculative decode; the pool's free
  list in order and its refcounts, the prefix cache's chains, full-prompt
  entries (a Mamba model's state with them) and LRU orders, the page
  tables, lengths and pending tokens equal the source's after the hop, and
  no page leaks once the trace drains;
* the reference's rejections (another geometry, seed, chunk or batch; a
  used destination; a replica out of range) and the port's (another
  ``LM``, paged-decode implementation or ``pages_per_program``);
* under tensor parallelism, two gloo ranks on a (1, 2) mesh in float32 on
  the reference's weights: a 2-way engine handed off at step 2 or 4 (its
  cache gathered over "model" into whole leaves, restored as each rank's
  block) continues bit for bit the unmigrated 2-way run (tokens and every
  logit), the ranks alike; the same snapshot restored onto an unsharded
  engine (K = 1, the whole model) keeps the 2-way run's token streams, the
  identity surface across K (the sums over "model" round otherwise).
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import dataclasses
from functools import lru_cache

import jax
import numpy as np
import pytest
import torch

from repro.serve import Router as RefRouter
from repro.serve import ServeEngine as RefServeEngine
from repro.serve import migrate_replica as ref_migrate_replica
from _torch_tp_ranks import Spawned
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models.model import LM
from repro_torch.serve import (
    MigrationError,
    Router,
    ServeEngine,
    migrate_replica,
    restore_engine,
    snapshot_engine,
)
from repro_torch.serve.migrate import snapshot_nbytes
from repro_torch.serve.scheduler import RequestState

ARCHS = ["qwen3-14b", "falcon-mamba-7b", "deepseek-v2-236b"]
GEOM = dict(max_batch=2, page_size=8, max_seq=64)
PS = GEOM["page_size"]


class Float32RefEngine(RefServeEngine):
    @staticmethod
    def config_for(arch, smoke):
        return dataclasses.replace(RefServeEngine.config_for(arch, smoke), dtype="float32")


def _prompt(rng, n):
    return rng.randint(0, 256, n).astype(np.int32)


def _specs(seed=0, n=6):
    """The reference test's trace (tests/test_migrate.py::_specs)."""
    rng = np.random.RandomState(seed)
    head = _prompt(rng, 2 * PS)
    specs = []
    for i in range(n):
        if i % 3 == 0:
            prompt = np.concatenate([head, _prompt(rng, 3)])
        else:
            prompt = _prompt(rng, int(rng.choice([7, 12, 21])))
        specs.append((prompt, int(rng.choice([4, 6])), (i // 2) * 2))
    return specs


def _submit_all(target, specs):
    return [target.submit(p, g, arrival_step=a) for p, g, a in specs]


def _drive(router, migrate_at, make_engine, replica=0):
    info = None
    while not router.drained:
        if router.step_count == migrate_at:
            info = migrate_replica(router, replica, make_engine)
        router.step()
    return info


@lru_cache(maxsize=None)
def _reference(arch: str):
    """The reference's float32 fleet of 2 with replica 0 handed off at
    step 3: its tokens, the handoff's stats and ckpt_cost event, and its
    weights as numpy."""
    make = lambda: Float32RefEngine(arch, smoke=True, seed=0, **GEOM)  # noqa: E731
    router = RefRouter([make() for _ in range(2)])
    routed = _submit_all(router, _specs())
    info = None
    while not router.drained:
        if router.step_count == 3:
            info = ref_migrate_replica(router, 0, make)
        router.step()
    ev = router.events("ckpt_cost")
    return ([rr.generated for rr in routed], info, [e.to_dict() for e in ev],
            jax.tree.map(np.asarray, router.engines[1].params))


@lru_cache(maxsize=None)
def _float32_lm(arch: str) -> LM:
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    return lm_params_from_numpy(cfg, _reference(arch)[3], device="cpu")


@lru_cache(maxsize=None)
def _bf16_lm(arch: str) -> LM:
    return LM(get_smoke_config(arch), device="cpu").init_params(torch.Generator().manual_seed(0))


def _engine(lm, **kw):
    return ServeEngine("", lm=lm, **{**GEOM, **kw})


# ---------------------------------------------------------- against the reference
@pytest.mark.parametrize("step", [1, 2, 5])
@pytest.mark.parametrize("arch", ARCHS)
def test_routed_handoff_gives_the_reference_tokens(arch, step):
    tokens, ref_info, _, _ = _reference(arch)
    assert ref_info["in_flight"] > 0
    lm = _float32_lm(arch)
    make = lambda: _engine(lm, paged_impl="stream")  # noqa: E731
    router = Router([make() for _ in range(2)])
    routed = _submit_all(router, _specs())
    info = _drive(router, step, make)
    assert info is not None and info["destination"] is router.engines[0]
    assert [rr.generated for rr in routed] == tokens
    assert router.stats()["requests_finished"] == 6


@pytest.mark.parametrize("arch", ARCHS)
def test_ckpt_cost_event_matches_reference(arch):
    _, ref_info, ref_events, _ = _reference(arch)
    lm = _float32_lm(arch)
    make = lambda: _engine(lm, paged_impl="stream")  # noqa: E731
    router = Router([make() for _ in range(2)])
    _submit_all(router, _specs())
    info = _drive(router, 3, make)
    events = [e.to_dict() for e in router.events("ckpt_cost")]
    assert len(events) == len(ref_events) == 1
    keys = ("kind", "op", "step", "replica", "workload")
    assert {k: events[0][k] for k in keys} == {k: ref_events[0][k] for k in keys}
    assert events[0]["op"] == "migrate" and events[0]["step"] == 3
    assert (info["in_flight"], info["requests"], info["pages_in_use"]) == \
        (ref_info["in_flight"], ref_info["requests"], ref_info["pages_in_use"])
    assert events[0]["nbytes"] == info["nbytes"] == snapshot_nbytes(
        snapshot_engine(router.engines[0])) > 0
    assert events[0]["n_shards"] == sum(len(layer) for layer in router.engines[0].cache)


# ---------------------------------------------------------- the port's own guarantee
def _handoff(lm, migrate_step, specs, **kw):
    src = _engine(lm, **kw)
    reqs = _submit_all(src, specs)
    for _ in range(migrate_step):
        src.step()
    dst = _engine(lm, **kw)
    rid_map = restore_engine(dst, snapshot_engine(src))
    dst.run()
    return [rid_map[r.rid] for r in reqs], src, dst


@pytest.mark.parametrize("step", [1, 2, 5])
@pytest.mark.parametrize("arch", ARCHS)
def test_restored_engine_continues_bitwise_in_bf16(arch, step):
    lm = _bf16_lm(arch)
    specs = _specs(seed=3)
    base = _engine(lm, collect_logits=True)
    want = _submit_all(base, specs)
    base.run()
    moved, src, dst = _handoff(lm, step, specs, collect_logits=True)
    if step == 2:
        assert any(r is not None and r.state is not RequestState.FINISHED
                   for r in src.scheduler.slots + src.scheduler.queue)
    for got, r in zip(moved, want):
        assert got.generated == r.generated
        assert len(got.logits_trace) == len(r.logits_trace)
        assert all(np.array_equal(a, b) for a, b in zip(got.logits_trace, r.logits_trace))
    assert dst.step_count == base.step_count
    assert dst.prefills_run + src.prefills_run == base.prefills_run


def test_migrate_mid_chunked_prefill():
    """A snapshot taken while a prompt streams in chunk by chunk carries the
    half-written pages and the prefill cursor."""
    lm = _bf16_lm("qwen3-14b")
    rng = np.random.RandomState(7)
    specs = [(_prompt(rng, 30), 5, 0), (_prompt(rng, 28), 4, 0), (_prompt(rng, 21), 4, 1)]
    base = _engine(lm, prefill_chunk=4)
    want = _submit_all(base, specs)
    base.run()
    src = _engine(lm, prefill_chunk=4)
    reqs = _submit_all(src, specs)
    src.step()
    assert any(r is not None and r.state is RequestState.PREFILLING for r in src.scheduler.slots)
    dst = _engine(lm, prefill_chunk=4)
    rid_map = restore_engine(dst, snapshot_engine(src))
    dst.run()
    assert [rid_map[r.rid].generated for r in reqs] == [r.generated for r in want]


def test_migrate_during_speculative_decode():
    """The proposer's counters and per-slot memory and the prefix cache's
    stored draft sources migrate: the destination keeps verifying and the
    streams stay exact.  The workload is the serve CLI's document extension
    (a stored page-aligned document whose head a follow-up request
    continues)."""
    lm = _bf16_lm("qwen3-14b")
    geom = dict(max_batch=2, page_size=8, max_seq=96)

    def drive(migrate_at=None):
        eng = ServeEngine("", lm=lm, speculate=4, **geom)
        head = _prompt(np.random.RandomState(3), 16)
        doc_req = eng.submit(head, 40)
        eng.run()
        eng.submit(np.concatenate([head, np.asarray(doc_req.generated, np.int32)]), 1)
        eng.run()
        follow = eng.submit(head.copy(), 30)
        follow.arrival_step = eng.step_count  # for the premise below; it is admitted now
        if migrate_at is None:
            eng.run()
            return follow, eng
        for _ in range(migrate_at):
            eng.step()
        dst = ServeEngine("", lm=lm, speculate=4, **geom)
        rid_map = restore_engine(dst, snapshot_engine(eng))
        dst.run()
        return rid_map[follow.rid], dst

    base_follow, base = drive()
    assert base.proposer.accepted_tokens > 0
    # the follow-up decodes by verify steps only: hand off after 3 of them
    follow_ops = [e.op for e in base.events("serve_step") if e.step >= base_follow.arrival_step]
    assert follow_ops.count("verify") > 3 and "decode" not in follow_ops
    moved_follow, dst = drive(3)
    assert moved_follow.generated == base_follow.generated
    assert any(e.op == "verify" for e in dst.events("serve_step"))
    assert dst.proposer.proposed_tokens == base.proposer.proposed_tokens
    assert dst.proposer.accepted_tokens == base.proposer.accepted_tokens


@pytest.mark.parametrize("arch", ["qwen3-14b", "falcon-mamba-7b"])
def test_pool_prefix_and_state_survive_the_hop(arch):
    lm = _bf16_lm(arch)
    aligned = _prompt(np.random.RandomState(11), 2 * PS)  # stored whole: a skip source
    src = _engine(lm)
    _submit_all(src, _specs(seed=5) + [(aligned, 3, 1)])
    for _ in range(4):
        src.step()
    dst = _engine(lm)
    restore_engine(dst, snapshot_engine(src))
    assert list(dst.pool._free) == list(src.pool._free)
    assert dst.pool._refcount == src.pool._refcount
    assert list(dst.prefix._pages.items()) == list(src.prefix._pages.items())
    assert dst.prefix._parent == src.prefix._parent
    assert dst.prefix._nchildren == src.prefix._nchildren
    assert list(dst.prefix._full.keys()) == list(src.prefix._full.keys())
    assert src.prefix._full, "test premise: a page-aligned prompt stored whole"
    for k, e in src.prefix._full.items():
        d = dst.prefix._full[k]
        assert d.page_ids == e.page_ids and np.array_equal(d.last_logits, e.last_logits)
        for got, want in zip(d.state, e.state):  # a Mamba layer's state after the prompt
            for name, leaf in want.items():
                assert (got[name] is None) == (leaf is None)
                if leaf is not None:
                    assert torch.equal(got[name], leaf) and got[name] is not leaf
    for got, want in zip(dst.cache, src.cache):
        assert got.keys() == want.keys()
        assert all(torch.equal(got[n], want[n]) for n in want)
    assert (dst.prefix.hits, dst.prefix.pages_shared, dst.prefix.prefills_skipped) == \
        (src.prefix.hits, src.prefix.pages_shared, src.prefix.prefills_skipped)
    assert np.array_equal(dst.page_tables, src.page_tables)
    assert torch.equal(dst.page_tables_dev, src.page_tables_dev)
    assert np.array_equal(dst.lengths, src.lengths)
    assert np.array_equal(dst.next_tokens, src.next_tokens)
    assert dst._rid == src._rid
    # the migrated prefix cache still serves the whole-prompt skip
    src.run()
    dst.run()
    again = dst.submit(aligned.copy(), 2)
    twin = src.submit(aligned.copy(), 2)
    dst.run()
    src.run()
    assert again.prefill_skipped and twin.prefill_skipped
    assert again.generated == twin.generated


@pytest.mark.parametrize("arch", ARCHS)
def test_no_page_leak_after_migration(arch):
    moved, _, dst = _handoff(_bf16_lm(arch), 3, _specs(seed=9))
    assert all(r.state is RequestState.FINISHED for r in moved)
    dst.prefix.clear(dst.pool)
    assert dst.pool.pages_in_use == 0


def test_migrated_replica_keeps_winning_affinity_probes():
    lm = _bf16_lm("qwen3-14b")
    rng = np.random.RandomState(13)
    head = _prompt(rng, 2 * PS)
    router = Router([_engine(lm) for _ in range(2)], spill_slack=512)
    router.submit(np.concatenate([head, _prompt(rng, 3)]), 3, arrival_step=0)
    router.submit(_prompt(rng, 7), 3, arrival_step=0)
    late = router.submit(np.concatenate([head, _prompt(rng, 5)]), 3, arrival_step=6)
    _drive(router, 4, lambda: _engine(lm))
    ev = next(e for e in router.events("router") if e.rid == late.rid)
    assert ev.reason == "affinity" and ev.replica == 0 and ev.matched_pages == 2


# ---------------------------------------------------------- guard rails
def test_geometry_mismatch_is_rejected():
    lm = _bf16_lm("qwen3-14b")
    src = _engine(lm)
    _submit_all(src, _specs())
    src.step()
    snap = snapshot_engine(src)
    other = LM(get_smoke_config("qwen3-14b"), device="cpu").init_params(
        torch.Generator().manual_seed(0))
    for bad in (dict(page_size=16, max_seq=64), dict(max_batch=4), dict(seed=1),
                dict(prefill_chunk=4), dict(lm=other), dict(paged_impl="gather")):
        with pytest.raises(MigrationError, match="geometry"):
            restore_engine(_engine(**{"lm": lm, **bad}), snap)
    dst = _engine(lm)
    dst.decode_pages_per_program = lambda: (8, True, {})
    with pytest.raises(MigrationError, match="pages_per_program"):
        restore_engine(dst, snap)
    with pytest.raises(MigrationError, match="lm: the destination serves another model"):
        restore_engine(_engine(other), snap)


def test_restore_onto_used_engine_is_rejected():
    lm = _bf16_lm("qwen3-14b")
    src = _engine(lm)
    _submit_all(src, _specs())
    src.step()
    snap = snapshot_engine(src)
    used = _engine(lm)
    used.submit(np.arange(7, dtype=np.int32), 2)
    with pytest.raises(MigrationError, match="fresh"):
        restore_engine(used, snap)


def test_bad_replica_index_is_rejected():
    lm = _bf16_lm("qwen3-14b")
    router = Router([_engine(lm)])
    with pytest.raises(ValueError, match="out of range"):
        migrate_replica(router, 1, lambda: _engine(lm))


# ---------------------------------------------------------- under tensor parallelism
TP_STEPS = (2, 4)


@pytest.fixture(scope="module")
def tp_handoffs(tmp_path_factory):
    """Both ranks' results of the 2-way handoffs, every arch in one group."""
    jobs = {arch: {"kind": "tp_migrate", "params": _reference(arch)[3], "specs": _specs(),
                   "cfg": dataclasses.replace(get_smoke_config(arch), dtype="float32"),
                   "engine": dict(GEOM), "steps": TP_STEPS} for arch in ARCHS}
    return Spawned(2, jobs, str(tmp_path_factory.mktemp("tp_migrate")), 240).results()


@pytest.mark.parametrize("arch", ARCHS)
def test_tp2_handoff_continues_bit_for_bit(arch, tp_handoffs):
    cfg = get_smoke_config(arch)
    for res in tp_handoffs:
        got = res[arch]
        control = got["control"]
        for step, run in got["runs"].items():
            assert run["in_flight"] > 0, step
            assert run["same_k"]["tokens"] == control["tokens"], step
            for a, b in zip(run["same_k"]["logits"], control["logits"]):
                np.testing.assert_array_equal(a, b)
            for layer in run["shapes"]:  # whole leaves
                if "k" in layer:
                    assert layer["k"][1] == cfg.n_kv_heads
                if "h" in layer:
                    assert layer["h"][1] == cfg.mamba.resolved_d_inner(cfg.d_model)
            assert run["nbytes"] > 0
    a, b = (res[arch] for res in tp_handoffs)
    assert a["control"]["tokens"] == b["control"]["tokens"]
    for step in TP_STEPS:
        assert a["runs"][step]["nbytes"] == b["runs"][step]["nbytes"]
        for x, y in zip(a["runs"][step]["same_k"]["logits"], b["runs"][step]["same_k"]["logits"]):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp2_snapshot_restored_at_k1_keeps_the_token_streams(arch, tp_handoffs):
    for res in tp_handoffs:
        got = res[arch]
        for step, run in got["runs"].items():
            assert run["k1"]["tokens"] == got["control"]["tokens"], step
