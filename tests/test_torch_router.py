"""Port parity: the prefix-affinity ``Router`` (``repro_torch.serve.router``)
against the JAX package's ``repro.serve.Router`` on the serve CLI's
8-request mixed trace (max_batch 4, page 16, max_seq 96), for qwen3-14b,
falcon-mamba-7b and deepseek-v2-236b at their smoke sizes.

Identity surfaces:

* against the reference: both packages' fleets of 2 replicas, in float32,
  the port's replicas sharing one LM converted from the reference engine's
  weights, give every request the same token stream and emit the same
  ``RouterEvent`` stream (every field: step, replica, matched pages, best
  affinity, reason, prompt pages, loads), the same ``stats()`` and the same
  per-replica planner counts, at the default ``spill_slack`` and at one
  small enough to spill (qwen3-14b).  Equal float32 streams are a fair
  demand here: tests/test_torch_serve_engine.py holds each arch's float32
  engine on this trace to the reference's tokens, with every top-1/top-2
  margin above the logits' tolerance, and a routed request runs the same
  computation as in one engine;
* against its own single engine, in bf16: the routed fleet's tokens and
  logits bit for bit one engine's (the engine's slot independence);
* the reference's rejections of a bad fleet.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import dataclasses
from functools import lru_cache

import jax
import numpy as np
import pytest
import torch

from repro.launch.serve import _mixed_trace_specs as ref_trace_specs
from repro.serve import Router as RefRouter
from repro.serve import ServeEngine as RefServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models.model import LM
from repro_torch.serve import CapacityPlanner, Router, ServeEngine

ENGINE = dict(max_batch=4, page_size=16, max_seq=96)
ARCHS = ["qwen3-14b", "falcon-mamba-7b", "deepseek-v2-236b"]
SPILL_SLACK = 8  # spills the trace's first affinity hit (its winner 30 tokens ahead)


class Float32RefEngine(RefServeEngine):
    @staticmethod
    def config_for(arch, smoke):
        return dataclasses.replace(RefServeEngine.config_for(arch, smoke), dtype="float32")


def _submit(target, specs):
    return [target.submit(p, gen, arrival_step=arr) for p, gen, arr, _ in specs]


def _replica_counts(router):
    planner = CapacityPlanner()
    planner.ingest(router.all_events())
    return {r: (s["dispatches"], s["affinity_hits"], s["spills"], s["decode_tokens"])
            for r, s in planner.replica_stats().items()}


@lru_cache(maxsize=None)
def _reference(arch: str, spill_slack: int = 512):
    """The reference's float32 fleet of 2 on the CLI's trace: its tokens,
    router events, stats and replica counts, and its weights as numpy."""
    engines = [Float32RefEngine(arch, smoke=True, seed=0, **ENGINE) for _ in range(2)]
    router = RefRouter(engines, spill_slack=spill_slack)
    routed = _submit(router, ref_trace_specs(engines[0].cfg, 16, 8, 0))
    stats = router.run()
    from repro.serve import CapacityPlanner as RefPlanner

    planner = RefPlanner()
    planner.ingest(router.all_events())
    counts = {r: (s["dispatches"], s["affinity_hits"], s["spills"], s["decode_tokens"])
              for r, s in planner.replica_stats().items()}
    return ([rr.generated for rr in routed], [e.to_dict() for e in router.events("router")],
            stats, counts, jax.tree.map(np.asarray, engines[0].params))


@lru_cache(maxsize=None)
def _float32_lm(arch: str) -> LM:
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    return lm_params_from_numpy(cfg, _reference(arch)[4], device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_routed_fleet_matches_reference_fleet_in_float32(arch):
    tokens, events, stats, counts, _ = _reference(arch)
    lm = _float32_lm(arch)
    router = Router([ServeEngine("", lm=lm, paged_impl="stream", **ENGINE) for _ in range(2)])
    routed = _submit(router, ref_trace_specs(lm.cfg, 16, 8, 0))
    got = router.run()
    assert [rr.generated for rr in routed] == tokens
    assert [e.to_dict() for e in router.events("router")] == events
    assert got == stats
    assert got["requests_finished"] == 8 and all(got["dispatch_per_replica"])
    assert got["affinity_hits"] > 0
    assert _replica_counts(router) == counts
    # every replica's serve_step rows carry its tag
    for i, eng in enumerate(router.engines):
        assert {e.replica for e in eng.events("serve_step")} == {i}


def test_spill_at_small_slack_matches_reference():
    tokens, events, stats, _, _ = _reference("qwen3-14b", SPILL_SLACK)
    lm = _float32_lm("qwen3-14b")
    router = Router([ServeEngine("", lm=lm, paged_impl="stream", **ENGINE) for _ in range(2)],
                    spill_slack=SPILL_SLACK)
    routed = _submit(router, ref_trace_specs(lm.cfg, 16, 8, 0))
    assert router.run() == stats
    got = [e.to_dict() for e in router.events("router")]
    assert got == events
    spill = next(e for e in got if e["reason"] == "spill")
    assert spill["best_affinity"] > 0 and spill["matched_pages"] == 0
    assert spill["loads"][1 - spill["replica"]] - spill["loads"][spill["replica"]] > SPILL_SLACK
    assert [rr.generated for rr in routed] == tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_routed_fleet_bitwise_its_single_engine_in_bf16(arch):
    cfg = get_smoke_config(arch)
    lm = LM(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    specs = ref_trace_specs(cfg, 16, 8, 0)
    single = ServeEngine("", lm=lm, collect_logits=True, **ENGINE)
    want = _submit(single, specs)
    single.run()
    router = Router([ServeEngine("", lm=lm, collect_logits=True, **ENGINE) for _ in range(2)])
    routed = _submit(router, specs)
    router.run()
    for rr, r in zip(routed, want):
        assert rr.generated == r.generated
        assert len(rr.request.logits_trace) == len(r.logits_trace)
        assert all(np.array_equal(a, b) for a, b in zip(rr.request.logits_trace, r.logits_trace))
    assert sorted({rr.replica for rr in routed}) == [0, 1]


def test_router_rejects_bad_fleets():
    """The reference's rejections (tests/test_router.py)."""
    lm = LM(get_smoke_config("qwen3-14b"), device="cpu").init_params(
        torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="at least one engine"):
        Router([])
    with pytest.raises(ValueError, match="page_size"):
        Router([ServeEngine("", lm=lm, **ENGINE),
                ServeEngine("", lm=lm, **{**ENGINE, "page_size": 8})])
    with pytest.raises(ValueError, match="spill_slack"):
        Router([ServeEngine("", lm=lm, **ENGINE)], spill_slack=-1)
