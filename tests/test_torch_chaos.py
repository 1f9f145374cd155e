"""Port parity: the §6 chaos loop (``repro_torch.runtime``) against
``repro.runtime.chaos``, and the SSP executor against the reference's.

The trace generator, the cluster simulator, the monitor, the injector and
the loop are pure Python copied unchanged: the trace JSON is held byte for
byte and their cases below are the reference's own (tests/test_chaos.py).
The executor's objectives come from float32 arithmetic in another order
(the local-SGD chain's dot products and its unfused updates, see
tests/test_torch_sgd.py; the primal's sums): at the chaos run's step sizes
(lr0 0.01, lambda 1e-2, smooth hinge, gamma 1: a contraction, no gate) they
measured at most 2e-7 apart relative, over 160 steps with resizes and
restores, and are held at OBJ_RTOL = 1e-5.  The loop's control sequence
(m, events, mitigations, decisions, restores) reads the objectives only
through the controller's convergence refits, and is held exactly; a
decision that flipped at a near tie would show here as a control mismatch.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import json

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import reference_ssp_indices
from repro.optim import simcluster as ref_sim
from repro.optim.problems import ERMProblem as RefProblem
from repro.optim.problems import synthetic_mnist
from repro.runtime import chaos as ref_chaos
from repro_torch.convert import problem_from_numpy
from repro_torch.optim.simcluster import SSPLocalSGD
from repro_torch.runtime.chaos import (
    ChaosEvent,
    ChaosLoop,
    ChaosRunLog,
    ChaosTrace,
    ClusterSim,
    default_system_model,
    replay,
    run_chaos_sim,
)

OBJ_RTOL = 1e-5


def _ssp_source(seed):
    return lambda t, m, h, nl: reference_ssp_indices(seed, t, m, h, nl)


def _ssp_pair(n_seed, m, seed=0):
    X, y = synthetic_mnist(n=256, d=16, effective_rank=8, seed=n_seed)
    rp = RefProblem(jnp.asarray(X), jnp.asarray(y), lam=1e-2, loss="smooth_hinge")
    pp = problem_from_numpy(X, y, 1e-2, "smooth_hinge", device="cpu")
    return (ref_sim.SSPLocalSGD(rp, m, lr0=0.01, seed=seed),
            SSPLocalSGD(pp, m, lr0=0.01, seed=seed, indices=_ssp_source(seed)))


# ------------------------------------------------------------------ trace
@pytest.mark.parametrize("seed", [0, 1])
def test_trace_json_equals_the_references(seed, tmp_path):
    ours, theirs = ChaosTrace.generate(seed, 160, 4), ref_chaos.ChaosTrace.generate(seed, 160, 4)
    assert json.dumps(ours.to_json()) == json.dumps(theirs.to_json())
    ours.save(tmp_path / "ours.json")
    theirs.save(tmp_path / "theirs.json")
    assert (tmp_path / "ours.json").read_bytes() == (tmp_path / "theirs.json").read_bytes()
    assert ChaosTrace.load(tmp_path / "theirs.json") == ours


def test_trace_generation_is_deterministic():
    a = ChaosTrace.generate(7, 200, 4)
    assert a.events == ChaosTrace.generate(7, 200, 4).events
    assert a.events != ChaosTrace.generate(8, 200, 4).events


def test_runlog_json_roundtrip(tmp_path):
    t = ChaosTrace.generate(3, 10, 2)
    log = ChaosRunLog(trace=t, meta={"seed": 3})
    log.append(step=0, m=2, objective=1.5, events=[], wall_s=1.0)
    log.save(tmp_path / "log.json")
    again = ChaosRunLog.load(tmp_path / "log.json")
    assert again.signature() == log.signature() and again.trace == t
    log.to_jsonl(tmp_path / "log.jsonl")
    assert ChaosRunLog.from_jsonl(tmp_path / "log.jsonl").signature() == log.signature()


# ------------------------------------------------------------------ sim
def test_cluster_sim_straggler_lifecycle():
    trace = ChaosTrace(seed=0, n_hosts=2, steps=20, events=[
        ChaosEvent(step=3, kind="straggler_on", host=1, magnitude=4.0, duration=5)])
    sim = ClusterSim(trace)
    sim.advance(0)
    base = sim.step_time(2, 1.0, 32)
    sim.advance(3)
    assert sim.step_time(2, 1.0, 32) > 3.0 * base * 0.8
    masked = sim.step_time(2, 1.0, 32, sync_mask={0: True, 1: False})
    assert masked == pytest.approx(base)
    sim.advance(8)  # duration elapsed -> auto recovery
    assert sim.step_time(2, 1.0, 32) == pytest.approx(base)


def test_cluster_sim_mitigations_normalize_step_time():
    trace = ChaosTrace(seed=0, n_hosts=2, steps=10, events=[
        ChaosEvent(step=1, kind="straggler_on", host=0, magnitude=3.0)])
    sim = ClusterSim(trace)
    sim.advance(0)
    base = sim.step_time(2, 1.0, 32)
    sim.advance(1)
    assert sim.step_time(2, 1.0, 32) > 2.0 * base
    sim.rebalance(0)
    assert sim.step_time(2, 1.0, 32) == pytest.approx(base, rel=1e-6)
    sim.hot_spare(0)
    assert sim.step_time(2, 1.0, 32) == pytest.approx(base, rel=1e-6)


def test_cluster_sim_overlapping_faults_extend_not_cancel():
    trace = ChaosTrace(seed=0, n_hosts=2, steps=20, events=[
        ChaosEvent(step=1, kind="slowdown", host=-1, magnitude=1.5, duration=5),
        ChaosEvent(step=3, kind="slowdown", host=-1, magnitude=1.8, duration=8)])
    sim = ClusterSim(trace)
    for step in range(7):
        sim.advance(step)
    assert sim.slowdown == pytest.approx(1.8)
    for step in range(7, 12):
        sim.advance(step)
    assert sim.slowdown == 1.0


def test_cluster_sim_membership():
    trace = ChaosTrace(seed=0, n_hosts=4, steps=10, events=[
        ChaosEvent(step=2, kind="leave", host=3), ChaosEvent(step=5, kind="join", host=-1)])
    sim = ClusterSim(trace)
    sim.advance(0)
    assert sim.capacity == 4
    sim.advance(2)
    assert sim.capacity == 3 and 3 not in sim.hosts()
    sim.advance(5)
    assert sim.capacity == 4 and 3 not in sim.hosts()  # a fresh host id


def test_cluster_sim_never_drops_below_one_host():
    trace = ChaosTrace(seed=0, n_hosts=2, steps=10, events=[
        ChaosEvent(step=1, kind="leave", host=0), ChaosEvent(step=2, kind="leave", host=1)])
    sim = ClusterSim(trace)
    sim.advance(1)
    sim.advance(2)
    assert sim.capacity == 1


@pytest.mark.parametrize("seed", [0, 1])
def test_cluster_sim_replays_the_references_state(seed):
    """Every step of a generated trace leaves the same speeds, weights,
    slowdown and step times in both simulators."""
    ours = ClusterSim(ChaosTrace.generate(seed, 160, 4))
    theirs = ref_chaos.ClusterSim(ref_chaos.ChaosTrace.generate(seed, 160, 4))
    for step in range(160):
        assert [e.to_dict() for e in ours.advance(step)] == \
            [e.to_dict() for e in theirs.advance(step)]
        if step % 7 == 3 and ours.hosts():
            ours.rebalance(ours.hosts()[0])
            theirs.rebalance(theirs.hosts()[0])
        assert (ours.speed, ours.shard_weight, ours.slowdown) == \
            (theirs.speed, theirs.shard_weight, theirs.slowdown)
        assert ours.step_time(2, 1.0, 32) == theirs.step_time(2, 1.0, 32)


# ------------------------------------------------------- monitor, injector
def test_monitor_host_attribution_and_reset():
    from repro_torch.runtime.straggler import StragglerMonitor

    mon = StragglerMonitor(consecutive=2, min_ratio=1.5)
    for step in range(10):
        mon.observe(step, 1.0, host_times={0: 0.5, 1: 0.5})
    ev = None
    for step in range(10, 14):
        ev = ev or mon.observe(step, 3.0, host_times={0: 0.5, 1: 2.9})
    assert ev is not None and ev.host == 1
    mon.reset()
    for step in range(10):
        mon.observe(step, 1.0, host_times={0: 0.5, 1: 0.5})
    ev = None
    for step in range(10, 14):
        ev = ev or mon.observe(step, 2.0, host_times={0: 1.0, 1: 1.0})
    assert ev is not None and ev.host == -1


def test_injector_schedule_mid_run():
    from repro_torch.runtime.failures import (FailureInjector, RestartPolicy,
                                              SimulatedFailure)

    inj = FailureInjector()
    inj.check(5)
    inj.schedule(7)
    with pytest.raises(SimulatedFailure):
        inj.check(7)
    inj.check(7)  # fires once
    policy = RestartPolicy(max_restarts=1)
    assert policy.should_restart() and not policy.should_restart()


# ----------------------------------------------------------- SSP executor
def test_ssp_executor_matches_reference():
    """outer_step with SSP masks, relax, resize, checkpoint and restore, on
    the reference's fold_in stream: the same objectives within OBJ_RTOL."""
    ref, port = _ssp_pair(0, 4)
    ours, theirs = [], []
    for t in range(30):
        if t == 8:
            for ex in (ref, port):
                ex.relax(2)
        if t == 12:
            for ex in (ref, port):
                ex.checkpoint()
        if t == 18:
            for ex in (ref, port):
                ex.restore()
                ex.resize(2)
        mask = [True, True, True, t % 4 == 0] if 8 <= t < 18 else None
        theirs.append(ref.outer_step(mask))
        ours.append(port.outer_step(mask))
    np.testing.assert_allclose(ours, theirs, rtol=OBJ_RTOL)
    assert port.t == ref.t and port.m == ref.m == 2 and port.local_steps == 2
    np.testing.assert_allclose(port.w.numpy(), np.asarray(ref.w), rtol=0,
                               atol=OBJ_RTOL * float(np.abs(np.asarray(ref.w)).max()))
    assert port.reference_floor() == pytest.approx(ref.reference_floor(), rel=OBJ_RTOL)


def test_ssp_relax_changes_trajectory():
    """sync_relax (H > 1 and a worker skipping the barrier) has a real
    algorithmic effect; before it the runs are identical."""
    X, y = synthetic_mnist(n=256, d=16, effective_rank=8, seed=0)
    pp = problem_from_numpy(X, y, 1e-2, "smooth_hinge", device="cpu")
    full, ssp = SSPLocalSGD(pp, 4, lr0=0.01), SSPLocalSGD(pp, 4, lr0=0.01)
    full_objs, ssp_objs = [], []
    for t in range(30):
        full_objs.append(full.outer_step())
        if t == 10:
            ssp.relax(2)
        ssp_objs.append(ssp.outer_step([True, True, True, t % 4 == 0] if t >= 10 else None))
    assert full_objs[:10] == ssp_objs[:10]
    assert full_objs[10:] != ssp_objs[10:]
    assert np.isfinite(ssp_objs).all()


def test_ssp_checkpoint_restore_rewinds_and_resize_keeps_the_iterate():
    X, y = synthetic_mnist(n=256, d=16, effective_rank=8, seed=1)
    pp = problem_from_numpy(X, y, 1e-2, "smooth_hinge", device="cpu")
    ex = SSPLocalSGD(pp, 2, lr0=0.01)
    with pytest.raises(RuntimeError, match="no checkpoint"):
        ex.restore()
    for _ in range(5):
        ex.outer_step()
    ex.checkpoint()
    branch_a = [ex.outer_step() for _ in range(5)]
    ex.restore()
    assert branch_a == [ex.outer_step() for _ in range(5)]
    before = float(pp.primal(ex.w))
    ex.resize(4)
    assert ex.m == 4 and tuple(ex.W.shape) == (4, pp.d)
    assert float(pp.primal(ex.w)) == before


def test_loop_unrelaxes_recovered_host():
    """sync_relax is a mitigation, not a mode: when the straggler's fault
    expires the host rejoins every barrier and H returns to 1."""
    from repro_torch.core.adaptive import AdaptiveController

    trace = ChaosTrace(seed=0, n_hosts=2, steps=40, events=[
        ChaosEvent(step=10, kind="straggler_on", host=1, magnitude=1.7, duration=12)])
    X, y = synthetic_mnist(n=256, d=16, effective_rank=8, seed=0)
    executor = SSPLocalSGD(problem_from_numpy(X, y, 1e-2, "smooth_hinge", device="cpu"), 2,
                           lr0=0.01)
    controller = AdaptiveController(default_system_model(), target_gap=0.02, p_star=0.0,
                                    m_options=[2], min_observations=10 ** 6)
    loop = ChaosLoop(ClusterSim(trace), executor, controller, base_compute_s=1.0, d=16,
                     relax_local_steps=3)
    log = loop.run()
    assert any((r.get("mitigation") or "").startswith("sync_relax") for r in log.rows)
    assert executor.local_steps == 1 and not loop._relaxed


# ------------------------------------------------------------- closed loop
@pytest.fixture(scope="module")
def runs():
    """seed -> (the port's run on the reference's draws, the reference's)."""
    return {seed: (run_chaos_sim(seed, device="cpu", indices=_ssp_source(seed)),
                   ref_chaos.run_chaos_sim(seed)) for seed in (0, 1)}


@pytest.mark.parametrize("seed", [0, 1])
def test_run_chaos_sim_matches_reference(runs, seed):
    ours, theirs = runs[seed]
    assert len(ours.rows) == len(theirs.rows) == 160
    for got, want in zip(ours.rows, theirs.rows):
        for key in ("step", "m", "events", "mitigation", "decision", "restore", "flag",
                    "step_s", "wall_s"):
            assert got.get(key) == want.get(key), (got["step"], key)
        assert got["objective"] == pytest.approx(want["objective"], rel=OBJ_RTOL)
    assert ours.meta["final_m"] == theirs.meta["final_m"]
    assert {k: v for k, v in ours.meta.items() if k != "final_objective"} == \
        {k: v for k, v in theirs.meta.items() if k != "final_objective"}
    if seed == 0:  # the reference's acceptance case: the loop adapts
        assert ours.n_mitigations() >= 1 and ours.n_resizes() >= 1
        assert any(r.get("restore") for r in ours.rows)


def test_port_replay_is_bit_identical(runs):
    """The port's own draws: a replay of its run log gives the same
    (m, objective, decision) sequence, float for float."""
    log = run_chaos_sim(0, device="cpu")
    again = replay(log, device="cpu")
    assert again.signature() == log.signature()
    assert again.meta["final_m"] == log.meta["final_m"]
    objs = [r["objective"] for r in log.rows]
    assert np.isfinite(objs).all() and objs[-1] < objs[0] * 0.8


def test_chaos_train_refuses_the_lm_path(monkeypatch):
    """``chaos_train --lm`` runs the LM chaos loop (the port's
    ``TrainerExecutor``; tests/test_torch_chaos_lm.py holds it against the
    JAX package) on the CPU when asked, and refuses to run it without a card
    otherwise: it never drops to the CPU on its own.  (Named from before the
    port had the LM executor, when ``--lm`` was refused outright.)"""
    import torch

    from repro_torch import chaos_train

    log = chaos_train.main(["--lm", "--steps", "8", "--device", "cpu"])
    assert len(log.rows) == 8 and log.meta["mode"] == "lm"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chaos_train.main(["--lm", "--steps", "8"])
