"""Port parity: the fleet (``repro_torch.fleet``, its CLI and
``repro_torch.fleet_day``) against the JAX package's on the CPU.

The fleet is pure Python and numpy in both packages, so the three
scenarios' run logs are the reference's bit for bit, their saved files the
same bytes, and a log saved by either package replays in the other.  The
executor contract is held call by call, and ``--real-convex`` (the training
job on the port's ``SSPLocalSGD``) on the reference's draws within OBJ_RTOL
of the reference's objectives, on the golden control sequence: the day's
job_sweep at one size, and the migrate scenario's job through the
scheduler's restores and resize.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest

from _torch_parity import reference_ssp_indices
from repro import fleet as ref_fleet
from repro.launch import fleet as ref_cli
from repro.runtime.chaos import ChaosEvent as RefChaosEvent, ChaosTrace as RefChaosTrace
from repro_torch import fleet, fleet_day
from repro_torch.launch import fleet as port_cli
from repro_torch.runtime.chaos import ChaosEvent, ChaosTrace

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures"
HOUR = 3600.0
# the objective of the same SGD chain, float32 on both sides, summed in
# another order (tests/test_torch_chaos.py's bound)
OBJ_RTOL = 1e-5

# scenario id -> (run_fleet_sim's keywords, golden fixture or None)
SCENARIOS = {
    "day": ({"scenario": "day"}, "fleet_golden_seed0.json"),
    "drift": ({"scenario": "drift", "drift": True}, "fleet_drift_seed0.json"),
    "migrate-measured": ({"scenario": "migrate", "measured": True},
                         "fleet_migration_seed0.json"),
    "migrate": ({"scenario": "migrate"}, None),
}


@pytest.fixture(scope="module")
def runs():
    """Each scenario at seed 0, run once by each package."""
    return {key: (fleet.run_fleet_sim(0, **kw), ref_fleet.run_fleet_sim(0, **kw))
            for key, (kw, _) in SCENARIOS.items()}


def assert_rows_match_golden(rows, golden_rows):
    """tests/test_fleet.py's comparison with a golden fixture: the control
    sequence exactly, modeled quantities to float tolerance."""
    assert len(rows) == len(golden_rows)
    for got, want in zip(rows, golden_rows):
        assert got["step"] == want["step"]
        assert got["events"] == want["events"]
        assert got["decisions"] == want["decisions"]
        assert got["free"] == want["free"]
        for name, ws in want["serve"].items():
            gs = got["serve"][name]
            assert (gs["m"], gs["ok"]) == (ws["m"], ws["ok"])
            assert gs["qps"] == pytest.approx(ws["qps"], rel=1e-9)
            assert gs["lat_s"] == pytest.approx(ws["lat_s"], rel=1e-6)
        for name, wj in want["jobs"].items():
            gj = got["jobs"][name]
            assert (gj["state"], gj["m"]) == (wj["state"], wj["m"])
            assert gj["prog"] == pytest.approx(wj["prog"], rel=1e-6, abs=1e-9)
        assert got["cost_hh"] == pytest.approx(want["cost_hh"], rel=1e-9)


# ----------------------------------------------------------- run logs
@pytest.mark.parametrize("key", list(SCENARIOS))
def test_run_log_is_the_references(runs, key):
    ours, theirs = runs[key]
    assert ours.signature() == theirs.signature()
    assert ours.rows == theirs.rows
    assert ours.meta == theirs.meta
    assert json.dumps(ours.to_json()) == json.dumps(theirs.to_json())
    assert [e.to_dict() for e in ours.events()] == [e.to_dict() for e in theirs.events()]
    assert ours.decisions() == theirs.decisions()
    golden = SCENARIOS[key][1]
    if golden is not None:
        want = fleet.FleetRunLog.load(FIXTURES / golden)
        assert ours.control_signature() == want.control_signature()
        assert_rows_match_golden(ours.rows, want.rows)


@pytest.mark.parametrize("key", list(SCENARIOS))
def test_saved_logs_replay_across_packages(runs, key, tmp_path):
    """Replay is exact in each package, and a log saved by one loads and
    replays in the other to the same signature; the files are the same
    bytes."""
    ours, theirs = runs[key]
    ours.save(tmp_path / "ours.json")
    theirs.save(tmp_path / "theirs.json")
    assert (tmp_path / "ours.json").read_bytes() == (tmp_path / "theirs.json").read_bytes()
    in_port = fleet.FleetRunLog.load(tmp_path / "theirs.json")
    assert fleet.replay(in_port).signature() == theirs.signature()
    in_ref = ref_fleet.FleetRunLog.load(tmp_path / "ours.json")
    assert ref_fleet.replay(in_ref).signature() == ours.signature()
    assert in_port.signature() == in_ref.signature() == ours.signature()


def test_event_log_round_trip_and_replay(runs, tmp_path):
    """The JSONL event log of the drift run (fleet ticks, drift and refit
    events) loads in the other package and replays."""
    ours, theirs = runs["drift"]
    ours.to_jsonl(tmp_path / "ours.jsonl")
    theirs.to_jsonl(tmp_path / "theirs.jsonl")
    assert (tmp_path / "ours.jsonl").read_bytes() == (tmp_path / "theirs.jsonl").read_bytes()
    loaded = fleet.FleetRunLog.from_jsonl(tmp_path / "theirs.jsonl")
    assert fleet.replay(loaded).signature() == ours.signature()
    assert loaded.events("refit") and loaded.decisions("drift:")


# ------------------------------------------------------ executor contract
class RecordingExecutor:
    """The chaos executor contract, recording every call
    (tests/test_fleet.py:264-290)."""

    def __init__(self):
        self.m = 0
        self.calls = []
        self.steps = 0

    def resize(self, m):
        self.calls.append(("resize", m))
        self.m = m

    def outer_step(self, sync_mask=None):
        self.steps += 1
        self.calls.append(("step", self.m))
        return 1.0 / self.steps

    def checkpoint(self):
        self.calls.append(("checkpoint", self.m))

    def restore(self):
        self.calls.append(("restore", self.m))

    def relax(self, h):
        self.calls.append(("relax", h))


def _contract_run(pkg, chaos_event, chaos_trace):
    """tests/test_fleet.py:293-310's run, with either package."""
    events = [chaos_event(step=3, kind="preempt", host=0),
              chaos_event(step=6, kind="leave", host=1)]
    ex = RecordingExecutor()
    job = pkg.TrainingJob(
        name="job", eps=1e-2, arrival_s=0.0, deadline_s=40.0 * HOUR, m_options=(2, 4),
        model=pkg.training_model(compute_s=30.0, rate=4e-3), executor=ex)
    trace = chaos_trace(seed=0, n_hosts=4, steps=10, events=events)
    sim = pkg.FleetSimulator(trace, [job], [], pkg.FleetConfig(tick_s=300.0))
    return sim.run(), job, ex


def test_executor_driven_through_admit_preempt_and_shrink():
    log, job, ex = _contract_run(fleet, ChaosEvent, ChaosTrace)
    ref_log, ref_job, ref_ex = _contract_run(ref_fleet, RefChaosEvent, RefChaosTrace)
    assert ex.calls == ref_ex.calls and ex.steps == ref_ex.steps
    assert log.signature() == ref_log.signature() and log.rows == ref_log.rows
    # the reference test's checks
    assert ("resize", job.m or 2) in ex.calls or ex.m in (2, 4)
    assert log.decisions("admit:job")
    assert log.decisions("restore:job")
    assert any(c[0] == "restore" for c in ex.calls)
    assert ex.m == job.m if job.state == "running" else job.m == 0
    assert any(c[0] == "resize" for c in ex.calls)
    assert any("obj" in r["jobs"]["job"] for r in log.rows)


# ------------------------------------------------------- --real-convex
def _reference_example():
    spec = importlib.util.spec_from_file_location("ref_fleet_day",
                                                  ROOT / "examples" / "fleet_day.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reference_executor(job):
    """The reference example's executor (examples/fleet_day.py:31-49) for
    ``job``: SSPLocalSGD over its 256 x 16 problem, checkpointed."""
    import jax.numpy as jnp

    from repro.optim.problems import ERMProblem, synthetic_mnist
    from repro.optim.simcluster import SSPLocalSGD

    X, y = synthetic_mnist(n=256, d=16, effective_rank=8, seed=0)
    problem = ERMProblem(jnp.asarray(X), jnp.asarray(y), lam=1e-2, loss="smooth_hinge")
    job.executor = SSPLocalSGD(problem, min(job.m_options), lr0=0.01, seed=0)
    job.executor.checkpoint()
    return job.executor


def _real_convex_against_the_reference(scenario, monkeypatch):
    """fleet_day's ``scenario`` with its training job on the port's
    SSPLocalSGD (the local-SGD kernel's plain version here) fed the
    reference's draws, against the reference's run with its own executor:
    the golden control sequence, the reference's signature, each tick's
    objective within OBJ_RTOL, the draws following the executor's (t, m)
    through restores and resizes, every restore rewinding to the
    checkpointed bits.  Returns the port's (t, m) a step and the number of
    restores."""
    from repro_torch.optim import simcluster

    restores, stepped = [], []

    class Checked(simcluster.SSPLocalSGD):
        def restore(self):
            super().restore()
            restores.append(self.w.numpy().tobytes() == self._ckpt[0].numpy().tobytes())

        def outer_step(self, sync_mask=None):
            stepped.append((self.t, self.m, self.local_steps, self.Xs.shape[1]))
            return super().outer_step(sync_mask)

    draws = []

    def reference_draws(t, m, h, nl):
        draws.append((t, m, h, nl))
        return reference_ssp_indices(0, t, m, h, nl)

    build, flags, name, golden = fleet_day.SCENARIOS[scenario]
    trace, jobs, deps, cfg = getattr(ref_fleet, build.__name__)(0, **flags)
    if scenario == "day":
        _reference_example().attach_real_convex(jobs)
    else:
        _reference_executor(next(job for job in jobs if job.name == name))
    theirs = ref_fleet.FleetSimulator(trace, jobs, deps, cfg).run()

    monkeypatch.setattr(simcluster, "SSPLocalSGD", Checked)
    ours, executor = fleet_day.run_day(0, scenario=scenario, real_convex=True, device="cpu",
                                       indices=reference_draws)
    assert ours.control_signature() == fleet.FleetRunLog.load(
        FIXTURES / golden).control_signature()
    assert ours.signature() == theirs.signature()
    got = [r["jobs"][name].get("obj") for r in ours.rows]
    want = [r["jobs"][name].get("obj") for r in theirs.rows]
    assert [g is None for g in got] == [w is None for w in want]
    steps = [i for i, w in enumerate(want) if w is not None]
    np.testing.assert_allclose([got[i] for i in steps], [want[i] for i in steps], rtol=OBJ_RTOL)
    assert got[steps[-1]] < got[steps[0]]
    # the draws follow the executor's step count (which a restore rewinds)
    # and its m, and it ends on the reference's
    assert draws == stepped
    ref_executor = next(job.executor for job in jobs if job.name == name)
    assert (executor.t, executor.m) == (ref_executor.t, ref_executor.m)
    assert all(restores)
    return [(t, m) for t, m, _, _ in stepped], len(restores)


def test_real_convex_day_matches_the_reference_example(monkeypatch):
    """The day: job_sweep at one size (m = 1 at seed 0), one restore."""
    steps, restores = _real_convex_against_the_reference("day", monkeypatch)
    assert {m for _, m in steps} == {1} and restores == 1


def test_real_convex_resizes_match_the_reference(monkeypatch):
    """The migrate scenario, whose job the scheduler restores four times at
    m = 4 and then resizes to 2: the executor re-partitions, and its draws
    and objectives follow the reference's through every restore and the
    resize.  (The drift scenario's 2 -> 8 -> 4 -> 2 is held card against
    CPU by chip_smoke.py's phases 31b and 31c; against the reference it
    would double this file's time.)"""
    steps, restores = _real_convex_against_the_reference("migrate", monkeypatch)
    assert [m for i, (_, m) in enumerate(steps) if i == 0 or steps[i - 1][1] != m] == [4, 2]
    assert restores == 4


# ------------------------------------------------------------- the CLI
def _cli_stdout(main, argv, cwd, monkeypatch):
    monkeypatch.chdir(cwd)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


@pytest.mark.parametrize("argv", [
    ["--scenario", "migrate", "--measured", "--spans", "spans.json", "--slo",
     "--out", "run.json"],
    ["--scenario", "drift", "--drift", "--slo", "--spans", "spans.json"],
    ["--scenario", "migrate", "--ticks", "48", "--hosts", "10", "--seed", "3"],
], ids=["migrate-measured-spans-slo", "drift-slo-spans", "migrate-seed3"])
def test_cli_prints_and_writes_the_references(argv, tmp_path, monkeypatch):
    """The same stdout line for line (the ckpt_cost and slo_alert lines
    among them), the same Perfetto file and run log byte for byte."""
    dirs = {}
    for name, main in (("port", port_cli.main), ("ref", ref_cli.main)):
        dirs[name] = tmp_path / name
        dirs[name].mkdir()
        dirs[name] = (dirs[name], _cli_stdout(main, argv, dirs[name], monkeypatch))
    (ours, ours_out), (theirs, theirs_out) = dirs["port"], dirs["ref"]
    assert ours_out == theirs_out
    assert "replay: identical" in ours_out
    if "--measured" in argv:
        assert "ckpt_cost tick" in ours_out
    if "--slo" in argv:
        assert "burn-rate alerts" in ours_out
    for name in ("spans.json", "run.json"):
        if name in argv:
            assert (ours / name).read_bytes() == (theirs / name).read_bytes()
    if "spans.json" in argv:
        from repro_torch.telemetry.trace import load_perfetto, validate_perfetto

        assert validate_perfetto(load_perfetto(ours / "spans.json")) == []


def test_cli_replays_the_references_log(tmp_path, monkeypatch):
    """``--replay`` of a log the reference CLI wrote, and the reverse."""
    day = ["--ticks", "48", "--out", "run.json", "--no-replay"]
    _cli_stdout(ref_cli.main, day, tmp_path, monkeypatch)
    ours = _cli_stdout(port_cli.main, ["--replay", "run.json"], tmp_path, monkeypatch)
    assert "run.json: replays bit-identically (48 ticks)" in ours
    _cli_stdout(port_cli.main, day, tmp_path, monkeypatch)
    theirs = _cli_stdout(ref_cli.main, ["--replay", "run.json"], tmp_path, monkeypatch)
    assert theirs == ours


def _constrained_drift_fleet(pkg, chaos, slo, drift_config, ticks=90):
    """tests/test_trace.py:420-466's fleet, with either package: a demand
    spike at the slowdown's onset that the replica-capped deployment cannot
    serve within its SLO, so the burn-rate monitor fires."""
    tick_s = 300.0
    trace = chaos.ChaosTrace.generate(0, ticks, 16, p_straggler=0.0, p_slowdown=0.0,
                                      p_preempt=0.0, p_membership=0.0, warmup=4)
    onset = ticks // 3
    trace.events.append(chaos.ChaosEvent(step=onset, kind="slowdown", host=-1,
                                         magnitude=2.0, duration=ticks // 3))
    trace.events.sort(key=lambda e: (e.step, e.host, e.kind))
    jobs = [pkg.TrainingJob(
        name="job_bg", eps=1e-2, arrival_s=0.0, deadline_s=0.70 * ticks * tick_s,
        m_options=(2, 4, 8), model=pkg.training_model(compute_s=36.0, rate=3.2e-3),
        ckpt_every_s=6 * tick_s)]
    qps = [2.0] * ticks
    for t in range(onset, min(onset + 6, ticks)):
        qps[t] = 8.0
    deployments = [pkg.ServeDeployment(
        name="serve_pinned",
        planner=pkg.serve_capacity_planner(dispatch_s=0.4, per_seq_s=0.35, log_b_s=0.02),
        trace=pkg.RequestTrace(seed=0, tick_s=tick_s, qps=qps), slo_p95_s=2.2,
        gen_tokens=1, batch_grid=(1, 2), replica_options=(1, 2))]
    cfg = pkg.FleetConfig(tick_s=tick_s, spans=True, slo=slo,
                          drift=drift_config(window=8, threshold=0.25, min_points=4,
                                             cooldown=16))
    return pkg.FleetSimulator(trace, jobs, deployments, cfg).run(steps=ticks)


def test_slo_alerts_and_spans_are_the_references(tmp_path):
    """Where the burn-rate monitor fires, its alerts (events and decisions)
    and the fleet's spans are the reference's, and so is their Perfetto
    file, byte for byte."""
    from repro import telemetry as ref_telemetry
    from repro.fleet.simulate import DEFAULT_FLEET_SLO as REF_SLO
    from repro.runtime import chaos as ref_chaos
    from repro.telemetry.trace import write_perfetto as ref_write_perfetto
    from repro_torch import telemetry
    from repro_torch.fleet.simulate import DEFAULT_FLEET_SLO
    from repro_torch.runtime import chaos
    from repro_torch.telemetry.trace import write_perfetto

    ours = _constrained_drift_fleet(fleet, chaos, DEFAULT_FLEET_SLO, telemetry.DriftConfig)
    theirs = _constrained_drift_fleet(ref_fleet, ref_chaos, REF_SLO, ref_telemetry.DriftConfig)
    alerts = [e.to_dict() for e in ours.events("slo_alert")]
    assert alerts and alerts == [e.to_dict() for e in theirs.events("slo_alert")]
    assert ours.decisions("slo_alert:") == theirs.decisions("slo_alert:")
    assert ours.signature() == theirs.signature()
    n = write_perfetto(tmp_path / "ours.json", ours.events("span"))
    assert n and n == ref_write_perfetto(tmp_path / "theirs.json", theirs.events("span"))
    assert (tmp_path / "ours.json").read_bytes() == (tmp_path / "theirs.json").read_bytes()
