"""A 24h multi-tenant fleet day: 3 training jobs + 2 serving deployments
sharing 24 simulated hosts under diurnal load and injected chaos.

The counterpart of examples/fleet_day.py.  The scheduler places every
workload by its Hemingway model (no workload is executed to discover its
needs), preempts training when serving needs the capacity, resizes jobs
against their deadlines, and emits a replayable ``FleetRunLog``.  This
module is the acceptance scenario: it checks

  * every serve deployment meets its p95 latency SLO over the day,
  * every training job reaches epsilon before its deadline or carries an
    explicit typed ``NoFeasiblePlan``,
  * the run log replays bit-identically from the same seed, and at seed 0
    its control sequence is the golden fixture's
    (tests/fixtures/fleet_golden_seed0.json).

``--real-convex`` backs job_sweep with the port's ``SSPLocalSGD``, one launch
of the local-SGD kernel an outer step, on ``--device`` (the card unless
``cpu`` is given), over a synthetic ``--n`` x ``--d`` problem (256 x 16 by
default; the paper's MNIST is 60000 x 784).  The executor records the
objective in the rows but steers nothing, so the replay and the golden
check hold with it too (the reference example skips them there).

At seed 0 the day runs job_sweep at one size.  ``--scenario drift`` and
``--scenario migrate`` run the fleet's other two scenarios (as ``python -m
repro_torch.launch.fleet --scenario drift --drift`` and ``--scenario migrate
--measured`` do) under the same checks, with ``--real-convex`` backing their
one training job, which the scheduler resizes: m 2 -> 8 -> 4 -> 2, and 4 -> 2
after four restores.

  PYTHONPATH=src python -m repro_torch.fleet_day --seed 0
  PYTHONPATH=src python -m repro_torch.fleet_day --seed 0 --out day.json
  PYTHONPATH=src python -m repro_torch.fleet_day --seed 0 --real-convex --device cpu
  PYTHONPATH=src python -m repro_torch.fleet_day --seed 0 --real-convex --n 60000 --d 784
  PYTHONPATH=src python -m repro_torch.fleet_day --scenario drift --real-convex --device cpu
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence, Tuple

from repro_torch.device import DeviceLike
from repro_torch.fleet import (FleetRunLog, FleetSimulator, build_day_scenario,
                               build_drift_scenario, build_migration_scenario, replay)
from repro_torch.launch.fleet import summarize

FIXTURES = Path(__file__).resolve().parents[2] / "tests" / "fixtures"

# --scenario: its builder and keywords (the arm run_fleet_sim runs with
# drift=True / measured=True), the training job --real-convex backs, and
# the fixture that holds its control sequence at seed 0
SCENARIOS = {
    "day": (build_day_scenario, {}, "job_sweep", "fleet_golden_seed0.json"),
    "drift": (build_drift_scenario, {"drift": True}, "job_drift", "fleet_drift_seed0.json"),
    "migrate": (build_migration_scenario, {"measured": True}, "job_mig",
                "fleet_migration_seed0.json"),
}

# the example's problem: examples/fleet_day.py:39-44
N, D, RANK = 256, 16, 8


def attach_real_convex(jobs, *, job: str = "job_sweep", n: int = N, d: int = D,
                       device: DeviceLike = None, indices=None):
    """Back ``job`` with a real SSPLocalSGD executor on ``device`` (the
    card when None): every scheduler resize then re-partitions an actual
    optimization run (the same executor contract launch/train.py's
    TrainerExecutor implements via elastic.rescale_training_state).
    ``indices`` replaces the executor's draws (an ``SSPIndexSource``).
    Returns the executor."""
    from repro_torch.convert import problem_from_numpy
    from repro_torch.optim.problems import synthetic_mnist
    from repro_torch.optim.simcluster import SSPLocalSGD

    X, y = synthetic_mnist(n=n, d=d, effective_rank=RANK, seed=0)
    problem = problem_from_numpy(X, y, 1e-2, "smooth_hinge", device=device)
    target = next(j for j in jobs if j.name == job)
    target.executor = SSPLocalSGD(problem, min(target.m_options), lr0=0.01, seed=0,
                                  indices=indices)
    target.executor.checkpoint()
    return target.executor


def run_day(seed: int, *, scenario: str = "day", real_convex: bool = False, n: int = N,
            d: int = D, device: DeviceLike = None,
            indices=None) -> Tuple[FleetRunLog, object]:
    """The scenario's run at ``seed``: its run log, and the executor of its
    training job (None without ``real_convex``)."""
    build, flags, job, _ = SCENARIOS[scenario]
    trace, jobs, deployments, cfg = build(seed, **flags)
    executor = None
    if real_convex:
        executor = attach_real_convex(jobs, job=job, n=n, d=d, device=device, indices=indices)
    log = FleetSimulator(trace, jobs, deployments, cfg).run()
    log.meta.update(seed=seed, ticks=trace.steps, scenario=scenario)
    if scenario != "day":  # run_fleet_sim's meta, so that replay runs the same arm
        log.meta.update({"drift": False, **flags})
    return log, executor


def main(argv: Optional[Sequence[str]] = None) -> FleetRunLog:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scenario", choices=sorted(SCENARIOS), default="day")
    ap.add_argument("--out", default=None, help="write run log JSON here")
    ap.add_argument("--real-convex", action="store_true",
                    help="drive the training job with a real SSPLocalSGD executor "
                         "through the elastic resize path")
    ap.add_argument("--n", type=int, default=N, help="--real-convex's rows")
    ap.add_argument("--d", type=int, default=D, help="--real-convex's features")
    ap.add_argument("--device", default=None,
                    help="--real-convex's device: cuda (default) or cpu")
    ap.add_argument("--no-replay", action="store_true")
    args = ap.parse_args(argv)

    log, _ = run_day(args.seed, scenario=args.scenario, real_convex=args.real_convex,
                     n=args.n, d=args.d, device=args.device)
    summarize(log)

    summary = log.meta["summary"]
    for name, dep in summary["serve"].items():
        if not dep["slo_met"]:
            raise RuntimeError(f"{name} violated its SLO: p95={dep['p95_s']:.3f}s > "
                               f"{dep['slo_p95_s']}s")
    for name, job in summary["jobs"].items():
        if not ((job["state"] == "done" and job["met_deadline"])
                or job["no_plan"] is not None):
            raise RuntimeError(f"{name}: state={job['state']} with no NoFeasiblePlan record")
    print("acceptance: all serve SLOs met at p95; every training job met "
          "its deadline or holds a typed NoFeasiblePlan ✓")

    if not args.no_replay:
        if replay(log).signature() != log.signature():
            raise RuntimeError("replay diverged from the original run")
        print("replay: identical decision/allocation sequence ✓")
        golden = FIXTURES / SCENARIOS[args.scenario][3]
        if args.seed == 0 and golden.exists():
            # control sequence only: floats are machine-dependent and are
            # compared to tolerance by the tests instead
            if log.control_signature() != FleetRunLog.load(golden).control_signature():
                raise RuntimeError(f"run diverged from {golden.name}")
            print("golden: matches the checked-in seed-0 fixture ✓")
    if args.out:
        log.save(args.out)
        print(f"run log -> {args.out}")
    return log


if __name__ == "__main__":
    main()
