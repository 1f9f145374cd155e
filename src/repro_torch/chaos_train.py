"""Closed-loop elastic training on the deterministic chaos simulator (§6).

The counterpart of examples/chaos_train.py.  Generates a seeded fault trace
(stragglers, preemptions, slowdowns, membership churn), then drives the full
adaptive loop against it:

    trace -> ClusterSim -> StragglerMonitor / FailureInjector
          -> AdaptiveController (online ConvergenceModel + Ernest refits)
          -> elastic resize / sync_relax / rebalance / hot_spare

with the SSP local-SGD executor's worker chains on the local-SGD kernel,
and finally REPLAYS the emitted run log from the same seed, asserting the
(m, objective, decision) sequence is bit-identical.  Runs on the CUDA device
unless ``--device`` names another.

  python -m repro_torch.chaos_train --seed 0
  python -m repro_torch.chaos_train --seed 0 --out run.json
  python -m repro_torch.chaos_train --seed 0 --device cpu
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.runtime.chaos import ChaosRunLog, replay, run_chaos_sim


def summarize(log: ChaosRunLog) -> None:
    steps = log.events("chaos_step")
    wall = steps[-1].wall_s if steps else 0.0
    print(f"steps={len(steps)} mitigations={log.n_mitigations()} "
          f"resizes={log.n_resizes()} final_m={log.meta['final_m']} "
          f"final_objective={log.meta['final_objective']:.4f} "
          f"modeled_wall={wall:.1f}s")
    for r in log.rows:
        tag = r.get("mitigation") or r.get("decision") or r.get("restore")
        if tag:
            print(f"  step {r['step']:4d} m={r['m']} {tag} "
                  f"objective={r['objective']:.4f}")


def main(argv: Optional[Sequence[str]] = None) -> ChaosRunLog:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=160)
    ap.add_argument("--out", default=None,
                    help="write the run log here (.json for the legacy "
                         "blob, .jsonl for the telemetry event log)")
    ap.add_argument("--lm", action="store_true",
                    help="drive the LM trainer (its chaos executor is not yet in the port)")
    ap.add_argument("--no-replay", action="store_true",
                    help="skip the replay determinism check")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.lm:
        raise NotImplementedError(
            "--lm drives the LM trainer through its chaos executor (TrainerExecutor), "
            "which the port does not have yet (ROADMAP.md, queue 1 item 8)")
    log = run_chaos_sim(args.seed, steps=args.steps, device=args.device)
    summarize(log)
    if not args.no_replay:
        again = replay(log, device=args.device)
        if again.signature() != log.signature():
            raise RuntimeError("replay diverged from the original run")
        print("replay: identical (m, objective, decision) sequence ✓")
    if args.out:
        if str(args.out).endswith(".jsonl"):
            log.to_jsonl(args.out)
        else:
            log.save(args.out)
        print(f"run log -> {args.out}")
    return log


if __name__ == "__main__":
    main()
