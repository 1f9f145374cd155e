"""Fleet simulator CLI: run a multi-tenant day on the simulated cluster.

  python -m repro_torch.launch.fleet --seed 0
  python -m repro_torch.launch.fleet --seed 0 --out run.json
  python -m repro_torch.launch.fleet --trace trace.json --seed 0   # replay chaos
  python -m repro_torch.launch.fleet --replay run.json             # verify a log

``--trace`` takes a ``ChaosTrace`` JSON (the same format launch/train.py's
--chaos consumes), so a recorded incident drives the fleet scheduler
instead of a seeded draw.  Every run re-verifies the replay guarantee
unless ``--no-replay`` is given.

The port's copy of ``repro/launch/fleet.py``: the same flags and the same
printed lines.  The fleet touches no device, so the CLI has no
``--device``; ``--spans`` writes the reference's Perfetto file byte for
byte.
"""
from __future__ import annotations

import argparse
import json
import sys


def summarize(log) -> None:
    s = log.meta["summary"]
    print(f"ticks={len(log.rows)} hosts={log.trace.n_hosts} "
          f"decisions={log.n_decisions()} "
          f"fleet_cost={s['cost_host_hours']:.1f} host-hours")
    for name, d in s["serve"].items():
        flag = "met" if d["slo_met"] else "VIOLATED"
        print(f"  serve {name}: p95={d['p95_s']:.3f}s "
              f"(slo {d['slo_p95_s']}s {flag}), "
              f"final replicas={d['final_replicas']}")
    for name, j in s["jobs"].items():
        if j["state"] == "done":
            hrs = j["finish_s"] / 3600.0
            flag = "in time" if j["met_deadline"] else "LATE"
            print(f"  train {name}: done at {hrs:.1f}h "
                  f"(deadline {j['deadline_s'] / 3600.0:.1f}h, {flag})")
        elif j["state"] == "infeasible":
            print(f"  train {name}: NoFeasiblePlan "
                  f"[{j['no_plan']['query']}] {j['no_plan']['reason']}")
        else:
            print(f"  train {name}: {j['state']} "
                  f"(progress {j['progress']:.2f})")
    for step, d in log.decisions():
        print(f"    tick {step:4d} {d}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ticks", type=int, default=None,
                    help="horizon in ticks (default: the 24h scenario, 288)")
    ap.add_argument("--hosts", type=int, default=None)
    ap.add_argument("--trace", default=None,
                    help="drive the fleet from this ChaosTrace JSON")
    ap.add_argument("--scenario", default="day",
                    choices=("day", "drift", "migrate"),
                    help="scenario builder: the 24h day, the streaming-"
                         "refit drift story, or the measured-recovery-cost "
                         "migration story")
    ap.add_argument("--drift", action="store_true",
                    help="turn the scheduler's streaming pace refit on")
    ap.add_argument("--measured", action="store_true",
                    help="feed measured restore/re-shard wall-times back "
                         "into resize planning (the migrate scenario's "
                         "closed loop)")
    ap.add_argument("--out", default=None, help="write FleetRunLog JSON here")
    ap.add_argument("--spans", default=None, metavar="TRACE_JSON",
                    help="emit modeled-time tick/job/deployment spans and "
                         "export them as a Perfetto trace here")
    ap.add_argument("--slo", action="store_true",
                    help="stream each deployment's tick latency through an "
                         "SLO burn-rate monitor (alerts become decisions "
                         "and boost autoscale headroom)")
    ap.add_argument("--replay", default=None, metavar="RUN_JSON",
                    help="load a recorded FleetRunLog and verify it replays")
    ap.add_argument("--no-replay", action="store_true",
                    help="skip the replay determinism check")
    args = ap.parse_args(argv)

    from repro_torch.fleet import replay as replay_log
    from repro_torch.fleet import run_fleet_sim
    from repro_torch.runtime.chaos import ChaosTrace

    if args.replay:
        from repro_torch.fleet import FleetRunLog
        recorded = FleetRunLog.load(args.replay)
        again = replay_log(recorded)
        if again.signature() != recorded.signature():
            print("replay DIVERGED from the recorded run", file=sys.stderr)
            return 1
        print(f"{args.replay}: replays bit-identically "
              f"({len(recorded.rows)} ticks)")
        summarize(recorded)
        return 0

    trace = None
    if args.trace:
        with open(args.trace) as f:
            trace = ChaosTrace.from_json(json.load(f))
        if args.hosts and args.hosts != trace.n_hosts:
            print(f"--hosts {args.hosts} ignored: the trace fixes the "
                  f"inventory at {trace.n_hosts} hosts", file=sys.stderr)
    ticks = args.ticks or (trace.steps if trace else None)
    hosts = trace.n_hosts if trace else args.hosts
    log = run_fleet_sim(args.seed, ticks=ticks, n_hosts=hosts, trace=trace,
                        scenario=args.scenario, drift=args.drift,
                        spans=bool(args.spans), slo=args.slo,
                        measured=args.measured)
    summarize(log)
    if args.measured:
        for e in log.events("ckpt_cost"):
            print(f"  ckpt_cost tick {e.step:4d} {e.op}:{e.workload} "
                  f"measured={e.wall_s:.0f}s planned={e.assumed_s:.0f}s")
    if args.slo:
        alerts = log.events("slo_alert")
        for a in alerts:
            print(f"  slo_alert tick {a.step:4d} {a.slo}: "
                  f"burn={a.burn_rate:.2f}x budget "
                  f"(remaining {a.budget_remaining:.0%})")
        print(f"slo: {len(alerts)} burn-rate alerts")
    if args.spans:
        from repro_torch.telemetry.trace import write_perfetto
        n = write_perfetto(args.spans, log.events("span"))
        print(f"trace: {n} spans -> {args.spans}")
    if not args.no_replay:
        again = replay_log(log)
        assert again.signature() == log.signature(), \
            "replay diverged from the original run"
        print("replay: identical decision/allocation sequence ✓")
    if args.out:
        log.save(args.out)
        print(f"run log -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
