"""CLI: inspect a telemetry JSONL event log (the port of
``repro/telemetry/__main__.py``, on the port's ``StatsSink``, ``read_events``,
``CapacityPlanner`` and tuner cache).

    python -m repro_torch.telemetry summarize run.jsonl [--strict]
    python -m repro_torch.telemetry trace run.jsonl [--perfetto out.json]

``summarize`` prints per-kind counts plus min/mean/max and streaming
p50/p95/p99 of every numeric field, and — when the log came from a routed
deployment — a per-replica breakdown (decode tok/s, dispatch share,
affinity hit rate).  With ``--strict``, any schema-invalid row fails the
command (exit 1) — the CI telemetry smoke step uses this to assert a
fresh run log is well-formed.

``trace`` renders the hierarchical span tree a ``--trace`` serve run (or
a ``--spans`` fleet run) logged, with per-component predicted-vs-measured
attribution; ``--perfetto`` re-exports the spans as a Chrome/Perfetto
trace, ``--flame`` adds the self-time flame summary, and ``--tune-cache``
joins kernel-tuner entries in as per-kernel attribution rows.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List

from .events import Event, SchemaError, from_dict
from .tracker import StatsSink


def _replica_breakdown(events: List[Event]) -> None:
    """Per-replica serving summary from replica-tagged serve_step rows
    plus router dispatch decisions; silent for single-engine logs."""
    steps = [e for e in events if e.kind == "serve_step" and e.replica >= 0]
    routes = [e for e in events if e.kind == "router"]
    if not steps and not routes:
        return
    replicas = sorted(
        {e.replica for e in steps} | {e.replica for e in routes}
    )
    print("per-replica:")
    for r in replicas:
        mine = [e for e in steps if e.replica == r]
        decode = [e for e in mine if e.op in ("decode", "verify")]
        busy = sum(e.step_s for e in decode)
        toks = sum(e.committed for e in decode)
        tok_s = toks / busy if busy > 0 else 0.0
        disp = [e for e in routes if e.replica == r]
        routable = [e for e in disp if e.prompt_pages > 0]
        hits = sum(1 for e in routable if e.matched_pages > 0)
        rate = hits / len(routable) if routable else 0.0
        print(
            f"  replica {r}: {toks} tokens in {busy:.3f}s "
            f"({tok_s:.1f} tok/s), dispatches={len(disp)}, "
            f"affinity_hit_rate={rate:.2f}"
        )
    spills = sum(1 for e in routes if e.reason == "spill")
    if routes:
        print(f"  router: {len(routes)} dispatches, {spills} spills")


def summarize(path: str, strict: bool = False) -> int:
    stats = StatsSink()
    events: List[Event] = []
    bad = 0
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                ev = from_dict(json.loads(line))
            except (SchemaError, json.JSONDecodeError) as e:
                bad += 1
                print(f"{path}:{lineno}: invalid row: {e}", file=sys.stderr)
                continue
            stats.write(ev)
            events.append(ev)
    for kind, info in stats.summary().items():
        print(f"{kind:<12} n={info['count']}")
        for name, agg in info["fields"].items():
            line = (
                f"  {name:<16} mean={agg['mean']:.6g} "
                f"min={agg['min']:.6g} max={agg['max']:.6g}"
            )
            if "p50" in agg:
                line += (
                    f" p50={agg['p50']:.6g} p95={agg['p95']:.6g} "
                    f"p99={agg['p99']:.6g}"
                )
            print(line)
    _replica_breakdown(events)
    total = sum(stats.counts.values())
    print(f"total        {total} events, {bad} invalid rows")
    return 1 if (strict and bad) else 0


def trace(
    path: str,
    perfetto: str = "",
    flame: bool = False,
    tune_cache: str = "",
    n_layers: int = 1,
) -> int:
    from .tracker import read_events
    from .trace import (
        attribute,
        flame_summary,
        format_attribution,
        format_tree,
        write_perfetto,
    )

    events: List[Event] = list(read_events(path))
    if tune_cache:
        from repro_torch.kernels.tune.cache import ConfigCache
        from repro_torch.kernels.tune.telemetry import tune_events

        events.extend(tune_events(ConfigCache(tune_cache)))
    spans = [e for e in events if e.kind == "span"]
    if not spans:
        print(f"{path}: no span events (run with --trace / --spans)",
              file=sys.stderr)
        return 1
    print(format_tree(events))
    # a planner refit from the log's own serve_step rows prices decode /
    # verify spans that did not carry predicted_s at emit time
    from repro_torch.serve.planner import CapacityPlanner

    planner = CapacityPlanner()
    planner.ingest(events)
    try:
        planner.fit()
    except ValueError:  # too few distinct batch sizes in the log
        planner = None
    attr = attribute(events, planner=planner, n_layers=n_layers)
    print(format_attribution(attr))
    if flame:
        print(flame_summary(events))
    alerts = [e for e in events if e.kind == "slo_alert"]
    for a in alerts:
        print(
            f"slo_alert step {a.step} {a.slo}/{a.objective}: "
            f"burn={a.burn_rate:.2f}x budget "
            f"(remaining {a.budget_remaining:.0%})"
        )
    if perfetto:
        n = write_perfetto(perfetto, events)
        print(f"perfetto: {n} spans -> {perfetto}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m repro_torch.telemetry")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_sum = sub.add_parser("summarize", help="per-kind stats for a JSONL event log")
    p_sum.add_argument("path")
    p_sum.add_argument("--strict", action="store_true", help="exit 1 on schema-invalid rows")
    p_tr = sub.add_parser("trace", help="span tree + cost attribution for a JSONL event log")
    p_tr.add_argument("path")
    p_tr.add_argument("--perfetto", default="", metavar="OUT_JSON",
                      help="also export the spans as a Perfetto/Chrome trace")
    p_tr.add_argument("--flame", action="store_true",
                      help="print the per-component self-time flame summary")
    p_tr.add_argument("--tune-cache", default="", metavar="CACHE_JSON",
                      help="join kernel-tuner cache entries as attribution rows")
    p_tr.add_argument("--n-layers", type=int, default=1,
                      help="model depth for per-kernel predicted cost rows")
    args = parser.parse_args(argv)
    if args.cmd == "summarize":
        return summarize(args.path, strict=args.strict)
    if args.cmd == "trace":
        return trace(
            args.path,
            perfetto=args.perfetto,
            flame=args.flame,
            tune_cache=args.tune_cache,
            n_layers=args.n_layers,
        )
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
