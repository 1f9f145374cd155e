"""Autotune CLI: sweep kernel families, persist the config cache.

  PYTHONPATH=src python -m repro_torch.kernels.tune --preset smoke
  PYTHONPATH=src python -m repro_torch.kernels.tune --preset full \\
      --families flash_decode_paged --cache results/tune_cache_torch.json
  PYTHONPATH=src python -m repro_torch.kernels.tune --preset smoke --device cpu \\
      --cache /tmp/t.json --telemetry

Runs on the card unless ``--device cpu`` is given, and raises when there is
none.  On the card each family is measured in the dtype its kernel takes
(bf16 for K2, K3, K4 and K5, float32 for K1) unless ``--dtype`` names another
the kernel takes; on the CPU the default is float32.  Prints one line per
family (winner config, measured us, pruning stats) and, with
``--telemetry``, the exported benchmark rows.  A family whose key the cache
already holds is not swept again: a second run prints the cached entries.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence

from repro_torch.kernels.tune import FAMILIES, ConfigCache, bench_rows, sweep_all


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--families", nargs="+", default=list(FAMILIES), choices=list(FAMILIES))
    ap.add_argument(
        "--cache",
        default=ConfigCache.default_path(),
        help="config-cache JSON path (default: $REPRO_TORCH_TUNE_CACHE or "
             "results/tune_cache_torch.json)",
    )
    ap.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                    help="dtype measured (default: each kernel's own on the card, float32 "
                         "on the CPU)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' times the plain "
                         "versions)")
    ap.add_argument(
        "--telemetry", action="store_true", help="also print the exported benchmark rows"
    )
    args = ap.parse_args(argv)

    cache = ConfigCache(args.cache)
    entries = sweep_all(args.preset, families=args.families, dtype=args.dtype,
                        device=args.device, cache=cache, iters=args.iters)
    for e in entries:
        cfg = ";".join(f"{k}={v}" for k, v in sorted(e["config"].items()))
        print(
            f"[tuned] {e['family']:20s} {cfg:24s} "
            f"{e['us_per_call']:10.1f} us  "
            f"(swept {e['candidates_swept']}, "
            f"pruned {e['candidates_pruned']}, {e['dtype']}, {e['backend']})"
        )
    print(f"# cache: {args.cache} ({len(cache.entries)} entries, {cache.sweeps} swept now, "
          f"{len(entries) - cache.sweeps} from the cache)")
    if args.telemetry:
        for name, us, derived in bench_rows(cache):
            print(f"{name},{us:.1f},{derived}")
    return entries


if __name__ == "__main__":
    main()
