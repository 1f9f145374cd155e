"""Export tuned kernel timings as telemetry consumers understand.

The canonical export is ``tune_events``: one typed
``repro_torch.telemetry.TuneEvent`` per cache entry, the same events the
sweep harness emits on its tracker as results land.  Consumers:

* the capacity planner (``repro_torch.serve.planner.CapacityPlanner.ingest``)
  ingests the events directly — measured paged-decode kernel timings it
  scales to whole decode steps (``n_layers * kernel + overhead``), so f(b)
  can be fitted from measured kernel costs before any engine traffic exists
  (``python -m repro_torch.launch.serve --tune-cache``);
* ``bench_rows``: one ``tune/<family>/<sig>`` row per cache entry with its
  distance from the roofline.

``decode_step_rows`` is the reference's deprecated pre-bus dict export.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.kernels.tune.cache import ConfigCache
from repro_torch.kernels.tune.roofline import estimate, roofline_fraction_us
from repro_torch.telemetry import TuneEvent, warn_deprecated

Row = Tuple[str, float, str]


def tune_events(cache: ConfigCache) -> List[TuneEvent]:
    """One typed ``TuneEvent`` per cache entry (sorted by key)."""
    return [TuneEvent.from_legacy_row(cache.entries[key]) for key in sorted(cache.entries)]


def bench_rows(cache: ConfigCache) -> List[Row]:
    """(name, us_per_call, derived) rows, one per cache entry."""
    rows: List[Row] = []
    for key in sorted(cache.entries):
        e = cache.entries[key]
        est = estimate(e["family"], e["shape"], e["config"], e["dtype"])
        frac = roofline_fraction_us(e["us_per_call"], est.flops, est.bytes_moved)
        cfg = ";".join(f"{k}={v}" for k, v in sorted(e["config"].items()))
        sig = key.split("|", 2)[1]
        derived = (
            f"{cfg};swept={e['candidates_swept']};"
            f"pruned={e['candidates_pruned']};backend={e['backend']};"
            f"x_lightspeed={frac:.1f}"
        )
        rows.append((f"tune/{e['family']}/{sig}", e["us_per_call"], derived))
    return rows


def decode_step_rows(cache: ConfigCache) -> List[Dict]:
    """Deprecated: measured paged-decode timings as ``{batch, step_s}``
    dicts.  Use ``tune_events`` + ``CapacityPlanner.ingest`` instead."""
    warn_deprecated(
        "repro_torch.kernels.tune.decode_step_rows",
        "tune_events(cache) + CapacityPlanner.ingest(events)",
    )
    rows = []
    for ev in tune_events(cache):
        if ev.family != "flash_decode_paged":
            continue
        rows.append(
            {
                "batch": int(ev.shape["b"]),
                "step_s": ev.us_per_call * 1e-6,
                "source": "kernel_tuner",
            }
        )
    return rows
