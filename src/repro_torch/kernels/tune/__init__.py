"""repro_torch.kernels.tune — shape-keyed kernel autotuner for the card.

A sweep harness plus a persisted config cache covering every kernel family
(flash_attention, flash_decode + flash_decode_paged, prefill_chunk, ssm_scan,
sdca), the port of ``repro/kernels/tune``.  Keys are (family, shape, dtype,
device type); values are the measured fastest block configs.

Public surface:

* ``ensure(family, shape)`` — cached config, sweeping at most once per key.
* ``lookup(family, shape, dtype, backend)`` — cheap read-only cache hit for
  the ``tuned`` paths in the ops wrappers (``pages_per_program=None`` in
  paged decode, ``tuned=True`` elsewhere); never sweeps, returns None on a
  miss (callers fall back to their defaults).
* ``default_cache()`` — process-wide cache bound to
  ``$REPRO_TORCH_TUNE_CACHE`` / ``results/tune_cache_torch.json``;
  ``set_default_cache(path)`` points it at another file (the serve CLI's
  ``--tune-cache``).
* ``tune_events`` / ``bench_rows`` — telemetry export: typed bus events for
  ``CapacityPlanner.ingest``, bench rows with each entry's distance from the
  roofline (``decode_step_rows`` is the deprecated dict form).

CLI: ``python -m repro_torch.kernels.tune --preset smoke`` (on the card;
``--device cpu`` times the plain versions).
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.kernels.tune.cache import ConfigCache, cache_key, shape_sig
from repro_torch.kernels.tune.sweep import (
    FAMILIES,
    SWEEP_SHAPES,
    candidates_for,
    device_time_fn,
    ensure,
    measured_call,
    ragged_lengths,
    sweep,
    sweep_all,
    time_fn,
)
from repro_torch.kernels.tune.telemetry import bench_rows, decode_step_rows, tune_events

__all__ = [
    "ConfigCache",
    "FAMILIES",
    "SWEEP_SHAPES",
    "bench_rows",
    "cache_key",
    "candidates_for",
    "decode_step_rows",
    "default_cache",
    "device_time_fn",
    "ensure",
    "lookup",
    "measured_call",
    "ragged_lengths",
    "reset_default_cache",
    "set_default_cache",
    "shape_sig",
    "sweep",
    "sweep_all",
    "time_fn",
    "tune_events",
]

_default_cache: Optional[ConfigCache] = None


def default_cache() -> ConfigCache:
    """Process-wide cache, loaded lazily from ``ConfigCache.default_path``."""
    global _default_cache
    if _default_cache is None:
        _default_cache = ConfigCache(ConfigCache.default_path())
    return _default_cache


def set_default_cache(path: str) -> ConfigCache:
    """Point the process-wide cache at ``path`` (loaded now)."""
    global _default_cache
    _default_cache = ConfigCache(path)
    return _default_cache


def reset_default_cache() -> None:
    """Drop the singleton (the next use reloads from the default path)."""
    global _default_cache
    _default_cache = None


def lookup(family: str, shape: Dict[str, int], dtype, backend: str) -> Optional[Dict]:
    """Read-only config lookup against the default cache; None on miss."""
    return default_cache().config(cache_key(family, shape, dtype, backend))
