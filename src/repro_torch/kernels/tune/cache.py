"""Shape-keyed persisted config cache for the kernel autotuner.

A cache entry maps one ``(family, shape, dtype, backend)`` key to the block
config the sweep harness measured fastest, plus the measurement itself.
Keys are flat strings::

    flash_decode_paged|b4_d64_g2_hk4_npp128_page16|bfloat16|cuda

— family, underscore-joined ``<name><value>`` shape items in sorted key order,
the dtype's name (``"float32"``, ``"bfloat16"``: the strings jnp gives, so a
file written by either package loads in the other), and the type of the
device the sweep ran on (``"cuda"`` or ``"cpu"``).  The value side keeps the
original shape dict so consumers (telemetry export, capacity planning) never
parse the signature back.  The schema (version 1) is the reference's
(``repro/kernels/tune/cache.py``).

Persistence is a single JSON file (default ``results/tune_cache_torch.json``,
overridable via ``$REPRO_TORCH_TUNE_CACHE`` or the ``path`` argument), written
atomically (tmp + rename).  The default differs from the reference's
``results/tune_cache.json``: the two packages' ``"cpu"`` entries time
different code under the same key.  ``path=None`` keeps the cache in memory
only.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.telemetry.io import atomic_write_json, file_lock

DEFAULT_CACHE_PATH = "results/tune_cache_torch.json"
CACHE_ENV = "REPRO_TORCH_TUNE_CACHE"
_SCHEMA_VERSION = 1


def dtype_name(dtype) -> str:
    """``torch.float32`` / ``"float32"`` / ``np.float32`` -> ``"float32"``."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).split(".")[-1]
    elif isinstance(dtype, str):
        name = dtype
    else:
        name = np.dtype(dtype).name
    if not isinstance(getattr(torch, name, None), torch.dtype):
        raise ValueError(f"{dtype!r} names no torch dtype")
    return name


def shape_sig(shape: Dict[str, int]) -> str:
    return "_".join(f"{k}{int(v)}" for k, v in sorted(shape.items()))


def cache_key(family: str, shape: Dict[str, int], dtype, backend: str) -> str:
    """``backend`` is the device type the entry was measured on."""
    return "|".join([family, shape_sig(shape), dtype_name(dtype), backend])


class ConfigCache:
    def __init__(self, path: Optional[str] = None, tracker=None):
        self.path = path
        self.entries: Dict[str, Dict] = {}
        self.sweeps = 0  # incremented by the sweep harness, not persisted
        # optional repro_torch.telemetry.Tracker; the sweep harness emits a
        # TuneEvent here (falls back to the process default tracker)
        self.tracker = tracker
        if path is not None and Path(path).exists():
            self.load()

    @classmethod
    def default_path(cls) -> str:
        return os.environ.get(CACHE_ENV, DEFAULT_CACHE_PATH)

    # ------------------------------------------------------------------
    def get(self, key: str) -> Optional[Dict]:
        return self.entries.get(key)

    def config(self, key: str) -> Optional[Dict]:
        entry = self.entries.get(key)
        return None if entry is None else entry["config"]

    def put(
        self,
        key: str,
        *,
        family: str,
        shape: Dict[str, int],
        dtype,
        config: Dict,
        us_per_call: float,
        swept: int,
        pruned: int,
        backend: str,
        wall_us_per_call: Optional[float] = None,
    ) -> Dict:
        entry = {
            "family": family,
            "shape": {k: int(v) for k, v in shape.items()},
            "dtype": dtype_name(dtype),
            "backend": backend,
            "config": {k: int(v) for k, v in config.items()},
            "us_per_call": float(us_per_call),
            "candidates_swept": int(swept),
            "candidates_pruned": int(pruned),
        }
        if wall_us_per_call is not None:
            entry["wall_us_per_call"] = float(wall_us_per_call)
        self.entries[key] = entry
        return entry

    # ------------------------------------------------------------------
    def load(self) -> "ConfigCache":
        with open(self.path) as f:
            payload = json.load(f)
        if payload.get("version") != _SCHEMA_VERSION:
            # stale schema: start fresh rather than misread configs
            self.entries = {}
            return self
        self.entries = payload["entries"]
        return self

    def save(self) -> None:
        """Merge-then-write: take an exclusive lock, re-read the on-disk
        entries and overlay this cache's before the atomic replace, so two
        processes sweeping different keys into one file union their entries
        instead of the last writer dropping the other's."""
        if self.path is None:
            return
        with file_lock(str(self.path) + ".lock"):
            if Path(self.path).exists():
                try:
                    with open(self.path) as f:
                        payload = json.load(f)
                    if payload.get("version") == _SCHEMA_VERSION:
                        self.entries = {**payload["entries"], **self.entries}
                except (OSError, json.JSONDecodeError):
                    pass  # torn/unreadable: our atomic write supersedes it
            atomic_write_json(
                self.path, {"version": _SCHEMA_VERSION, "entries": self.entries}
            )
