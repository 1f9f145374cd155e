"""Sharded, atomic, async checkpointing with keep-k retention: the port of
``repro/checkpoint/manager.py``, in its format 2, so that a checkpoint
written by either package restores in the other, bit for bit.

Layout (format 2):  <dir>/step_<N>/
           shard_0000.npz ...    (balanced key partitions of the flat tree)
           manifest.json         (schema, shard index, metadata — written LAST)
           COMMITTED             (legacy marker, kept for external tooling)

A tree is nested dicts and tuples (``#i`` keys) of tensors or numpy arrays,
flattened to '/'-joined keys as in the reference.  bf16 (and fp8) leaves,
which numpy's npz cannot hold, are stored as same-width unsigned integer
views with the true dtype in the manifest; ``restore`` returns a tree of CPU
tensors in the stored dtypes, bf16 restored from its bits (the reference
needs ``ml_dtypes`` for that view, the port does not).

Crash-safety: every file goes through the atomic write-temp-then-rename of
``repro_torch.telemetry.io``, and the manifest is written after every shard:
its presence is the commit point.  A ``file_lock`` sidecar serialises
writers across processes.

* ``save_async`` copies each leaf to host memory at call time (training may
  update its tensors right after) and writes on a background thread,
  returning a :class:`CheckpointWrite`; ``wait()`` is the barrier.
* ``restore`` validates the manifest and the shard set, raises the typed
  :class:`CorruptCheckpoint` for a torn step, or falls back to the previous
  complete step with a ``RuntimeWarning``; it also reads format 1
  (``arrays.npz`` and ``COMMITTED``).
* Retention keeps the newest ``keep`` complete steps.
* ``restore_sharded`` restores, then places each leaf by its entry of a
  sharding tree (``repro_torch.runtime.elastic.LeafSharding``): the rank's
  block on its device, or the whole leaf where the entry is None; so a
  checkpoint of whole leaves restores onto a mesh of any shape.
* Every save and restore appends ``{op, step, wall_s, bytes}`` to
  ``timings`` (``last_timing``); ``restore_sharded`` records its restore as
  ``restore`` does (the placement after it is not in ``wall_s``, as in the
  reference).
"""
from __future__ import annotations

import io as _io
import json
import shutil
import threading
import time
import warnings
import zipfile
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.telemetry.io import (
    atomic_write_bytes,
    atomic_write_json,
    atomic_write_text,
    file_lock,
)
from repro_torch.training.tree import tree_map

FORMAT_VERSION = 2

# default shard sizing: one shard per ~64 MiB of leaf bytes, capped
_SHARD_BYTES = 64 << 20
_MAX_SHARDS = 16

# dtypes npz cannot hold: (the port's dtype, the unsigned view the file holds)
_BIT_VIEWS = {"bfloat16": (torch.bfloat16, np.uint16),
              "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8),
              "float8_e5m2": (torch.float8_e5m2, np.uint8)}
_SIGNED = {np.uint16: torch.int16, np.uint8: torch.uint8}


class CorruptCheckpoint(RuntimeError):
    """A step directory failed validation: torn or unparseable manifest,
    schema/shard-count mismatch, or an unreadable shard file."""


def _flatten(tree, prefix="") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any]):
    # rebuild nested dict/tuple structure from '/'-joined keys
    root: Dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            items = sorted(node.items(), key=lambda kv: int(kv[0][1:]))
            return tuple(fix(v) for _, v in items)
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def _to_host(v) -> Tuple[np.ndarray, str]:
    """(the array the npz holds, the leaf's true dtype name)."""
    if isinstance(v, torch.Tensor):
        t = v.detach().to("cpu", copy=True)
        name = str(t.dtype).replace("torch.", "")
        if name in _BIT_VIEWS:
            view = _BIT_VIEWS[name][1]
            return t.view(_SIGNED[view]).numpy().view(view), name
        return t.numpy(), name
    a = np.array(v)  # a copy, as the reference's device_get
    name = str(a.dtype)
    if name in _BIT_VIEWS:
        return a.view(_BIT_VIEWS[name][1]), name
    return a, name


def _from_file(arr: np.ndarray, name: str) -> torch.Tensor:
    if name in _BIT_VIEWS:
        dtype, view = _BIT_VIEWS[name]
        bits = np.array(arr, order="C").view(view)
        return torch.from_numpy(bits.view(np.int16 if view is np.uint16 else np.uint8)).view(dtype)
    if name != str(arr.dtype):
        raise CorruptCheckpoint(f"a leaf stored as {arr.dtype} claims dtype {name}")
    return torch.from_numpy(arr if arr.flags.c_contiguous else np.array(arr, order="C"))


class CheckpointWrite:
    """Handle for one in-flight (or finished) checkpoint write."""

    def __init__(self, step: int):
        self.step = int(step)
        self.wall_s: Optional[float] = None  # set when the write commits
        self.nbytes = 0
        self.n_shards = 0
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> "CheckpointWrite":
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        return self

    @property
    def done(self) -> bool:
        return self._thread is None or not self._thread.is_alive()


class CheckpointManager:
    def __init__(self, directory, keep: int = 3, async_write: bool = True,
                 shard_bytes: int = _SHARD_BYTES, max_shards: int = _MAX_SHARDS):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_write = async_write
        self.shard_bytes = int(shard_bytes)
        self.max_shards = int(max_shards)
        self._pending: Optional[CheckpointWrite] = None
        # measured wall-times, oldest first: {"op", "step", "wall_s", "bytes"}
        self.timings: List[Dict[str, Any]] = []

    # ------------------------------------------------------------------
    # save
    # ------------------------------------------------------------------
    def save_async(self, step: int, tree, metadata: Optional[Dict] = None) -> CheckpointWrite:
        """Copy ``tree`` to host memory now and write it on a background
        thread.  Returns a handle; ``wait()`` or the next ``save_async`` is
        the barrier (one outstanding write at a time)."""
        host = {k: _to_host(v) for k, v in _flatten(tree).items()}
        meta = dict(metadata or {})
        meta["step"] = int(step)
        self.wait()
        handle = CheckpointWrite(step)
        if self.async_write:
            handle._thread = threading.Thread(target=self._write_guarded,
                                              args=(step, host, meta, handle), daemon=True)
            handle._thread.start()
            self._pending = handle
        else:
            self._write_guarded(step, host, meta, handle)
            handle.wait()
        return handle

    def wait(self) -> None:
        """Barrier: block until the in-flight write (if any) has committed."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.wait()

    def _partition(self, host: Dict[str, Tuple[np.ndarray, str]]) -> List[List[str]]:
        """Deterministic balanced key partition: big leaves first, each onto
        the lightest shard (the reference's)."""
        total = sum(a.nbytes for a, _ in host.values())
        n = max(1, min(self.max_shards, len(host), -(-total // max(self.shard_bytes, 1))))
        loads = [0] * n
        shards: List[List[str]] = [[] for _ in range(n)]
        for key in sorted(host, key=lambda k: (-host[k][0].nbytes, k)):
            i = min(range(n), key=lambda j: (loads[j], j))
            loads[i] += host[key][0].nbytes
            shards[i].append(key)
        return [sorted(s) for s in shards if s]

    def _write_guarded(self, step, host, meta, handle: CheckpointWrite):
        try:
            self._write(step, host, meta, handle)
        except BaseException as e:  # surfaced on wait(), not lost in the thread
            handle._error = e

    def _write(self, step: int, host: Dict[str, Tuple[np.ndarray, str]], meta: Dict,
               handle: CheckpointWrite):
        t0 = time.perf_counter()
        with file_lock(self.dir / ".ckpt.lock"):
            final = self.dir / f"step_{step:08d}"
            if final.exists() and not self._complete(final):
                shutil.rmtree(final)  # torn remains of a crashed writer
            final.mkdir(parents=True, exist_ok=True)
            shard_index = []
            for i, keys in enumerate(self._partition(host)):
                buf = _io.BytesIO()
                np.savez(buf, **{k: host[k][0] for k in keys})
                atomic_write_bytes(final / f"shard_{i:04d}.npz", buf.getvalue())
                shard_index.append({
                    "file": f"shard_{i:04d}.npz",
                    "arrays": {k: {"shape": list(host[k][0].shape), "dtype": host[k][1]}
                               for k in keys},
                })
            manifest = {"format": FORMAT_VERSION, "step": int(step), "metadata": meta,
                        "n_shards": len(shard_index), "shards": shard_index,
                        "written_at": time.time()}
            # the manifest is the commit point: written last, atomically
            atomic_write_json(final / "manifest.json", manifest)
            atomic_write_text(final / "COMMITTED", "ok")  # legacy marker
            self._gc()
        handle.nbytes = sum(a.nbytes for a, _ in host.values())
        handle.n_shards = len(shard_index)
        handle.wall_s = time.perf_counter() - t0
        self.timings.append({"op": "save", "step": int(step), "wall_s": handle.wall_s,
                             "bytes": handle.nbytes})

    def _gc(self) -> None:
        # never deletes the newest complete manifest
        steps = self.all_steps()
        for s in steps[: max(len(steps) - self.keep, 0)]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ------------------------------------------------------------------
    # discovery / validation
    # ------------------------------------------------------------------
    @staticmethod
    def _manifest(path: Path) -> Dict:
        mpath = path / "manifest.json"
        if not mpath.exists():
            raise CorruptCheckpoint(f"{path.name}: no manifest")
        try:
            manifest = json.loads(mpath.read_text())
        except (json.JSONDecodeError, OSError) as e:
            raise CorruptCheckpoint(f"{path.name}: unreadable manifest: {e}")
        if not isinstance(manifest, dict) or "metadata" not in manifest:
            raise CorruptCheckpoint(f"{path.name}: manifest schema invalid")
        fmt = manifest.get("format", 1)
        if fmt > FORMAT_VERSION:
            raise CorruptCheckpoint(
                f"{path.name}: format {fmt} is newer than supported ({FORMAT_VERSION})")
        if fmt >= 2:
            shards = manifest.get("shards")
            if not isinstance(shards, list) or manifest.get("n_shards") != len(shards):
                raise CorruptCheckpoint(f"{path.name}: shard count mismatch")
            for entry in shards:
                if not (path / entry["file"]).exists():
                    raise CorruptCheckpoint(f"{path.name}: missing shard {entry['file']}")
        else:  # format-1 layout: single arrays.npz + COMMITTED marker
            if "arrays" not in manifest:
                raise CorruptCheckpoint(f"{path.name}: manifest schema invalid")
            if not (path / "COMMITTED").exists() or not (path / "arrays.npz").exists():
                raise CorruptCheckpoint(f"{path.name}: uncommitted legacy step")
        return manifest

    def _complete(self, path: Path) -> bool:
        try:
            self._manifest(path)
            return True
        except CorruptCheckpoint:
            return False

    def all_steps(self) -> List[int]:
        steps = []
        for p in self.dir.glob("step_*"):
            if self._complete(p):
                steps.append(int(p.name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    # restore
    # ------------------------------------------------------------------
    @staticmethod
    def _load_npz(path: Path, dtypes: Dict[str, str]) -> Dict[str, torch.Tensor]:
        try:
            out = {}
            with np.load(path) as z:
                for k in z.files:
                    arr = z[k]  # each member read once
                    out[k] = _from_file(arr, dtypes.get(k) or str(arr.dtype))
            return out
        except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
            raise CorruptCheckpoint(f"{path.name}: unreadable shard: {e}")

    def _load_step(self, step: int) -> Tuple[Any, Dict]:
        path = self.dir / f"step_{step:08d}"
        if not path.exists():
            raise CorruptCheckpoint(f"step_{step:08d}: no such checkpoint")
        manifest = self._manifest(path)
        flat: Dict[str, torch.Tensor] = {}
        if manifest.get("format", 1) >= 2:
            for entry in manifest["shards"]:
                dtypes = {k: v["dtype"] for k, v in entry["arrays"].items()}
                part = self._load_npz(path / entry["file"], dtypes)
                if set(part) != set(entry["arrays"]):
                    raise CorruptCheckpoint(
                        f"{path.name}/{entry['file']}: key set does not match manifest")
                flat.update(part)
        else:
            dtypes = {k: v["dtype"] for k, v in manifest["arrays"].items()}
            flat = self._load_npz(path / "arrays.npz", dtypes)
        return _unflatten(flat), manifest["metadata"]

    def restore(self, step: Optional[int] = None, *, fallback: bool = True) -> Tuple[Any, Dict]:
        """Returns (tree of CPU tensors, metadata).  A corrupt step falls
        back to the previous complete one with a ``RuntimeWarning``
        (``fallback=False`` raises :class:`CorruptCheckpoint` instead)."""
        t0 = time.perf_counter()
        complete = self.all_steps()
        if step is None:
            if not complete:
                raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
            candidates = list(reversed(complete))
        else:
            candidates = [step] + [s for s in reversed(complete) if s < step]
        last_err: Optional[CorruptCheckpoint] = None
        for i, s in enumerate(candidates):
            try:
                tree, meta = self._load_step(s)
            except CorruptCheckpoint as e:
                last_err = e
                if not fallback:
                    raise
                continue
            if i > 0:
                warnings.warn(f"checkpoint step {candidates[0]} is corrupt ({last_err}); "
                              f"fell back to step {s}", RuntimeWarning, stacklevel=2)
            self.timings.append({"op": "restore", "step": int(s),
                                 "wall_s": time.perf_counter() - t0,
                                 "bytes": sum(t.numel() * t.element_size()
                                              for t in _flatten(tree).values())})
            return tree, meta
        assert last_err is not None
        raise last_err

    def restore_sharded(self, shardings, step: Optional[int] = None) -> Tuple[Any, Dict]:
        """Restore and place each leaf with the given sharding tree (the
        restored tree's structure; a None entry keeps the whole leaf on the
        host): works across different mesh shapes (elastic rescale)."""
        host, meta = self.restore(step)

        def place(x, sh):
            return sh.place(x) if sh is not None else x

        return tree_map(place, host, shardings), meta

    # ------------------------------------------------------------------
    def last_timing(self, op: str) -> Optional[Dict[str, Any]]:
        """Most recent measured wall-time entry for ``op`` ('save'/'restore')."""
        for entry in reversed(self.timings):
            if entry["op"] == op:
                return entry
        return None
