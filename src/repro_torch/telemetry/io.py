"""Atomic filesystem primitives every telemetry writer goes through.

Two write patterns cover every sink and cache in the repo:

* **whole-file JSON** (``atomic_write_json``): write-temp-then-rename in
  the destination directory, so a concurrent reader sees either the old
  file or the new one, never a torn write.  The kernel-tune config cache
  and the run-log ``save()`` paths both route here — two processes
  sweeping the same key (CI slow job + tier-1 overlap) can no longer
  corrupt ``tune_cache.json``.
* **append-only JSONL** (``append_jsonl``): one ``os.write`` on an
  ``O_APPEND`` descriptor per flush.  POSIX appends of a single write
  are atomic with respect to other appenders, so concurrent writers
  interleave whole lines, never partial ones.
"""

from __future__ import annotations

import contextlib
import fcntl
import json
import os
import tempfile
from pathlib import Path
from typing import Any, Iterable, List


def atomic_write_text(path, text: str) -> None:
    """Write ``text`` to ``path`` via temp-file + rename (same directory,
    so the rename never crosses a filesystem boundary)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def atomic_write_json(path, payload: Any, *, indent: int = 2, sort_keys: bool = True) -> None:
    """Atomically serialize ``payload`` as JSON to ``path``."""
    atomic_write_text(path, json.dumps(payload, indent=indent, sort_keys=sort_keys))


def atomic_write_bytes(path, data: bytes) -> None:
    """Binary twin of :func:`atomic_write_text` — checkpoint shards route
    here so a crash mid-save can never leave a torn ``.npz``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


@contextlib.contextmanager
def file_lock(path):
    """Exclusive advisory lock on a sidecar file, serializing
    read-merge-write cycles across processes (the atomic rename alone
    keeps files untorn but lets two concurrent merges drop entries)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


def append_jsonl(path, lines: Iterable[str]) -> int:
    """Append ``lines`` (no trailing newlines) to ``path`` as one atomic
    ``os.write``.  Returns the number of lines appended."""
    lines = list(lines)
    if not lines:
        return 0
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    data = ("\n".join(lines) + "\n").encode("utf-8")
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        os.write(fd, data)
    finally:
        os.close(fd)
    return len(lines)


def read_jsonl(path) -> List[dict]:
    """Parse every non-empty line of a JSONL file."""
    out: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
