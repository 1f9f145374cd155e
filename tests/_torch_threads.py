"""Torch's intra-op threads in a test worker.

Under pytest-xdist, n worker processes share the machine's cores; torch's
default pool in each takes every core, so n pools oversubscribe them and
a test's CPU matmuls can run a hundred times slower than alone.  Every
``tests/test_torch_*.py`` imports this module, so that when pytest collects
them each worker sets its pool to its share, ``max(1, os.cpu_count() // n)``
threads.  Without xdist torch's default stays.  Nothing in ``repro_torch``
sets a thread count: this is the test harness's choice.
"""
import os
from typing import Mapping, Optional

import torch


def worker_threads(environ: Mapping[str, str] = os.environ) -> Optional[int]:
    """The intra-op threads for this process: a share of the cores under
    xdist (``PYTEST_XDIST_WORKER_COUNT``), else None (torch's default)."""
    n = environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not n:
        return None
    return max(1, (os.cpu_count() or 1) // int(n))


THREADS = worker_threads()
if THREADS is not None:
    torch.set_num_threads(THREADS)
