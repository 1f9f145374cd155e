"""Continuous-batching serving of the port: paged KV cache, scheduler,
prefix cache, the Hemingway capacity planner, the prefix-affinity router
over replicas and live replica migration.  ``paging``, ``prefix``,
``scheduler``, ``speculate``, ``planner`` and ``router`` are copies of
``repro.serve``'s pure-Python modules; ``cache``, ``engine`` and ``migrate``
hold the tensors."""

from repro_torch.serve.cache import init_paged_cache, write_prefill
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.migrate import (
    MigrationError,
    migrate_replica,
    restore_engine,
    snapshot_engine,
)
from repro_torch.serve.paging import SCRATCH_PAGE, OutOfPages, PagePool
from repro_torch.serve.planner import CapacityPlanner
from repro_torch.serve.prefix import PrefixCache
from repro_torch.serve.router import RoutedRequest, Router
from repro_torch.serve.scheduler import Request, RequestState, Scheduler

__all__ = [
    "CapacityPlanner",
    "MigrationError",
    "OutOfPages",
    "PagePool",
    "PrefixCache",
    "Request",
    "RequestState",
    "RoutedRequest",
    "Router",
    "SCRATCH_PAGE",
    "Scheduler",
    "ServeEngine",
    "init_paged_cache",
    "migrate_replica",
    "restore_engine",
    "snapshot_engine",
    "write_prefill",
]
