"""Continuous-batching serving of the port: paged KV cache, scheduler,
prefix cache and the Hemingway capacity planner.  ``paging``, ``prefix``,
``scheduler``, ``speculate`` and ``planner`` are copies of ``repro.serve``'s
pure-Python modules; ``cache`` and ``engine`` hold the tensors."""

from repro_torch.serve.cache import init_paged_cache, write_prefill
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.paging import SCRATCH_PAGE, OutOfPages, PagePool
from repro_torch.serve.planner import CapacityPlanner
from repro_torch.serve.prefix import PrefixCache
from repro_torch.serve.scheduler import Request, RequestState, Scheduler

__all__ = [
    "CapacityPlanner",
    "OutOfPages",
    "PagePool",
    "PrefixCache",
    "Request",
    "RequestState",
    "SCRATCH_PAGE",
    "Scheduler",
    "ServeEngine",
    "init_paged_cache",
    "write_prefill",
]
