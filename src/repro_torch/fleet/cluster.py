"""Fleet cluster: host inventory + allocation table over chaos health state.

``runtime.chaos.ClusterSim`` already knows how to replay a seeded
``ChaosTrace`` into per-host speed multipliers, cluster-wide slowdowns,
preemptions, and join/leave churn.  This module adds the one thing a
multi-tenant fleet needs on top: an **allocation table** (host -> owner)
with hard invariants —

  * a host is owned by at most one workload (no double allocation),
  * allocate only hands out live, free hosts,
  * release returns exactly what was allocated (freed capacity conserved),

plus the per-owner health views the scheduler prices decisions with:
BSP training runs at the pace of its slowest host, serving capacity is the
sum of per-replica speeds (a 2x-slow replica is half a replica).

The port's copy of ``repro/fleet/cluster.py``, unchanged but for its
imports: it runs on the port's ``runtime.chaos.ClusterSim``.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

from repro_torch.runtime.chaos import ChaosEvent, ChaosTrace, ClusterSim


class AllocationError(ValueError):
    """Allocator misuse (double-alloc, bad release) or capacity shortfall."""


class FleetCluster:
    def __init__(self, trace: ChaosTrace):
        self.sim = ClusterSim(trace)
        self.alloc: Dict[int, str] = {}   # host -> owner name

    # -- inventory -----------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.sim.capacity

    def hosts(self) -> List[int]:
        return self.sim.hosts()

    def free_hosts(self) -> List[int]:
        return [h for h in self.sim.hosts() if h not in self.alloc]

    def owned(self, owner: str) -> List[int]:
        return sorted(h for h, o in self.alloc.items() if o == owner)

    def n_allocated(self) -> int:
        return len(self.alloc)

    # -- allocation (the invariant-bearing operations) ------------------
    def allocate(self, owner: str, n: int) -> List[int]:
        """Hand ``owner`` the first n free live hosts (stable order)."""
        free = self.free_hosts()
        if n < 0:
            raise AllocationError(f"allocate({owner}, {n}): negative count")
        if n > len(free):
            raise AllocationError(
                f"allocate({owner}, {n}): only {len(free)} hosts free")
        taken = free[:n]
        for h in taken:
            self.alloc[h] = owner
        return taken

    def release(self, owner: str, hosts: Iterable[int]) -> None:
        for h in hosts:
            if self.alloc.get(h) != owner:
                raise AllocationError(
                    f"release({owner}, {h}): host owned by "
                    f"{self.alloc.get(h)!r}")
            del self.alloc[h]

    def release_all(self, owner: str) -> List[int]:
        hosts = self.owned(owner)
        self.release(owner, hosts)
        return hosts

    # -- time ------------------------------------------------------------
    def advance(self, step: int) -> Tuple[List[ChaosEvent],
                                          Dict[str, List[int]],
                                          Dict[str, List[int]]]:
        """Apply this step's chaos events.  Returns

        ``(events, lost, preempted)`` where ``lost[owner]`` are hosts that
        left the inventory out from under their owner (allocation dropped
        here — the owner must re-acquire), and ``preempted[owner]`` are
        owned hosts that were preempt-killed but return fresh (allocation
        kept; the owner lost in-flight work, not capacity)."""
        events = self.sim.advance(step)
        lost: Dict[str, List[int]] = {}
        preempted: Dict[str, List[int]] = {}
        for ev in events:
            if ev.kind == "preempt" and ev.host in self.alloc:
                preempted.setdefault(self.alloc[ev.host], []).append(ev.host)
        live = set(self.sim.hosts())
        for h in sorted(set(self.alloc) - live):
            lost.setdefault(self.alloc[h], []).append(h)
            del self.alloc[h]
        return events, lost, preempted

    # -- health views ----------------------------------------------------
    def host_multiplier(self, host: int) -> float:
        """Step-time multiplier for one host (>1 = slower)."""
        return self.sim.speed.get(host, 1.0) * self.sim.slowdown

    def bsp_pace(self, owner: str) -> float:
        """A BSP job runs at its slowest member's multiplier."""
        hosts = self.owned(owner)
        if not hosts:
            return 1.0
        return max(self.host_multiplier(h) for h in hosts)

    def effective_replicas(self, owner: str,
                           exclude: Iterable[int] = ()) -> float:
        """Serving capacity in replica units: a k-times-slower replica
        contributes 1/k of a replica."""
        skip = set(exclude)
        return sum(1.0 / self.host_multiplier(h)
                   for h in self.owned(owner) if h not in skip)


__all__ = ["AllocationError", "ChaosTrace", "FleetCluster"]
