"""Collective-traffic summaries of a counted step (the counterpart of
``repro/dist/hlo_analysis.py``).

Thin queries on an ``OpCostSummary`` (``repro_torch.dist.op_costs``), used by
the dry-run roofline (``repro_torch.launch.dryrun``): how many bytes enter
collectives per device, and how many cross links under a ring algorithm.
The reference's take HLO text; the port's take the summary of the rank's
program as it ran.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.dist.op_costs import OpCostSummary


def collective_bytes(summary: OpCostSummary) -> int:
    """Total per-device operand bytes entering collective ops."""
    return int(summary.collective_operand_bytes)


def collective_wire_bytes(summary: OpCostSummary) -> int:
    """Total per-device ring-model wire bytes across all collectives."""
    return int(summary.collective_wire_bytes)


def collective_breakdown(summary: OpCostSummary) -> Dict[str, int]:
    """Per-kind operand bytes (e.g. {"all-reduce": ..., "all-gather": ...})."""
    return {k: int(v) for k, v in summary.per_kind_operand.items()}


def collective_wire_breakdown(summary: OpCostSummary) -> Dict[str, int]:
    """Per-kind ring-model wire bytes."""
    return {k: int(v) for k, v in summary.per_kind_wire.items()}
