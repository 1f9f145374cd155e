"""The serve data plane's collectives over the mesh's "model" group, at the
points where GSPMD puts them for the reference's ``Rules.for_serving``
placement (``repro_torch.serve.sharding``).

Each is a plain function on local tensors with the group passed in; with
``group=None`` (no mesh, or a model axis of size 1) it returns its input's
result unchanged, so the unsharded and the (1, 1)-mesh engines run the same
operations bit for bit.

* ``all_reduce_sum``: the sum of a row-parallel product's partials (the
  attention output projection, the MLP's down projection, Mamba's
  ``x_proj`` and ``out_proj``), in float32 for a lower-precision input and
  rounded once at the end.  Each rank's partial is already a rounded bf16
  product, so the result is K rounded partials summed, not the unsharded
  product's single rounding.  The float32 sum saves only the roundings of
  the reduction's intermediate sums: one rounding in all, where a bf16
  all-reduce over K ranks may round at each of its K - 1 additions (at
  K = 2 both round once);
* ``vocab_parallel_embed``: the rank's rows of a vocab-sharded embedding,
  the rows outside its range masked to zero, summed over the ranks: exact,
  since each element has one nonzero term;
* ``gather_vocab``: vocab-sharded logits to every rank, as an ``all_reduce``
  into a zero-filled full-vocab buffer (exact for the same reason); gloo
  takes only ``broadcast`` and ``all_reduce`` for CUDA tensors, so no
  ``all_gather`` is used.

All-reduce results are the same bits on every rank, so the ranks' residual
streams, logits and greedy tokens stay in step.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def _reduce_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


def all_reduce_sum(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks, in x's dtype (summed in
    float32 when x is bf16 or fp16, and rounded to x's dtype once; the
    partials themselves come in rounded)."""
    if group is None:
        return x
    buf = x.to(_reduce_dtype(x.dtype), copy=True)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(x.dtype)


def vocab_parallel_embed(embed: torch.Tensor, tokens: torch.Tensor, vocab_start: int,
                         group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Rows of the embedding for ``tokens`` (any shape) when this rank holds
    rows ``vocab_start .. vocab_start + embed.shape[0] - 1`` of it: the local
    lookup, zero outside that range, summed over ``group``."""
    if group is None:
        return embed[tokens]
    local = tokens - vocab_start
    inside = (local >= 0) & (local < embed.shape[0])
    rows = embed[local.clamp(0, embed.shape[0] - 1)]
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return all_reduce_sum(rows, group)


def gather_vocab(logits: torch.Tensor, vocab_start: int, vocab_size: int,
                 group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Logits (..., V_local) of the rank's vocab slice ``vocab_start ..`` to
    the full (..., vocab_size) on every rank of ``group``."""
    if group is None:
        return logits
    full = torch.zeros((*logits.shape[:-1], vocab_size), dtype=_reduce_dtype(logits.dtype),
                       device=logits.device)
    full[..., vocab_start:vocab_start + logits.shape[-1]] = logits
    dist.all_reduce(full, op=dist.ReduceOp.SUM, group=group)
    return full.to(logits.dtype)
