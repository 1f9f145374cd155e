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

The trainer's data plane, over the mesh's "data" group (FSDP, each rank
holding a contiguous block of a leaf along one dim,
``repro_torch.runtime.elastic.LeafSharding``):

* ``all_reduce_``: the sum over the group, in place;
* ``gather_blocks``: the ranks' blocks along ``dim`` to the whole tensor on
  every rank: ``all_gather_into_tensor`` on NCCL; on gloo, which takes only
  ``broadcast`` and ``all_reduce`` for CUDA tensors, an ``all_reduce`` into
  a whole tensor filled with -0.0 around the rank's block.  Each element
  then has one term and -0.0s, and -0.0 + x is x for every x (+0.0 and
  -0.0 included), so the result is the blocks' bits;
* ``reduce_scatter_blocks``: the sum over the group of whole tensors, the
  rank's block of it kept: ``reduce_scatter_tensor`` on NCCL, an
  ``all_reduce`` and the rank's slice on gloo.

Either raises for a backend other than the two: nothing falls back.
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


def _backend(group: dist.ProcessGroup) -> str:
    backend = str(dist.get_backend(group)).lower()
    if backend not in ("nccl", "gloo"):
        raise NotImplementedError(f"the data plane's collectives run on nccl or gloo, not "
                                  f"{backend}")
    return backend


def all_reduce_(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place and return it (``x`` itself when
    ``group`` is None)."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def gather_blocks(local: torch.Tensor, dim: int, group: Optional[dist.ProcessGroup]
                  ) -> torch.Tensor:
    """The whole tensor from the ranks' contiguous blocks along ``dim``
    (rank r of the group holds block r), on every rank, bit for bit."""
    if group is None:
        return local
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    moved = local.movedim(dim, 0).contiguous()
    whole = torch.empty((world * moved.shape[0], *moved.shape[1:]), dtype=local.dtype,
                        device=local.device)
    if _backend(group) == "nccl":
        dist.all_gather_into_tensor(whole, moved, group=group)
    else:
        whole.fill_(-0.0)
        whole[rank * moved.shape[0]:(rank + 1) * moved.shape[0]] = moved
        dist.all_reduce(whole, op=dist.ReduceOp.SUM, group=group)
    return whole.movedim(0, dim)


def reduce_scatter_blocks(whole: torch.Tensor, dim: int,
                          group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Rank r's block r along ``dim`` of the sum of ``whole`` over
    ``group``, contiguous (``whole`` itself when ``group`` is None).  On
    gloo ``whole`` is summed in place."""
    if group is None:
        return whole
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    n = whole.shape[dim] // world
    if _backend(group) == "nccl":
        moved = whole.movedim(dim, 0).contiguous()
        out = torch.empty((n, *moved.shape[1:]), dtype=whole.dtype, device=whole.device)
        dist.reduce_scatter_tensor(out, moved, op=dist.ReduceOp.SUM, group=group)
        return out.movedim(0, dim).contiguous()
    dist.all_reduce(whole, op=dist.ReduceOp.SUM, group=group)
    return whole.narrow(dim, rank * n, n).contiguous()
