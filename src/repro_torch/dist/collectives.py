"""The collectives of the serve and training data planes, over the mesh's
"model" group (tensor parallelism) and its "data" group (FSDP), at the
points where GSPMD puts them for the reference's ``Rules``
(``repro_torch.serve.sharding``, ``repro_torch.training.trainer``).

Each is a plain function on local tensors with the group passed in; with
``group=None`` (no mesh, or an axis of size 1) it returns its input's result
unchanged, so the unsharded and the (1, 1)-mesh engines and trainers run
the same operations bit for bit.

The "model" group (tensor parallelism), with a backward where training
needs one (Megatron's conjugate pair):

* ``all_reduce_sum``: the sum of a row-parallel product's partials (the
  attention output projection, the MLP's down projection, Mamba's
  ``x_proj`` and ``out_proj``), in float32 for a lower-precision input and
  rounded once at the end.  Each rank's partial is already a rounded bf16
  product, so the result is K rounded partials summed, not the unsharded
  product's single rounding.  The float32 sum saves only the roundings of
  the reduction's intermediate sums: one rounding in all, where a bf16
  all-reduce over K ranks may round at each of its K - 1 additions (at
  K = 2 both round once).  Its gradient passes through: every rank holds
  the same downstream, so each partial's gradient is the sum's;
* ``copy_to_model``: a replicated activation (or parameter) entering the
  rank's slice of the work (a column-parallel product, a norm scale applied
  to the rank's heads): the identity forward, its gradient, which each rank
  holds for its slice only, summed over the group in the backward;
* ``vocab_parallel_embed``: the rank's rows of a vocab-sharded embedding,
  the rows outside its range masked to -0.0, summed over the ranks: exact,
  since each element has one term and -0.0s, and -0.0 + x is x for every x
  (+0.0 and -0.0 included).  Its gradient reaches the rank's rows;
* ``gather_vocab``: vocab-sharded logits to every rank, as an ``all_reduce``
  into a -0.0-filled full-vocab buffer (exact for the same reason); gloo
  takes only ``broadcast`` and ``all_reduce`` for CUDA tensors, so no
  ``all_gather`` is used.  Its gradient is the rank's slice of the full
  logits' gradient, which every rank computes alike.

All-reduce results are the same bits on every rank, so the ranks' residual
streams, logits, losses and greedy tokens stay in step.

The MoE's expert-parallel and 2-D paths (``repro_torch.models.moe``) and
the sequence-split decode (``repro_torch.models.attention``) add two more,
on any group (the "model" group, or the batch axes' "spare" group):

* ``gather_dim``: the ranks' contiguous blocks along one dim to the whole
  tensor on every rank (``gather_blocks``: exact), whose gradient is the
  rank's block of the whole gradient (every rank computes the same whole
  gradient downstream): the router's logits over "model", the 2-D path's
  output columns over the spare axes;
* ``split_dim``: the rank's block of a replicated tensor along one dim,
  whose gradient is gathered from the ranks' blocks (the 2-D path's token
  columns, each rank's experts reading its d-block).

``all_reduce_sum`` and ``copy_to_model`` take any group too: the 2-D path
sums its gate and up partials over the spare axes, and its hidden
activation's gradient through ``copy_to_model`` on that group.

The "data" group (FSDP, each rank holding a contiguous block of a leaf
along one dim, ``repro_torch.runtime.elastic.LeafSharding``):

* ``all_reduce_``: the sum over the group, in place;
* ``gather_blocks``: the ranks' blocks along ``dim`` to the whole tensor on
  every rank: ``all_gather_into_tensor`` on NCCL; on gloo, which takes only
  ``broadcast`` and ``all_reduce`` for CUDA tensors, an ``all_reduce`` into
  a whole tensor filled with -0.0 around the rank's block, the blocks'
  bits;
* ``reduce_scatter_blocks``: the sum over the group of whole tensors, the
  rank's block of it kept: ``reduce_scatter_tensor`` on NCCL, an
  ``all_reduce`` and the rank's slice on gloo.

Either raises for a backend other than the two: nothing falls back.

A ``VirtualGroup`` (a stand-in mesh's group, ``repro_torch.launch.mesh``:
the dry-run's rank on the "meta" device) moves nothing: each collective on
it returns a tensor of the right shape (the rank's own values where it has
them, zeros where other ranks' would be), as the NCCL path shapes it.  Every
collective reports itself to the dry-run's counter
(``repro_torch.dist.op_costs``): its kind, operand and output bytes, group
size and mesh axis.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.dist import op_costs

# the collectives run in this process, by kind (a driver resets and reads it)
CALLS: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class VirtualGroup:
    """A stand-in mesh's process group: ``size`` ranks along the mesh axes
    ``axis`` (one name, or a tuple of names flattened), this rank at
    ``rank``.  No process group exists behind it."""

    axis: Union[str, Tuple[str, ...]]
    size: int
    rank: int = 0

    @property
    def axis_name(self) -> str:
        return self.axis if isinstance(self.axis, str) else "+".join(self.axis)


def group_size(group) -> int:
    """The ranks of ``group`` (a process group or a ``VirtualGroup``)."""
    return group.size if isinstance(group, VirtualGroup) else dist.get_world_size(group)


def group_rank(group) -> int:
    """This rank's index in ``group``."""
    return group.rank if isinstance(group, VirtualGroup) else dist.get_rank(group)



def _axis(group) -> str:
    return group.axis_name if isinstance(group, VirtualGroup) else "group"


def _reduce_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


def _sum_(buf: torch.Tensor, group) -> torch.Tensor:
    """``buf`` summed over ``group`` in place (reported; nothing moves on a
    virtual group)."""
    CALLS["all-reduce"] += 1
    with op_costs.collective("all-reduce", group_size(group), _axis(group), buf):
        if not isinstance(group, VirtualGroup):
            dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    buf = x.to(_reduce_dtype(x.dtype), copy=True)
    return _sum_(buf, group).to(x.dtype)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad.contiguous(), ctx.group), None


def _differentiable(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks, in x's dtype (summed in
    float32 when x is bf16 or fp16, and rounded to x's dtype once; the
    partials themselves come in rounded); its gradient passes through."""
    if group is None:
        return x
    if _differentiable(x):
        return _AllReduceSum.apply(x, group)
    return _summed(x, group)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself, whose gradient is summed over ``group`` in the
    backward (``x`` unchanged without a group or a gradient)."""
    if group is None or not _differentiable(x):
        return x
    return _CopyToModel.apply(x, group)


def vocab_parallel_embed(embed: torch.Tensor, tokens: torch.Tensor, vocab_start: int,
                         group) -> torch.Tensor:
    """Rows of the embedding for ``tokens`` (any shape) when this rank holds
    rows ``vocab_start .. vocab_start + embed.shape[0] - 1`` of it: the local
    lookup, -0.0 outside that range, summed over ``group``."""
    if group is None:
        return embed[tokens]
    local = tokens - vocab_start
    inside = (local >= 0) & (local < embed.shape[0])
    rows = embed[local.clamp(0, embed.shape[0] - 1)]
    rows = torch.where(inside[..., None], rows, torch.full_like(rows, -0.0))
    return all_reduce_sum(rows, group)


def _gather_vocab(logits: torch.Tensor, vocab_start: int, vocab_size: int,
                  group) -> torch.Tensor:
    full = torch.full((*logits.shape[:-1], vocab_size), -0.0,
                      dtype=_reduce_dtype(logits.dtype), device=logits.device)
    full[..., vocab_start:vocab_start + logits.shape[-1]] = logits
    return _sum_(full, group).to(logits.dtype)


class _GatherVocab(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, vocab_start, vocab_size, group):
        ctx.span = (vocab_start, logits.shape[-1])
        return _gather_vocab(logits, vocab_start, vocab_size, group)

    @staticmethod
    def backward(ctx, grad):
        start, n = ctx.span
        return grad[..., start:start + n].contiguous(), None, None, None


def gather_vocab(logits: torch.Tensor, vocab_start: int, vocab_size: int,
                 group) -> torch.Tensor:
    """Logits (..., V_local) of the rank's vocab slice ``vocab_start ..`` to
    the full (..., vocab_size) on every rank of ``group``."""
    if group is None:
        return logits
    if _differentiable(logits):
        return _GatherVocab.apply(logits, vocab_start, vocab_size, group)
    return _gather_vocab(logits, vocab_start, vocab_size, group)


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.n = dim, group, x.shape[dim]
        return gather_blocks(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        rank = group_rank(ctx.group)
        return grad.narrow(ctx.dim, rank * ctx.n, ctx.n).contiguous(), None, None


class _SplitDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n = x.shape[dim] // group_size(group)
        return x.narrow(dim, group_rank(group) * n, n).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return gather_blocks(grad.contiguous(), ctx.dim, ctx.group), None, None


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The whole tensor from the ranks' blocks of ``x`` along ``dim`` (rank
    r of ``group`` holds block r), bit for bit; its gradient is the rank's
    block.  ``x`` itself without a group."""
    if group is None:
        return x
    dim = dim % x.dim()
    if _differentiable(x):
        return _GatherDim.apply(x, dim, group)
    return gather_blocks(x, dim, group)


def split_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Rank r's block r of a replicated ``x`` along ``dim``; its gradient
    is gathered from every rank's block.  ``x`` itself without a group."""
    if group is None:
        return x
    dim = dim % x.dim()
    if _differentiable(x):
        return _SplitDim.apply(x, dim, group)
    n = x.shape[dim] // group_size(group)
    return x.narrow(dim, group_rank(group) * n, n)


def _backend(group) -> str:
    if isinstance(group, VirtualGroup):
        return "virtual"
    backend = str(dist.get_backend(group)).lower()
    if backend not in ("nccl", "gloo"):
        raise NotImplementedError(f"the data plane's collectives run on nccl or gloo, not "
                                  f"{backend}")
    return backend


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place and return it (``x`` itself when
    ``group`` is None)."""
    if group is not None:
        _sum_(x, group)
    return x


def gather_blocks(local: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The whole tensor from the ranks' contiguous blocks along ``dim``
    (rank r of the group holds block r), on every rank, bit for bit."""
    if group is None:
        return local
    world, rank = group_size(group), group_rank(group)
    moved = local.movedim(dim, 0).contiguous()
    whole = torch.empty((world * moved.shape[0], *moved.shape[1:]), dtype=local.dtype,
                        device=local.device)
    backend = _backend(group)
    CALLS["all-gather"] += 1
    with op_costs.collective("all-gather", world, _axis(group), moved, whole):
        if backend == "nccl":
            dist.all_gather_into_tensor(whole, moved, group=group)
        else:
            whole.fill_(-0.0)
            whole[rank * moved.shape[0]:(rank + 1) * moved.shape[0]] = moved
            if backend == "gloo":
                dist.all_reduce(whole, op=dist.ReduceOp.SUM, group=group)
    return whole.movedim(0, dim)


def reduce_scatter_blocks(whole: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Rank r's block r along ``dim`` of the sum of ``whole`` over
    ``group``, contiguous (``whole`` itself when ``group`` is None).  On
    gloo ``whole`` is summed in place."""
    if group is None:
        return whole
    world, rank = group_size(group), group_rank(group)
    n = whole.shape[dim] // world
    backend = _backend(group)
    if backend == "gloo":
        _sum_(whole, group)
        return whole.narrow(dim, rank * n, n).contiguous()
    moved = whole.movedim(dim, 0).contiguous()
    out = torch.empty((n, *moved.shape[1:]), dtype=whole.dtype, device=whole.device)
    CALLS["reduce-scatter"] += 1
    with op_costs.collective("reduce-scatter", world, _axis(group), moved, out):
        if backend == "nccl":
            dist.reduce_scatter_tensor(out, moved, op=dist.ReduceOp.SUM, group=group)
        else:
            out.copy_(moved[rank * n:(rank + 1) * n])
    return out.movedim(0, dim).contiguous()
