"""Mixture-of-Experts FFN, the local path of ``repro/models/moe.py``: a
float32 router with top-k (renormalised where the config says so), dispatch
into a fixed-shape (E, c, d) buffer, the experts' SwiGLU as batched matrix
products, the combine summed in float32, plus the shared experts; in
training, the capacity that drops tokens and the router's aux loss.

Eval is dropless (``_capacity(train=False)``, ``moe.py:77-94``): every
expert's capacity is the number of tokens T, so no token is dropped and the
buffer's shape depends on T alone.  Tokens take their slots in a stable sort by
expert, so a token's slot depends only on the tokens before it; its row of
each expert's product is computed alone (a product's row depends only on
that row at a fixed shape).  So a token's output does not depend on the
tokens after it, which the serve engine's prefix reuse needs (prompts are
padded to whole row blocks, so T is fixed), nor on the other rows' contents.
The blocks (``repro_torch.models.blocks``) call it on one row block at a
time: ``prefill_rows`` rows in prefill and in a prefill chunk (whose other
rows are padding), ``decode_rows`` (the engine's ``max_batch``) in a decode
step and in each draft index's block of a verify step, so T is always one
of the two shapes the plain engine uses.
The buffer holds every expert's T rows whatever the routing: at full width a
1024-row prefill block computes all 160 experts on 1024 rows, and a decode
step reads every expert's weights (PERF.md).  Gathering only the routed
tokens into products of data-dependent size would let the library pick
another algorithm by shape and is later work.

Training (``train=True``, ``moe.py:77-155``, ``:214-238``): one dispatch over
all B * S tokens of the batch, at the Switch/GShard capacity
ceil(T k / E x capacity_factor); an expert's assignments past its capacity
(in the stable sort's order) are dropped and add zero, and the router adds
the load-balance loss E sum_e me_e fe_e x router_aux_loss (me_e the mean
router probability of expert e, fe_e the share of the assignments routed to
it).

The combine adds each token's k weighted expert outputs in float32 in order
of expert id, the order of the reference's scatter-add, one addition at a
time, and the dispatch's gradient sums each token's k copies one at a time
too (``_RepeatRows``): no atomics (autograd's backward of a gather that takes a
row k times is an accumulating scatter), so the same inputs give the same
bits on the card, forward and backward.

On a data mesh (the trainer's FSDP over "data", "model" of size 1) the
reference takes its ``shard_map`` path, whose blocks are the data shards:
each rank dispatches its own rows at their capacity, and the aux loss is a
function of the whole batch (``apply_moe(rt=...)``, the data group).

On a "model" axis of K > 1 (``moe.py:212-303``) each rank holds E / K
experts (the config's ``expert_shards``: rank r experts r E / K ..
(r + 1) E / K - 1), E / K of the router's columns and 1 / K of the shared
experts' width (``sh_gate``/``sh_up`` columns, ``sh_down`` rows), and one of
two paths runs:

* **expert parallel** (``moe.py:253-281``), whenever the rules shard the
  tokens over the batch axes or no other axis is larger than 1: the
  rank's float32 router logits are gathered over "model" (a concatenation:
  the routing is exactly the unsharded routing), the rank dispatches its
  tokens with every assignment to another rank's expert sent to the drop
  bucket (the reference's ``a_ids``), at the capacity of its own tokens
  (dropless in eval), combines each token's local terms in float32 in
  expert-id order and casts them to the dtype, adds the shared experts'
  partial, and one sum over "model" follows: the reference's order of
  rounding;
* **2-D** (``_dispatch_2d``, ``moe.py:158-203``), when the tokens are
  replicated (the rules' "batch" is None) and other axes (the "spare"
  axes) remain: the experts' d_model dim stays in its stored blocks over
  the spare axes (the config's ``embed_shards``; the weights are never
  gathered), each rank dispatches its block of the token columns, the gate
  and up partials are summed over the spare axes before the SiLU, and the
  down output, d-blocked, is gathered over them.

In training the conjugate pairs sit where Megatron puts them: the FFN's
input and the top-k weights enter the rank's work through
``copy_to_model`` (each rank's combine reads only its own experts, so the
weights' gradient is summed over "model" before the replicated softmax's
backward), and the router logits' gather has the slice as its backward
(``repro_torch.dist.collectives``).  The 2-D path's token block is a
``split_dim`` (its gradient gathered over the spare axes), its hidden
activation and the top-k weights enter the rank's d-block through
``copy_to_model`` over the spare axes, and its output's gather slices its
gradient.  The aux loss is
computed from the replicated routing, the data group's share.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.dist.collectives import (
    all_reduce_,
    all_reduce_sum,
    copy_to_model,
    gather_dim,
    group_rank,
    group_size,
    split_dim,
)

# parameters stored (and read) in float32 whatever the config's dtype: the
# router decides the top-k, where a bf16 rounding would flip near ties
FLOAT32_PARAMS = frozenset({"router"})


def moe_shapes(cfg: ArchConfig) -> Dict[str, Tuple[Tuple[int, ...], str, float]]:
    """name -> (shape, init, scale), the reference's (``moe.py:56-74``), at a
    rank's share of the experts (``expert_shards``, ``embed_shards``) and
    the whole model's scales."""
    moe = cfg.moe
    d, e, f = cfg.d_model, moe.n_routed_experts, moe.expert_d_ff
    s_in, s_ff = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    el, dl = e // moe.expert_shards, d // moe.embed_shards  # a rank's (module docstring)
    shapes = {
        "router": ((d, el), "normal", s_in),
        "w_gate": ((el, dl, f), "normal", s_in),
        "w_up": ((el, dl, f), "normal", s_in),
        "w_down": ((el, f, dl), "normal", s_ff),
    }
    if moe.n_shared_experts:
        fs = moe.n_shared_experts * f
        fl = fs // moe.expert_shards
        shapes.update({"sh_gate": ((d, fl), "normal", s_in),
                       "sh_up": ((d, fl), "normal", s_in),
                       "sh_down": ((fl, d), "normal", 1.0 / math.sqrt(fs))})
    return shapes


def capacity(t: int, moe: Optional[MoEConfig] = None, train: bool = False) -> int:
    """Capacity per expert for a dispatch of ``t`` tokens (``_capacity``):
    dropless in eval; in training the Switch/GShard
    ceil(t k / E x capacity_factor), at least 1."""
    if not train:
        return max(t, 1)
    cap = int(math.ceil(t * moe.top_k / moe.n_routed_experts * moe.capacity_factor))
    return max(cap, 1)


def route(p, x: torch.Tensor, cfg: ArchConfig, train: bool = False, group=None):
    """Router in float32, ``moe.py:97``: x (T, d) -> ids (T, k) int64, probs
    (T, k) float32, and with ``train`` the aux loss (a float32 0-d tensor,
    0 where the config's ``router_aux_loss`` is 0) as a third value.

    With ``group`` (a data group whose ranks route the batch's other rows)
    the aux is this rank's share of the whole batch's, as the reference
    routes the global batch before its ``shard_map`` (``moe.py:226``): fe,
    the routed fractions (no gradient), from the assignment counts and the
    token count summed over the group, and the rank's me term its
    probabilities' sum over the global token count, so that the shares sum
    to E sum(me fe) x router_aux_loss of the whole batch."""
    return route_logits(x.float() @ p["router"].float(), cfg, train, group)


def route_logits(logits: torch.Tensor, cfg: ArchConfig, train: bool = False, group=None):
    """``route`` from the float32 router logits (T, E) of every expert."""
    moe = cfg.moe
    probs_full = torch.softmax(logits, dim=-1)
    probs, ids = torch.topk(probs_full, moe.top_k, dim=-1)
    if moe.norm_topk:
        probs = probs / torch.clamp(probs.sum(dim=-1, keepdim=True), min=1e-9)
    if not train:
        return ids, probs
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    if moe.router_aux_loss > 0:
        e = moe.n_routed_experts
        if group is None:
            me = probs_full.reshape(-1, e).mean(0)
            fe = F.one_hot(ids.reshape(-1), e).float().mean(0)
        else:
            probs_full = probs_full.reshape(-1, e)
            counts = F.one_hot(ids.reshape(-1), e).float().sum(0)
            n = torch.tensor([float(probs_full.shape[0])], device=logits.device)
            counts = all_reduce_(torch.cat([counts, n]), group)
            me = probs_full.sum(0) / counts[e]
            fe = counts[:e] / (counts[e] * moe.top_k)
        aux = e * torch.sum(me * fe) * moe.router_aux_loss
    return ids, probs, aux


class _RepeatRows(torch.autograd.Function):
    """x (T, d) -> (T k, d), row i k + j a copy of row i; the gradient of
    row i sums its k copies' in float32 in order of j, one addition at a
    time, rounded once to x's dtype."""

    @staticmethod
    def forward(ctx, x, k):
        ctx.k = k
        return x.repeat_interleave(k, dim=0)

    @staticmethod
    def backward(ctx, grad):
        parts = grad.reshape(-1, ctx.k, grad.shape[-1]).float()
        total = parts[:, 0]
        for j in range(1, ctx.k):
            total = total + parts[:, j]
        return total.to(grad.dtype), None


def _dispatch(xt: torch.Tensor, ids: torch.Tensor, el: int, e0: int, c: int):
    """The dispatch of ``moe.py:116-140``: the assignments of ``ids`` (T, k)
    sorted stably by local expert (``ids - e0``; an expert outside
    ``0 .. el - 1`` is another rank's and goes to the drop bucket ``el``),
    an assignment whose rank in its expert reaches ``c`` dropped too.
    Returns (order, slot, valid, xe (el, c, d)): a dropped assignment's input
    goes to the buffer's extra row ``el c``, whose product is never taken."""
    t, d = xt.shape
    k = ids.shape[1]
    local = ids.reshape(-1) - e0
    a_ids = torch.where((local >= 0) & (local < el), local, el)
    order = torch.argsort(a_ids, stable=True)  # (T*k,) grouped by expert
    sorted_ids = a_ids[order]
    ar = torch.arange(t * k, device=xt.device)
    is_new = torch.ones_like(sorted_ids, dtype=torch.bool)
    is_new[1:] = sorted_ids[1:] != sorted_ids[:-1]
    rank = ar - torch.cummax(torch.where(is_new, ar, 0), dim=0).values
    valid = (sorted_ids < el) & (rank < c)
    slot = torch.where(valid, sorted_ids * c + rank, el * c)
    xbuf = xt.new_zeros((el * c + 1, d))
    xbuf[slot] = _RepeatRows.apply(xt, k)[order]
    return order, slot, valid, xbuf[:el * c].reshape(el, c, d)


def _combine(oe: torch.Tensor, ids: torch.Tensor, probs: torch.Tensor, order, slot,
             valid) -> torch.Tensor:
    """Each token's k weighted expert outputs (``oe`` (el c, d'), the
    buffer's rows) summed in float32 in order of expert id, one addition at
    a time; a dropped (or another rank's) assignment reads the last row and
    weighs 0.  Returns (T, d') float32."""
    t, k = ids.shape
    d = oe.shape[1]
    weight = torch.where(valid, probs.reshape(-1)[order].float(), 0.0)
    contrib = torch.empty((t * k, d), dtype=torch.float32, device=oe.device)
    contrib[order] = oe[slot.clamp(max=oe.shape[0] - 1)].float() * weight[:, None]
    by_expert = torch.argsort(ids, dim=1, stable=True)
    terms = contrib.reshape(t, k, d).gather(1, by_expert[:, :, None].expand(t, k, d))
    y = terms[:, 0]
    for j in range(1, k):
        y = y + terms[:, j]
    return y


def dispatch_compute_combine(xt: torch.Tensor, ids: torch.Tensor, probs: torch.Tensor,
                             wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
                             cap: Optional[int] = None, e0: int = 0) -> torch.Tensor:
    """``moe.py:116-155`` on one rank: xt (T, d), ids/probs (T, k), the
    rank's experts' weights (El, d, f) / (El, f, d), experts ``e0 .. e0 + El
    - 1`` (the assignments to others dropped), ``cap`` tokens an expert
    (dropless, ``capacity(T)``, when None).  An assignment whose rank among
    its expert's (in the stable sort by expert) reaches the capacity is
    dropped: its term is 0.  Returns (T, d) in xt's dtype."""
    t = xt.shape[0]
    c = capacity(t) if cap is None else int(cap)
    order, slot, valid, xe = _dispatch(xt, ids, wg.shape[0], e0, c)
    h = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)
    oe = torch.bmm(h, wd).reshape(-1, wd.shape[2])
    return _combine(oe, ids, probs, order, slot, valid).to(xt.dtype)


def dispatch_2d(xt: torch.Tensor, ids: torch.Tensor, probs: torch.Tensor, wg: torch.Tensor,
                wu: torch.Tensor, wd: torch.Tensor, cap: Optional[int], e0: int,
                spare) -> torch.Tensor:
    """``_dispatch_2d`` (``moe.py:158-203``): xt (T, d) the replicated
    tokens, the rank's experts' weights in their d-blocks over the spare
    axes' group ``spare`` (wg/wu (El, d / S, f), wd (El, f, d / S)).  The
    rank dispatches its block of the token columns, the gate and up partials
    are summed over ``spare`` (float32, rounded once) before the SiLU, and
    the d-blocked output is gathered over it.  Returns (T, d) in xt's
    dtype."""
    t = xt.shape[0]
    c = capacity(t) if cap is None else int(cap)
    x_loc = split_dim(xt, 1, spare)
    order, slot, valid, xe = _dispatch(x_loc, ids, wg.shape[0], e0, c)
    g = all_reduce_sum(torch.bmm(xe, wg), spare)
    u = all_reduce_sum(torch.bmm(xe, wu), spare)
    h = copy_to_model(F.silu(g) * u, spare)
    oe = torch.bmm(h, wd).reshape(-1, wd.shape[2])
    # each rank's combine weighs its d-block alone: the weights' gradient
    # is summed over the spare axes (then over "model", by the caller)
    y_loc = _combine(oe, ids, copy_to_model(probs, spare), order, slot, valid).to(xt.dtype)
    return gather_dim(y_loc, 1, spare)


def shared_ffn(p, xt: torch.Tensor) -> torch.Tensor:
    h = F.silu(xt @ p["sh_gate"]) * (xt @ p["sh_up"])
    return h @ p["sh_down"]


def spare_group(mesh, rules):
    """The 2-D path's group (``moe.py:243-251``): the mesh's axes but
    "model", those holding more than one rank, when ``rules`` leave the
    tokens replicated (their "batch" is None), else None."""
    from repro_torch.dist.partitioning import MODEL_AXIS, mesh_axes

    if mesh is None or rules.batch_axes():
        return None
    names, sizes = mesh_axes(mesh)
    spare = tuple(a for a, n in zip(names, sizes) if a != MODEL_AXIS and n > 1)
    if not spare:
        return None
    return mesh.get_group(spare[0] if len(spare) == 1 else spare)


def apply_moe(p, x: torch.Tensor, cfg: ArchConfig, train: bool = False, rt=None):
    """``apply_moe``, ``moe.py:214``: x (B, S, d) -> y (B, S, d), one
    dispatch over all B * S tokens; with ``train`` the training capacity and
    (y, aux).  With a Runtime ``rt`` whose mesh has a data group, x is this
    rank's rows: the capacity counts them alone, as the reference's
    ``shard_map`` block does (``moe.py:226-259``), and aux is the rank's
    share of the whole batch's (``route``).  With ``rt``'s "model" group
    (``cfg`` a rank's local config, ``expert_shards`` K) the expert-parallel
    path runs.  A config whose ``embed_shards`` is above 1 (the caller's
    choice, ``training.trainer.train_lm``) runs the 2-D path over
    ``spare_group(rt.mesh, rt.rules)`` (module docstring): every rank routes
    every token and the aux is the whole batch's."""
    b, s, d = x.shape
    moe = cfg.moe
    model = None if rt is None else rt.model_group()
    if (model is None) != (moe.expert_shards == 1):
        raise ValueError(f"a config of {moe.expert_shards} expert shard(s) on a runtime whose "
                         f"model group has {1 if model is None else group_size(model)} rank(s)")
    spare = None  # the tokens' replicas over the 2-D path's axes
    if moe.embed_shards > 1:
        if rt is not None and rt.rules is not None:
            spare = spare_group(rt.mesh, rt.rules)
        if spare is None or group_size(spare) != moe.embed_shards:
            raise ValueError(f"the experts' d_model in {moe.embed_shards} blocks over a 2-D "
                             f"group of {1 if spare is None else group_size(spare)} rank(s)")
    group = rt.data_group() if train and rt is not None and spare is None else None
    xt = copy_to_model(x.reshape(b * s, d), model)
    logits = gather_dim(xt.float() @ p["router"].float(), 1, model)
    routed = route_logits(logits, cfg, train=train, group=group)
    ids, probs = routed[0], copy_to_model(routed[1], model)
    cap = capacity(b * s, moe, train=True) if train else None
    e0 = 0 if model is None else group_rank(model) * p["w_gate"].shape[0]
    if spare is not None:
        y = dispatch_2d(xt, ids, probs, p["w_gate"], p["w_up"], p["w_down"], cap, e0, spare)
    else:
        y = dispatch_compute_combine(xt, ids, probs, p["w_gate"], p["w_up"], p["w_down"], cap,
                                     e0=e0)
    if moe.n_shared_experts:
        y = y + shared_ffn(p, xt)
    y = all_reduce_sum(y, model).reshape(b, s, d)
    return (y, routed[2]) if train else y
