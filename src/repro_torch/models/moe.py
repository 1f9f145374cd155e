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

Not ported: the expert-parallel ``shard_map`` and 2-D paths (ROADMAP.md).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig

# parameters stored (and read) in float32 whatever the config's dtype: the
# router decides the top-k, where a bf16 rounding would flip near ties
FLOAT32_PARAMS = frozenset({"router"})


def moe_shapes(cfg: ArchConfig) -> Dict[str, Tuple[Tuple[int, ...], str, float]]:
    """name -> (shape, init, scale), the reference's (``moe.py:56-74``)."""
    moe = cfg.moe
    d, e, f = cfg.d_model, moe.n_routed_experts, moe.expert_d_ff
    s_in, s_ff = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    shapes = {
        "router": ((d, e), "normal", s_in),
        "w_gate": ((e, d, f), "normal", s_in),
        "w_up": ((e, d, f), "normal", s_in),
        "w_down": ((e, f, d), "normal", s_ff),
    }
    if moe.n_shared_experts:
        fs = moe.n_shared_experts * f
        shapes.update({"sh_gate": ((d, fs), "normal", s_in),
                       "sh_up": ((d, fs), "normal", s_in),
                       "sh_down": ((fs, d), "normal", 1.0 / math.sqrt(fs))})
    return shapes


def capacity(t: int, moe: Optional[MoEConfig] = None, train: bool = False) -> int:
    """Capacity per expert for a dispatch of ``t`` tokens (``_capacity``):
    dropless in eval; in training the Switch/GShard
    ceil(t k / E x capacity_factor), at least 1."""
    if not train:
        return max(t, 1)
    cap = int(math.ceil(t * moe.top_k / moe.n_routed_experts * moe.capacity_factor))
    return max(cap, 1)


def route(p, x: torch.Tensor, cfg: ArchConfig, train: bool = False):
    """Router in float32, ``moe.py:97``: x (T, d) -> ids (T, k) int64, probs
    (T, k) float32, and with ``train`` the aux loss (a float32 0-d tensor,
    0 where the config's ``router_aux_loss`` is 0) as a third value."""
    moe = cfg.moe
    logits = x.float() @ p["router"].float()
    probs_full = torch.softmax(logits, dim=-1)
    probs, ids = torch.topk(probs_full, moe.top_k, dim=-1)
    if moe.norm_topk:
        probs = probs / torch.clamp(probs.sum(dim=-1, keepdim=True), min=1e-9)
    if not train:
        return ids, probs
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if moe.router_aux_loss > 0:
        e = moe.n_routed_experts
        me = probs_full.reshape(-1, e).mean(0)
        fe = F.one_hot(ids.reshape(-1), e).float().mean(0)
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


def dispatch_compute_combine(xt: torch.Tensor, ids: torch.Tensor, probs: torch.Tensor,
                             wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
                             cap: Optional[int] = None) -> torch.Tensor:
    """``moe.py:116-155`` on one device: xt (T, d), ids/probs (T, k), expert
    weights (E, d, f) / (E, f, d), ``cap`` tokens an expert (dropless,
    ``capacity(T)``, when None).  An assignment whose rank among its
    expert's (in the stable sort by expert) reaches the capacity is dropped:
    its input goes to the buffer's extra row E c, whose product is never
    taken, it reads the last expert's last output row, and its weight, so its
    term, is 0.  Returns (T, d) in xt's dtype."""
    t, d = xt.shape
    k = ids.shape[1]
    e = wg.shape[0]
    c = capacity(t) if cap is None else int(cap)
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)  # (T*k,) grouped by expert
    sorted_ids = flat[order]
    ar = torch.arange(t * k, device=xt.device)
    is_new = torch.ones_like(sorted_ids, dtype=torch.bool)
    is_new[1:] = sorted_ids[1:] != sorted_ids[:-1]
    rank = ar - torch.cummax(torch.where(is_new, ar, 0), dim=0).values
    valid = rank < c  # dropless: a token's k experts differ, so rank < T
    slot = torch.where(valid, sorted_ids * c + rank, e * c)
    xbuf = xt.new_zeros((e * c + 1, d))
    xbuf[slot] = _RepeatRows.apply(xt, k)[order]
    xe = xbuf[:e * c].reshape(e, c, d)
    h = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)
    oe = torch.bmm(h, wd).reshape(e * c, d)
    weight = torch.where(valid, probs.reshape(-1)[order].float(), 0.0)
    contrib = torch.empty((t * k, d), dtype=torch.float32, device=xt.device)
    contrib[order] = oe[slot.clamp(max=e * c - 1)].float() * weight[:, None]
    # each token's k terms in order of expert id, added one at a time
    by_expert = torch.argsort(ids, dim=1, stable=True)
    terms = contrib.reshape(t, k, d).gather(1, by_expert[:, :, None].expand(t, k, d))
    y = terms[:, 0]
    for j in range(1, k):
        y = y + terms[:, j]
    return y.to(xt.dtype)


def shared_ffn(p, xt: torch.Tensor) -> torch.Tensor:
    h = F.silu(xt @ p["sh_gate"]) * (xt @ p["sh_up"])
    return h @ p["sh_down"]


def apply_moe(p, x: torch.Tensor, cfg: ArchConfig, train: bool = False):
    """``apply_moe`` without a mesh, ``moe.py:214``: x (B, S, d) -> y (B, S,
    d), one dispatch over all B * S tokens; with ``train`` the training
    capacity and (y, aux)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    if train:
        ids, probs, aux = route(p, xt, cfg, train=True)
        cap = capacity(b * s, cfg.moe, train=True)
    else:
        ids, probs = route(p, xt, cfg)
        cap = None
    y = dispatch_compute_combine(xt, ids, probs, p["w_gate"], p["w_up"], p["w_down"], cap)
    if cfg.moe.n_shared_experts:
        y = y + shared_ffn(p, xt)
    y = y.reshape(b, s, d)
    return (y, aux) if train else y
