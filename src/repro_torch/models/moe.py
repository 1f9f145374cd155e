"""Mixture-of-Experts FFN, the local eval path of ``repro/models/moe.py``:
a float32 router with top-k (renormalised where the config says so),
dropless dispatch into a fixed-shape (E, T, d) buffer, the experts' SwiGLU
as batched matrix products, the combine summed in float32, plus the shared
experts.

Dropless (``_capacity(train=False)``, ``moe.py:77-94``): every expert's
capacity is the number of tokens T, so no token is dropped and the buffer's
shape depends on T alone.  Tokens take their slots in a stable sort by
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

The combine adds each token's k weighted expert outputs in float32 in order
of expert id, the order of the reference's scatter-add, one addition at a
time: no atomics, so the same inputs give the same bits on the card.

Not ported: the expert-parallel ``shard_map`` and 2-D paths, the training
capacity and the router's aux loss (ROADMAP.md).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

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


def capacity(t: int) -> int:
    """Eval capacity per expert for a dispatch of ``t`` tokens: dropless."""
    return max(t, 1)


def route(p, x: torch.Tensor, cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router in float32, ``moe.py:97``: x (T, d) -> ids (T, k) int64, probs
    (T, k) float32."""
    moe = cfg.moe
    logits = x.float() @ p["router"].float()
    probs, ids = torch.topk(torch.softmax(logits, dim=-1), moe.top_k, dim=-1)
    if moe.norm_topk:
        probs = probs / torch.clamp(probs.sum(dim=-1, keepdim=True), min=1e-9)
    return ids, probs


def dispatch_compute_combine(xt: torch.Tensor, ids: torch.Tensor, probs: torch.Tensor,
                             wg: torch.Tensor, wu: torch.Tensor,
                             wd: torch.Tensor) -> torch.Tensor:
    """``moe.py:116-155`` on one device: xt (T, d), ids/probs (T, k), expert
    weights (E, d, f) / (E, f, d).  Returns (T, d) in xt's dtype."""
    t, d = xt.shape
    k = ids.shape[1]
    e = wg.shape[0]
    c = capacity(t)
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)  # (T*k,) grouped by expert
    sorted_ids = flat[order]
    ar = torch.arange(t * k, device=xt.device)
    is_new = torch.ones_like(sorted_ids, dtype=torch.bool)
    is_new[1:] = sorted_ids[1:] != sorted_ids[:-1]
    rank = ar - torch.cummax(torch.where(is_new, ar, 0), dim=0).values
    slot = sorted_ids * c + rank  # a token's k experts differ, so rank < c
    tok = order // k
    xbuf = xt.new_zeros((e * c, d))
    xbuf[slot] = xt[tok]
    xe = xbuf.reshape(e, c, d)
    h = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)
    oe = torch.bmm(h, wd).reshape(e * c, d)
    contrib = torch.empty((t * k, d), dtype=torch.float32, device=xt.device)
    contrib[order] = oe[slot].float() * probs.reshape(-1)[order].float()[:, None]
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


def apply_moe(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """``apply_moe(train=False)`` without a mesh, ``moe.py:214``: x (B, S, d)
    -> y (B, S, d), one dispatch over all B * S tokens."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    ids, probs = route(p, xt, cfg)
    y = dispatch_compute_combine(xt, ids, probs, p["w_gate"], p["w_up"], p["w_down"])
    if cfg.moe.n_shared_experts:
        y = y + shared_ffn(p, xt)
    return y.reshape(b, s, d)
