"""Shared model layers: RMSNorm, NeoX rotary embeddings, SwiGLU MLP, the LM
head and the training loss (counterparts of ``repro/models/layers.py``; the
embedding lookup is ``repro_torch.dist.collectives.vocab_parallel_embed``).

The reference keeps float32 master weights and casts them to ``cfg.dtype`` at
each use.  The port stores each matrix in ``cfg.dtype`` once (norm scales stay
float32, as the reference reads them): the cast is elementwise and
deterministic, so this gives the same bits as casting at each use.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """float32 inside, as ``layers.py:23``; returns x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * scale.float()
    return y.to(x.dtype)


def rope_angles(positions: torch.Tensor, rot_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) int -> cos/sin of shape (..., S, rot_dim // 2)."""
    half = rot_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    # theta stays a Python scalar: a tensor made from it would be copied to
    # the card at every call, and that copy waits for the queued work
    inv_freq = 1.0 / torch.pow(theta, exponent)
    ang = positions.float()[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, rotary_pct: float = 1.0,
               theta: float = 10_000.0) -> torch.Tensor:
    """NeoX half rotation (``layers.py:44``).  x (B, S, H, D); positions
    (B, S) or (S,)."""
    d = x.shape[-1]
    rot_dim = int(d * rotary_pct)
    rot_dim -= rot_dim % 2
    if rot_dim == 0:
        return x
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    cos, sin = rope_angles(positions, rot_dim, theta)
    if cos.dim() == 2:  # (S, rot/2) -> broadcast batch
        cos, sin = cos[None], sin[None]
    cos = cos[:, :, None, :]  # (B, S, 1, rot/2)
    sin = sin[:, :, None, :]
    half = rot_dim // 2
    x1 = x_rot[..., :half].float()
    x2 = x_rot[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


def apply_mlp(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: silu(x W_gate) * (x W_up), then W_down."""
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


def row_blocks(n: int, rows: int) -> List[slice]:
    """Slices cutting ``n`` positions (or batch rows) into blocks of ``rows``."""
    return [slice(i, min(i + rows, n)) for i in range(0, n, rows)]


def by_rows(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
            rows: int) -> torch.Tensor:
    """``fn`` applied to x (B, S, ...) one block of ``rows`` positions at a
    time: with S a multiple of ``rows``, every call sees one fixed shape."""
    if x.shape[1] <= rows:
        return fn(x)
    return torch.cat([fn(x[:, r]) for r in row_blocks(x.shape[1], rows)], dim=1)


def by_batch(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
             rows: int) -> torch.Tensor:
    """``fn`` applied to x (B, ...) one block of ``rows`` batch rows at a
    time: with B a multiple of ``rows``, every call sees one fixed shape."""
    if x.shape[0] <= rows:
        return fn(x)
    return torch.cat([fn(x[r]) for r in row_blocks(x.shape[0], rows)], dim=0)


def lm_logits(head: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x @ head


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy with a float32 log-sum-exp
    (``layers.py:110-121``): logits (..., V), labels (...,) int; with
    ``mask`` (...,) the masked mean ``sum(nll * mask) / max(sum(mask), 1)``."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
