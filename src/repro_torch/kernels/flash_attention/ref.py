"""Plain PyTorch version of the blocked flash forward (K3).

Ports ``repro/kernels/flash_attention/ops.py::_flash_fwd_impl``: the same
per-row arithmetic (float32 scores, masks, online softmax over key tiles of
``block_k`` positions, masked tiles as exact no-ops, output
``acc / max(l, 1e-30)`` cast to q's type).  The reference scans query blocks
one at a time; here every query tile runs at once and only the key tiles are
looped, which is the same per-row arithmetic with far fewer launches.

Queries are cut into tiles of ``block_q`` rows and every product is one
batched matmul of fixed per-tile shape, so a row's result depends only on
its own q, the keys and values at positions it may see, and the fixed key
tiles from position 0: not on Sq or the batch.  (A single (Sq, D) x (D, bk)
product would not give that on the CPU, where the product's kernel, and so
the order of its sums, depends on Sq.)  The serve engine's prefix guarantee
rests on this.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_fwd_ref(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hk, Skv, D)
    v: torch.Tensor,  # (B, Hk, Skv, Dv)
    kv_lens: torch.Tensor,  # (B,) valid key positions
    *,
    causal: bool,
    sm_scale: float,
    q_offset: int,
    block_q: int,
    block_k: int,
) -> torch.Tensor:
    """Returns (B, Hq, Sq, Dv) in q's dtype."""
    b, hq, sq, d = q.shape
    _, hk, skv, _ = k.shape
    dv = v.shape[3]
    g = hq // hk
    nq = -(-sq // block_q)
    nk = -(-skv // block_k)
    dev = q.device
    # (B, Hk, G, nq*bq, D) -> (B, Hk, nq, G*bq, D): one row block per tile
    qf = q.float().reshape(b, hk, g, sq, d)
    qf = torch.nn.functional.pad(qf, (0, 0, 0, nq * block_q - sq))
    qf = qf.reshape(b, hk, g, nq, block_q, d).permute(0, 1, 3, 2, 4, 5)
    qf = qf.reshape(b, hk, nq, g * block_q, d).contiguous()
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, nk * block_k - skv))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, nk * block_k - skv))
    lens = torch.clamp(kv_lens.to(device=dev, dtype=torch.int64), max=skv)  # (B,)
    # absolute query position of every (tile, row): (nq, G*bq)
    q_pos = (q_offset + torch.arange(nq, device=dev)[:, None] * block_q
             + torch.arange(block_q, device=dev).repeat(g)[None, :])
    kv_pos = torch.arange(block_k, device=dev)

    acc = torch.zeros((b, hk, nq, g * block_q, dv), dtype=torch.float32, device=dev)
    m = torch.full((b, hk, nq, g * block_q), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hk, nq, g * block_q), dtype=torch.float32, device=dev)
    for j in range(nk):
        kj = kf[:, :, j * block_k:(j + 1) * block_k].contiguous()  # (B, Hk, bk, D)
        vj = vf[:, :, j * block_k:(j + 1) * block_k].contiguous()
        s = torch.matmul(qf, kj[:, :, None].transpose(-1, -2)) * sm_scale  # (B,Hk,nq,R,bk)
        kpos = j * block_k + kv_pos  # (bk,)
        mask = (kpos[None, :] < lens[:, None])[:, None, None, None, :]  # (B,1,1,1,bk)
        if causal:
            mask = mask & (q_pos[:, :, None] >= kpos[None, None, :])[None, None]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p, vj[:, :, None])
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]  # (B, Hk, nq, G*bq, Dv)
    out = out.reshape(b, hk, nq, g, block_q, dv).permute(0, 1, 3, 2, 4, 5)
    out = out.reshape(b, hq, nq * block_q, dv)[:, :, :sq]
    return out.to(q.dtype)
