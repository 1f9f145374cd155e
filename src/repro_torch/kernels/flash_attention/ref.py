"""Plain PyTorch versions of the blocked flash forward (K3) and of its
backward (K3-bwd).

``flash_fwd_ref`` ports ``repro/kernels/flash_attention/ops.py::_flash_fwd_impl``:
the same per-row arithmetic (float32 scores, masks, online softmax over key
tiles of ``block_k`` positions, masked tiles as exact no-ops, output
``acc / max(l, 1e-30)`` cast to q's type, and on request the float32
log-sum-exp ``m + log(max(l, 1e-30))`` per row).  ``flash_bwd_ref`` ports
``_flash_bwd`` (``ops.py:118``).  The reference scans query blocks
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
    return_lse: bool = False,
):
    """Returns (B, Hq, Sq, Dv) in q's dtype, and with ``return_lse`` also
    the rows' log-sum-exp (B, Hq, Sq) in float32."""
    b, hq, sq, d = q.shape
    _, hk, skv, _ = k.shape
    dv = v.shape[3]
    g = hq // hk
    nq = -(-sq // block_q)
    nk = -(-skv // block_k)
    dev = q.device
    qf = _to_tiles(q, hk, block_q)  # (B, Hk, nq, G*bq, D): one row block per tile
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
    out = _from_tiles(out, g, block_q, sq).to(q.dtype)
    if not return_lse:
        return out
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    return out, _from_tiles(lse[..., None], g, block_q, sq)[..., 0]


def _to_tiles(x: torch.Tensor, hk: int, block_q: int) -> torch.Tensor:
    """(B, Hk*G, Sq, D) -> (B, Hk, nq, G*bq, D) in float32, zero-padded to
    whole query tiles: one row block per (KV head, query tile)."""
    b, hq, sq, d = x.shape
    g, nq = hq // hk, -(-sq // block_q)
    xf = torch.nn.functional.pad(x.float().reshape(b, hk, g, sq, d),
                                 (0, 0, 0, nq * block_q - sq))
    xf = xf.reshape(b, hk, g, nq, block_q, d).permute(0, 1, 3, 2, 4, 5)
    return xf.reshape(b, hk, nq, g * block_q, d).contiguous()


def _from_tiles(x: torch.Tensor, g: int, block_q: int, sq: int) -> torch.Tensor:
    """The inverse of ``_to_tiles``: (B, Hk, nq, G*bq, D) -> (B, Hk*G, Sq, D)."""
    b, hk, nq, _, d = x.shape
    x = x.reshape(b, hk, nq, g, block_q, d).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hk * g, nq * block_q, d)[:, :, :sq]


def flash_bwd_ref(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hk, Skv, D)
    v: torch.Tensor,  # (B, Hk, Skv, Dv)
    kv_lens: torch.Tensor,  # (B,)
    out: torch.Tensor,  # (B, Hq, Sq, Dv), the forward's output
    lse: torch.Tensor,  # (B, Hq, Sq) float32, the forward's log-sum-exp
    dout: torch.Tensor,  # (B, Hq, Sq, Dv)
    *,
    causal: bool,
    sm_scale: float,
    q_offset: int,
    block_q: int,
    block_k: int,
):
    """(dq, dk, dv) in q's, k's and v's dtypes, with the arithmetic of the
    reference's ``_flash_bwd``: everything in float32, key tiles of
    ``block_k`` positions in order, each tile's ``p = exp(s - lse)`` masked
    to 0, ``delta = rowsum(dout * out)``, ``ds = p (dp - delta)``;
    ``dq = sum_j ds_j k_j scale``, ``dv = sum p^T dout`` and
    ``dk = sum ds^T q scale``, each KV head's sums taken over its G query
    heads (GQA) and every query tile at once."""
    b, hq, sq, d = q.shape
    _, hk, skv, _ = k.shape
    dv_dim = v.shape[3]
    g = hq // hk
    nq = -(-sq // block_q)
    nk = -(-skv // block_k)
    dev = q.device
    qf = _to_tiles(q, hk, block_q)  # (B, Hk, nq, R, D), R = G * bq
    dof = _to_tiles(dout, hk, block_q)
    delta = (dout.float() * out.float()).sum(dim=-1)  # (B, Hq, Sq)
    dlf = _to_tiles(delta[..., None], hk, block_q)[..., 0]  # (B, Hk, nq, R)
    lsef = _to_tiles(lse[..., None], hk, block_q)[..., 0]
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, nk * block_k - skv))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, nk * block_k - skv))
    lens = torch.clamp(kv_lens.to(device=dev, dtype=torch.int64), max=skv)
    q_pos = (q_offset + torch.arange(nq, device=dev)[:, None] * block_q
             + torch.arange(block_q, device=dev).repeat(g)[None, :])  # (nq, R)
    kv_pos = torch.arange(block_k, device=dev)

    dq = torch.zeros_like(qf)
    dk = torch.zeros((b, hk, nk * block_k, d), dtype=torch.float32, device=dev)
    dv = torch.zeros((b, hk, nk * block_k, dv_dim), dtype=torch.float32, device=dev)
    for j in range(nk):
        cols = slice(j * block_k, (j + 1) * block_k)
        kj, vj = kf[:, :, cols], vf[:, :, cols]  # (B, Hk, bk, D)
        s = torch.matmul(qf, kj[:, :, None].transpose(-1, -2)) * sm_scale  # (B,Hk,nq,R,bk)
        kpos = j * block_k + kv_pos
        mask = (kpos[None, :] < lens[:, None])[:, None, None, None, :]
        if causal:
            mask = mask & (q_pos[:, :, None] >= kpos[None, None, :])[None, None]
        s = torch.where(mask, s, NEG_INF)
        p = torch.where(mask, torch.exp(s - lsef[..., None]), 0.0)
        dp = torch.matmul(dof, vj[:, :, None].transpose(-1, -2))
        ds = p * (dp - dlf[..., None])
        dq = dq + torch.matmul(ds, kj[:, :, None]) * sm_scale
        # (B, Hk, nq * R, bk)^T (B, Hk, nq * R, D): the group's and every
        # query tile's rows summed in one product
        pf = p.reshape(b, hk, nq * g * block_q, block_k)
        dsf = ds.reshape(b, hk, nq * g * block_q, block_k)
        dv[:, :, cols] = torch.matmul(pf.transpose(-1, -2), dof.reshape(b, hk, -1, dv_dim))
        dk[:, :, cols] = torch.matmul(dsf.transpose(-1, -2), qf.reshape(b, hk, -1, d)) * sm_scale
    dq = _from_tiles(dq, g, block_q, sq)
    return (dq.to(q.dtype), dk[:, :, :skv].to(k.dtype), dv[:, :, :skv].to(v.dtype))
