"""Plain PyTorch versions of paged flash decode (K2) and contiguous flash
decode (K5).

Ports ``repro/kernels/flash_decode/ops.py``'s ``_stream_core`` (:126) and
``_gather_core`` (:161) with their shared ``_block_update`` (:96) and
``_paged_prep``: ``pages_per_program`` pages make one score block, reduced
with an online softmax in float32.  ``stream`` gathers only the current
group's pages and stops at the longest live row; ``gather`` builds the dense
(B, Hk, npp * page, d) view and runs every group.  Both hand
``_block_update`` contiguous float32 blocks of the same shapes, so they are
bitwise equal to each other (DESIGN.md §10 requires it of the reference);
the groups ``gather`` runs past a row's length are exact no-ops.

The optional ``q_pe`` / ``kpe_pages`` term is the MLA absorbed-latent path's
(``paged_latent_decode_attention``): scores ``q . k + q_pe . kpe``, then the
scale, as the reference's ``_block_update`` adds them.

``flash_decode_ref`` is K5's: the blocked math of
``repro/kernels/flash_decode/kernel.py::_decode_kernel`` (:46) over the
padded cache, through the same ``_block_update``.
"""
from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e30


def _block_update(q, k_blk, v_blk, start: int, length, scale: float, acc, m, l,
                  qpe=None, kpe_blk=None):
    """One online-softmax block update: q (B, Hk, G, d), blocks
    (B, Hk, blk, d), running acc (B, Hk, G, dv), m and l (B, Hk, G); with
    ``qpe`` (B, Hk, G, dr) the score term against ``kpe_blk`` (B, Hk, blk,
    dr) is added before the scale."""
    blk = k_blk.shape[-2]
    s = torch.einsum("bkgd,bkpd->bkgp", q, k_blk)
    if qpe is not None:
        s = s + torch.einsum("bkgd,bkpd->bkgp", qpe, kpe_blk)
    s = s * scale
    pos = start + torch.arange(blk, device=q.device)
    valid = (pos[None, :] < length[:, None])[:, None, None, :]  # (B, 1, 1, blk)
    s = torch.where(valid, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum("bkgp,bkpd->bkgd", p, v_blk)
    return acc_new, m_new, l_new


def paged_prep(page_tables: torch.Tensor, pages_per_program: int) -> Tuple[torch.Tensor, int, int]:
    """Clamp ppp to the table width and pad the table with the scratch page
    to a multiple of it.  Returns (table, ppp, n_groups)."""
    n_pp = page_tables.shape[1]
    ppp = max(1, min(int(pages_per_program), n_pp))
    padc = (-n_pp) % ppp
    if padc:  # padded positions are masked out
        page_tables = torch.nn.functional.pad(page_tables, (0, padc))
    return page_tables.long(), ppp, page_tables.shape[1] // ppp


def _init(b, hk, g, dv, device):
    return (torch.zeros((b, hk, g, dv), dtype=torch.float32, device=device),
            torch.full((b, hk, g), NEG_INF, dtype=torch.float32, device=device),
            torch.zeros((b, hk, g), dtype=torch.float32, device=device))


def _blocked(tile: torch.Tensor, b: int, hk: int, blk: int) -> torch.Tensor:
    """(B, ppp, Hk, page, d) -> contiguous float32 (B, Hk, ppp * page, d)."""
    return tile.movedim(2, 1).reshape(b, hk, blk, tile.shape[-1]).float().contiguous()


def paged_decode_stream(q, k_pages, v_pages, lengths, page_tables, *, scale: float,
                        pages_per_program: int, q_pe=None, kpe_pages=None) -> torch.Tensor:
    """q (B, Hk, G, d); pools (n_pages, Hk, page, d); lengths (B,);
    page_tables (B, npp); optional q_pe (B, Hk, G, dr) and kpe_pages
    (n_pages, Hk, page, dr).  Returns (B, Hk, G, dv) in q's dtype."""
    b, hk, g, _ = q.shape
    page = k_pages.shape[2]
    n_pages = k_pages.shape[0]
    table, ppp, n_groups = paged_prep(page_tables, pages_per_program)
    table = table.clamp(0, n_pages - 1)  # the reference's gather clamps
    blk = ppp * page
    qf = q.float()
    qpef = None if q_pe is None else q_pe.float()
    lens = lengths.to(torch.int64)
    hi = min(-(-int(lens.max()) // blk), n_groups) if b else 0
    acc, m, l = _init(b, hk, g, v_pages.shape[3], q.device)
    for j in range(hi):
        pids = table[:, j * ppp:(j + 1) * ppp]  # (B, ppp)
        k_blk = _blocked(k_pages[pids], b, hk, blk)
        v_blk = _blocked(v_pages[pids], b, hk, blk)
        kpe_blk = None if q_pe is None else _blocked(kpe_pages[pids], b, hk, blk)
        acc, m, l = _block_update(qf, k_blk, v_blk, j * blk, lens, scale, acc, m, l,
                                  qpef, kpe_blk)
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def paged_decode_gather(q, k_pages, v_pages, lengths, page_tables, *, scale: float,
                        pages_per_program: int, q_pe=None, kpe_pages=None) -> torch.Tensor:
    """The gather oracle: the dense (B, Hk, npp * page, d) views first, then
    the same blocked online softmax over every group."""
    b, hk, g, _ = q.shape
    page = k_pages.shape[2]
    n_pages = k_pages.shape[0]
    table, ppp, n_groups = paged_prep(page_tables, pages_per_program)
    table = table.clamp(0, n_pages - 1)
    blk = ppp * page
    s_cap = n_groups * blk

    def full(pool):
        return pool[table].movedim(2, 1).reshape(b, hk, s_cap, pool.shape[-1])

    def blocked(dense, j):
        return dense[:, :, j * blk:(j + 1) * blk].float().contiguous()

    k_full, v_full = full(k_pages), full(v_pages)
    kpe_full = None if q_pe is None else full(kpe_pages)
    qf = q.float()
    qpef = None if q_pe is None else q_pe.float()
    lens = lengths.to(torch.int64)
    acc, m, l = _init(b, hk, g, v_pages.shape[3], q.device)
    for j in range(n_groups):
        k_blk, v_blk = blocked(k_full, j), blocked(v_full, j)
        kpe_blk = None if kpe_full is None else blocked(kpe_full, j)
        acc, m, l = _block_update(qf, k_blk, v_blk, j * blk, lens, scale, acc, m, l,
                                  qpef, kpe_blk)
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def flash_decode_ref(q, k_cache, v_cache, lengths, *, sm_scale: float,
                     block_k: int) -> torch.Tensor:
    """q (B, Hq, d); caches (B, Hk, S, d) with Hq = G * Hk, query head h
    reading KV head h // G; lengths (B,).  Tiles of ``min(block_k, S)``
    positions over the cache padded to a multiple of them, a running max,
    sum and accumulator in float32, p kept in float32, positions at or past
    ``lengths[b]`` masked (a row of length 0 gives zeros).  Lengths are
    clamped to [0, S], as the kernel clamps them.  Returns (B, Hq, d) in q's
    dtype."""
    b, hq, d = q.shape
    _, hk, s, _ = k_cache.shape
    if hq % hk:
        raise ValueError(f"Hq={hq} not a multiple of Hk={hk}")
    g = hq // hk
    bk = max(1, min(int(block_k), s))
    qf = q.reshape(b, hk, g, d).float()
    lens = lengths.to(torch.int64).clamp(0, s)
    acc, m, l = _init(b, hk, g, v_cache.shape[3], q.device)
    for start in range(0, s, bk):
        pad = max(0, start + bk - s)  # the last tile, padded with zeros (masked)
        k_blk = torch.nn.functional.pad(k_cache[:, :, start:start + bk].float(), (0, 0, 0, pad))
        v_blk = torch.nn.functional.pad(v_cache[:, :, start:start + bk].float(), (0, 0, 0, pad))
        acc, m, l = _block_update(qf, k_blk, v_blk, start, lens, sm_scale, acc, m, l)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, v_cache.shape[3]).to(q.dtype)
