"""GQA attention for the dense archs: grouped KV heads, qk-norm (Qwen3),
QKV bias, partial rotary; prefill and chunked prefill through the flash
forward (K3), training through K3 and its backward (K3-bwd: ``apply_attention``
with grad enabled) and paged decode through paged flash decode (K2).  Counterparts
of ``repro/models/attention.py:70`` (``_project_qkv``), ``:98``
(``apply_attention``), ``:128`` (``apply_attention_decode_paged``), ``:167``
(``apply_attention_prefill_paged``) and ``:207`` (``apply_attention_decode``,
the contiguous cache's decode step: the plain ``decode_attention``, as the
reference's jnp one, whose length-0 rows get the mean of V where K5 gives
zeros).

The projections, qk-norm, rope and output projection run over row blocks of
fixed shape: ``rt.prefill_rows`` positions in prefill and chunked prefill,
``rt.decode_rows`` batch rows in decode (``repro_torch.models.runtime``).

Parameters are one layer's dict of tensors: ``wq`` (d, H*hd), ``wk`` and
``wv`` (d, Hk*hd), ``wo`` (H*hd, d), stored flattened as in the reference,
plus ``q_norm``/``k_norm`` (hd,) with qk-norm and ``bq``/``bk``/``bv`` with
QKV bias.

Under a mesh (``rt.mesh``) the model is a tensor-parallel rank's: ``cfg``
holds its local widths (its ``n_heads / K`` query and ``n_kv_heads / K`` KV
heads, the same group size G), the projections are its column slices and
``wo`` its row slice (``repro_torch.serve.sharding``), so every function
here, and K3 and K2 within, runs unchanged at the rank's heads; ``wo``'s
partial products are summed over the "model" group
(``repro_torch.dist.collectives.all_reduce_sum``).  In training
(``apply_attention`` under grad) the replicated input and the qk-norm
scales, which each rank applies to its heads only, enter through
``copy_to_model``, which sums their gradients over the group.

The contiguous decode (``apply_attention_decode``) also runs over a cache
split along its sequence (the long-context cell's rules, ``rt.seq_group()``):
each rank holds a block of positions, the rank holding the new token's
position writes its K/V (``write_owned``), and each rank's partial
(max, sum, p V: ``decode_partials``) is merged over the group in rank
order (``merge_partials``), so every rank gets the same bits; the reference
leaves this merge to GSPMD (``flash_attention/ops.py:253-258``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.collectives import all_reduce_sum, copy_to_model, gather_dim, group_rank
from repro_torch.kernels.flash_attention.ops import (
    decode_attention, decode_partials, flash_attention)
from repro_torch.kernels.flash_decode.ops import (
    paged_decode_attention,
    paged_prefill_attention,
)
from repro_torch.models.layers import apply_rope, by_batch, by_rows, rms_norm, row_blocks
from repro_torch.models.runtime import Runtime


def attention_shapes(cfg: ArchConfig) -> Dict[str, Tuple[Tuple[int, ...], str, float]]:
    """name -> (shape, init, scale) with the reference's initialisers
    (``attention.py:25-52``): normal * scale for the projections, ones for
    the norms, zeros for the biases."""
    d, h, k_, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s, so = 1.0 / math.sqrt(d), 1.0 / math.sqrt(h * hd)
    shapes = {
        "wq": ((d, h * hd), "normal", s),
        "wk": ((d, k_ * hd), "normal", s),
        "wv": ((d, k_ * hd), "normal", s),
        "wo": ((h * hd, d), "normal", so),
    }
    if cfg.qkv_bias:
        shapes.update({"bq": ((h * hd,), "zeros", 0.0), "bk": ((k_ * hd,), "zeros", 0.0),
                       "bv": ((k_ * hd,), "zeros", 0.0)})
    if cfg.qk_norm:
        shapes.update({"q_norm": ((hd,), "ones", 0.0), "k_norm": ((hd,), "ones", 0.0)})
    return shapes


def _project_qkv(p, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    b, s, _ = x.shape
    h, k_, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, k_, hd)
    v = v.reshape(b, s, k_, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, rotary_pct=cfg.rotary_pct, theta=cfg.rope_theta)
    k = apply_rope(k, positions, rotary_pct=cfg.rotary_pct, theta=cfg.rope_theta)
    return q, k, v


def apply_attention(p, x: torch.Tensor, cfg: ArchConfig, rt: Runtime, *,
                    kv_lens: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal prefill attention over x (B, S, d).  The projections, qk-norm
    and rope run over blocks of ``rt.prefill_rows`` positions, the flash
    forward over the whole sequence.  Returns (y (B, S, d), cache {"k", "v"}
    of shape (B, Hk, S, hd))."""
    b, s, _ = x.shape
    group = rt.model_group()
    x = copy_to_model(x, group)
    if cfg.qk_norm and group is not None:
        p = dict(p.items(), q_norm=copy_to_model(p["q_norm"], group),
                 k_norm=copy_to_model(p["k_norm"], group))
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    parts = [_project_qkv(p, x[:, r], cfg, positions[:, r])
             for r in row_blocks(s, rt.prefill_rows)]
    q, k, v = (torch.cat(t, dim=1) for t in zip(*parts))
    qt = q.transpose(1, 2).contiguous()  # (B, H, S, hd)
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    out = flash_attention(qt, kt, vt, causal=True, kv_lens=kv_lens,
                          block_q=rt.block_q, block_k=rt.block_k)
    out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)
    y = all_reduce_sum(by_rows(lambda o: o @ p["wo"], out, rt.prefill_rows), group)
    return y, {"k": kt, "v": vt}


def scatter_positions(page_tables: torch.Tensor, positions: torch.Tensor, page: int):
    """(page ids, offsets) of ``positions`` (B,) in the rows of ``page_tables``
    (B, npp); int64, for indexing the pools."""
    pid = page_tables.gather(1, (positions // page).long()[:, None])[:, 0].long()
    return pid, (positions % page).long()


def apply_attention_prefill_paged(p, x: torch.Tensor, cfg: ArchConfig, rt: Runtime,
                                  cache: Dict[str, torch.Tensor], page_tables: torch.Tensor,
                                  *, s0: int, n_valid: int, base: int) -> torch.Tensor:
    """One chunk of a chunked prefill: positions ``s0 .. s0 + n_valid - 1``
    of the request whose page-table row is ``page_tables`` (1, npp).

    x (1, S, d) is the prefill row blocks the chunk touches, row j at
    position ``base + j`` (``base`` a multiple of ``rt.prefill_rows``), so
    each position sits at the row of the block where a monolithic prefill
    puts it; the rows outside the chunk are padding.  The projections run
    over those blocks, the chunk's K/V are scattered into its pages, and the
    flash forward (K3) runs the chunk's queries over the gathered page row
    with ``q_offset = s0`` and ``kv_lens = s0 + n_valid``: key tiles from
    position 0, as in the monolithic prefill.  The reference's padded tail
    rows (``attention.py:190-193``) are not computed at all, so none is
    scattered.  Returns y (1, S, d), zero at the padding rows."""
    s = x.shape[1]
    positions = torch.arange(base, base + s, dtype=torch.int32, device=x.device)[None]
    parts = [_project_qkv(p, x[:, r], cfg, positions[:, r])
             for r in row_blocks(s, rt.prefill_rows)]
    q, k, v = (torch.cat(t, dim=1) for t in zip(*parts))
    rows = slice(s0 - base, s0 - base + n_valid)
    pid, offset = scatter_positions(page_tables.expand(n_valid, -1),
                                    positions[0, rows], rt.page_size)
    cache["k"][pid, :, offset] = k[0, rows].to(cache["k"].dtype)
    cache["v"][pid, :, offset] = v[0, rows].to(cache["v"].dtype)
    kv_lens = torch.full((1,), s0 + n_valid, dtype=torch.int32, device=x.device)
    out = paged_prefill_attention(q[:, rows].transpose(1, 2).contiguous(), cache["k"],
                                  cache["v"], kv_lens, page_tables, q_offset=s0,
                                  block_q=rt.block_q, block_k=rt.block_k)
    y = x.new_zeros((1, s, cfg.n_heads * cfg.head_dim))
    y[:, rows] = out.transpose(1, 2).reshape(1, n_valid, cfg.n_heads * cfg.head_dim)
    return all_reduce_sum(by_rows(lambda o: o @ p["wo"], y, rt.prefill_rows), rt.model_group())


def apply_attention_decode_paged(p, x: torch.Tensor, cfg: ArchConfig, rt: Runtime,
                                 cache: Dict[str, torch.Tensor], lengths: torch.Tensor,
                                 page_tables: torch.Tensor) -> torch.Tensor:
    """Paged-KV decode of one new token per row, x (B, 1, d): scatter every
    row's new K/V into its page, then attend over the pool with
    ``lengths + 1``, one call over all B rows.  The projections run over
    blocks of ``rt.decode_rows`` rows.  A speculative verify step's fold
    puts rows of one sequence at consecutive positions: all are scattered
    before any attends, so each sees the ones before it.

    The reference's scatter (``attention.py:154-157``) is functional and
    returns new pools; the port writes ``cache``'s pools in place.  Idle
    slots all write page 0 (the scratch page), offset 0, in the same step;
    that is harmless because no live row ever reads page 0."""
    b = x.shape[0]
    rows = rt.decode_rows or b
    lengths = lengths.to(torch.int32)
    parts = [_project_qkv(p, x[r], cfg, lengths[r, None]) for r in row_blocks(b, rows)]
    q, k, v = (torch.cat(t, dim=0) for t in zip(*parts))
    pid, offset = scatter_positions(page_tables, lengths, rt.page_size)
    cache["k"][pid, :, offset] = k[:, 0].to(cache["k"].dtype)
    cache["v"][pid, :, offset] = v[:, 0].to(cache["v"].dtype)
    out = paged_decode_attention(q[:, 0].contiguous(), cache["k"], cache["v"], lengths + 1,
                                 page_tables, impl=rt.paged_impl,
                                 pages_per_program=rt.pages_per_program)
    y = by_batch(lambda o: o.reshape(o.shape[0], cfg.n_heads * cfg.head_dim) @ p["wo"], out,
                 rows)
    return all_reduce_sum(y, rt.model_group())[:, None, :]


def write_owned(cache: torch.Tensor, new: torch.Tensor, local: torch.Tensor,
                seq_dim: int) -> None:
    """Write each row's ``new`` (B, ...) at its position ``local`` (B,) of
    ``cache`` (B, ..., S_block, ...) along ``seq_dim``, in place, where the
    position falls inside this rank's block (0 <= local < S_block); other
    rows keep what they hold (no data-dependent shape: the "meta" device
    runs it too)."""
    n = cache.shape[seq_dim]
    at = torch.arange(cache.shape[0], device=cache.device)
    pos = local.long().clamp(0, n - 1)
    index = (at,) + (slice(None),) * (seq_dim - 1) + (pos,)
    own = ((local >= 0) & (local < n)).reshape(-1, *([1] * (new.dim() - 1)))
    cache[index] = torch.where(own, new.to(cache.dtype), cache[index])


def merge_partials(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor, group) -> torch.Tensor:
    """Merge attention partials over ``group``: each rank's running max
    ``m``, sum ``l`` (both (..., 1), float32) and unnormalised output ``o``
    (..., D) over its block of positions, gathered to every rank and summed
    in rank order at the common max, then normalised (``max(l, 1e-30)``, as
    ``decode_attention``); every rank computes the same bits.  Returns
    (..., D) float32."""
    parts = gather_dim(torch.cat([m, l, o], dim=-1)[None], 0, group)
    top = parts[..., :1].amax(dim=0)
    total = out = None
    for r in range(parts.shape[0]):
        a = torch.exp(parts[r, ..., :1] - top)
        term_l, term_o = parts[r, ..., 1:2] * a, parts[r, ..., 2:] * a
        total = term_l if total is None else total + term_l
        out = term_o if out is None else out + term_o
    return out / torch.clamp(total, min=1e-30)


def split_decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           lengths: torch.Tensor, group, sm_scale=None) -> torch.Tensor:
    """``decode_attention`` over a cache whose sequence is split over
    ``group``: ``k_cache``/``v_cache`` (B, Hk, S_block, D) this rank's block,
    ``lengths`` (B,) the valid positions counted from the block's start
    (<= 0: none here).  The rank's partial (``decode_partials``) is merged
    over the group (``merge_partials``).  A row with no valid position
    anywhere gets the mean of V, as ``decode_attention``.  Returns
    (B, Hq, D) in q's dtype."""
    out = merge_partials(*decode_partials(q, k_cache, v_cache, lengths, sm_scale), group)
    return out.reshape(q.shape[0], q.shape[1], v_cache.shape[-1]).to(q.dtype)


def apply_attention_decode(p, x: torch.Tensor, cfg: ArchConfig, rt: Runtime,
                           cache: Dict[str, torch.Tensor], lengths: torch.Tensor
                           ) -> torch.Tensor:
    """Decode of one new token per row, x (B, 1, d), against the contiguous
    cache {"k", "v"} (B, Hk, max_seq, hd) (``LM.init_cache``, or a prefill's
    cache), which it updates in place: each row's new K/V written at its
    length, then ``decode_attention`` over ``lengths + 1`` positions.  The
    reference's write (``attention.py:222-226``) is functional.  The
    projections run over blocks of ``rt.decode_rows`` rows.

    Under a sequence split (``rt.seq_group()``, the long-context cell) the
    cache is the rank's block of positions: the rank that holds position
    ``lengths`` writes the new token's K/V, every rank attends over its
    block (``split_decode_attention``), and the partials are merged over
    the group in rank order."""
    b = x.shape[0]
    rows = rt.decode_rows or b
    lengths = lengths.to(torch.int32)
    parts = [_project_qkv(p, x[r], cfg, lengths[r, None]) for r in row_blocks(b, rows)]
    q, k, v = (torch.cat(t, dim=0) for t in zip(*parts))
    seq = rt.seq_group()
    if seq is None:
        at = torch.arange(b, device=x.device)
        cache["k"][at, :, lengths.long()] = k[:, 0].to(cache["k"].dtype)
        cache["v"][at, :, lengths.long()] = v[:, 0].to(cache["v"].dtype)
        out = decode_attention(q[:, 0], cache["k"], cache["v"], lengths + 1)
    else:
        local = lengths - group_rank(seq) * cache["k"].shape[2]
        write_owned(cache["k"], k[:, 0], local, seq_dim=2)
        write_owned(cache["v"], v[:, 0], local, seq_dim=2)
        out = split_decode_attention(q[:, 0], cache["k"], cache["v"], local + 1, seq)
    y = by_batch(lambda o: o.reshape(o.shape[0], cfg.n_heads * cfg.head_dim) @ p["wo"], out,
                 rows)
    return all_reduce_sum(y, rt.model_group())[:, None, :]
