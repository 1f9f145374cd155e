"""Multi-head Latent Attention (DeepSeek-V2): the counterpart of
``repro/models/mla.py``'s prefill, its training forward and its serving
paths.

Queries come through a low-rank bottleneck (``wq_a``, ``q_a_norm``,
``wq_b``); keys and values through one compressed latent ``c_kv`` of width
``kv_lora_rank`` (``wkv_a``, ``kv_a_norm``) and one rotary key slice ``k_pe``
shared by every head.  The cache holds only (c_kv, k_pe): the MLA memory win.

* ``apply_mla`` (prefill and training, ``mla.py:107``, modes "prefill" and
  "train"): K and V re-expanded from the latent by ``wkv_b``, then MHA
  causal attention with qk dim nope + rope and v dim ``v_head_dim`` on the
  flash forward (K3 with dk 192, dv 128 at full width).  The projections,
  norms and rope run over blocks of ``rt.prefill_rows`` positions, as
  ``attention.apply_attention`` does.  Under grad it is differentiable: the
  attention takes its gradient through the flash backward (K3-bwd at (192,
  128), or (24, 16) in the smoke config), and ``blocks.apply_block_train``
  drops the cache it returns.
* ``apply_mla_decode_paged`` (``mla.py:180``, the absorbed path): scatter the
  new token's (c_kv, k_pe) into its page, fold ``W_uk`` into the query
  (``q_lat``), attend in latent space over the latent pool in place (K2's
  latent form: scores against c_kv and k_pe, context against c_kv), then
  ``W_uv`` and ``wo``.  ``q_lat`` is computed in the config's dtype and the
  latent context rounded to it before ``W_uv``, as the reference does.

* ``apply_mla_prefill_paged`` (chunked prefill, ``mla.py:239``): the
  chunk's latents scattered into the latent pages, K/V re-expanded from the
  gathered latent row block by block from position 0, as ``apply_mla``
  re-expands them, then K3 with ``q_offset``.

The row-wise steps run over row blocks of fixed shape: ``rt.prefill_rows``
positions in prefill and chunked prefill, ``rt.decode_rows`` batch rows in
decode (``repro_torch.models.runtime``).

* ``apply_mla_decode`` (``mla.py:147``): the contiguous latent cache's
  decode step (``LM.decode_step``), the new latents written at each row's
  length, then ``_mla_decode_attn`` (``mla.py:295``) over the row, absorbed
  (``rt.mla_absorb``: scores against c_kv and k_pe, the context in latent
  space) or naive (K/V re-expanded from the latents a chunk of 2048
  positions at a time under an online softmax, the reference's default).
  ``paged_impl="legacy"`` in ``apply_mla_decode_paged`` (``mla.py:214-224``)
  gathers the request's latent pages into a contiguous row and runs the same
  function.  Both are plain PyTorch, as the reference's are plain jnp.

Parameters are one layer's dict with the reference's names, shapes and
initialisers (``mla.py:44-69``); the up-projections are stored flattened,
(lora, H * dim), as there.  The two latent norms are float32.

Under tensor parallelism (``rt.mesh``, ``repro_torch.serve.sharding``) the
config is a rank's (``n_heads / K``): ``wq_b`` and ``wkv_b`` hold the rank's
columns and ``wo`` its rows, so every function here, K3 and K2's latent form
within, runs over the rank's heads, and ``wo``'s partials are summed over
the "model" group.  ``wq_a``, ``wkv_a``, the latent norms and the latent
cache stay whole: every rank computes, and writes, the same latent bits.  In
training the fork sits after those replicated down-projections and norms:
``cq`` and [c_kv, k_pe] enter the rank's heads through ``copy_to_model``,
whose backward sums their gradients over the group, so ``wq_a``, ``wkv_a``
and the norms get whole gradients, the same bits on every rank.  A latent
cache split along its sequence (``rt.seq_group()``) is refused by name: no
cell of the catalog gives MLA one (``rules_for_cell`` splits the sequence
only for the long-context cell, which only Mamba archs run).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.collectives import all_reduce_sum, copy_to_model
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_decode.ops import gather_pages, paged_latent_decode_attention
from repro_torch.models.attention import scatter_positions
from repro_torch.models.layers import apply_rope, by_batch, by_rows, rms_norm, row_blocks
from repro_torch.models.runtime import Runtime

NEG_INF = -1e30
MLA_DECODE_CHUNK = 2048  # the reference's ``chunk`` of the naive form


def mla_shapes(cfg: ArchConfig) -> Dict[str, Tuple[Tuple[int, ...], str, float]]:
    """name -> (shape, init, scale): normal * scale for the projections, ones
    for the norms."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": ((d, m.q_lora_rank), "normal", 1.0 / math.sqrt(d)),
        "q_a_norm": ((m.q_lora_rank,), "ones", 0.0),
        "wq_b": ((m.q_lora_rank, h * qk), "normal", 1.0 / math.sqrt(m.q_lora_rank)),
        "wkv_a": ((d, m.kv_lora_rank + m.qk_rope_head_dim), "normal", 1.0 / math.sqrt(d)),
        "kv_a_norm": ((m.kv_lora_rank,), "ones", 0.0),
        "wkv_b": ((m.kv_lora_rank, h * (m.qk_nope_head_dim + m.v_head_dim)), "normal",
                  1.0 / math.sqrt(m.kv_lora_rank)),
        "wo": ((h * m.v_head_dim, d), "normal", 1.0 / math.sqrt(h * m.v_head_dim)),
    }


def sm_scale(cfg: ArchConfig) -> float:
    m = cfg.mla
    return 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)


def _mla_q(p, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor, group=None):
    """(q_nope (B, S, H, nope), q_pe (B, S, H, rope)), ``mla.py:85``; under a
    "model" ``group`` the replicated ``cq`` enters the rank's heads through
    ``copy_to_model``."""
    m = cfg.mla
    b, s, _ = x.shape
    cq = copy_to_model(rms_norm(x @ p["wq_a"], p["q_a_norm"], cfg.norm_eps), group)
    q = (cq @ p["wq_b"]).reshape(b, s, cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_pe = apply_rope(q[..., m.qk_nope_head_dim:], positions, theta=cfg.rope_theta)
    return q[..., :m.qk_nope_head_dim], q_pe


def _mla_kv_latent(p, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    """(c_kv (B, S, r), k_pe (B, S, rope)), ``mla.py:97``."""
    m = cfg.mla
    kv_a = x @ p["wkv_a"]
    ckv = rms_norm(kv_a[..., :m.kv_lora_rank], p["kv_a_norm"], cfg.norm_eps)
    kpe = apply_rope(kv_a[..., m.kv_lora_rank:][:, :, None, :], positions,
                     theta=cfg.rope_theta)[:, :, 0, :]
    return ckv, kpe


def _expand_kv(p, ckv: torch.Tensor, kpe: torch.Tensor, cfg: ArchConfig):
    """One row block's k (B, S, H, nope + rope) and v (B, S, H, v),
    re-expanded from its latents (c_kv, k_pe)."""
    m = cfg.mla
    b, s, _ = ckv.shape
    kv = (ckv @ p["wkv_b"]).reshape(b, s, cfg.n_heads, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kv[..., :m.qk_nope_head_dim], kv[..., m.qk_nope_head_dim:]
    k = torch.cat([k_nope, kpe[:, :, None, :].expand(*k_nope.shape[:3], m.qk_rope_head_dim)],
                  dim=-1)
    return k, v


def _project(p, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor, group=None):
    """One row block's q (B, S, H, nope + rope), k (the same) and v
    (B, S, H, v), and its latents (c_kv, k_pe); under a "model" ``group``
    the replicated latents enter the rank's heads through one
    ``copy_to_model`` of [c_kv, k_pe]."""
    q_nope, q_pe = _mla_q(p, x, cfg, positions, group)
    ckv, kpe = _mla_kv_latent(p, x, cfg, positions)
    if group is not None and torch.is_grad_enabled():
        both = copy_to_model(torch.cat([ckv, kpe], dim=-1), group)
        ckv, kpe = both[..., :ckv.shape[-1]], both[..., ckv.shape[-1]:]
    k, v = _expand_kv(p, ckv, kpe, cfg)
    return torch.cat([q_nope, q_pe], dim=-1), k, v, ckv, kpe


def apply_mla(p, x: torch.Tensor, cfg: ArchConfig, rt: Runtime, *,
              kv_lens: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal prefill over x (B, S, d).  Returns (y (B, S, d), cache
    {"ckv" (B, S, r), "kpe" (B, S, rope)})."""
    m = cfg.mla
    b, s, _ = x.shape
    group = rt.model_group()
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    parts = [_project(p, x[:, r], cfg, positions[:, r], group)
             for r in row_blocks(s, rt.prefill_rows)]
    q, k, v, ckv, kpe = (torch.cat(t, dim=1) for t in zip(*parts))
    out = flash_attention(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                          v.transpose(1, 2).contiguous(), causal=True, sm_scale=sm_scale(cfg),
                          kv_lens=kv_lens, block_q=rt.block_q, block_k=rt.block_k)
    out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * m.v_head_dim)
    y = all_reduce_sum(by_rows(lambda o: o @ p["wo"], out, rt.prefill_rows), group)
    return y, {"ckv": ckv, "kpe": kpe}


def apply_mla_prefill_paged(p, x: torch.Tensor, cfg: ArchConfig, rt: Runtime,
                            cache: Dict[str, torch.Tensor], page_tables: torch.Tensor,
                            *, s0: int, n_valid: int, base: int) -> torch.Tensor:
    """One chunk of a chunked prefill over the latent pools: positions ``s0
    .. s0 + n_valid - 1`` of the request whose page-table row is
    ``page_tables`` (1, npp); x (1, S, d) the prefill row blocks the chunk
    touches, row j at position ``base + j``, as
    ``attention.apply_attention_prefill_paged`` takes them.

    The chunk's (c_kv, k_pe) go into the latent pages; K and V are
    re-expanded from the gathered latent row over blocks of
    ``rt.prefill_rows`` positions from position 0, the row padded to whole
    blocks, as ``apply_mla`` re-expands them (the reference's one product
    over the whole row, ``mla.py:276-278``, would give the earlier positions
    other bits here); K3 runs the chunk's queries with ``q_offset = s0``.
    Returns y (1, S, d), zero at the rows outside the chunk."""
    m = cfg.mla
    s, rows_r = x.shape[1], rt.prefill_rows
    positions = torch.arange(base, base + s, dtype=torch.int32, device=x.device)[None]
    parts = [(*_mla_q(p, x[:, r], cfg, positions[:, r]),
              *_mla_kv_latent(p, x[:, r], cfg, positions[:, r]))
             for r in row_blocks(s, rows_r)]
    q_nope, q_pe, ckv, kpe = (torch.cat(t, dim=1) for t in zip(*parts))
    rows = slice(s0 - base, s0 - base + n_valid)
    pid, offset = scatter_positions(page_tables.expand(n_valid, -1), positions[0, rows],
                                    rt.page_size)
    cache["ckv"][pid, offset] = ckv[0, rows].to(cache["ckv"].dtype)
    cache["kpe"][pid, offset] = kpe[0, rows].to(cache["kpe"].dtype)
    kv_len = s0 + n_valid
    skv = -(-kv_len // rows_r) * rows_r  # the blocks holding every key position read

    def latent_row(pool):
        full = gather_pages(pool, page_tables)  # (1, npp * page, width)
        return torch.nn.functional.pad(full, (0, 0, 0, max(0, skv - full.shape[1])))[:, :skv]

    ckv_row, kpe_row = latent_row(cache["ckv"]), latent_row(cache["kpe"])
    kv = [_expand_kv(p, ckv_row[:, r], kpe_row[:, r], cfg) for r in row_blocks(skv, rows_r)]
    k, v = (torch.cat(t, dim=1) for t in zip(*kv))
    q = torch.cat([q_nope[:, rows], q_pe[:, rows]], dim=-1)
    out = flash_attention(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                          v.transpose(1, 2).contiguous(), causal=True, sm_scale=sm_scale(cfg),
                          kv_lens=torch.full((1,), kv_len, dtype=torch.int32, device=x.device),
                          q_offset=s0, block_q=rt.block_q, block_k=rt.block_k)
    y = x.new_zeros((1, s, cfg.n_heads * m.v_head_dim))
    y[:, rows] = out.transpose(1, 2).reshape(1, n_valid, cfg.n_heads * m.v_head_dim)
    return all_reduce_sum(by_rows(lambda o: o @ p["wo"], y, rows_r), rt.model_group())


def apply_mla_decode_paged(p, x: torch.Tensor, cfg: ArchConfig, rt: Runtime,
                           cache: Dict[str, torch.Tensor], lengths: torch.Tensor,
                           page_tables: torch.Tensor) -> torch.Tensor:
    """Absorbed paged decode of one new token per row, x (B, 1, d), against
    the latent pools ``cache`` {"ckv" (n_pages, page, r), "kpe" (n_pages,
    page, rope)}, which it updates in place (the reference's scatter at
    ``mla.py:209-214`` is functional).  Every row's latents are scattered
    before any row attends; the projections and ``W_uk`` / ``W_uv`` run over
    blocks of ``rt.decode_rows`` rows.  Idle slots write page 0, the scratch
    page, which no live row reads.  With ``rt.paged_impl == "legacy"`` each
    row's pages are gathered into a contiguous row and ``_mla_decode_attn``
    attends over it, absorbed or not as ``rt.mla_absorb`` says.  Returns
    y (B, 1, d)."""
    m = cfg.mla
    b, h = x.shape[0], cfg.n_heads
    rows = rt.decode_rows or b
    lengths = lengths.to(torch.int32)
    q_nope, q_pe, ckv_new, kpe_new = _project_decode(p, x, cfg, lengths, rows)
    pid, offset = scatter_positions(page_tables, lengths, rt.page_size)
    cache["ckv"][pid, offset] = ckv_new.to(cache["ckv"].dtype)
    cache["kpe"][pid, offset] = kpe_new.to(cache["kpe"].dtype)
    if rt.paged_impl == "legacy":
        out = _mla_decode_attn(p, q_nope, q_pe, gather_pages(cache["ckv"], page_tables),
                               gather_pages(cache["kpe"], page_tables), lengths + 1, cfg,
                               absorb=rt.mla_absorb)
        y = by_batch(lambda o: o.reshape(o.shape[0], h * m.v_head_dim) @ p["wo"], out, rows)
        return all_reduce_sum(y, rt.model_group())[:, None, :]
    wk, wv = _split_wkv_b(p, cfg)
    q_lat = by_batch(lambda qn: torch.einsum("bhe,rhe->bhr", qn, wk), q_nope, rows)  # (B, H, r)
    ctx_lat = paged_latent_decode_attention(
        q_lat.contiguous(), q_pe.contiguous(), cache["ckv"], cache["kpe"], lengths + 1,
        page_tables, sm_scale=sm_scale(cfg), impl=rt.paged_impl,
        pages_per_program=rt.pages_per_program)

    def out_proj(ctx):
        out = torch.einsum("bhr,rhe->bhe", ctx.to(x.dtype), wv)  # (B, H, v)
        return out.reshape(ctx.shape[0], h * m.v_head_dim) @ p["wo"]

    return all_reduce_sum(by_batch(out_proj, ctx_lat, rows), rt.model_group())[:, None, :]


def _project_decode(p, x: torch.Tensor, cfg: ArchConfig, lengths: torch.Tensor, rows: int):
    """The decode step's q_nope (B, H, nope), q_pe (B, H, rope) and new
    latents c_kv (B, r), k_pe (B, rope) at positions ``lengths``, over
    blocks of ``rows`` rows."""
    def project(xb, positions):
        q_nope, q_pe = _mla_q(p, xb, cfg, positions)
        ckv_new, kpe_new = _mla_kv_latent(p, xb, cfg, positions)
        return q_nope[:, 0], q_pe[:, 0], ckv_new[:, 0], kpe_new[:, 0]

    parts = [project(x[r], lengths[r, None]) for r in row_blocks(x.shape[0], rows)]
    return tuple(torch.cat(t, dim=0) for t in zip(*parts))


def _split_wkv_b(p, cfg: ArchConfig):
    """(W_uk (r, H, nope), W_uv (r, H, v)): ``wkv_b`` split per head."""
    m = cfg.mla
    wkv_b = p["wkv_b"].reshape(m.kv_lora_rank, cfg.n_heads, m.qk_nope_head_dim + m.v_head_dim)
    return wkv_b[..., :m.qk_nope_head_dim], wkv_b[..., m.qk_nope_head_dim:]


def apply_mla_decode(p, x: torch.Tensor, cfg: ArchConfig, rt: Runtime,
                     cache: Dict[str, torch.Tensor], lengths: torch.Tensor) -> torch.Tensor:
    """Decode of one new token per row, x (B, 1, d), against the contiguous
    latent cache {"ckv" (B, max_seq, r), "kpe" (B, max_seq, rope)}
    (``LM.init_cache``, or a prefill's cache), which it updates in place:
    each row's new latents written at its length, then ``_mla_decode_attn``
    over ``lengths + 1`` positions (``mla.py:147-178``; the reference's write
    is functional).  The projections run over blocks of ``rt.decode_rows``
    rows.  Returns y (B, 1, d)."""
    if rt.seq_group() is not None:
        raise ValueError(
            "MLA's latent cache split along its sequence: no cell of the catalog "
            "splits an MLA arch's cache_seq (the long-context cell runs Mamba archs)")
    m = cfg.mla
    b = x.shape[0]
    rows = rt.decode_rows or b
    lengths = lengths.to(torch.int32)
    q_nope, q_pe, ckv_new, kpe_new = _project_decode(p, x, cfg, lengths, rows)
    at, pos = torch.arange(b, device=x.device), lengths.long()
    cache["ckv"][at, pos] = ckv_new.to(cache["ckv"].dtype)
    cache["kpe"][at, pos] = kpe_new.to(cache["kpe"].dtype)
    out = _mla_decode_attn(p, q_nope, q_pe, cache["ckv"], cache["kpe"], lengths + 1, cfg,
                           absorb=rt.mla_absorb)
    y = by_batch(lambda o: o.reshape(o.shape[0], cfg.n_heads * m.v_head_dim) @ p["wo"],
                 out, rows)
    return all_reduce_sum(y, rt.model_group())[:, None, :]


def _mla_decode_attn(p, q_nope: torch.Tensor, q_pe: torch.Tensor, ckv: torch.Tensor,
                     kpe: torch.Tensor, lens: torch.Tensor, cfg: ArchConfig, *,
                     absorb: bool, chunk: int = MLA_DECODE_CHUNK) -> torch.Tensor:
    """Decode attention over a contiguous latent row (``mla.py:295-370``):
    q_nope (B, H, nope), q_pe (B, H, rope), ckv (B, S, r), kpe (B, S, rope),
    lens (B,) the valid positions including the new token.  Returns
    (B, H, v) in the config's dtype.

    Absorbed: ``q_lat = q_nope W_uk`` in the config's dtype, scores
    ``q_lat . ckv + q_pe . kpe`` accumulated in float32, the softmax in
    float32 over the masked scores, p rounded to the config's dtype for the
    latent context (float32 sums), which is rounded before ``W_uv``.
    Naive: chunks of ``chunk`` positions, each chunk's K and V re-expanded
    from its latents by ``wkv_b`` in the config's dtype, scores and the
    online softmax in float32, the output rounded once at the end."""
    m = cfg.mla
    b, h = q_nope.shape[0], cfg.n_heads
    s_max = ckv.shape[1]
    scale = sm_scale(cfg)
    dtype = q_nope.dtype
    lens = lens.to(ckv.device)
    if absorb:
        wk, wv = _split_wkv_b(p, cfg)
        q_lat = torch.einsum("bhe,rhe->bhr", q_nope, wk)
        scores = (torch.einsum("bhr,bsr->bhs", q_lat.float(), ckv.float())
                  + torch.einsum("bhe,bse->bhs", q_pe.float(), kpe.float())) * scale
        mask = torch.arange(s_max, device=ckv.device)[None, :] < lens[:, None]
        scores = torch.where(mask[:, None, :], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        ctx_lat = torch.einsum("bhs,bsr->bhr", probs.to(dtype).float(), ckv.float())
        return torch.einsum("bhr,rhe->bhe", ctx_lat.to(dtype), wv)
    wkv_b = p["wkv_b"].reshape(m.kv_lora_rank, h, m.qk_nope_head_dim + m.v_head_dim)
    acc = torch.zeros((b, h, m.v_head_dim), dtype=torch.float32, device=ckv.device)
    mx = torch.full((b, h), NEG_INF, dtype=torch.float32, device=ckv.device)
    l = torch.zeros((b, h), dtype=torch.float32, device=ckv.device)
    qn, qp = q_nope.float(), q_pe.float()
    for j in range(max(1, -(-s_max // chunk))):
        span = slice(j * chunk, min((j + 1) * chunk, s_max))
        kv_j = torch.einsum("bsr,rhe->bshe", ckv[:, span], wkv_b)
        k_nope, v_j = kv_j[..., :m.qk_nope_head_dim], kv_j[..., m.qk_nope_head_dim:]
        s_j = (torch.einsum("bhe,bshe->bhs", qn, k_nope.float())
               + torch.einsum("bhe,bse->bhs", qp, kpe[:, span].float())) * scale
        valid = torch.arange(span.start, span.stop, device=ckv.device)[None, :] < lens[:, None]
        s_j = torch.where(valid[:, None, :], s_j, NEG_INF)
        mx_new = torch.maximum(mx, s_j.amax(dim=-1))
        alpha = torch.exp(mx - mx_new)
        pj = torch.where(valid[:, None, :], torch.exp(s_j - mx_new[..., None]), 0.0)
        l = l * alpha + pj.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhs,bshe->bhe", pj, v_j.float())
        mx = mx_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(dtype)
