"""GQA attention for the dense archs: grouped KV heads, qk-norm (Qwen3),
QKV bias, partial rotary; prefill through the flash forward (K3) and paged
decode through paged flash decode (K2).  Counterparts of
``repro/models/attention.py:70`` (``_project_qkv``), ``:98``
(``apply_attention``) and ``:128`` (``apply_attention_decode_paged``).

Parameters are one layer's dict of tensors: ``wq`` (d, H*hd), ``wk`` and
``wv`` (d, Hk*hd), ``wo`` (H*hd, d), stored flattened as in the reference,
plus ``q_norm``/``k_norm`` (hd,) with qk-norm and ``bq``/``bk``/``bv`` with
QKV bias.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_decode.ops import paged_decode_attention
from repro_torch.models.layers import apply_rope, by_rows, rms_norm, row_blocks
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
    return by_rows(lambda o: o @ p["wo"], out, rt.prefill_rows), {"k": kt, "v": vt}


def apply_attention_decode_paged(p, x: torch.Tensor, cfg: ArchConfig, rt: Runtime,
                                 cache: Dict[str, torch.Tensor], lengths: torch.Tensor,
                                 page_tables: torch.Tensor) -> torch.Tensor:
    """Paged-KV decode of one new token per row, x (B, 1, d): scatter the new
    token's K/V into its page, then attend over the pool with ``lengths + 1``.

    The reference's scatter (``attention.py:154-157``) is functional and
    returns new pools; the port writes ``cache``'s pools in place.  Idle
    slots all write page 0 (the scratch page), offset 0, in the same step;
    that is harmless because no live row ever reads page 0."""
    b = x.shape[0]
    lengths = lengths.to(torch.int32)
    q, k, v = _project_qkv(p, x, cfg, lengths[:, None])
    page = rt.page_size
    page_idx = (lengths // page).long()
    offset = (lengths % page).long()
    pid = page_tables.gather(1, page_idx[:, None])[:, 0].long()
    cache["k"][pid, :, offset] = k[:, 0].to(cache["k"].dtype)
    cache["v"][pid, :, offset] = v[:, 0].to(cache["v"].dtype)
    out = paged_decode_attention(q[:, 0].contiguous(), cache["k"], cache["v"], lengths + 1,
                                 page_tables, impl=rt.paged_impl,
                                 pages_per_program=rt.pages_per_program)
    y = out.reshape(b, cfg.n_heads * cfg.head_dim) @ p["wo"]
    return y[:, None, :]
