"""Paged KV cache and recurrent state, and prefill-to-cache writes
(counterparts of ``repro/serve/cache.py:34-125``).

The cache is one dict per layer.  Attention leaves (``"k"``, ``"v"``) are
*page-major* pools of shape (n_pages, Hk, page_size, hd), one row per
physical page, shared by every request through its page table; page 0 is
the scratch page.  MLA's latent leaves are page-major too: ``"ckv"``
(n_pages, page_size, kv_lora_rank) and ``"kpe"`` (n_pages, page_size,
qk_rope_head_dim), the reference's ``cache_seq`` leaves.  Mamba leaves are
*slot-major*, indexed by decode slot: ``"h"`` (max_batch, Dn, N) float32,
the scan's state, and ``"conv"`` (max_batch, Dn, d_conv - 1) in the config's
dtype, the conv's last inputs.
A pure Mamba model has no page pools at all; the engine's page accounting
runs all the same.  ``snapshot_state`` / ``restore_state`` carry the
slot-major leaves, for whole-prompt reuse.

Unlike the reference's functional writers, these write the engine's cache in
place.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

PAGED_LEAVES = ("k", "v", "ckv", "kpe")
Cache = List[Dict[str, torch.Tensor]]


def init_paged_cache(lm, *, num_pages: int, page_size: int, max_batch: int) -> Cache:
    """Zero pools (attention layers) and zero states for ``max_batch`` slots
    (Mamba layers) for every layer of ``lm``."""
    cfg = lm.cfg
    cache: Cache = []
    for layer in lm.layers:
        if layer.spec.mixer == "attn" and cfg.mla is not None:
            m = cfg.mla
            cache.append({name: torch.zeros((num_pages, page_size, width), dtype=lm.dtype,
                                            device=lm.device)
                          for name, width in (("ckv", m.kv_lora_rank),
                                              ("kpe", m.qk_rope_head_dim))})
        elif layer.spec.mixer == "attn":
            shape = (num_pages, cfg.n_kv_heads, page_size, cfg.head_dim)
            cache.append({name: torch.zeros(shape, dtype=lm.dtype, device=lm.device)
                          for name in ("k", "v")})
        else:
            mc = cfg.mamba
            di = mc.resolved_d_inner(cfg.d_model)
            cache.append({
                "h": torch.zeros((max_batch, di, mc.d_state), dtype=torch.float32,
                                 device=lm.device),
                "conv": torch.zeros((max_batch, di, mc.d_conv - 1), dtype=lm.dtype,
                                    device=lm.device)})
    return cache


def write_prefill(paged: Cache, prefill_cache: Cache, *, slot: int, page_ids: Sequence[int],
                  page_size: int, skip_pages: int = 0, n_tokens: Optional[int] = None) -> Cache:
    """Write a batch-1 prefill cache into ``page_ids`` (attention leaves, per
    layer (1, Hk, S, hd), or MLA's (1, S, width)) and decode slot ``slot``
    (Mamba state leaves).
    Only the first ``n_tokens`` positions (default all S) are written to
    pages; the last page may be partial, its tail zero-padded and
    overwritten by later decode steps.

    ``skip_pages`` leading pages are NOT written: they are prefix-shared,
    immutable, and may back a request that is still decoding; their content
    is already bitwise what this prefill computed for the same positions (see
    the engine on why)."""
    n_new = len(page_ids) - skip_pages
    for layer, pre_layer in zip(paged, prefill_cache):
        for name, leaf in layer.items():
            pre = pre_layer[name][0]
            if name not in PAGED_LEAVES:
                leaf[slot] = pre.to(leaf.dtype)
                continue
            if n_new <= 0:
                continue
            if pre.dim() == 2:  # (S, width): MLA's latents, no head axis
                pre = pre[None]
            n_tok = pre.shape[1] if n_tokens is None else int(n_tokens)
            pre = pre[:, :n_tok]  # (Hk, n_tok, hd)
            pre = torch.nn.functional.pad(pre, (0, 0, 0, len(page_ids) * page_size - n_tok))
            hk, _, hd = pre.shape
            pages = pre.reshape(hk, len(page_ids), page_size, hd)[:, skip_pages:]
            pids = torch.as_tensor(np.asarray(page_ids[skip_pages:], np.int64),
                                   device=leaf.device)
            leaf[pids] = pages.transpose(0, 1).reshape(-1, *leaf.shape[1:]).to(leaf.dtype)
    return paged


def snapshot_state(paged: Cache, slot: int) -> List[Dict[str, Optional[torch.Tensor]]]:
    """Host copies (CPU tensors, in the leaves' dtypes: numpy has no bf16) of
    the slot-major leaves of decode slot ``slot``; paged leaves are
    ``None``.  The prefix cache keeps it for whole-prompt reuse."""
    return [{name: None if name in PAGED_LEAVES else leaf[slot].to("cpu", copy=True)
             for name, leaf in layer.items()} for layer in paged]


def restore_state(paged: Cache, snapshot, slot: int) -> Cache:
    """Write a ``snapshot_state`` result back into decode slot ``slot``."""
    for layer, snap in zip(paged, snapshot):
        for name, value in snap.items():
            if value is not None:
                layer[name][slot] = value
    return paged


def max_pages_per_seq(max_seq: int, page_size: int) -> int:
    return -(-max_seq // page_size)
