"""Paged KV cache construction and prefill-to-page writes (counterparts of
``repro/serve/cache.py:34-125``).

The cache is one dict per layer.  Attention leaves (``"k"``, ``"v"``) are
*page-major* pools of shape (n_pages, Hk, page_size, hd), one row per
physical page, shared by every request through its page table; page 0 is
the scratch page.  Any other leaf would be *slot-major* (recurrent state,
indexed by decode slot); the dense archs the port runs have none, so
``snapshot_state`` / ``restore_state`` carry nothing for them.

Unlike the reference's functional writers, these write the engine's pools in
place.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

PAGED_LEAVES = ("k", "v")
Cache = List[Dict[str, torch.Tensor]]


def init_paged_cache(lm, *, num_pages: int, page_size: int, max_batch: int) -> Cache:
    """Zero pools for every layer of ``lm`` (``max_batch`` would size
    slot-major leaves, which dense layers do not have)."""
    cfg = lm.cfg
    shape = (num_pages, cfg.n_kv_heads, page_size, cfg.head_dim)
    return [{name: torch.zeros(shape, dtype=lm.dtype, device=lm.device)
             for name in PAGED_LEAVES} for _ in range(cfg.n_layers)]


def write_prefill(paged: Cache, prefill_cache: Cache, *, page_ids: Sequence[int],
                  page_size: int, skip_pages: int = 0, n_tokens: Optional[int] = None) -> Cache:
    """Write a batch-1 prefill cache (per layer (1, Hk, S, hd)) into
    ``page_ids``.  Only the first ``n_tokens`` positions (default all S) are
    written; the last page may be partial, its tail zero-padded and
    overwritten by later decode steps.

    ``skip_pages`` leading pages are NOT written: they are prefix-shared,
    immutable, and may back a request that is still decoding; their content
    is already bitwise what this prefill computed for the same positions (see
    the engine on why).  Dense layers have no slot-major leaves, so no decode
    slot is written."""
    n_new = len(page_ids) - skip_pages
    if n_new <= 0:
        return paged
    device = paged[0]["k"].device
    pids = torch.as_tensor(np.asarray(page_ids[skip_pages:], np.int64), device=device)
    for layer, pre_layer in zip(paged, prefill_cache):
        for name in PAGED_LEAVES:
            pre = pre_layer[name][0]  # (Hk, S, hd)
            n_tok = pre.shape[1] if n_tokens is None else int(n_tokens)
            pre = pre[:, :n_tok]
            pre = torch.nn.functional.pad(pre, (0, 0, 0, len(page_ids) * page_size - n_tok))
            hk, _, hd = pre.shape
            pages = pre.reshape(hk, len(page_ids), page_size, hd)[:, skip_pages:]
            layer[name][pids] = pages.transpose(0, 1).to(layer[name].dtype)
    return paged


def snapshot_state(paged: Cache, slot: int) -> List[Dict[str, Optional[np.ndarray]]]:
    """Host copies of the slot-major leaves of decode slot ``slot``; paged
    leaves are ``None``.  The prefix cache keeps it for whole-prompt reuse."""
    return [{name: None if name in PAGED_LEAVES else leaf[slot].cpu().numpy()
             for name, leaf in layer.items()} for layer in paged]


def restore_state(paged: Cache, snapshot, slot: int) -> Cache:
    """Write a ``snapshot_state`` result back into decode slot ``slot``."""
    for layer, snap in zip(paged, snapshot):
        for name, value in snap.items():
            if value is not None:
                layer[name][slot] = torch.as_tensor(value, device=layer[name].device)
    return paged


def max_pages_per_seq(max_seq: int, page_size: int) -> int:
    return -(-max_seq // page_size)
