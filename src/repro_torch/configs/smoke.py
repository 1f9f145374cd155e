"""Reduced smoke-test variants of every architecture.

Same *family* (layer period, MoE/MLA/Mamba structure, frontend) but tiny
dimensions so one forward/train step runs in <1s on CPU.  Full configs are
only ever exercised via the dry-run (ShapeDtypeStruct, no allocation).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.configs.base import ArchConfig, MambaConfig, MLAConfig, ShapeSpec


def smoke_variant(cfg: ArchConfig) -> ArchConfig:
    """Shrink every dimension while preserving structure."""
    period_len = len(cfg.period)
    n_layers = cfg.first_k_dense + period_len  # one period + dense head
    kv = max(1, min(cfg.n_kv_heads, 2))
    heads = max(kv, min(cfg.n_heads, 4))
    heads = int(math.ceil(heads / kv) * kv)  # heads divisible by kv
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(
            moe,
            n_routed_experts=min(moe.n_routed_experts, 8),
            n_shared_experts=min(moe.n_shared_experts, 1),
            top_k=min(moe.top_k, 2),
            expert_d_ff=64,
        )
    mla = cfg.mla
    if mla is not None:
        mla = MLAConfig(
            q_lora_rank=32,
            kv_lora_rank=16,
            qk_nope_head_dim=16,
            qk_rope_head_dim=8,
            v_head_dim=16,
        )
    mamba = cfg.mamba
    if mamba is not None:
        mamba = MambaConfig(d_state=4, expand=2, d_conv=4, dt_rank=8)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=heads if cfg.n_heads else 0,
        n_kv_heads=kv if cfg.n_kv_heads else 0,
        head_dim=16 if cfg.head_dim else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        moe=moe,
        mla=mla,
        mamba=mamba,
        n_frontend_tokens=8 if cfg.n_frontend_tokens else 0,
    )


SMOKE_TRAIN = ShapeSpec("smoke_train", seq_len=32, global_batch=2, kind="train")
SMOKE_PREFILL = ShapeSpec("smoke_prefill", seq_len=32, global_batch=2, kind="prefill")
SMOKE_DECODE = ShapeSpec("smoke_decode", seq_len=32, global_batch=2, kind="decode")
