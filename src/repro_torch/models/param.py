"""The logical axes of the LM's parameters and of its serving cache: one
name (or ``None``) a tensor dimension, copied from the reference's ``ann(...)``
calls (``repro/models/param.py``'s ``Annotated`` leaves) and cache-axes
tables.  ``repro_torch.dist.partitioning.Rules`` turns them into placements.

The reference carries the axes inside its parameter tree (a pytree class);
the port's axes are plain data: tables keyed by the port's parameter names,
and ``LM.param_axes()`` / ``LM.cache_axes()`` (``repro_torch.models.model``)
assemble them into the reference's trees, a period layer's leaves with a
leading "layers" axis.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.configs.base import ArchConfig, LayerSpec

Axes = Tuple[Optional[str], ...]

# embed, final_norm, lm_head, frontend_proj (layers.py:94, :99, :21; model.py:56)
TOP_AXES: Dict[str, Axes] = {
    "embed": ("vocab", "embed"),
    "final_norm": ("norm",),
    "lm_head": ("embed", "vocab"),
    "frontend_proj": ("embed", None),
}
NORM_AXES: Axes = ("norm",)  # ln1, ln2 (layers.py:21)

# GQA attention, projections stored flattened (attention.py:35-50)
ATTENTION_AXES: Dict[str, Axes] = {
    "wq": ("embed", "heads_flat"),
    "wk": ("embed", "kv_flat"),
    "wv": ("embed", "kv_flat"),
    "wo": ("heads_flat", "embed"),
    "bq": ("heads_flat",),
    "bk": ("kv_flat",),
    "bv": ("kv_flat",),
    "q_norm": ("norm",),
    "k_norm": ("norm",),
}

# SwiGLU (layers.py:71-76)
MLP_AXES: Dict[str, Axes] = {
    "w_gate": ("embed", "mlp"),
    "w_up": ("embed", "mlp"),
    "w_down": ("mlp", "embed"),
}

# Mamba-1 (mamba.py:33-49)
MAMBA_AXES: Dict[str, Axes] = {
    "in_proj": ("embed", "mamba_inner"),
    "conv_w": ("mamba_inner", "conv"),
    "conv_b": ("mamba_inner",),
    "x_proj": ("mamba_inner", "lora"),
    "dt_w": ("dt_rank", "mamba_inner"),
    "dt_b": ("mamba_inner",),
    "A_log": ("mamba_inner", "ssm_state"),
    "D": ("mamba_inner",),
    "out_proj": ("mamba_inner", "embed"),
}

# MLA (mla.py:52-66)
MLA_AXES: Dict[str, Axes] = {
    "wq_a": ("embed", "lora"),
    "q_a_norm": ("norm",),
    "wq_b": ("lora", "heads_flat"),
    "wkv_a": ("embed", "lora"),
    "kv_a_norm": ("norm",),
    "wkv_b": ("lora", "heads_flat"),
    "wo": ("heads_flat", "embed"),
}

# MoE (moe.py:57-73)
MOE_AXES: Dict[str, Axes] = {
    "router": ("embed", "expert"),
    "w_gate": ("expert", "embed", "expert_mlp"),
    "w_up": ("expert", "embed", "expert_mlp"),
    "w_down": ("expert", "expert_mlp", "embed"),
    "sh_gate": ("embed", "mlp"),
    "sh_up": ("embed", "mlp"),
    "sh_down": ("mlp", "embed"),
}

# The cache's leaves.  The port's paged pools keep the reference's dims in
# order: (pages, Hk, page, hd) for K/V, (pages, page, width) for MLA's
# latents, (slots, Dn, ...) for the Mamba state.
CACHE_AXES: Dict[str, Axes] = {  # attention.py:63-67
    # cache_head_dim claims the model axis when kv_heads doesn't divide it
    "k": ("cache_batch", "act_kv_heads", "cache_seq", "cache_head_dim"),
    "v": ("cache_batch", "act_kv_heads", "cache_seq", "cache_head_dim"),
}
MAMBA_CACHE_AXES: Dict[str, Axes] = {  # mamba.py:63-66
    "h": ("cache_batch", "mamba_inner", None),
    "conv": ("cache_batch", "mamba_inner", None),
}
MLA_CACHE_AXES: Dict[str, Axes] = {  # mla.py:79-82
    "ckv": ("cache_batch", "cache_seq", "cache_latent"),
    "kpe": ("cache_batch", "cache_seq", None),
}


def mixer_axes(cfg: ArchConfig, spec: LayerSpec) -> Dict[str, Axes]:
    if spec.mixer == "attn":
        return MLA_AXES if cfg.mla is not None else ATTENTION_AXES
    return MAMBA_AXES


def ffn_axes(spec: LayerSpec) -> Dict[str, Axes]:
    return MOE_AXES if spec.ffn == "moe" else MLP_AXES


def layer_param_axes(cfg: ArchConfig, spec: LayerSpec, group: str, name: str) -> Axes:
    """The axes of one layer's parameter: ``group`` "ln1"/"ln2" (``name``
    unused), "mixer" or "ffn"."""
    if group in ("ln1", "ln2"):
        return NORM_AXES
    return (mixer_axes(cfg, spec) if group == "mixer" else ffn_axes(spec))[name]


def layer_cache_axes(cfg: ArchConfig, spec: LayerSpec) -> Dict[str, Axes]:
    """The axes of one layer's cache leaves (``blocks.py:48-53``)."""
    if spec.mixer == "attn":
        return dict(MLA_CACHE_AXES if cfg.mla is not None else CACHE_AXES)
    return dict(MAMBA_CACHE_AXES)
