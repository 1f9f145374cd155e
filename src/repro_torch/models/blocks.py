"""The dense attention block, pre-norm: ln1 -> attention -> residual ->
ln2 -> SwiGLU -> residual.  Counterparts of ``repro/models/blocks.py``'s
``apply_block`` (:56) for prefill and ``apply_block_decode_paged`` (:98).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import apply_mlp, by_rows, rms_norm
from repro_torch.models.runtime import Runtime


Spec = Tuple[Tuple[int, ...], str, float]  # (shape, init, scale)


class DenseBlock(nn.Module):
    """One layer's parameters, named as the reference's param tree
    (``pos0/{ln1, mixer/{...}, ln2, ffn/{...}}``) and initialised as there
    (``blocks.py:init_block``, ``layers.py:95-103``).  Matrices are stored in
    ``dtype``, norm scales in float32."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device: torch.device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.specs: Dict[str, Dict[str, Spec]] = {
            "mixer": attn_mod.attention_shapes(cfg),
            "ffn": {"w_gate": ((d, f), "normal", 1.0 / math.sqrt(d)),
                    "w_up": ((d, f), "normal", 1.0 / math.sqrt(d)),
                    "w_down": ((f, d), "normal", 1.0 / math.sqrt(f))},
        }

        def param(shape, init):
            dt = torch.float32 if init == "ones" else dtype
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device),
                                requires_grad=False)

        self.ln1 = param((d,), "ones")
        self.ln2 = param((d,), "ones")
        self.mixer = nn.ParameterDict({k: param(shape, init) for k, (shape, init, _)
                                       in self.specs["mixer"].items()})
        self.ffn = nn.ParameterDict({k: param(shape, init) for k, (shape, init, _)
                                     in self.specs["ffn"].items()})

    def init_params(self, generator: torch.Generator) -> None:
        """The reference's distributions and scales, one matrix at a time
        (float32 draws on the generator's device, then cast)."""
        self.ln1.fill_(1.0)
        self.ln2.fill_(1.0)
        for group in ("mixer", "ffn"):
            params = getattr(self, group)
            for name, (shape, init, scale) in self.specs[group].items():
                fill_param(params[name], init, scale, generator)


def fill_param(t: torch.Tensor, init: str, scale: float, generator: torch.Generator) -> None:
    if init == "ones":
        t.fill_(1.0)
    elif init == "zeros":
        t.zero_()
    else:
        draw = torch.randn(t.shape, generator=generator, dtype=torch.float32,
                           device=generator.device)
        t.copy_(draw.mul_(scale))


def apply_block(p: DenseBlock, x: torch.Tensor, cfg: ArchConfig, rt: Runtime, *,
                kv_lens: Optional[torch.Tensor] = None):
    """Prefill: returns (x, cache {"k", "v"} (B, Hk, S, hd)).  The norms and
    the MLP run over blocks of ``rt.prefill_rows`` positions, as the
    attention's projections do."""
    rows = rt.prefill_rows
    h = by_rows(lambda xr: rms_norm(xr, p.ln1, cfg.norm_eps), x, rows)
    y, cache = attn_mod.apply_attention(p.mixer, h, cfg, rt, kv_lens=kv_lens)
    x = x + y
    return by_rows(lambda xr: xr + apply_mlp(p.ffn, rms_norm(xr, p.ln2, cfg.norm_eps)),
                   x, rows), cache


def apply_block_decode_paged(p: DenseBlock, x: torch.Tensor, cfg: ArchConfig, rt: Runtime,
                             cache: Dict[str, torch.Tensor], lengths: torch.Tensor,
                             page_tables: torch.Tensor) -> torch.Tensor:
    """One decode step of x (B, 1, d) against the layer's page pools, which
    it updates in place."""
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    x = x + attn_mod.apply_attention_decode_paged(p.mixer, h, cfg, rt, cache, lengths,
                                                  page_tables)
    h2 = rms_norm(x, p.ln2, cfg.norm_eps)
    return x + apply_mlp(p.ffn, h2)
