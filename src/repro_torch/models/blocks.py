"""Decoder blocks, pre-norm: ln1 -> mixer (attention, MLA or Mamba) ->
residual, then, unless the layer's ffn is "none", ln2 -> SwiGLU or MoE ->
residual.  Counterparts of ``repro/models/blocks.py``'s ``init_block`` (:22),
``apply_block`` (:56) for prefill and, without its cache, training
(``apply_block_train``), ``apply_block_decode_paged`` (:98),
``apply_block_prefill_paged`` (:141) for chunked prefill and
``apply_block_decode`` (:182) for the contiguous cache, dispatching on
the layer's ``LayerSpec`` (and on ``cfg.mla`` for the attention mixer) as
there.

Every row-wise step (the norms, the MLP, the MoE's dispatch) runs over row
blocks of one fixed shape: ``rt.prefill_rows`` positions in prefill and in
chunked prefill, whose row blocks are the monolithic prefill's, and
``rt.decode_rows`` batch rows in decode, so that a verify step's folded
batch runs them at the decode step's shape.  A matrix product's row, and the
MoE's output for a token, depend on the other rows only through the shape
(``repro_torch.serve.engine``), so a position gets the same bits in each.
Training's MoE dispatch is the exception: one over the whole batch.

Under a mesh (``rt.mesh``) the SwiGLU's ``w_gate``/``w_up`` are a
tensor-parallel rank's columns and ``w_down`` its rows, and their product is
summed over the "model" group (``repro_torch.dist.collectives``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.dist.collectives import all_reduce_sum
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import apply_mlp, by_batch, by_rows, rms_norm
from repro_torch.models.runtime import Runtime


Spec = Tuple[Tuple[int, ...], str, float]  # (shape, init, scale)


class Block(nn.Module):
    """One layer's parameters, named as the reference's param tree
    (``pos<i>/{ln1, mixer/{...}[, ln2, ffn/{...}]}``) and initialised as
    there (``blocks.py:init_block``, ``layers.py:95-103``, ``attention.py``,
    ``mla.py``, ``mamba.py``, ``moe.py``).  Matrices are stored in ``dtype``;
    norm scales, the Mamba parameters the reference reads in float32 and the
    MoE router in float32."""

    def __init__(self, cfg: ArchConfig, spec: LayerSpec, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.spec = spec
        d, f = cfg.d_model, cfg.d_ff
        if spec.mixer == "attn":
            mixer = mla_mod.mla_shapes(cfg) if cfg.mla else attn_mod.attention_shapes(cfg)
            float32 = frozenset()
        else:
            mixer, float32 = mamba_mod.mamba_shapes(cfg), mamba_mod.FLOAT32_PARAMS
        self.specs: Dict[str, Dict[str, Spec]] = {"mixer": mixer}
        if spec.ffn == "dense":
            self.specs["ffn"] = {"w_gate": ((d, f), "normal", 1.0 / math.sqrt(d)),
                                 "w_up": ((d, f), "normal", 1.0 / math.sqrt(d)),
                                 "w_down": ((f, d), "normal", 1.0 / math.sqrt(f))}
        elif spec.ffn == "moe":
            self.specs["ffn"] = moe_mod.moe_shapes(cfg)
            float32 = float32 | moe_mod.FLOAT32_PARAMS

        def param(name, shape, init):
            dt = torch.float32 if init == "ones" or name in float32 else dtype
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device),
                                requires_grad=False)

        self.ln1 = param("ln1", (d,), "ones")
        self.ln2 = param("ln2", (d,), "ones") if spec.ffn != "none" else None
        for group, shapes in self.specs.items():
            setattr(self, group, nn.ParameterDict(
                {k: param(k, shape, init) for k, (shape, init, _) in shapes.items()}))
        if spec.ffn == "none":
            self.ffn = None

    def init_entries(self):
        """(tensor, initialiser, scale) of each parameter, in the order
        ``init_params`` draws them."""
        yield self.ln1, "ones", 0.0
        if self.ln2 is not None:
            yield self.ln2, "ones", 0.0
        for group, shapes in self.specs.items():
            params = getattr(self, group)
            for name, (_, init, scale) in shapes.items():
                yield params[name], init, scale

    def init_params(self, generator: torch.Generator) -> None:
        """The reference's distributions and scales, one matrix at a time
        (float32 draws on the generator's device, then cast)."""
        for t, init, scale in self.init_entries():
            fill_param(t, init, scale, generator)


def fill_param(t: torch.Tensor, init: str, scale: float, generator: torch.Generator) -> None:
    """Fill ``t`` from ``generator``; a stacked (E, ...) expert tensor one
    expert at a time, so the float32 draw is one expert's, not all E's."""
    if t.dim() == 3 and init in ("normal", "uniform"):
        for part in t:
            fill_param(part, init, scale, generator)
        return
    if init == "ones":
        t.fill_(1.0)
    elif init == "zeros":
        t.zero_()
    elif init == "normal":
        draw = torch.randn(t.shape, generator=generator, dtype=torch.float32,
                           device=generator.device)
        t.copy_(draw.mul_(scale))
    elif init == "uniform":  # in (-scale, scale)
        draw = torch.rand(t.shape, generator=generator, dtype=torch.float32,
                          device=generator.device)
        t.copy_(draw.mul_(2 * scale).sub_(scale))
    else:
        mamba_mod.init_mamba_param(t, init, generator)


def _mix(p: Block, x: torch.Tensor, cfg: ArchConfig, rt: Runtime,
         n_valid: Optional[int] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x plus the layer's mixer of ln1(x), and the mixer's cache (prefill's
    arithmetic over the whole sequence; ``apply_block``)."""
    h = by_rows(lambda xr: rms_norm(xr, p.ln1, cfg.norm_eps), x, rt.prefill_rows)
    if p.spec.mixer == "attn":
        kv_lens = None if n_valid is None else torch.full(
            (x.shape[0],), int(n_valid), dtype=torch.int32, device=x.device)
        mixer = mla_mod.apply_mla if cfg.mla else attn_mod.apply_attention
        y, cache = mixer(p.mixer, h, cfg, rt, kv_lens=kv_lens)
    else:
        y, cache = mamba_mod.apply_mamba(p.mixer, h, cfg, rt, n_valid=n_valid)
    return x + y, cache


def apply_block(p: Block, x: torch.Tensor, cfg: ArchConfig, rt: Runtime, *,
                n_valid: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill: returns (x, cache), the cache {"k", "v"} (B, Hk, S, hd) of an
    attention layer or the state {"h", "conv"} of a Mamba layer after
    position ``n_valid - 1`` (default the last).  Positions from ``n_valid``
    on are padding.  The norms and the MLP run over blocks of
    ``rt.prefill_rows`` positions, as the mixers' projections do."""
    x, cache = _mix(p, x, cfg, rt, n_valid)
    if p.ffn is None:
        return x, cache
    return by_rows(lambda xr: xr + _ffn(p, rms_norm(xr, p.ln2, cfg.norm_eps), cfg, rt),
                   x, rt.prefill_rows), cache


def apply_block_train(p: Block, x: torch.Tensor, *, cfg: ArchConfig,
                      rt: Runtime) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward of one layer (mode "train" in the reference):
    the prefill's arithmetic over the whole sequence, differentiable, its
    cache not kept.  Returns (x, aux), aux the MoE router's loss (a float32
    0-d tensor, 0 for other FFNs).  Attention takes its gradient through the
    flash backward (K3-bwd), Mamba through the selective scan's (K4-bwd).  A
    MoE FFN dispatches once over all B x S tokens at the training capacity,
    as ``moe.py:229-236`` does, never by row blocks: the capacity depends on
    the dispatch's tokens.  On a data mesh the tokens are the rank's rows
    and aux its share (``moe.apply_moe``)."""
    if p.spec.ffn != "moe":
        return apply_block(p, x, cfg, rt)[0], torch.zeros((), dtype=torch.float32,
                                                          device=x.device)
    x, _ = _mix(p, x, cfg, rt)
    y, aux = moe_mod.apply_moe(p.ffn, rms_norm(x, p.ln2, cfg.norm_eps), cfg, train=True,
                               group=rt.data_group())
    return x + y, aux


def apply_block_prefill_paged(p: Block, x: torch.Tensor, cfg: ArchConfig, rt: Runtime,
                              cache: Dict[str, torch.Tensor], page_tables: torch.Tensor, *,
                              s0: int, n_valid: int, base: int) -> torch.Tensor:
    """One chunk of a chunked prefill (attention mixers only) against the
    layer's page pools, which it updates in place: x (1, S, d) is the prefill
    row blocks the chunk touches, row j at position ``base + j``, the chunk
    positions ``s0 .. s0 + n_valid - 1``
    (``attention.apply_attention_prefill_paged``).  Returns x."""
    if p.spec.mixer != "attn":
        raise NotImplementedError("chunked paged prefill supports attn mixers only")
    rows = rt.prefill_rows
    h = by_rows(lambda xr: rms_norm(xr, p.ln1, cfg.norm_eps), x, rows)
    mixer = mla_mod.apply_mla_prefill_paged if cfg.mla else attn_mod.apply_attention_prefill_paged
    x = x + mixer(p.mixer, h, cfg, rt, cache, page_tables, s0=s0, n_valid=n_valid, base=base)
    if p.ffn is None:
        return x
    return by_rows(lambda xr: xr + _ffn(p, rms_norm(xr, p.ln2, cfg.norm_eps), cfg, rt), x, rows)


def _ffn(p: Block, h: torch.Tensor, cfg: ArchConfig, rt: Runtime) -> torch.Tensor:
    """The layer's FFN in prefill and decode: SwiGLU (summed over the
    "model" group), or the MoE's dropless eval (one dispatch over the rows
    given: one row block)."""
    if p.spec.ffn == "moe":
        return moe_mod.apply_moe(p.ffn, h, cfg)
    return all_reduce_sum(apply_mlp(p.ffn, h), rt.model_group())


def apply_block_decode_paged(p: Block, x: torch.Tensor, cfg: ArchConfig, rt: Runtime,
                             cache: Dict[str, torch.Tensor], lengths: torch.Tensor,
                             page_tables: torch.Tensor) -> torch.Tensor:
    """One decode step of x (B, 1, d) against the layer's cache, which it
    updates in place: an attention layer's page pools (K/V, or MLA's latent
    pools), or a Mamba layer's slot-major state (which the lengths and page
    tables do not index).  The norms and the FFN run over blocks of
    ``rt.decode_rows`` rows."""
    if p.spec.mixer == "attn":
        attend = (mla_mod.apply_mla_decode_paged if cfg.mla
                  else attn_mod.apply_attention_decode_paged)
        return _decode(p, x, cfg, rt, lambda h: attend(p.mixer, h, cfg, rt, cache, lengths,
                                                       page_tables))
    return _decode(p, x, cfg, rt,
                   lambda h: mamba_mod.apply_mamba_decode(p.mixer, h, cfg, cache, rt))


def apply_block_decode(p: Block, x: torch.Tensor, cfg: ArchConfig, rt: Runtime,
                       cache: Dict[str, torch.Tensor], lengths: torch.Tensor) -> torch.Tensor:
    """``apply_block_decode_paged`` against the contiguous cache
    (``LM.init_cache``): an attention layer's K/V (B, Hk, max_seq, hd) or
    MLA's latents (B, max_seq, r), written at each row's length, or a Mamba
    layer's state; updated in place."""
    if p.spec.mixer == "attn":
        attend = mla_mod.apply_mla_decode if cfg.mla else attn_mod.apply_attention_decode
        return _decode(p, x, cfg, rt, lambda h: attend(p.mixer, h, cfg, rt, cache, lengths))
    return _decode(p, x, cfg, rt,
                   lambda h: mamba_mod.apply_mamba_decode(p.mixer, h, cfg, cache, rt))


def _decode(p: Block, x: torch.Tensor, cfg: ArchConfig, rt: Runtime, mix) -> torch.Tensor:
    """One decode step of a layer: x plus ``mix(ln1(x))``, then the FFN; the
    norms and the FFN over blocks of ``rt.decode_rows`` rows."""
    rows = rt.decode_rows or x.shape[0]
    x = x + mix(by_batch(lambda xb: rms_norm(xb, p.ln1, cfg.norm_eps), x, rows))
    if p.ffn is None:
        return x
    return by_batch(lambda xb: xb + _ffn(p, rms_norm(xb, p.ln2, cfg.norm_eps), cfg, rt), x, rows)
