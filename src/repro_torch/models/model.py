"""The LM for the dense attention archs (qwen3-14b), the pure Mamba archs
(falcon-mamba-7b), DeepSeek-MoE (MoE FFNs, a dense head layer) and
DeepSeek-V2 (MLA attention, MoE FFNs, a dense head layer): the serving
entry points of ``repro/models/model.py``, and its training entry point.

* ``loss_fn(batch)`` — the counterpart of ``LM.loss_fn`` (``model.py:150``):
  next-token cross-entropy of a training batch plus the MoE layers' router
  aux loss, summed over the layers in order, differentiable in the
  parameters once ``trainable()`` has set their ``requires_grad``; each
  layer runs under the Runtime's ``remat`` policy, attention through the
  flash forward and its backward (K3, K3-bwd), Mamba through the selective
  scan and its backward (K4, K4-bwd), a MoE FFN at the training capacity;
  MLA's attention at its unequal key and value dims (K3-bwd at (192, 128)
  as a dv and a dk pass, at the smoke config's (24, 16) as one).  The
  frontends and jamba are not ported and raise (ROADMAP.md).

* ``prefill(tokens)`` — the counterpart of ``LM.prefill`` (``model.py:171``):
  a full-sequence causal forward; returns one position's logits and each
  layer's K/V (attention), latents (MLA) or recurrent state (Mamba).
* ``prefill_chunk(tokens, n_valid, cache, page_tables, s0=...)`` — the
  counterpart of ``LM.prefill_chunk`` (``model.py:250``): one chunk of a
  chunked prefill into the paged pools (attention archs), run over the
  monolithic prefill's row blocks.
* ``decode_step_paged(tokens, lengths, cache, page_tables)`` — the
  counterpart of ``LM.decode_step_paged`` (``model.py:289``): one token per
  row against the paged pools and the slot-major Mamba state, which it
  updates in place; a speculative verify step's folded batch too.

The reference's ``first_k_dense`` unrolled head layers (``model.py:60-66``,
each ``period[0]`` with a dense FFN) and its ``lax.scan`` over the stacked
periods become one loop over ``n_layers`` ``Block`` entries of a
``ModuleList``, in ``cfg.layer_specs()`` order: layer l < k is a head layer,
layer l >= k is ``period[(l - k) % len(period)]``.  Archs with a frontend
are not ported yet and raise, and so does jamba, whose blocks would
construct but which no parity test holds yet (ROADMAP.md).

The model holds weights only: kernel geometry and the paged decode's
implementation come with each call, as a ``Runtime`` (the serve engine's).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import blocks as blocks_mod
from repro_torch.models.layers import (
    by_batch,
    embed_tokens,
    lm_logits,
    rms_norm,
    softmax_cross_entropy,
)
from repro_torch.models.runtime import Runtime

LayerCache = Dict[str, torch.Tensor]  # {"k", "v"}, {"ckv", "kpe"} or {"h", "conv"}
DEFAULT_RUNTIME = Runtime()


# archs whose blocks construct but whose port no parity test holds yet
NOT_YET_HELD = ("jamba",)


def check_supported(cfg: ArchConfig) -> None:
    """Raise for what the port's LM does not run yet."""
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the PyTorch port runs no {cfg.frontend} frontend yet; "
            "see ROADMAP.md for the slices that bring the rest")
    if cfg.name.startswith(NOT_YET_HELD):
        raise NotImplementedError(
            f"{cfg.name}: not held against the reference by a parity test yet; "
            "see ROADMAP.md for the slice that brings it")


class LM(nn.Module):
    def __init__(self, cfg: ArchConfig, device: DeviceLike = None):
        super().__init__()
        check_supported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        d, vocab = cfg.d_model, cfg.vocab_size

        def matrix(*shape):
            return nn.Parameter(torch.empty(shape, dtype=self.dtype, device=device),
                                requires_grad=False)

        self.embed = matrix(vocab, d)
        self.final_norm = nn.Parameter(torch.empty(d, dtype=torch.float32, device=device),
                                       requires_grad=False)
        self.lm_head = None if cfg.tie_embeddings else matrix(d, vocab)
        self.layers = nn.ModuleList(
            blocks_mod.Block(cfg, spec, self.dtype, device) for spec in cfg.layer_specs())

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "LM":
        """Random weights with the reference's initialisers (``layers.py``,
        ``attention.py``, ``mla.py``, ``mamba.py``, ``moe.py``), drawn in
        float32 from ``generator`` (on its own device) one matrix (one
        expert's matrix) at a time and stored in the config's dtype.  The
        draws are not JAX's: the CPU tests load the reference's weights
        through ``repro_torch.convert`` instead."""
        d = self.cfg.d_model
        blocks_mod.fill_param(self.embed, "normal", 1.0 / math.sqrt(d), generator)
        self.final_norm.fill_(1.0)
        if self.lm_head is not None:
            blocks_mod.fill_param(self.lm_head, "normal", 1.0 / math.sqrt(d), generator)
        for layer in self.layers:
            layer.init_params(generator)
        return self

    def _head(self) -> torch.Tensor:
        return self.embed.T if self.lm_head is None else self.lm_head

    # ------------------------------------------------------------------
    def trainable(self, flag: bool = True) -> "LM":
        """Set every parameter's ``requires_grad``.  Every arch the LM is
        built for trains (``check_supported`` refuses the rest at
        construction)."""
        for param in self.parameters():
            param.requires_grad_(flag)
        return self

    def loss_fn(self, batch: Dict[str, torch.Tensor], rt: Runtime = DEFAULT_RUNTIME
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: tokens (B, S), labels (B, S) already shifted, optional
        loss_mask (B, S).  Returns (loss, {"ce", "aux", "tokens"}) as the
        reference's ``loss_fn``: the embedding, each layer's block (under
        ``rt.remat``), the final norm and the head in the config's dtype,
        the cross-entropy in float32; aux, the MoE layers' router losses
        summed over the layers in order (0 without MoE), is added to it."""
        cfg = self.cfg
        tokens = batch["tokens"].to(self.device)
        labels = batch["labels"].to(self.device)
        mask = batch.get("loss_mask")
        x = embed_tokens(self.embed, tokens)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for layer in self.layers:
            x, layer_aux = rt.remat_call(functools.partial(blocks_mod.apply_block_train, layer,
                                                           cfg=cfg, rt=rt), x)
            aux = aux + layer_aux
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        logits = lm_logits(self._head(), x)
        ce = softmax_cross_entropy(logits, labels, None if mask is None else mask.to(self.device))
        return ce + aux, {"ce": ce, "aux": aux,
                          "tokens": torch.tensor(float(labels.numel()), device=self.device)}

    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, n_valid: Optional[int] = None,
                rt: Runtime = DEFAULT_RUNTIME) -> Tuple[torch.Tensor, List[LayerCache]]:
        """tokens (B, S) int.  Returns (logits (B, V) at position
        ``n_valid - 1`` (default the last), per-layer cache: {"k", "v"} of
        shape (B, Hk, S, hd) for attention, {"ckv" (B, S, r), "kpe" (B, S,
        rope)} for MLA, the state {"h", "conv"} after position
        ``n_valid - 1`` for Mamba).  Positions from ``n_valid`` on
        are padding: causality keeps them out of every earlier position's
        result, the attention reads no key among them (so padded rows cost
        it little), and the Mamba scan holds its state across them."""
        cfg = self.cfg
        x = embed_tokens(self.embed, tokens.to(self.device))
        caches = []
        for layer in self.layers:
            x, c = blocks_mod.apply_block(layer, x, cfg, rt, n_valid=n_valid)
            caches.append(c)
        last = tokens.shape[1] if n_valid is None else int(n_valid)
        x = rms_norm(x[:, last - 1:last], self.final_norm, cfg.norm_eps)
        return lm_logits(self._head(), x)[:, 0], caches

    @torch.no_grad()
    def prefill_chunk(self, tokens: torch.Tensor, n_valid: int, cache: List[LayerCache],
                      page_tables: torch.Tensor, *, s0: int,
                      rt: Runtime = DEFAULT_RUNTIME) -> Tuple[torch.Tensor, List[LayerCache]]:
        """One chunk of a chunked paged prefill (attention archs): tokens
        (1, C), of which the first ``n_valid`` are the prompt's positions
        ``s0 .. s0 + n_valid - 1``; page_tables (1, npp) the request's row.
        Each layer scatters the chunk's K/V (MLA: latents) into the request's
        pages, then attends with ``q_offset = s0`` over the gathered row.

        Every row-wise step runs over the monolithic prefill's row blocks
        (``rt.prefill_rows`` rows, block i holding positions from i x rows):
        the chunk's positions sit at their rows of the blocks they fall in,
        the other rows are padding, and the tokens past
        ``n_valid`` are not computed.  So after the last chunk the pages and
        the last position's logits are bitwise those of ``prefill`` over the
        prompt padded to whole blocks.  Returns (logits (1, V) at position
        ``s0 + n_valid - 1``, computed as ``prefill`` computes its one
        position, cache); the reference returns every row's (1, C, V)."""
        cfg = self.cfg
        rows, n = rt.prefill_rows, int(n_valid)
        if not 1 <= n <= tokens.shape[1]:
            raise ValueError(f"n_valid={n} outside 1..{tokens.shape[1]}")
        base = s0 // rows * rows
        span = slice(s0 - base, s0 - base + n)
        ids = torch.zeros((1, -(-(s0 + n - base) // rows) * rows), dtype=torch.int64,
                          device=self.device)
        ids[:, span] = tokens[:, :n].to(self.device)
        x = embed_tokens(self.embed, ids)
        for layer, c in zip(self.layers, cache):
            x = blocks_mod.apply_block_prefill_paged(layer, x, cfg, rt, c, page_tables, s0=s0,
                                                     n_valid=n, base=base)
        x = rms_norm(x[:, span.stop - 1:span.stop], self.final_norm, cfg.norm_eps)
        return lm_logits(self._head(), x)[:, 0], cache

    @torch.no_grad()
    def decode_step_paged(self, tokens: torch.Tensor, lengths: torch.Tensor,
                          cache: List[LayerCache], page_tables: torch.Tensor,
                          rt: Runtime = DEFAULT_RUNTIME
                          ) -> Tuple[torch.Tensor, List[LayerCache]]:
        """tokens (B,) int; lengths (B,) int32, the current fill (also the new
        token's position); cache the per-layer page pools
        (``repro_torch.serve.cache.init_paged_cache``); page_tables
        (B, pages_per_seq) int32, page 0 the scratch page idle slots write
        into; MLA layers' pools are the latent pages.  Mamba layers' caches
        are the slot-major state (``init_paged_cache``), which lengths and
        tables do not index.
        Rows may be a speculative verify step's fold, several rows of one
        sequence at consecutive positions (each layer scatters every row's
        K/V before any attends); the row-wise steps, the head included, run
        over blocks of ``rt.decode_rows`` rows.
        Returns (logits (B, V), cache), the pools and states updated in
        place."""
        cfg = self.cfg
        x = embed_tokens(self.embed, tokens.to(self.device)[:, None])
        for layer, c in zip(self.layers, cache):
            x = blocks_mod.apply_block_decode_paged(layer, x, cfg, rt, c, lengths, page_tables)
        return by_batch(lambda xb: lm_logits(self._head(),
                                             rms_norm(xb, self.final_norm, cfg.norm_eps)[:, 0]),
                        x, rt.decode_rows or x.shape[0]), cache
