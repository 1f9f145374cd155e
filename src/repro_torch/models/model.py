"""The LM for every arch of the catalog: the dense attention archs (qwen3,
qwen1.5 with its QKV bias, stablelm), the pure Mamba archs (falcon-mamba),
jamba's hybrid period (Mamba and attention layers, MoE on the odd ones),
DeepSeek-MoE (MoE FFNs, a dense head layer), DeepSeek-V2 (MLA attention, MoE
FFNs, a dense head layer) and the frontend stubs (internvl2's vision,
musicgen's audio): the entry points of ``repro/models/model.py``.

* ``loss_fn(batch)`` — the counterpart of ``LM.loss_fn`` (``model.py:150``):
  next-token cross-entropy of a training batch plus the MoE layers' router
  aux loss, summed over the layers in order, differentiable in the
  parameters once ``trainable()`` has set their ``requires_grad``; each
  layer runs under the Runtime's ``remat`` policy, attention through the
  flash forward and its backward (K3, K3-bwd), Mamba through the selective
  scan and its backward (K4, K4-bwd), a MoE FFN at the training capacity;
  MLA's attention at its unequal key and value dims (K3-bwd at (192, 128)
  as a dv and a dk pass, at the smoke config's (24, 16) as one).  On a
  data mesh (the trainer's FSDP over "data") it takes the rank's rows and
  returns the rank's share of the global loss.
* ``prefill(tokens, frontend_embeds)`` — the counterpart of ``LM.prefill``
  (``model.py:171``): a full-sequence causal forward; returns one position's
  logits and each layer's K/V (attention), latents (MLA) or recurrent state
  (Mamba).
* ``prefill_chunk(tokens, n_valid, cache, page_tables, s0=...)`` — the
  counterpart of ``LM.prefill_chunk`` (``model.py:250``): one chunk of a
  chunked prefill into the paged pools (attention archs), run over the
  monolithic prefill's row blocks.
* ``decode_step_paged(tokens, lengths, cache, page_tables)`` — the
  counterpart of ``LM.decode_step_paged`` (``model.py:289``): one token per
  row against the paged pools and the slot-major Mamba state, which it
  updates in place; a speculative verify step's folded batch too.
* ``init_cache(batch, max_seq)`` and ``decode_step(tokens, lengths, cache,
  frontend_embed)`` — the counterparts of ``model.py:181`` and ``:214``: a
  zero contiguous cache (per layer K/V (B, Hk, max_seq, hd), MLA's latents
  (B, max_seq, r), or the Mamba state) and one token per row against it,
  updated in place; ``frontend_embed`` teacher-forces one frontend position.

The frontend stub (``model.py:55-59``, ``:101-112``): a frontend arch's
inputs are precomputed embeddings (B, F, d) that ``frontend_proj`` (d, d)
projects and that go before the token embeddings; ``loss_fn`` drops their F
positions before the head, ``prefill`` refuses a frontend arch's tokens
without them, as the reference asserts.  The product is plain
``torch.matmul``, as the reference's is outside any kernel.

The reference's ``first_k_dense`` unrolled head layers (``model.py:60-66``,
each ``period[0]`` with a dense FFN) and its ``lax.scan`` over the stacked
periods become one loop over ``n_layers`` ``Block`` entries of a
``ModuleList``, in ``cfg.layer_specs()`` order: layer l < k is a head layer,
layer l >= k is ``period[(l - k) % len(period)]``.

The model holds weights only: kernel geometry and the paged decode's
implementation come with each call, as a ``Runtime`` (the serve engine's).

A tensor-parallel rank's model (``shard``, built by
``repro_torch.serve.sharding.ShardingPlan.shard_params``) holds its slice of
every parameter under a config of its local widths (``n_heads / K``,
``n_kv_heads / K``, ``d_ff / K``, the Mamba inner width / K; ``vocab_size``
the whole vocabulary's).  Its embedding and head hold its rows of a
vocab-sharded vocabulary: the lookup masks the tokens outside them and sums
over the "model" group, and the logits are gathered to the full vocabulary
on every rank before anything reads them (``repro_torch.dist.collectives``).
Its serving entry points take the group from the call's ``Runtime``
(``rt.mesh``), whose "model" axis must be the shard's world.

``param_axes()`` and ``cache_axes()`` give the reference's logical-axes
trees (``model.py:82``, ``:201``) from ``repro_torch.models.param``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.collectives import all_reduce_, gather_vocab, vocab_parallel_embed
from repro_torch.models import blocks as blocks_mod
from repro_torch.models import param as param_mod
from repro_torch.models.layers import (
    by_batch,
    lm_logits,
    rms_norm,
    softmax_cross_entropy,
)
from repro_torch.models.runtime import Runtime

LayerCache = Dict[str, torch.Tensor]  # {"k", "v"}, {"ckv", "kpe"} or {"h", "conv"}
DEFAULT_RUNTIME = Runtime()
# (the tensor, its initialiser, its scale), in the order init_params draws
InitEntry = Tuple[torch.Tensor, str, float]


@dataclasses.dataclass(frozen=True)
class Shard:
    """The slice of the weights a tensor-parallel rank holds: rank ``rank``
    of ``world`` along the mesh's "model" axis; ``vocab`` says whether the
    embedding's and the head's vocabulary rows are split over the ranks;
    ``whole`` is the whole model's config."""

    rank: int
    world: int
    vocab: bool
    whole: ArchConfig


TRAINER_TP = ("training with tensor parallelism (a mesh whose 'model' axis is larger than 1) "
              "is not ported: the trainer's tensor parallelism, ROADMAP.md queue 1 item 7")


def check_trainable_mesh(rt: Runtime, shard=None) -> None:
    """Raise ``NotImplementedError`` by name for a training mesh with a
    "model" axis larger than 1, or a tensor-parallel rank's model: the
    trainer shards over "data" only and never silently replicates."""
    if rt.model_world() > 1 or shard is not None:
        raise NotImplementedError(TRAINER_TP)


class LM(nn.Module):
    def __init__(self, cfg: ArchConfig, device: DeviceLike = None,
                 shard: Optional[Shard] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.shard = shard
        self.dtype = getattr(torch, cfg.dtype)
        d, vocab = cfg.d_model, cfg.vocab_size
        self.vocab_start = 0
        if shard is not None and shard.vocab:
            vocab //= shard.world
            self.vocab_start = shard.rank * vocab

        def matrix(*shape):
            return nn.Parameter(torch.empty(shape, dtype=self.dtype, device=device),
                                requires_grad=False)

        self.embed = matrix(vocab, d)
        self.final_norm = nn.Parameter(torch.empty(d, dtype=torch.float32, device=device),
                                       requires_grad=False)
        self.lm_head = None if cfg.tie_embeddings else matrix(d, vocab)
        self.frontend_proj = matrix(d, d) if cfg.frontend != "none" else None
        self.layers = nn.ModuleList(
            blocks_mod.Block(cfg, spec, self.dtype, device) for spec in cfg.layer_specs())

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def init_entries(self) -> Iterator[InitEntry]:
        """Every parameter with its initialiser and scale, in the order
        ``init_params`` draws them."""
        d = self.cfg.d_model
        yield self.embed, "normal", 1.0 / math.sqrt(d)
        yield self.final_norm, "ones", 0.0
        if self.lm_head is not None:
            yield self.lm_head, "normal", 1.0 / math.sqrt(d)
        if self.frontend_proj is not None:
            yield self.frontend_proj, "normal", 1.0 / math.sqrt(d)
        for layer in self.layers:
            yield from layer.init_entries()

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "LM":
        """Random weights with the reference's initialisers (``layers.py``,
        ``attention.py``, ``mla.py``, ``mamba.py``, ``moe.py``), drawn in
        float32 from ``generator`` (on its own device) one matrix (one
        expert's matrix) at a time and stored in the config's dtype.  The
        draws are not JAX's: the CPU tests load the reference's weights
        through ``repro_torch.convert`` instead.  A rank's slice of a
        sharded model is drawn by ``ShardingPlan.shard_params``, from the
        whole model's draws."""
        if self.shard is not None and self.shard.world > 1:
            raise ValueError("a tensor-parallel rank's weights come from "
                             "ShardingPlan.shard_params, not init_params")
        for t, init, scale in self.init_entries():
            blocks_mod.fill_param(t, init, scale, generator)
        return self

    def leaf_axes(self) -> Iterator[Tuple[Tuple, torch.Tensor, param_mod.Axes]]:
        """Each parameter with its path in the reference's param tree
        (``convert.param_layout``) and its logical axes, one a dim."""
        from repro_torch.convert import param_layout

        owner = {id(p): blk.spec for blk in self.layers for p in blk.parameters()}
        for path, _, t in param_layout(self):
            if len(path) == 1:
                yield path, t, param_mod.TOP_AXES[path[0]]
                continue
            group = path[-2] if len(path) > 3 else path[-1]
            yield path, t, param_mod.layer_param_axes(self.cfg, owner[id(t)], group, path[-1])

    def param_axes(self) -> Dict:
        """The logical axes of every parameter as the reference's tree
        (``repro.models.model.LM.param_axes``): a period layer's leaves
        with a leading "layers" axis."""
        from repro_torch.convert import set_path, tuples

        tree: Dict = {}
        for path, _, axes in self.leaf_axes():
            set_path(tree, path, axes if path[0] != "periods" else ("layers",) + axes)
        return tuples(tree)

    def cache_axes(self) -> Dict:
        """The logical axes of the serving cache's leaves as the reference's
        tree (``model.py:201-210``): {"head": one dict a head layer,
        "periods": {"pos<i>": leading "layers" axis}}; the port's per-layer
        cache (``repro_torch.serve.cache``) holds the same leaves, its pools'
        dims in the same order."""
        cfg = self.cfg
        head_spec = dataclasses.replace(cfg.period[0], ffn="dense")
        return {"head": tuple(param_mod.layer_cache_axes(cfg, head_spec)
                              for _ in range(cfg.first_k_dense)),
                "periods": {f"pos{i}": {k: ("layers",) + v for k, v in
                                        param_mod.layer_cache_axes(cfg, spec).items()}
                            for i, spec in enumerate(cfg.period)}}

    def _vocab_group(self, rt: Runtime):
        """The "model" group that the embedding and head sum and gather over
        (None when the vocabulary is not split), after checking that the
        call's mesh is the one the weights were sliced for."""
        world = 1 if self.shard is None else self.shard.world
        if rt.model_world() != world:
            raise ValueError(f"the model holds a slice for {world} rank(s) along 'model', the "
                             f"runtime's mesh has {rt.model_world()}")
        if self.shard is None or not self.shard.vocab:
            return None
        return rt.model_group()

    def _embed_tokens(self, tokens: torch.Tensor, rt: Runtime) -> torch.Tensor:
        return vocab_parallel_embed(self.embed, tokens.to(self.device), self.vocab_start,
                                    self._vocab_group(rt))

    def _logits(self, x: torch.Tensor, rt: Runtime) -> torch.Tensor:
        """The head over x (..., d), gathered to the whole vocabulary."""
        return gather_vocab(lm_logits(self._head(), x), self.vocab_start, self.cfg.vocab_size,
                            self._vocab_group(rt))

    def _head(self) -> torch.Tensor:
        return self.embed.T if self.lm_head is None else self.lm_head

    def _embed_inputs(self, tokens: torch.Tensor, frontend_embeds: Optional[torch.Tensor],
                      rt: Runtime = DEFAULT_RUNTIME) -> Tuple[torch.Tensor, int]:
        """(x, n_front): the token embeddings (B, S, d), after a frontend
        arch's projected embeddings (B, F, d) in its config's dtype
        (``model.py:101-112``), and F (0 without a frontend)."""
        x = self._embed_tokens(tokens, rt)
        if self.frontend_proj is None:
            return x, 0
        if frontend_embeds is None:
            raise ValueError(f"{self.cfg.name} needs frontend_embeds")
        fe = self._project_frontend(frontend_embeds)
        return torch.cat([fe, x], dim=1), fe.shape[1]

    def _project_frontend(self, fe: torch.Tensor) -> torch.Tensor:
        """Frontend embeddings (..., d) through ``frontend_proj``, in the
        config's dtype."""
        return fe.to(self.device, self.dtype) @ self.frontend_proj

    # ------------------------------------------------------------------
    def trainable(self, flag: bool = True) -> "LM":
        """Set every parameter's ``requires_grad``: every arch trains."""
        for param in self.parameters():
            param.requires_grad_(flag)
        return self

    def loss_fn(self, batch: Dict[str, torch.Tensor], rt: Runtime = DEFAULT_RUNTIME
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: tokens (B, S), labels (B, S) already shifted, a frontend
        arch's frontend_embeds (B, F, d), optional loss_mask (B, S).  Returns
        (loss, {"ce", "aux", "tokens"}) as the reference's ``loss_fn``: the
        embedding, each layer's block (under ``rt.remat``) over the F + S
        positions, the final norm and the head over the last S in the
        config's dtype, the cross-entropy in float32; aux, the MoE layers'
        router losses summed over the layers in order (0 without MoE), is
        added to it.

        On a data mesh (``rt.data_group()`` not None) the batch is this
        rank's rows of the global batch and loss, ce and aux are the rank's
        shares of the reference's global values (what GSPMD computes for
        the global batch), so that their sums over the ranks are those
        values and the summed gradients theirs: the CE is the rank's summed
        token NLL over the global token count (``loss_mask``'s sum over the
        group), the aux the rank's share of each MoE layer's
        (``repro_torch.models.moe.route``); ``tokens`` is the global
        count.  A mesh whose "model" axis is larger than 1 raises."""
        cfg = self.cfg
        check_trainable_mesh(rt, self.shard)
        group = rt.data_group()
        labels = batch["labels"].to(self.device)
        mask = batch.get("loss_mask")
        x, n_front = self._embed_inputs(batch["tokens"], batch.get("frontend_embeds"))
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for layer in self.layers:
            x, layer_aux = rt.remat_call(functools.partial(blocks_mod.apply_block_train, layer,
                                                           cfg=cfg, rt=rt), x)
            aux = aux + layer_aux
        x = rms_norm(x[:, n_front:], self.final_norm, cfg.norm_eps)
        logits = lm_logits(self._head(), x)
        ce = softmax_cross_entropy(logits, labels, None if mask is None else mask.to(self.device),
                                   group=group)
        tokens = torch.tensor(float(labels.numel()), device=self.device)
        return ce + aux, {"ce": ce, "aux": aux, "tokens": all_reduce_(tokens, group)}

    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, frontend_embeds: Optional[torch.Tensor] = None, *,
                n_valid: Optional[int] = None, rt: Runtime = DEFAULT_RUNTIME
                ) -> Tuple[torch.Tensor, List[LayerCache]]:
        """tokens (B, S) int, after a frontend arch's ``frontend_embeds``
        (B, F, d) (F = 0 without a frontend).  Returns (logits (B, V) at
        position ``F + n_valid - 1`` (default the last), per-layer cache over
        the F + S positions: {"k", "v"} of shape (B, Hk, F + S, hd) for
        attention, {"ckv" (B, F + S, r), "kpe" (B, F + S, rope)} for MLA, the
        state {"h", "conv"} after position ``F + n_valid - 1`` for Mamba).
        Token positions from ``n_valid`` on are padding: causality keeps
        them out of every earlier position's result, the attention reads no
        key among them (so padded rows cost it little), and the Mamba scan
        holds its state across them."""
        cfg = self.cfg
        x, n_front = self._embed_inputs(tokens, frontend_embeds, rt)
        last = n_front + (tokens.shape[1] if n_valid is None else int(n_valid))
        caches = []
        for layer in self.layers:
            x, c = blocks_mod.apply_block(layer, x, cfg, rt,
                                          n_valid=None if n_valid is None else last)
            caches.append(c)
        x = rms_norm(x[:, last - 1:last], self.final_norm, cfg.norm_eps)
        return self._logits(x, rt)[:, 0], caches

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
        x = self._embed_tokens(ids, rt)
        for layer, c in zip(self.layers, cache):
            x = blocks_mod.apply_block_prefill_paged(layer, x, cfg, rt, c, page_tables, s0=s0,
                                                     n_valid=n, base=base)
        x = rms_norm(x[:, span.stop - 1:span.stop], self.final_norm, cfg.norm_eps)
        return self._logits(x, rt)[:, 0], cache

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
        x = self._embed_tokens(tokens[:, None], rt)
        for layer, c in zip(self.layers, cache):
            x = blocks_mod.apply_block_decode_paged(layer, x, cfg, rt, c, lengths, page_tables)
        return by_batch(lambda xb: self._logits(rms_norm(xb, self.final_norm, cfg.norm_eps)[:, 0],
                                                rt),
                        x, rt.decode_rows or x.shape[0]), cache

    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int) -> List[LayerCache]:
        """A zero contiguous cache for ``decode_step`` (``model.py:181``), a
        dict a layer: {"k", "v"} (B, Hk, max_seq, hd) for attention,
        {"ckv" (B, max_seq, r), "kpe" (B, max_seq, rope)} for MLA, in the
        config's dtype, the state {"h" (B, Dn, N) float32, "conv" (B, Dn,
        d_conv - 1)} for Mamba."""
        cfg = self.cfg

        def zeros(*shape, dtype=self.dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        cache: List[LayerCache] = []
        for layer in self.layers:
            if layer.spec.mixer == "attn" and cfg.mla is not None:
                m = cfg.mla
                cache.append({"ckv": zeros(batch, max_seq, m.kv_lora_rank),
                              "kpe": zeros(batch, max_seq, m.qk_rope_head_dim)})
            elif layer.spec.mixer == "attn":
                shape = (batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
                cache.append({"k": zeros(*shape), "v": zeros(*shape)})
            else:
                mc = cfg.mamba
                di = mc.resolved_d_inner(cfg.d_model)
                cache.append({"h": zeros(batch, di, mc.d_state, dtype=torch.float32),
                              "conv": zeros(batch, di, mc.d_conv - 1)})
        return cache

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, lengths: torch.Tensor,
                    cache: List[LayerCache], frontend_embed: Optional[torch.Tensor] = None,
                    rt: Runtime = DEFAULT_RUNTIME) -> Tuple[torch.Tensor, List[LayerCache]]:
        """tokens (B,) int; lengths (B,) the current fill (also the new
        token's position); cache ``init_cache``'s, or a prefill's at
        ``max_seq`` positions.  ``frontend_embed`` (B, d), when given, is
        projected through ``frontend_proj`` and decoded in place of the token
        embedding, teacher-forcing one frontend position (``tokens`` is then
        not read).  Returns (logits (B, V), cache), the cache updated in
        place (``model.py:214-246``)."""
        cfg = self.cfg
        if frontend_embed is not None:
            if self.frontend_proj is None:
                raise ValueError(f"{cfg.name} has no frontend")
            x = self._project_frontend(frontend_embed[:, None])
        else:
            x = self._embed_tokens(tokens[:, None], rt)
        lengths = lengths.to(self.device)
        for layer, c in zip(self.layers, cache):
            x = blocks_mod.apply_block_decode(layer, x, cfg, rt, c, lengths)
        return by_batch(lambda xb: self._logits(rms_norm(xb, self.final_norm, cfg.norm_eps)[:, 0],
                                                rt),
                        x, rt.decode_rows or x.shape[0]), cache
