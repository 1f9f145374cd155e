"""Sharded serve data plane: ``Runtime`` + ``Rules`` -> each rank's tensors
(the counterpart of ``repro/serve/sharding.py``).

This is the one place the serve engine meets a device mesh.  Given a
``Runtime`` carrying a ``DeviceMesh`` (and optionally explicit ``Rules``;
``Rules.for_serving`` is the default policy: tensor parallelism over "model",
page pool, decode slots and ``embed`` replicated), a :class:`ShardingPlan`

* builds the rank's model (``shard_params``): each parameter's spec comes
  from ``Rules.param_pspec`` over its logical axes at the whole model's
  shape, and the rank keeps the slice the spec names, as plain local
  tensors under a config of local widths (``local_config``: ``n_heads / K``,
  ``n_kv_heads / K``, ``d_ff / K``, the Mamba inner width / K), so the
  model's code and the kernels (K3, K2, K4) run unchanged over the rank's
  heads and channels;
* checks the paged cache (``shard_cache``): pools split along
  ``act_kv_heads``, Mamba states along ``mamba_inner``, the page axis
  (``cache_batch``) replicated so any slot's page table can reference any
  page;
* wraps the decode and prefill-chunk calls in ``sharded_decode`` /
  ``sharded_prefill_chunk`` spans (``component="sharding.dispatch"``,
  ``world=K``) when tracing is on (``sharding.py:100-119``).

GSPMD puts the collectives; the port calls them where GSPMD does
(``repro_torch.dist.collectives``): a sum over the "model" group after each
row-parallel product, the vocab-parallel embedding's masked sum, and the
logits gathered to every rank before the host reads them.  Tokens, lengths
and page tables stay replicated: every rank runs the same host loop, and the
gathered logits are the same bits on every rank, so the ranks stay in step.

One leaf is sliced otherwise than its spec's contiguous block: Mamba's
``in_proj`` (d, 2 Dn) holds the x and z halves side by side; its spec shards
the 2 Dn columns, and the rank keeps its slice of each half (GSPMD would
move the halves between ranks at the split; the port slices them so that no
collective is needed there).

What the plan refuses, by name and never by replicating a dim the model
would have to split (``NotImplementedError`` naming ROADMAP.md):

* at world size > 1, MLA (its latent pools have no head axis) and the MoE
  FFN (the ``expert`` axis takes the reference's ``shard_map`` path): queue 1
  item 10;
* at world size > 1, a spec that would split a head or a channel group: the
  heads or KV heads not dividing K (where ``CACHE_AXES``' ``cache_head_dim``
  takes the model axis), query heads sharded without their KV heads, or a
  Mamba inner width or FFN width that does not divide K;
* a parameter sharded over any axis but "model" (``Rules.default``'s FSDP
  over "data" is the trainer's mesh, ``repro_torch.training.trainer``;
  serving keeps each parameter whole over "data"): queue 1 item 7.

The reference refuses ``paged_impl="pallas"`` at world size > 1, its kernel
being host-compiled; the port does not: K2 runs rank-locally over the rank's
KV heads, and so does K3 in prefill.

The plan is geometry only until ``shard_params`` builds a model: a
(1, 1) mesh returns the caller's model itself, bitwise the unsharded engine.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.partitioning import MODEL_AXIS, Rules, Spec, entry_axes, mesh_axes
from repro_torch.models import param as param_mod
from repro_torch.models.blocks import fill_param
from repro_torch.models.model import LM, Shard
from repro_torch.models.param import Axes

# leaves whose sharded dim is a concatenation of equal parts, each sliced
SPLIT_PARTS = {"in_proj": 2}


def mesh_world_size(mesh) -> int:
    if mesh is None:
        return 1
    size = 1
    for n in mesh_axes(mesh)[1]:
        size *= n
    return size


def _refuse(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"tensor-parallel serving: {what} (ROADMAP.md, queue 1 item "
                               f"{item})")


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """Placement of one serve engine's state on one mesh.  ``rank`` is this
    process's index along "model" (None: the mesh's own, which a stand-in
    mesh must give explicitly)."""

    mesh: Any
    rules: Rules
    rank: Optional[int] = None

    # ------------------------------------------------------------------
    @classmethod
    def for_runtime(cls, rt) -> Optional["ShardingPlan"]:
        """Plan for ``Runtime`` ``rt``; ``None`` when it carries no mesh."""
        if rt.mesh is None:
            return None
        return cls(mesh=rt.mesh, rules=rt.rules or Rules.for_serving(rt.mesh))

    @property
    def world(self) -> int:
        """The size of the mesh's "model" axis."""
        names, shape = mesh_axes(self.mesh)
        return dict(zip(names, shape)).get(MODEL_AXIS, 1)

    def sharded(self, entry) -> bool:
        """Whether a spec entry splits its dim over the ranks (the "model"
        axis at a size above 1)."""
        return self.world > 1 and MODEL_AXIS in entry_axes(entry)

    @property
    def model_rank(self) -> int:
        if self.rank is not None:
            return self.rank
        return 0 if self.world == 1 else self.mesh.get_local_rank(MODEL_AXIS)

    # ------------------------------------------------------------------
    def param_specs(self, lm: LM) -> Iterator[Tuple[torch.Tensor, str, Axes, Spec]]:
        """Each parameter of ``lm`` (a whole model, on any device, "meta"
        too) in ``init_params``' order, with its name, logical axes and spec
        at its shape."""
        axes = {id(t): (path[-1], ax) for path, t, ax in lm.leaf_axes()}
        for t, _, _ in lm.init_entries():
            name, ax = axes[id(t)]
            yield t, name, ax, self.rules.param_pspec(ax, tuple(t.shape))

    def cache_specs(self, cfg: ArchConfig) -> List[Dict[str, Spec]]:
        """Each layer's cache leaves' specs at the whole model's paged-pool
        shapes (any page count: the page axis is replicated)."""
        out = []
        for spec in cfg.layer_specs():
            shapes = _cache_shapes(cfg, spec)
            out.append({name: self.rules.act_pspec(ax, shapes[name])
                        for name, ax in param_mod.layer_cache_axes(cfg, spec).items()})
        return out

    def check(self, cfg: ArchConfig) -> None:
        """Raise for a config or rules this plan cannot place (module
        docstring)."""
        specs = {}
        for _, name, axes, spec in self.param_specs(LM(cfg, "meta")):
            specs[name] = spec
            for ax, e in zip(axes, spec):
                if any(a != MODEL_AXIS and self.rules.axis_sizes[a] > 1
                       for a in entry_axes(e)):
                    raise _refuse(f"{name} sharded over {e}: only 'model' is placed here; "
                                  "FSDP over 'data' is the trainer's", 7)
                if ax == "embed" and self.sharded(e):
                    raise _refuse(f"{name}'s d_model dim sharded ({spec}): the serve plan "
                                  "keeps d_model whole", 7)
        if self.world == 1:
            return
        k = self.world
        if cfg.mla is not None:
            raise _refuse(f"{cfg.name}'s MLA layers (latent pools without a head axis)", 10)
        if any(spec.ffn == "moe" for spec in cfg.layer_specs()):
            raise _refuse(f"{cfg.name}'s MoE FFN: its 'expert' axis needs the reference's "
                          "shard_map path", 10)
        sharded = {name: any(self.sharded(e) for e in spec) for name, spec in specs.items()}
        if cfg.uses_attention:
            h, hk = cfg.n_heads, cfg.n_kv_heads
            if sharded["wq"] and h % k or sharded["wk"] and hk % k:
                raise _refuse(f"{cfg.name}: {h} heads over {hk} KV heads do not divide "
                              f"{k} ranks; the spec would split a head", 10)
            if sharded["wq"] != sharded["wk"]:
                raise _refuse(f"{cfg.name}: query heads sharded without their KV heads "
                              f"(wq {specs['wq']}, wk {specs['wk']})", 10)
            for layer in self.cache_specs(cfg):
                for name in ("k", "v"):
                    if name in layer and self.sharded(layer[name][3]):
                        raise _refuse(f"{cfg.name}: the KV pool's spec {layer[name]} shards "
                                      "cache_head_dim, splitting each head", 10)
        for name, width, what in (("w_down", cfg.d_ff, "FFN width"),
                                  ("out_proj", _d_inner(cfg), "Mamba inner width")):
            if name in sharded and not sharded[name]:
                raise _refuse(f"{cfg.name}: its {what} {width} is not split over {k} ranks "
                              "(it does not divide them, or the rules keep it whole)", 10)

    def local_config(self, cfg: ArchConfig) -> ArchConfig:
        """The rank's config: ``cfg`` at its local widths (``check`` first)."""
        self.check(cfg)
        return self._local_widths(cfg)

    def _local_widths(self, cfg: ArchConfig) -> ArchConfig:
        k = self.world
        if k == 1:
            return cfg
        changes: Dict[str, Any] = {}
        if cfg.uses_attention:
            changes.update(n_heads=cfg.n_heads // k, n_kv_heads=cfg.n_kv_heads // k)
        if cfg.d_ff:
            changes["d_ff"] = cfg.d_ff // k
        if cfg.mamba is not None:
            changes["mamba"] = dataclasses.replace(cfg.mamba, d_inner=_d_inner(cfg) // k)
        return dataclasses.replace(cfg, **changes)

    # ------------------------------------------------------------------
    def slice_param(self, t: torch.Tensor, name: str, spec: Spec) -> torch.Tensor:
        """The rank's slice of ``t`` (the whole parameter) that ``spec``
        names, a view; Mamba's ``in_proj``, its slice of each half
        (``SPLIT_PARTS``) concatenated."""
        k, r = self.world, self.model_rank
        for dim, e in enumerate(spec):
            if not self.sharded(e):
                continue
            parts = SPLIT_PARTS.get(name, 1)
            n = t.shape[dim] // parts
            step = n // k
            pieces = [t.narrow(dim, p * n + r * step, step) for p in range(parts)]
            t = pieces[0] if parts == 1 else torch.cat(pieces, dim=dim)
        return t

    @torch.no_grad()
    def shard_params(self, cfg: ArchConfig, device: DeviceLike = None, *, seed: int = 0,
                     source: Optional[LM] = None) -> LM:
        """The rank's model for ``cfg``, built one matrix at a time: each
        whole matrix is drawn on ``device`` as ``LM.init_params`` draws it
        from a generator seeded with ``seed`` (or taken from ``source``, a
        whole model, such as one converted from the reference's weights),
        the rank's slice kept and the rest freed, so a rank never holds the
        whole model and its weights are the unsharded model's, sliced.  At
        world size 1 ``source`` is returned itself."""
        if source is not None:
            cfg, device = source.cfg, source.device
            if self.world == 1:
                return source
        self.check(cfg)
        device = resolve_device(device)
        whole = LM(cfg, "meta")
        vocab_sharded = self.sharded(self.rules.param_pspec(
            param_mod.TOP_AXES["embed"], (cfg.vocab_size, cfg.d_model))[0])
        local = LM(self._local_widths(cfg), device,
                   shard=Shard(self.model_rank, self.world, vocab_sharded, cfg))
        src = None if source is None else (t for t, _, _ in source.init_entries())
        gen = None if source is not None else torch.Generator(device=device).manual_seed(seed)
        # the whole model's initialisers and scales (a scale such as wo's
        # 1 / sqrt(H hd) is the whole width's), the rank's tensors to fill
        for (meta, init, scale), (_, name, _, spec), (dst, _, _) in zip(
                whole.init_entries(), self.param_specs(whole), local.init_entries()):
            if src is not None:
                full = next(src)
            else:
                full = torch.empty(meta.shape, dtype=meta.dtype, device=device)
                fill_param(full, init, scale, gen)
            part = self.slice_param(full, name, spec)
            if tuple(part.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: slice {tuple(part.shape)} for a local "
                                 f"{tuple(dst.shape)}")
            dst.copy_(part)
            del full, part
        return local

    def shard_cache(self, cache: List[Dict[str, torch.Tensor]],
                    cfg: ArchConfig) -> List[Dict[str, torch.Tensor]]:
        """Check that the rank's cache (``init_paged_cache`` of its model)
        holds the slice of each leaf that its spec names at ``cfg``'s (the
        whole model's) shape: pools split along ``act_kv_heads``, Mamba
        states along ``mamba_inner``, the page / slot axis whole.  Returns
        it."""
        for layer, specs in zip(cache, self.cache_specs(cfg)):
            whole_shapes = _cache_shapes(cfg, None, layer)
            for name, leaf in layer.items():
                want = tuple(n // self.world if self.sharded(e) else n
                             for n, e in zip(whole_shapes[name], specs[name]))
                if tuple(leaf.shape) != want:
                    raise ValueError(f"cache leaf {name}: {tuple(leaf.shape)}, the spec "
                                     f"{specs[name]} names {want}")
        return cache

    def put_replicated(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated tensor (tokens, lengths, page tables): every rank
        computes the same, so it stays where it is."""
        return x

    # ------------------------------------------------------------------
    def _dispatch_span(self, tracer, fn: Callable, name: str) -> Callable:
        """Wrap a sharded call so each dispatch emits a trace span
        (``sharding.py:100-119``); on the card the span covers the launches,
        and the engine's enclosing scope (which reads the logits) carries
        the wall time."""
        if tracer is None:
            return fn
        world = self.world

        def dispatched(*args, **kwargs):
            with tracer.span(name, component="sharding.dispatch", world=world):
                return fn(*args, **kwargs)

        return dispatched

    def decode_fn(self, lm: LM, tracer: Any = None) -> Callable:
        """``lm.decode_step_paged``, traced as ``sharded_decode``."""
        return self._dispatch_span(tracer, lm.decode_step_paged, "sharded_decode")

    def prefill_chunk_fn(self, lm: LM, tracer: Any = None) -> Callable:
        """``lm.prefill_chunk``, traced as ``sharded_prefill_chunk``."""
        return self._dispatch_span(tracer, lm.prefill_chunk, "sharded_prefill_chunk")


def _d_inner(cfg: ArchConfig) -> int:
    return 0 if cfg.mamba is None else cfg.mamba.resolved_d_inner(cfg.d_model)


def _cache_shapes(cfg: ArchConfig, spec, layer: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Dict[str, Tuple[int, ...]]:
    """A layer's whole-model cache leaf shapes (``serve/cache.py``'s
    layouts); the page / slot count from ``layer``'s leaves (else 1)."""
    def rows(name):
        return 1 if layer is None else int(layer[name].shape[0])

    if layer is not None:
        names = set(layer)
    elif spec.mixer == "attn":
        names = {"ckv", "kpe"} if cfg.mla is not None else {"k", "v"}
    else:
        names = {"h", "conv"}
    out = {}
    for name in names:
        if name in ("k", "v"):
            page = 1 if layer is None else int(layer[name].shape[2])
            out[name] = (rows(name), cfg.n_kv_heads, page, cfg.head_dim)
        elif name in ("ckv", "kpe"):
            page = 1 if layer is None else int(layer[name].shape[1])
            width = cfg.mla.kv_lora_rank if name == "ckv" else cfg.mla.qk_rope_head_dim
            out[name] = (rows(name), page, width)
        else:
            last = cfg.mamba.d_state if name == "h" else cfg.mamba.d_conv - 1
            out[name] = (rows(name), _d_inner(cfg), last)
    return out
