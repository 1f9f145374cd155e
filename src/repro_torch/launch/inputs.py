"""Meta-device stand-ins for every input of a cell's step, at one rank's
local shapes (the counterpart of ``repro/launch/inputs.py``).

The reference returns ``ShapeDtypeStruct``s with ``NamedSharding``s, global
shapes that GSPMD cuts.  The port runs one rank's program, so each function
here returns ``Placed``: tensors on the mesh's device (the "meta" device,
no memory, for the dry-run), zeros at the rank's local shape, and beside
them each leaf's ``LeafSharding`` (its spec at the whole shape,
``repro_torch.runtime.elastic``), from which the local shape follows.  The
mesh is a ``repro_torch.launch.mesh.StandInMesh``: every rank of a cell has
the same local shapes under the Rules' divisibility rules, so one rank
speaks for the cell.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.dist.partitioning import Rules, mesh_axes
from repro_torch.models import param as param_mod
from repro_torch.models.model import LM
from repro_torch.runtime.elastic import (
    LeafSharding,
    mesh_coordinate,
    mesh_device,
    shardings_for,
)
from repro_torch.training.trainer import meta_tree, tp_pieces, whole_config
from repro_torch.training.tree import tree_leaves, tree_map

# the sequence dim of the contiguous cache's leaves (LM.init_cache)
SEQ_DIM = {"k": 2, "v": 2, "ckv": 1, "kpe": 1}


class Placed(NamedTuple):
    """A tree of meta tensors at one rank's local shapes, and the
    ``LeafSharding`` of each leaf."""

    values: Any
    shardings: Any


def text_seq_len(cfg: ArchConfig, shape: ShapeSpec) -> int:
    """Frontend-stub archs spend n_frontend_tokens of the sequence budget."""
    if shape.kind == "train" or shape.kind == "prefill":
        return shape.seq_len - cfg.n_frontend_tokens
    return shape.seq_len


def _act(mesh, rules: Rules, axes, whole, dtype) -> Tuple[torch.Tensor, LeafSharding]:
    """A meta tensor at the rank's block of an activation of shape ``whole``
    with logical ``axes``, and its sharding."""
    names, sizes = mesh_axes(mesh)
    sh = LeafSharding(rules.act_pspec(axes, whole), dict(zip(names, sizes)),
                      mesh_coordinate(mesh), mesh_device(mesh), mesh)
    return torch.zeros(sh.local_shape(whole), dtype=dtype, device=mesh_device(mesh)), sh


def _placed(pairs: Dict[str, Tuple[torch.Tensor, LeafSharding]]) -> Placed:
    """A dict of (tensor, sharding) pairs as ``Placed``."""
    return Placed({k: v for k, (v, _) in pairs.items()}, {k: s for k, (_, s) in pairs.items()})


def batch_sds(cfg: ArchConfig, shape: ShapeSpec, mesh, rules: Rules) -> Placed:
    """Train/prefill batch stand-ins: tokens (and labels for train) (B, S),
    a frontend arch's embeddings (B, F, d) float32, at the rank's rows."""
    b = shape.global_batch
    s_text = text_seq_len(cfg, shape)
    out = {"tokens": _act(mesh, rules, ("batch", "seq"), (b, s_text), torch.int32)}
    if shape.kind == "train":
        out["labels"] = _act(mesh, rules, ("batch", "seq"), (b, s_text), torch.int32)
    if cfg.frontend != "none":
        out["frontend_embeds"] = _act(mesh, rules, ("batch", "frontend_seq", None),
                                      (b, cfg.n_frontend_tokens, cfg.d_model), torch.float32)
    return _placed(out)


def decode_sds(cfg: ArchConfig, shape: ShapeSpec, mesh, rules: Rules,
               lm: LM) -> Tuple[Placed, Placed, Placed]:
    """(tokens, lengths, cache) stand-ins for ``LM.decode_step``: the rank's
    rows of the batch, and the cache (``init_cache``'s leaves) at the block
    each leaf's spec names at the whole model's shape, checked against the
    rank's LM (its KV heads or Mamba channels).  Under
    ``rules_for_cell``'s long-context branch the attention leaves hold the
    rank's block of positions (``cache_seq`` over the batch axes; the
    decode merges the ranks' partial softmaxes,
    ``repro_torch.models.attention``)."""
    b = shape.global_batch
    tokens = _act(mesh, rules, ("batch",), (b,), torch.int32)
    lengths = _act(mesh, rules, ("batch",), (b,), torch.int32)
    whole_lm = LM(cfg, "meta")
    names, sizes = mesh_axes(mesh)
    cache, shardings = [], []
    for whole, spec in zip(whole_lm.init_cache(b, shape.seq_len), cfg.layer_specs()):
        spec_of = param_mod.layer_cache_axes(cfg, spec)
        layer, specs = {}, {}
        for name, leaf in whole.items():
            sh = LeafSharding(rules.act_pspec(spec_of[name], tuple(leaf.shape)),
                              dict(zip(names, sizes)), mesh_coordinate(mesh),
                              mesh_device(mesh), mesh)
            layer[name] = torch.zeros(sh.local_shape(leaf.shape), dtype=leaf.dtype,
                                      device=mesh_device(mesh))
            specs[name] = sh
        cache.append(layer)
        shardings.append(specs)
    for layer, own in zip(cache, lm.init_cache(tokens[0].shape[0], 1)):
        for name, leaf in layer.items():
            got = list(leaf.shape)
            if name in SEQ_DIM:
                got[SEQ_DIM[name]] = 1
            if tuple(got) != tuple(own[name].shape):
                raise ValueError(f"cache leaf {name}: the spec's block {tuple(leaf.shape)}, "
                                 f"the rank's LM holds {tuple(own[name].shape)} (at one "
                                 "position)")
    return Placed(*tokens), Placed(*lengths), Placed(cache, shardings)


def params_sds(lm: LM, mesh, rules: Rules) -> Tuple[Placed, Any]:
    """(the float32 master parameters at the rank's blocks, the axes tree):
    ``meta_tree`` of the whole model (``lm`` the rank's, a tensor-parallel
    rank's too) cut by ``rules``."""
    axes, whole = lm.param_axes(), meta_tree(lm)
    shardings = shardings_for(mesh, rules, axes, whole, mesh_device(mesh),
                              pieces=tp_pieces(whole_config(lm)))
    values = tree_map(lambda t, sh: torch.zeros(sh.local_shape(t.shape), dtype=t.dtype,
                                                device=mesh_device(mesh)), whole, shardings)
    return Placed(values, shardings), axes


def opt_state_sds(opt, params: Placed, param_axes, mesh, rules: Rules,
                  pieces=None) -> Placed:
    """The optimizer state of the rank's blocks (``opt.init`` on them, as
    the trainer initialises it) and its shardings (``opt.init_axes``; the
    parameters' ``pieces``, ``trainer.tp_pieces``), each leaf checked
    against the block its spec names."""
    whole = opt.init(tree_map(lambda v, sh: torch.empty(
        tuple(n * sh.parts(d) for d, n in enumerate(v.shape)), dtype=v.dtype, device="meta"),
        params.values, params.shardings))
    values = opt.init(params.values)
    shardings = shardings_for(mesh, rules, opt.init_axes(param_axes), whole,
                              mesh_device(mesh), pieces=pieces)
    for v, sh, w in zip(tree_leaves(values), tree_leaves(shardings), tree_leaves(whole)):
        if tuple(v.shape) != sh.local_shape(w.shape):
            raise ValueError(f"optimizer state block {tuple(v.shape)} is not the block "
                             f"{sh.local_shape(w.shape)} of spec {sh.spec}")
    return Placed(values, shardings)


def rules_for_cell(base: Rules, shape: ShapeSpec, mesh) -> Rules:
    """Per-cell sharding adjustments.

    Long-context decode (global_batch < the batch axes' size): the batch
    cannot fill the data axis, so shard the cache's sequence over it
    instead (the reference leaves the partial softmax's merge to GSPMD; the
    port merges the ranks' partials in rank order,
    ``repro_torch.models.attention.split_decode_attention``), and the
    tokens stay replicated, so the MoE takes its 2-D path."""
    if shape.kind == "decode" and mesh is not None:
        sizes = dict(zip(*mesh_axes(mesh)))
        data = sizes.get("data", 1) * sizes.get("pod", 1)
        if shape.global_batch < data:
            return base.override(acts={
                "batch": None,
                "cache_batch": None,
                "cache_seq": ("pod", "data"),
            })
    return base
