"""Training step construction: gradient accumulation, clipping, the lr
schedule (the port of ``repro/training/trainer.py``).

``make_train_step`` builds ``step(params, opt_state, batch, step_idx) ->
(params, opt_state, metrics)`` with the reference's signature and
arithmetic.  ``params`` is the float32 master tree in the reference's layout
(``repro_torch.convert.tree_from_lm``); each step copies it into the LM's
tensors (cast to the config's dtype: the reference casts its float32 master
weights at each use, the same values), runs ``LM.loss_fn`` forward and
backward, gathers the gradients into the same layout in float32 (the
gradient of a float32 master leaf is its cast's gradient, the LM tensor's,
in float32), sums ``microbatches`` of them in float32, clips by the global
norm and applies the optimizer.

On a mesh (``rt.mesh`` with axes ("data", "model"), or a stand-in with
"pod" too; ``rt.rules`` the reference's ``Rules.default``: FSDP over the
batch axes, tensor parallelism over "model") ``params`` and the optimizer
state hold the rank's block of every leaf, as
``Rules.default(mesh).param_pspec`` names it (``param_shardings``): a
contiguous block along a dim split over the batch axes, and the slice the
serve plan gives a tensor-parallel rank along a dim split over "model"
(Mamba's ``in_proj`` a slice of each half: ``LeafSharding.pieces``).  The
LM is the rank's (``train_lm``): the whole model, or at a "model" axis of K
> 1 a tensor-parallel rank's, at the serve plan's local widths
(``repro_torch.serve.sharding``: MLA at n_heads / K, the MoE's E / K
experts on its expert-parallel path, dim 0 of each expert leaf over
"model" and its ``embed`` dim over the batch axes under FSDP).  A step

1. gathers each master leaf's blocks over the batch axes into the rank's
   LM, one leaf at a time (so the rank never holds a second float32 copy
   of its slice of the model);
2. runs forward and backward on the rank's rows of the global batch (rows
   r B / K to (r + 1) B / K over the batch axes, the "batch" rule), the
   loss the rank's share of the global loss (``LM.loss_fn``; every rank of
   a "model" group computes the same);
3. sums each gradient over the batch axes in float32 and keeps the rank's
   block (a reduce-scatter over "data" only: a tensor-parallel rank's
   slices are its own);
4. takes the global norm from the blocks' squares, summed over the axes
   each leaf is split over, a leaf replicated over an axis counted once;
5. clips, and updates the rank's blocks (``Optimizer.update(shards=...)``).

The metrics are the global values on every rank.  With one rank on every
axis each collective is the identity and the step is the unmeshed one,
bit for bit.

``make_train_step(compressor=...)`` raises: the reference's path calls a
``GradientCompressor.apply`` that does not exist
(``repro/training/trainer.py:96``); its trainer compresses in
``Trainer.train_some``, and so does the port's
(``repro_torch.launch.train``).

``make_diloco_inner_step`` is the reference's DiLoCo inner step
(``trainer.py:117-141``): a leading replica axis on the parameters, the
optimizer state and the batch, each replica's ``make_train_step`` step on
its slices (one replica after the other where the reference vmaps; each
replica's result independent of the others'), and ``outer_sync``, the
float32 mean over the replicas broadcast back to each.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.convert import load_tree_into_lm, param_layout, set_path, tree_from_lm, tuples
from repro_torch.device import DeviceLike
from repro_torch.dist.collectives import all_reduce_, group_rank, reduce_scatter_blocks
from repro_torch.dist.partitioning import MODEL_AXIS, Rules, entry_axes
from repro_torch.models.model import LM, Shard
from repro_torch.models.param import TOP_AXES
from repro_torch.models.runtime import Runtime
from repro_torch.runtime.elastic import gather_leaf, shardings_for
from repro_torch.training.optimizers import Optimizer, clip_by_global_norm
from repro_torch.training.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0
    microbatches: int = 1  # gradient accumulation factor
    # local-SGD (H>1 => H local steps between outer syncs)
    local_steps: int = 1
    compression: Optional[str] = None  # None | "int8" | "topk" | "powersgd"


def rescaled_config(cfg: TrainConfig, batch_ratio: float,
                    local_steps: Optional[int] = None) -> TrainConfig:
    """Adjust a TrainConfig after an elastic resize: linear lr-scaling with
    the global-batch ratio (Goyal et al.), optionally switching the
    local-SGD sync period (the sync_relax mitigation)."""
    return dataclasses.replace(
        cfg, learning_rate=cfg.learning_rate * batch_ratio,
        local_steps=cfg.local_steps if local_steps is None else max(int(local_steps), 1))


def lr_schedule(cfg: TrainConfig, step, device=None) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_ratio``; float32, as
    the reference computes it, on ``device``."""
    s = torch.as_tensor(step, device=device).to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    total = max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = torch.clamp((s - cfg.warmup_steps) / total, 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.learning_rate * torch.where(s < cfg.warmup_steps, warm, decay)


def _split_microbatches(batch: Dict, n: int):
    """(B, ...) -> n batches of (B // n, ...) for every leaf."""
    size = next(iter(batch.values())).shape[0] // n
    return [{k: v[i * size:(i + 1) * size] for k, v in batch.items()} for i in range(n)]


def _grads(lm: LM):
    """The LM's gradients as a float32 tree in the reference's layout; the
    LM's own gradients are released."""
    grads = tree_from_lm(lm, grads=True)
    for p in lm.parameters():
        p.grad = None
    return grads


COMPRESSOR_IN_STEP = (
    "make_train_step(compressor=...): the reference's path calls GradientCompressor.apply, "
    "which does not exist (repro/training/trainer.py:96); the trainer compresses in "
    "Trainer.train_some, as the reference's Trainer does")


# ---------------------------------------------------------------------------
# The data mesh
# ---------------------------------------------------------------------------
def meta_tree(lm: LM):
    """The LM's parameters in the reference's layout as float32 tensors on
    the "meta" device: the whole model's leaves' shapes (a tensor-parallel
    rank's LM too), no memory."""
    if lm.shard is not None:
        lm = LM(lm.shard.whole, "meta")
    stacks, tree = {}, {}
    for path, n, t in param_layout(lm):
        if n is None:
            set_path(tree, path, torch.empty(t.shape, dtype=torch.float32, device="meta"))
        else:
            stacks.setdefault(path, []).append(t.shape)
    for path, shapes in stacks.items():
        set_path(tree, path, torch.empty((len(shapes), *shapes[0]), dtype=torch.float32,
                                         device="meta"))
    return tuples(tree)


@torch.no_grad()
def draw_blocks(cfg: ArchConfig, shardings, generator: torch.Generator,
                device: DeviceLike = None) -> Dict:
    """The rank's blocks of the float32 master tree that
    ``tree_from_lm(LM(cfg, device).init_params(generator))`` gives whole:
    the same draws, in ``init_params``' order, one tensor at a time, each
    drawn whole, stored in the config's dtype as the LM stores it, and cut
    to the rank's block (``shardings``: ``param_shardings``' tree) before
    the next is drawn.  So a rank never holds more of the model than its
    blocks and one whole tensor."""
    from repro_torch.convert import _get
    from repro_torch.models.blocks import fill_param

    whole = LM(cfg, "meta")
    where = {id(t): (path, n) for path, n, t in param_layout(whole)}
    blocks: Dict = {}
    for t, init, scale in whole.init_entries():
        path, n = where[id(t)]
        sh = _get(shardings, path)
        if n is not None:  # one layer of a leaf stacked over the periods
            if sh.parts(0) > 1:
                raise NotImplementedError(f"{path}: a leaf split over its periods")
            sh = dataclasses.replace(sh, spec=sh.spec[1:], pieces=sh.pieces[1:])
        drawn = torch.empty(t.shape, dtype=t.dtype, device=device)
        fill_param(drawn, init, scale, generator)
        blocks.setdefault(path, {})[n] = sh.place(drawn).to(torch.float32)
        del drawn
    tree: Dict = {}
    for path, parts in blocks.items():
        set_path(tree, path, parts[None] if None in parts
                 else torch.stack([parts[n] for n in range(len(parts))]))
    return tuples(tree)


def whole_config(lm: LM) -> ArchConfig:
    """The whole model's config (a tensor-parallel rank's LM holds its
    local widths')."""
    return lm.cfg if lm.shard is None else lm.shard.whole


def train_lm(cfg: ArchConfig, rt: Runtime, device: DeviceLike = None) -> LM:
    """The LM a rank runs, no weights drawn: the whole model, or on a mesh
    whose "model" axis is K > 1 a tensor-parallel rank's, at the serve
    plan's local widths (``ShardingPlan.local_config``: E / K experts and
    n_heads / K MLA heads too) and the rank's vocabulary rows where
    ``Rules.default`` splits them.  Where ``rt.rules`` (``Rules.default``
    when None) leave the tokens replicated over spare axes (the dry-run's
    long-context cell), its MoE experts' d_model dim is the rank's block
    over them (``embed_shards``: the 2-D path, ``repro_torch.models.moe``)."""
    from repro_torch.models.moe import spare_group

    spare = (spare_group(rt.mesh, rt.rules or Rules.default(rt.mesh))
             if cfg.uses_moe and rt.mesh is not None else None)
    if rt.model_world() == 1 and spare is None:
        return LM(cfg, device)
    from repro_torch.dist.collectives import group_size
    from repro_torch.serve.sharding import ShardingPlan

    plan = ShardingPlan(rt.mesh, Rules.for_serving(rt.mesh))
    local = plan.local_config(cfg)
    if spare is not None:
        local = dataclasses.replace(local, moe=dataclasses.replace(
            local.moe, embed_shards=group_size(spare)))
    vocab = plan.sharded(Rules.default(rt.mesh).param_pspec(
        TOP_AXES["embed"], (cfg.vocab_size, cfg.d_model))[0])
    return LM(local, device, shard=Shard(plan.model_rank, plan.world, vocab, cfg))


def tp_pieces(cfg: ArchConfig) -> Dict:
    """``shardings_for``'s pieces: Mamba's ``in_proj`` columns, the x and z
    halves of 2 Dn side by side (``serve.sharding.SPLIT_PARTS``)."""
    if cfg.mamba is None:
        return {}
    return {("mamba_inner", 2 * cfg.mamba.resolved_d_inner(cfg.d_model)): 2}


def param_shardings(lm: LM, rt: Runtime):
    """The ``LeafSharding`` tree of the LM's float32 master parameters on
    ``rt.mesh`` under ``rt.rules`` (``Rules.default`` when None)."""
    cfg = whole_config(lm)
    rules = rt.rules or Rules.default(rt.mesh)
    return shardings_for(rt.mesh, rules, lm.param_axes(), meta_tree(lm), lm.device,
                         pieces=tp_pieces(cfg))


def state_shardings(lm: LM, rt: Runtime, opt: Optimizer):
    """The ``LeafSharding`` tree of ``opt``'s state for the LM's master
    parameters (its own axes, ``Optimizer.init_axes``)."""
    rules = rt.rules or Rules.default(rt.mesh)
    return shardings_for(rt.mesh, rules, opt.init_axes(lm.param_axes()),
                         opt.init(meta_tree(lm)), lm.device, pieces=tp_pieces(whole_config(lm)))


def local_rows(batch: Dict, rank: int, world: int) -> Dict:
    """Rows r B / K .. (r + 1) B / K of every leaf of a global batch."""
    b = next(iter(batch.values())).shape[0]
    if b % world:
        raise ValueError(f"a global batch of {b} rows does not split over {world} ranks")
    n = b // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def batch_axes(shardings) -> tuple:
    """The mesh's axes but "model" (the FSDP and batch axes)."""
    from repro_torch.training.tree import tree_leaves as leaves

    first = leaves(shardings)[0]
    return tuple(a for a in first.axis_sizes if a != MODEL_AXIS)


@torch.no_grad()
def load_blocks_into_lm(lm: LM, params, shardings) -> None:
    """Copy the master blocks into the LM's tensors: each leaf's blocks cast
    to the dtype the port stores it in (bf16 for the matrices: half the
    bytes of a float32 gather, and the same values, since the cast is
    elementwise) and gathered over the batch axes, one leaf at a time (a
    tensor-parallel rank's LM holds its slices, and a dim the LM holds in
    the rank's block over the batch axes, the 2-D path's expert d-blocks,
    is not gathered)."""
    if shardings is None:
        load_tree_into_lm(lm, params)
        return
    dsts: Dict = {}
    for path, n, dst in param_layout(lm):
        dsts.setdefault(path, []).append((n, dst))

    def get(tree, path):
        for key in path:
            tree = tree[key]
        return tree

    axes = batch_axes(shardings)
    for path, targets in dsts.items():
        local = get(params, path).to(targets[0][1].dtype)
        want = tuple(targets[0][1].shape)
        if targets[0][0] is not None:  # one layer of a leaf stacked over the periods
            want = (local.shape[0],) + want
        sh = get(shardings, path)
        # a dim the LM holds in the rank's block stays so (the 2-D path's
        # expert d-blocks): only the others are gathered
        whole = gather_leaf(local, sh, tuple(a for a in axes if any(
            a in entry_axes(sh.spec[d]) and local.shape[d] != want[d]
            for d in range(local.dim()))))
        for n, dst in targets:
            dst.copy_(whole if n is None else whole[n])
        del whole


def reduce_grads(grads, shardings, group, scatter: bool = True):
    """Each gradient leaf summed over the batch axes' group (float32): the
    rank's block with ``scatter``, else the whole sum on every rank.  The
    identity when ``group`` is None.  A dim split over "model" is the
    rank's own slice and is not summed."""
    if group is None:
        return grads
    axes = batch_axes(shardings)

    def leaf(g, sh):
        dims = sh.dims_over(axes)
        if scatter and dims:
            return reduce_scatter_blocks(g, dims[0], sh.group(dims[0]))
        return all_reduce_(g, group)

    return tree_map(leaf, grads, shardings)


def _split_groups(sh) -> tuple:
    """(axes, group) of each split dim of a leaf, in dim order."""
    return tuple((entry_axes(sh.spec[d]), sh.group(d)) for d in sh.split_dims())


@torch.no_grad()
def clip_sharded(grads, shardings, group, max_norm: float):
    """``clip_by_global_norm`` over a tree of blocks: the leaves' squares
    summed by the set of mesh axes each leaf is split over, each sum over
    those axes' groups, a leaf replicated over an axis counted once
    (``clip_by_global_norm`` itself when the mesh has one rank)."""
    if shardings is None or (group is None
                             and not any(sh.split_dims() for sh in tree_leaves(shardings))):
        return clip_by_global_norm(grads, max_norm)
    zero = torch.zeros((), dtype=torch.float32, device=tree_leaves(grads)[0].device)
    sums, groups = {}, {}
    for g, sh in zip(tree_leaves(grads), tree_leaves(shardings)):
        key = tuple(axes for axes, _ in _split_groups(sh))
        groups.setdefault(key, [grp for _, grp in _split_groups(sh)])
        sums[key] = sums.get(key, zero) + torch.sum(torch.square(g.float()))
    total = sums.pop((), zero)
    for key, sq in sums.items():
        for grp in groups[key]:
            sq = all_reduce_(sq, grp)
        total = sq + total
    norm = torch.sqrt(total)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def global_metrics(metrics: Dict[str, torch.Tensor], group, keys=("loss", "ce", "aux")):
    """The ranks' shares of ``keys`` summed over the group (one all_reduce
    of the scalars): the global values on every rank."""
    if group is None:
        return metrics
    names = [k for k in keys if k in metrics]
    total = all_reduce_(torch.stack([metrics[k].float() for k in names]), group)
    return dict(metrics, **{k: total[i] for i, k in enumerate(names)})


class DataMesh:
    """What a train step on a mesh needs: the master parameters'
    shardings, the batch axes' group (None at one rank) and this rank's
    place on it."""

    def __init__(self, lm: LM, rt: Runtime):
        self.shardings = param_shardings(lm, rt)
        self.group = rt.data_group()
        self.world = rt.data_world()
        self.rank = 0 if self.group is None else group_rank(self.group)


def forward_backward(lm: LM, rt: Runtime, batch: Dict):
    """(loss, extra, float32 gradient tree) of ``LM.loss_fn`` on ``batch``
    (on a data mesh: the rank's shares and its rows' gradients)."""
    loss, extra = lm.loss_fn(batch, rt)
    loss.backward()
    return loss.detach(), {k: v.detach() for k, v in extra.items()}, _grads(lm)


def make_train_step(lm: LM, opt: Optimizer, cfg: TrainConfig, compressor=None,
                    rt: Runtime = Runtime(), local_batch: bool = False) -> Callable:
    """Returns step(params, opt_state, batch, step_idx) -> (p, s, metrics):
    ``batch`` a dict of (B, S) tensors or arrays (the global batch; with
    ``local_batch`` the rank's rows of it already), ``metrics`` float32 0-d
    tensors on the LM's device: loss, grad_norm, lr, and without
    microbatches the loss's ce, aux and tokens.  The LM must be
    ``trainable()`` (a tensor-parallel rank's: ``train_lm``).  With
    ``rt.mesh`` the step runs on the mesh (the module docstring); ``params``
    and ``opt_state`` are the rank's blocks."""
    if compressor is not None:
        raise TypeError(COMPRESSOR_IN_STEP)
    mesh = DataMesh(lm, rt) if rt.mesh is not None else None
    shardings = None if mesh is None else mesh.shardings
    group = None if mesh is None else mesh.group

    def step_fn(params, opt_state, batch, step_idx):
        batch = {k: torch.as_tensor(v, device=lm.device) for k, v in batch.items()}
        if mesh is not None and not local_batch:
            batch = local_rows(batch, mesh.rank, mesh.world)
        load_blocks_into_lm(lm, params, shardings)
        for p in lm.parameters():
            p.grad = None
        if cfg.microbatches > 1:
            grads, loss_sum = None, torch.zeros((), dtype=torch.float32, device=lm.device)
            for mb in _split_microbatches(batch, cfg.microbatches):
                loss, _, g = forward_backward(lm, rt, mb)
                grads = g if grads is None else tree_map(torch.add, grads, g)
                loss_sum = loss_sum + loss
            grads = tree_map(lambda g: g / cfg.microbatches, grads)
            loss = loss_sum / cfg.microbatches
            extra = {}
        else:
            loss, extra, grads = forward_backward(lm, rt, batch)
        grads = reduce_grads(grads, shardings, group)
        grads, gnorm = clip_sharded(grads, shardings, group, cfg.grad_clip)
        lr = lr_schedule(cfg, step_idx, device=lm.device)
        new_params, new_opt = opt.update(grads, opt_state, params, lr, shards=shardings)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        metrics.update({k: v for k, v in extra.items() if v.dim() == 0})
        return new_params, new_opt, global_metrics(metrics, group)

    return step_fn


# ---------------------------------------------------------------------------
# Local SGD (communication-avoiding data parallelism), DiLoCo style: H inner
# steps a replica with no gradient sync between replicas, then one mean of
# the parameters (``repro/training/trainer.py:104-141``).
# ---------------------------------------------------------------------------
def _replica(tree, i: int):
    return tree_map(lambda x: x[i], tree)


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def make_diloco_inner_step(lm: LM, opt: Optimizer, cfg: TrainConfig, n_replicas: int,
                           rt: Runtime = Runtime()):
    """DiLoCo-style inner step: ``make_train_step``'s step over a leading
    replica axis of the parameters, the optimizer state and the batch
    (``(n_replicas, per_replica_batch, ...)``), one replica after the other
    on one device (the reference vmaps); each replica's result depends on
    its slices only.  Returns (inner, outer_sync): ``inner(params_r,
    opt_state_r, batch_r, step_idx) -> (params_r, opt_state_r, metrics_r)``,
    the metrics with the replica axis too, and ``outer_sync(params_r)``, the
    float32 mean over the replicas broadcast back to each.  Parameter
    memory is n_replicas times one copy's (the trade the planner weighs)."""
    base = make_train_step(lm, opt, cfg, rt=rt)

    def inner(params_r, opt_state_r, batch_r, step_idx):
        outs = [base(_replica(params_r, i), _replica(opt_state_r, i),
                     {k: torch.as_tensor(v)[i] for k, v in batch_r.items()}, step_idx)
                for i in range(n_replicas)]
        return tuple(_stack([o[j] for o in outs]) for j in range(3))

    def outer_sync(params_r):
        return tree_map(lambda p: p.float().mean(dim=0, keepdim=True).to(p.dtype)
                        .expand(n_replicas, *p.shape[1:]).contiguous(), params_r)

    return inner, outer_sync
