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

On a data mesh (``rt.mesh`` with "model" of size 1, ``rt.rules`` the
reference's ``Rules.default``: FSDP over "data") ``params`` and the
optimizer state hold the rank's contiguous block of every leaf, as
``Rules.default(mesh).param_pspec`` names it (``param_shardings``), and a
step

1. gathers each master leaf's blocks into the rank's LM, one leaf at a
   time (so the rank never holds a second float32 copy of the model);
2. runs forward and backward on the rank's rows of the global batch (rows
   r B / K to (r + 1) B / K, the "batch" rule), the loss the rank's share
   of the global loss (``LM.loss_fn``);
3. sums each gradient over the group in float32 and keeps the rank's block;
4. takes the global norm from the blocks' squares summed over the group,
   a replicated leaf counted once;
5. clips, and updates the rank's blocks (``Optimizer.update(shards=...)``).

The metrics are the global values on every rank.  With one rank on the
"data" axis every collective is the identity and the step is the unmeshed
one, bit for bit.  A "model" axis larger than 1 raises (the trainer's
tensor parallelism, ROADMAP.md).

``make_train_step(compressor=...)`` raises: the reference's path calls a
``GradientCompressor.apply`` that does not exist
(``repro/training/trainer.py:96``); its trainer compresses in
``Trainer.train_some``, and so does the port's
(``repro_torch.launch.train``).  ``make_diloco_inner_step`` waits for the
dry-run (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

from repro_torch.convert import load_tree_into_lm, param_layout, set_path, tree_from_lm, tuples
from repro_torch.dist.collectives import all_reduce_, reduce_scatter_blocks
from repro_torch.dist.partitioning import Rules
from repro_torch.models.model import LM, check_trainable_mesh
from repro_torch.models.runtime import Runtime
from repro_torch.runtime.elastic import gather_leaf, mesh_coordinate, shardings_for
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
    the "meta" device: the whole leaves' shapes, no memory."""
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


def param_shardings(lm: LM, rt: Runtime):
    """The ``LeafSharding`` tree of the LM's float32 master parameters on
    ``rt.mesh`` under ``rt.rules`` (``Rules.default`` when None)."""
    check_trainable_mesh(rt)
    rules = rt.rules or Rules.default(rt.mesh)
    return shardings_for(rt.mesh, rules, lm.param_axes(), meta_tree(lm), lm.device)


def local_rows(batch: Dict, rank: int, world: int) -> Dict:
    """Rows r B / K .. (r + 1) B / K of every leaf of a global batch."""
    b = next(iter(batch.values())).shape[0]
    if b % world:
        raise ValueError(f"a global batch of {b} rows does not split over {world} ranks")
    n = b // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


@torch.no_grad()
def load_blocks_into_lm(lm: LM, params, shardings) -> None:
    """Copy the master blocks into the LM's tensors: each leaf's blocks cast
    to the dtype the port stores it in (bf16 for the matrices: half the
    bytes of a float32 gather, and the same values, since the cast is
    elementwise) and gathered whole from the ranks, one leaf at a time."""
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

    for path, targets in dsts.items():
        local = get(params, path).to(targets[0][1].dtype)
        whole = gather_leaf(local, get(shardings, path))
        for n, dst in targets:
            dst.copy_(whole if n is None else whole[n])
        del whole


def reduce_grads(grads, shardings, group, scatter: bool = True):
    """Each gradient leaf summed over the group (float32): the rank's block
    with ``scatter``, else the whole sum on every rank.  The identity when
    ``group`` is None."""
    if group is None:
        return grads

    def leaf(g, sh):
        dims = sh.split_dims()
        if scatter and dims:
            return reduce_scatter_blocks(g, dims[0], sh.group(dims[0]))
        return all_reduce_(g, group)

    return tree_map(leaf, grads, shardings)


@torch.no_grad()
def clip_sharded(grads, shardings, group, max_norm: float):
    """``clip_by_global_norm`` over a tree of blocks: the norm from the
    split leaves' squares summed over the group and the replicated leaves'
    counted once (``clip_by_global_norm`` itself when ``group`` is None)."""
    if group is None:
        return clip_by_global_norm(grads, max_norm)
    split = torch.zeros((), dtype=torch.float32, device=tree_leaves(grads)[0].device)
    whole = torch.zeros_like(split)
    for g, sh in zip(tree_leaves(grads), tree_leaves(shardings)):
        sq = torch.sum(torch.square(g.float()))
        if sh.split_dims():
            split = split + sq
        else:
            whole = whole + sq
    norm = torch.sqrt(all_reduce_(split, group) + whole)
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
    """What a train step on a data mesh needs: the master parameters'
    shardings, the "data" group (None at one rank) and this rank's place
    on it."""

    def __init__(self, lm: LM, rt: Runtime):
        self.shardings = param_shardings(lm, rt)
        self.group = rt.data_group()
        self.world = rt.data_world()
        self.rank = mesh_coordinate(rt.mesh).get("data", 0)


def forward_backward(lm: LM, rt: Runtime, batch: Dict):
    """(loss, extra, float32 gradient tree) of ``LM.loss_fn`` on ``batch``
    (on a data mesh: the rank's shares and its rows' gradients)."""
    loss, extra = lm.loss_fn(batch, rt)
    loss.backward()
    return loss.detach(), {k: v.detach() for k, v in extra.items()}, _grads(lm)


def make_train_step(lm: LM, opt: Optimizer, cfg: TrainConfig, compressor=None,
                    rt: Runtime = Runtime()) -> Callable:
    """Returns step(params, opt_state, batch, step_idx) -> (p, s, metrics):
    ``batch`` a dict of (B, S) tensors or arrays (the global batch),
    ``metrics`` float32 0-d tensors on the LM's device: loss, grad_norm, lr,
    and without microbatches the loss's ce, aux and tokens.  The LM must be
    ``trainable()``.  With ``rt.mesh`` the step runs on the data mesh (the
    module docstring); ``params`` and ``opt_state`` are the rank's blocks."""
    if compressor is not None:
        raise TypeError(COMPRESSOR_IN_STEP)
    mesh = DataMesh(lm, rt) if rt.mesh is not None else None
    shardings = None if mesh is None else mesh.shardings
    group = None if mesh is None else mesh.group

    def step_fn(params, opt_state, batch, step_idx):
        batch = {k: torch.as_tensor(v, device=lm.device) for k, v in batch.items()}
        if mesh is not None:
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
