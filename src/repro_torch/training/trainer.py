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

``compressor`` (gradient compression) waits for the LM chaos executor, and
``make_diloco_inner_step`` for the dry-run (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

from repro_torch.convert import load_tree_into_lm, tree_from_lm
from repro_torch.models.model import LM
from repro_torch.models.runtime import Runtime
from repro_torch.training.optimizers import Optimizer, clip_by_global_norm
from repro_torch.training.tree import tree_map


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


def make_train_step(lm: LM, opt: Optimizer, cfg: TrainConfig, compressor=None,
                    rt: Runtime = Runtime()) -> Callable:
    """Returns step(params, opt_state, batch, step_idx) -> (p, s, metrics):
    ``batch`` a dict of (B, S) tensors or arrays, ``metrics`` float32 0-d
    tensors on the LM's device: loss, grad_norm, lr, and without
    microbatches the loss's ce, aux and tokens.  The LM must be
    ``trainable()``."""
    if compressor is not None:
        raise NotImplementedError("gradient compression waits for the LM chaos executor "
                                  "(ROADMAP.md)")

    def loss_and_grads(batch):
        loss, extra = lm.loss_fn(batch, rt)
        loss.backward()
        return loss.detach(), {k: v.detach() for k, v in extra.items()}, _grads(lm)

    def step_fn(params, opt_state, batch, step_idx):
        batch = {k: torch.as_tensor(v, device=lm.device) for k, v in batch.items()}
        load_tree_into_lm(lm, params)
        for p in lm.parameters():
            p.grad = None
        if cfg.microbatches > 1:
            grads, loss_sum = None, torch.zeros((), dtype=torch.float32, device=lm.device)
            for mb in _split_microbatches(batch, cfg.microbatches):
                loss, _, g = loss_and_grads(mb)
                grads = g if grads is None else tree_map(torch.add, grads, g)
                loss_sum = loss_sum + loss
            grads = tree_map(lambda g: g / cfg.microbatches, grads)
            loss = loss_sum / cfg.microbatches
            extra = {}
        else:
            loss, extra, grads = loss_and_grads(batch)
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
        lr = lr_schedule(cfg, step_idx, device=lm.device)
        new_params, new_opt = opt.update(grads, opt_state, params, lr)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        metrics.update({k: v for k, v in extra.items() if v.dim() == 0})
        return new_params, new_opt, metrics

    return step_fn
