"""Optimizers: AdamW and Adafactor, with the reference's arithmetic and state
layout (``repro/training/optimizers.py``).

Parameters, gradients and state are trees of tensors in the reference's
layout (``repro_torch.training.tree``): the trainer keeps its float32 master
parameters in the reference's param tree, periods stacked, so that
Adafactor's factoring and update clipping see the reference's leaves (a
stacked norm scale is a 2-D leaf there, factored over the periods) and a
checkpoint of either package restores into the other.  ``update`` runs under
``no_grad`` and returns new trees; the old ones are freed with their last
reference.  Scalars are float32 tensors on the parameters' device, as the
reference's are float32 arrays.

``init_axes`` maps the params' logical-axes tree onto the state's, as the
reference's does (``optimizers.py:71-72``, ``:129-138``): the state is
sharded like its parameter (``repro_torch.runtime.elastic``).

On a data mesh (``repro_torch.training.trainer``) every leaf is the rank's
block, and ``update`` takes ``shards``, the params' tree of
``LeafSharding``: AdamW is elementwise and needs no collective; Adafactor's
statistics are means over whole dims (``vr`` over the last, ``vc`` over the
second-to-last, ``denom`` over ``vr``'s last, the update's RMS over the
whole leaf), so where such a dim is split over the ranks the partial sums
are summed over the group and divided by the whole dim's size.  A leaf
split nowhere runs the unsharded arithmetic, so a mesh of one rank is the
unsharded optimizer bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.dist.treeutil import map_axes
from repro_torch.training.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]  # params -> state
    update: Callable[..., Tuple[Any, Any]]
    # (grads, state, params, lr, shards=None) -> (new_params, new_state)
    init_axes: Callable[[Any], Any]  # param axes tree -> state axes tree
    name: str = "opt"


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over the leaves (in JAX's order) of sum(g^2), float32."""
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float())) for leaf in leaves))


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled by min(1, max_norm / max(norm, 1e-9)), norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, tree), norm


def _zeros(p: torch.Tensor, shape=None) -> torch.Tensor:
    return torch.zeros(p.shape if shape is None else shape, dtype=torch.float32, device=p.device)


def _count(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        return {"mu": tree_map(_zeros, params), "nu": tree_map(_zeros, params),
                "count": _count(params)}

    @torch.no_grad()
    def update(grads, state, params, lr, shards=None):
        count = state["count"] + 1
        cf = count.float()
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()), state["nu"], grads)
        mu_hat_scale = 1.0 / (1 - torch.pow(b1, cf))
        nu_hat_scale = 1.0 / (1 - torch.pow(b2, cf))

        def step(p, m, v):
            upd = (m * mu_hat_scale) / (torch.sqrt(v * nu_hat_scale) + eps)
            upd = upd + weight_decay * p.float()
            return (p.float() - lr * upd).to(p.dtype)

        new_params = tree_map(step, params, mu, nu)
        return new_params, {"mu": mu, "nu": nu, "count": count}

    def init_axes(axes):
        return {"mu": axes, "nu": axes, "count": ()}

    return Optimizer(init, update, init_axes, name="adamw")


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018; factored v, no momentum)
# ---------------------------------------------------------------------------
def adafactor(eps: float = 1e-30, clip_threshold: float = 1.0, decay: float = 0.8,
              weight_decay: float = 0.0) -> Optimizer:
    def factored(p) -> bool:
        return p.dim() >= 2

    def init(params):
        def leaf(p):
            if factored(p):
                return {"vr": _zeros(p, p.shape[:-1]), "vc": _zeros(p, p.shape[:-2] + p.shape[-1:])}
            return {"v": _zeros(p)}

        return {"v": tree_map(leaf, params), "count": _count(params)}

    @torch.no_grad()
    def update(grads, state, params, lr, shards=None):
        count = state["count"] + 1
        cf = count.float()
        beta2 = 1.0 - torch.pow(cf, -decay)

        def leaf(p, g, s, sh):
            gf = g.float()
            g2 = torch.square(gf) + eps
            if factored(p):
                vr = beta2 * s["vr"] + (1 - beta2) * _mean(g2, -1, sh)
                vc = beta2 * s["vc"] + (1 - beta2) * _mean(g2, -2, sh)
                denom = torch.clamp(_mean(vr, -1, sh, param_dim=-2, keepdim=True), min=eps)
                rhat = (vr / denom)[..., None]
                upd = gf * torch.rsqrt(rhat * vc[..., None, :] + eps)
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta2 * s["v"] + (1 - beta2) * g2
                upd = gf * torch.rsqrt(v + eps)
                new_s = {"v": v}
            # update clipping by RMS
            rms = torch.sqrt(_mean_all(torch.square(upd), sh) + 1e-30)
            upd = upd / torch.clamp(rms / clip_threshold, min=1.0)
            if weight_decay:
                upd = upd + weight_decay * p.float()
            return (p.float() - lr * upd).to(p.dtype), new_s

        new_params, new_v = _map2(leaf, params, grads, state["v"], shards)
        return new_params, {"v": new_v, "count": count}

    def init_axes(axes):
        def leaf(ax):
            ax = tuple(ax)
            if len(ax) >= 2:
                return {"vr": ax[:-1], "vc": ax[:-2] + ax[-1:]}
            return {"v": ax}

        return {"v": map_axes(leaf, axes), "count": ()}

    return Optimizer(init, update, init_axes, name="adafactor")


def _mean(x: torch.Tensor, dim: int, sh, param_dim: int = None, keepdim: bool = False):
    """x's mean over ``dim``, the whole dim's where the parameter's dim
    ``param_dim`` (default ``dim``) is split over the ranks (``sh``, the
    parameter's ``LeafSharding``; None unsharded): the block's sum summed
    over the group, over the whole dim's size."""
    pd = dim if param_dim is None else param_dim
    if sh is None or sh.parts(pd) == 1:
        return x.mean(dim, keepdim=keepdim)
    from repro_torch.dist.collectives import all_reduce_

    total = all_reduce_(x.sum(dim, keepdim=keepdim), sh.group(pd))
    return total / (x.shape[dim] * sh.parts(pd))


def _mean_all(x: torch.Tensor, sh) -> torch.Tensor:
    """The mean over every element of the whole leaf whose block is x (the
    block's sum summed over the group of each split dim in turn)."""
    if sh is None or not sh.split_dims():
        return torch.mean(x)
    from repro_torch.dist.collectives import all_reduce_

    total = x.sum()
    for d in sh.split_dims():
        total = all_reduce_(total, sh.group(d))
    return total / (x.numel() * sh.n_blocks())


def _map2(fn, params, grads, states, shards=None):
    """``fn(p, g, s, sh) -> (new_p, new_s)`` over the parameter leaves (``s``
    a leaf's state dict, ``sh`` its ``LeafSharding`` or None); returns the
    two new trees."""
    if isinstance(params, dict):
        out = {k: _map2(fn, params[k], grads[k], states[k], None if shards is None else shards[k])
               for k in params}
        return {k: v[0] for k, v in out.items()}, {k: v[1] for k, v in out.items()}
    if isinstance(params, (tuple, list)):
        out = [_map2(fn, p, g, s, None if shards is None else shards[i])
               for i, (p, g, s) in enumerate(zip(params, grads, states))]
        return type(params)(o[0] for o in out), type(params)(o[1] for o in out)
    return fn(params, grads, states, shards)


def get_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    raise ValueError(f"unknown optimizer {name!r}")


def default_optimizer_for(n_params: int) -> str:
    """Adafactor for huge models (float32 Adam state would not fit per chip)."""
    return "adafactor" if n_params > 40e9 else "adamw"
