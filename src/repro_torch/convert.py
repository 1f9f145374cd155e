"""Carry the JAX package's data and state (as numpy arrays) into the port,
and the port's LM state back into the reference's layout.

Both packages meet only through numpy: the reference hands over its arrays,
and these functions place them on the port's device as contiguous tensors:
float32 for the optimisation problems, the config's dtype for LM weights.
The way back: ``lm_params_to_numpy`` (the port's LM as the reference's
param tree) and ``tree_to_numpy`` / ``tree_from_numpy`` (any tree, such as
the optimizer state, whose layout is the reference's already).

The LM's parameters in the reference's layout: ``param_layout`` says where
each of the port's per-layer tensors sits in the reference's param tree, a
period layer's leaves stacked over the periods; ``tree_from_lm`` builds that
tree from the LM's tensors or their gradients (the trainer's float32 master
parameters and gradients) and ``load_tree_into_lm`` copies a tree into the
LM, cast to the dtypes the port stores.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import LM
from repro_torch.optim.problems import ERMProblem, LossName
from repro_torch.training.tree import tree_map

# (path in the reference's param tree, index along a stacked period leaf or
# None, the port's tensor)
LayoutEntry = Tuple[Tuple[Any, ...], Optional[int], torch.Tensor]


def _f32(a, device: torch.device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32), device=device)


def problem_from_numpy(X: np.ndarray, y: np.ndarray, lam: float,
                       loss: LossName = "hinge", smooth_gamma: float = 1.0,
                       device: DeviceLike = None) -> ERMProblem:
    """An ``ERMProblem`` over (X (n, d), y (n,)) on ``device`` (the card when
    None)."""
    device = resolve_device(device)
    return ERMProblem(_f32(X, device), _f32(y, device), float(lam), loss,
                      float(smooth_gamma))


def cocoa_state_from_numpy(X: np.ndarray, y: np.ndarray, a: np.ndarray,
                           w: np.ndarray, device: DeviceLike = None
                           ) -> Tuple[torch.Tensor, ...]:
    """CoCoA's shards and state (Xs (m, nl, d), ys (m, nl), a (m, nl),
    w (d,)) as float32 tensors on ``device`` (the card when None)."""
    device = resolve_device(device)
    return tuple(_f32(t, device) for t in (X, y, a, w))


@torch.no_grad()
def lm_params_from_numpy(cfg: ArchConfig, params: Mapping[str, Any],
                         device: DeviceLike = None) -> LM:
    """The port's ``LM`` for ``cfg`` on ``device`` (the card when None),
    holding the reference's parameters.

    ``params`` is the reference's param tree (``repro.models.model.LM.init``)
    with numpy leaves: ``embed``, ``final_norm``, ``lm_head``, a frontend
    arch's ``frontend_proj``, with
    ``first_k_dense`` head layers ``head_layers`` (a tuple of unstacked
    layer dicts), and ``periods``, whose leaves are stacked over the periods:
    for an attention layer ``pos<i>/{ln1, mixer/{wq, wk, wv, wo, q_norm,
    k_norm}, ln2, ffn/{w_gate, w_up, w_down}}``, for an MLA layer
    ``mixer/{wq_a, q_a_norm, wq_b, wkv_a, kv_a_norm, wkv_b, wo}``, for a MoE
    FFN ``ffn/{router, w_gate, w_up, w_down, sh_gate, sh_up, sh_down}``, for
    a Mamba layer ``pos<i>/{ln1, mixer/{in_proj, conv_w, conv_b, x_proj,
    dt_w, dt_b, A_log, D, out_proj}}``.  Layer l < k = ``first_k_dense`` is
    head layer l; layer l >= k is period (l - k) // P, position
    (l - k) % P of a period of length P.  Each leaf is cast to the dtype the
    port stores it in (the config's dtype for matrices, float32 for norm
    scales, the MoE router and the Mamba parameters the reference reads in
    float32)."""
    lm = LM(cfg, device)
    load_tree_into_lm(lm, params)
    return lm


def param_layout(lm: LM) -> Iterator[LayoutEntry]:
    """Each of the LM's parameter tensors with its place in the reference's
    param tree: ``embed``, ``final_norm``, ``lm_head``, ``frontend_proj``;
    layer l < k = ``first_k_dense`` at ``("head_layers", l, ...)``; layer l >= k at
    ``("periods", "pos<(l - k) % P>", ...)``, index ``(l - k) // P`` of its
    stacked leaves (``lm_params_from_numpy``'s docstring)."""
    cfg = lm.cfg
    yield ("embed",), None, lm.embed
    yield ("final_norm",), None, lm.final_norm
    if lm.lm_head is not None:
        yield ("lm_head",), None, lm.lm_head
    if lm.frontend_proj is not None:
        yield ("frontend_proj",), None, lm.frontend_proj
    k, period = cfg.first_k_dense, len(cfg.period)
    for i, layer in enumerate(lm.layers):
        if i < k:
            base, n = ("head_layers", i), None
        else:
            base, n = ("periods", f"pos{(i - k) % period}"), (i - k) // period
        yield base + ("ln1",), n, layer.ln1
        if layer.ln2 is not None:
            yield base + ("ln2",), n, layer.ln2
        for group in layer.specs:
            for name, t in getattr(layer, group).items():
                yield base + (group, name), n, t


def set_path(tree: Dict, path: Tuple[Any, ...], value) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def _get(tree, path: Tuple[Any, ...]):
    for key in path:
        tree = tree[key]
    return tree


def tuples(node):
    """Dicts keyed 0..n-1 (head_layers) become tuples, as in the reference."""
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(key, int) for key in node):
        return tuple(tuples(node[i]) for i in range(len(node)))
    return {key: tuples(value) for key, value in node.items()}


@torch.no_grad()
def tree_from_lm(lm: LM, *, grads: bool = False, dtype: torch.dtype = torch.float32) -> Dict:
    """The reference's param tree of the LM's tensors (or, with ``grads``,
    of their gradients, zeros where a tensor has none), in ``dtype``, on the
    LM's device; a period layer's leaves stacked over the periods."""
    stacks: Dict[Tuple[Any, ...], List[torch.Tensor]] = {}
    tree: Dict = {}
    for path, n, t in param_layout(lm):
        value = t.grad if grads else t
        value = torch.zeros_like(t) if value is None else value
        if n is None:
            set_path(tree, path, value.to(dtype, copy=True))
        else:
            stacks.setdefault(path, []).append(value)
    for path, parts in stacks.items():
        set_path(tree, path, torch.stack([part.to(dtype) for part in parts]))
    return tuples(tree)


@torch.no_grad()
def load_tree_into_lm(lm: LM, tree: Mapping[str, Any]) -> LM:
    """Copy the reference's param tree (numpy arrays or tensors, any float
    dtype) into the LM's tensors, each cast to the dtype the port stores it
    in (``lm_params_from_numpy``)."""
    k = lm.cfg.first_k_dense
    if len(tree.get("head_layers", ())) != k:
        raise ValueError(f"{len(tree.get('head_layers', ()))} head layers for first_k_dense={k}")
    for path, n, dst in param_layout(lm):
        src = _get(tree, path)
        if not isinstance(src, torch.Tensor):
            src = torch.from_numpy(np.array(src, dtype=np.float32))
        if n is not None:
            src = src[n]
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{'/'.join(map(str, path))}: shape {tuple(src.shape)} does not fit "
                             f"{tuple(dst.shape)}")
        dst.copy_(src)
    return lm


def lm_params_to_numpy(lm: LM) -> Dict:
    """The inverse of ``lm_params_from_numpy``: the LM's parameters as the
    reference's param tree of float32 numpy arrays."""
    return tree_to_numpy(tree_from_lm(lm))


def tree_to_numpy(tree) -> Any:
    """A tree of tensors (the trainer's parameters or optimizer state, in the
    reference's layout) as numpy arrays of the same dtypes (bf16 as
    float32, which numpy lacks)."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(leaf, tree)


def tree_from_numpy(tree, device: DeviceLike = None) -> Any:
    """A tree of numpy arrays (the reference's parameters or optimizer state)
    as tensors of the same dtypes on ``device`` (the card when None)."""
    device = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)
