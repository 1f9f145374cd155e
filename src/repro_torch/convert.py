"""Carry the JAX package's data and state (as numpy arrays) into the port.

Both packages meet only through numpy: the reference hands over its arrays,
and these functions place them on the port's device as contiguous tensors:
float32 for the optimisation problems, the config's dtype for LM weights.
"""
from __future__ import annotations

from typing import Any, Mapping, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import LM
from repro_torch.optim.problems import ERMProblem, LossName


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
    with numpy leaves: ``embed``, ``final_norm``, ``lm_head``, with
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

    def put(dst: torch.Tensor, src) -> None:
        src = np.asarray(src)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"shape {src.shape} does not fit {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(np.array(src, dtype=np.float32)))

    put(lm.embed, params["embed"])
    put(lm.final_norm, params["final_norm"])
    if lm.lm_head is not None:
        put(lm.lm_head, params["lm_head"])
    k, period = cfg.first_k_dense, len(cfg.period)
    head_layers = params.get("head_layers", ())
    if len(head_layers) != k:
        raise ValueError(f"{len(head_layers)} head layers for first_k_dense={k}")
    for i, layer in enumerate(lm.layers):
        if i < k:  # a head layer's leaves are unstacked
            src, n = head_layers[i], None
        else:
            src, n = params["periods"][f"pos{(i - k) % period}"], (i - k) // period

        def put_leaf(dst: torch.Tensor, leaf) -> None:
            put(dst, leaf if n is None else leaf[n])

        put_leaf(layer.ln1, src["ln1"])
        if layer.ln2 is not None:
            put_leaf(layer.ln2, src["ln2"])
        for group in layer.specs:
            for name, dst in getattr(layer, group).items():
                put_leaf(dst, src[group][name])
    return lm
