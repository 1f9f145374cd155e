"""Mamba-1 mixer (falcon-mamba): the counterpart of ``repro/models/mamba.py``,
with the selective scan on K4 (``repro_torch.kernels.ssm_scan``).

Parameters are one layer's dict with the reference's names, shapes and
initialisers (``mamba.py:22-51``).  The matrices ``in_proj``, ``x_proj``,
``dt_w`` and ``out_proj`` are stored in the config's dtype; ``conv_w``,
``conv_b``, ``dt_b``, ``A_log`` and ``D``, which the reference reads in
float32, are stored in float32.

The depthwise causal conv accumulates in float32 and rounds once, written
as the explicit sum of ``d_conv`` shifted products in the same order in
prefill and in the decode step, so the two agree (the reference's comment at
``mamba.py:101``).  It is not ``F.conv1d``: a float32 convolution on the
card goes through cuDNN in TF32 by default.

The decode state is ``{"h": (B, Dn, N) float32, "conv": (B, Dn, d_conv - 1)
in the config's dtype}``: the scan's state and the last ``d_conv - 1``
inputs of the conv.  The decode step updates both in place.

Prefill takes ``n_valid``: positions from ``n_valid`` on are padding (the
serve engine pads prompts to whole row blocks).  Their ``dt`` and ``x`` are
zeroed before the scan, so there the state is held bit for bit (decay 1,
input 0) and ``h_last`` is the state after position ``n_valid - 1``; the
conv tail is taken from the ``d_conv - 1`` real positions before
``n_valid``, with zeros before position 0.  The reference takes it as the
last ``d_conv - 1`` positions of the sequence (``mamba.py:122``), which at a
prompt shorter than that raises or repeats a position; the port does not.

Under a mesh (``rt.mesh``) the model is a tensor-parallel rank's: ``cfg``
holds its share of the inner width (``MambaConfig.d_inner``: Dn / K
channels), ``in_proj`` its columns of each half (x and z), ``conv_w``,
``conv_b``, ``dt_w``, ``dt_b``, ``A_log`` and ``D`` its channels, and
``x_proj`` and ``out_proj`` its rows (``repro_torch.serve.sharding``).  K4
scans the rank's channels; ``x_proj``'s and ``out_proj``'s partial products
are summed over the "model" group, so dt's low-rank input and B and C are
the whole sums on every rank.  In training their gradients, and the
replicated input's, which each rank holds for its channels only, are
summed over the group too (``copy_to_model``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.collectives import all_reduce_sum, copy_to_model
from repro_torch.kernels.ssm_scan.ops import selective_scan
from repro_torch.models.layers import by_rows
from repro_torch.models.runtime import Runtime

# parameters stored (and read) in float32 whatever the config's dtype
FLOAT32_PARAMS = frozenset({"conv_w", "conv_b", "dt_b", "A_log", "D"})


def mamba_shapes(cfg: ArchConfig) -> Dict[str, Tuple[Tuple[int, ...], str, float]]:
    """name -> (shape, init, scale), the reference's initialisers: normal *
    scale, uniform in (-scale, scale) for ``dt_w``, the softplus inverse of
    a log-uniform draw in [1e-3, 1e-1] for ``dt_b``, log(1..N) for
    ``A_log`` (S4D-real), zeros and ones."""
    mc = cfg.mamba
    d, di, n = cfg.d_model, mc.resolved_d_inner(cfg.d_model), mc.d_state
    dtr = mc.resolved_dt_rank(d)
    return {
        "in_proj": ((d, 2 * di), "normal", 1.0 / math.sqrt(d)),
        "conv_w": ((di, mc.d_conv), "normal", 1.0 / math.sqrt(mc.d_conv)),
        "conv_b": ((di,), "zeros", 0.0),
        "x_proj": ((di, dtr + 2 * n), "normal", 1.0 / math.sqrt(di)),
        "dt_w": ((dtr, di), "uniform", dtr ** -0.5),
        "dt_b": ((di,), "dt_bias", 0.0),
        "A_log": ((di, n), "a_log", 0.0),
        "D": ((di,), "ones", 0.0),
        "out_proj": ((di, d), "normal", 1.0 / math.sqrt(di)),
    }


def init_mamba_param(t: torch.Tensor, init: str, generator: torch.Generator) -> None:
    """The initialisers of ``mamba_shapes`` that are not plain normal, zeros
    or ones, drawn in float32 on the generator's device."""
    if init == "a_log":
        n = t.shape[1]
        t.copy_(torch.log(torch.arange(1, n + 1, dtype=torch.float32)).expand(t.shape))
    elif init == "dt_bias":
        u = torch.rand(t.shape, generator=generator, dtype=torch.float32,
                       device=generator.device)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        t.copy_(torch.log(torch.expm1(dt)))
    else:
        raise ValueError(f"unknown initialiser {init!r}")


def _conv(taps: List[torch.Tensor], p) -> torch.Tensor:
    """silu(sum_k taps[k] * conv_w[:, k] + conv_b) in float32; taps[k] holds
    the input k - (d_conv - 1) positions back from each output's own."""
    w = p["conv_w"]
    acc = taps[0] * w[:, 0]
    for k in range(1, len(taps)):
        acc = acc + taps[k] * w[:, k]
    return F.silu(acc + p["conv_b"])


def _split_xdb(p, x_conv: torch.Tensor, cfg: ArchConfig, rows: int, group=None):
    """x_conv (B, S, Dn) -> dt (B, S, Dn) float32, and B, C (B, S, N) as
    views of x_proj's output (``mamba.py:_split_xdb``), summed over
    ``group``."""
    mc = cfg.mamba
    dtr, n = mc.resolved_dt_rank(cfg.d_model), mc.d_state
    xdb = copy_to_model(all_reduce_sum(by_rows(lambda r: r @ p["x_proj"], x_conv, rows), group),
                        group)
    dt_raw, b_ssm, c_ssm = xdb.split([dtr, n, n], dim=-1)
    dt = by_rows(lambda r: F.softplus((r @ p["dt_w"]).float() + p["dt_b"]), dt_raw, rows)
    return dt, b_ssm, c_ssm


def apply_mamba(p, x: torch.Tensor, cfg: ArchConfig, rt: Runtime, *,
                n_valid: Optional[int] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill: x (B, S, d) -> (out (B, S, d), state {"h", "conv"} after
    position ``n_valid - 1``, default the last).  The products run over
    blocks of ``rt.prefill_rows`` positions; the conv and the scan span the
    whole sequence.  Also the training forward (``n_valid`` None): with grad
    the scan is ``SelectiveScan`` (K4, then K4-bwd in the backward) from
    zero state."""
    mc = cfg.mamba
    s = x.shape[1]
    di, cw = mc.resolved_d_inner(cfg.d_model), mc.d_conv
    n = s if n_valid is None else int(n_valid)
    rows = rt.prefill_rows
    group = rt.model_group()
    x = copy_to_model(x, group)
    xz = by_rows(lambda r: r @ p["in_proj"], x, rows)
    x_in, z = xz.split(di, dim=-1)
    xp = F.pad(x_in.float(), (0, 0, cw - 1, 0))  # zeros before position 0
    x_conv = _conv([xp[:, k:k + s] for k in range(cw)], p).to(x.dtype)
    dt, b_ssm, c_ssm = _split_xdb(p, x_conv, cfg, rows, group)
    if n < s:  # the serve engine's padding (in place: never on the training path)
        dt[:, n:] = 0.0
        x_conv[:, n:] = 0
    y, h = selective_scan(x_conv, dt, -torch.exp(p["A_log"]), b_ssm, c_ssm, p["D"])
    out = all_reduce_sum(by_rows(lambda r: r @ p["out_proj"], y * F.silu(z), rows), group)
    tail = F.pad(x_in[:, max(0, n - (cw - 1)):n], (0, 0, max(0, cw - 1 - n), 0))
    return out, {"h": h, "conv": tail.transpose(1, 2).contiguous()}


def apply_mamba_decode(p, x: torch.Tensor, cfg: ArchConfig, state: Dict[str, torch.Tensor],
                       rt: Optional[Runtime] = None) -> torch.Tensor:
    """One decode step of x (B, 1, d) from ``state`` {"h" (B, Dn, N) float32,
    "conv" (B, Dn, d_conv - 1)}, which it updates in place.  Returns
    (B, 1, d)."""
    group = None if rt is None else rt.model_group()
    mc = cfg.mamba
    di, cw = mc.resolved_d_inner(cfg.d_model), mc.d_conv
    xz = x[:, 0] @ p["in_proj"]
    x_in, z = xz.split(di, dim=-1)
    conv = state["conv"]
    taps = [conv[..., k].float() for k in range(cw - 1)] + [x_in.float()]
    x_conv = _conv(taps, p).to(x.dtype)[:, None]  # (B, 1, Dn)
    dt, b_ssm, c_ssm = _split_xdb(p, x_conv, cfg, 1, group)
    y, _ = selective_scan(x_conv, dt, -torch.exp(p["A_log"]), b_ssm, c_ssm, p["D"],
                          state["h"])
    conv.copy_(torch.cat([conv[..., 1:], x_in[..., None].to(conv.dtype)], dim=-1))
    return all_reduce_sum((y[:, 0] * F.silu(z)) @ p["out_proj"], group)[:, None]
