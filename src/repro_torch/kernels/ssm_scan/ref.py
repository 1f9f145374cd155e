"""Plain PyTorch version of the selective scan (K4), the Mamba-1 recurrence

    h_t = exp(dt_t A) * h_{t-1} + (dt_t x_t) B_t
    y_t = sum_n C_t[n] h_t[:, n] + D x_t

as a sequential loop over t in float32: the counterpart of
``repro/kernels/ssm_scan/ref.py::selective_scan_ref`` with the initial state
of ``ops.py::selective_scan`` (``h0``).  At S = 1 it is
``ops.py::selective_scan_step``, the decode step.

Each step runs the reference's operations in its order, one rounding each:
``decay = exp(dt A)``, ``h = decay h + (dt x) B``, ``y = sum_n h C + D x``.
The sum over n halves the state axis repeatedly (n with n + N/2, then
N/4, ...).  This serial loop is the reference-order oracle the card holds
the kernel against: the kernel scans time as an associative scan in fixed
tiles and sums over n in order, so the two differ by a few float32
roundings a step (``tests/test_torch_block_scan.py`` models the kernel's
grouping).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def lane_sum(p: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by halving it while its length is even, then
    in one sum over what remains (1 for a power of two)."""
    while p.shape[-1] > 1 and p.shape[-1] % 2 == 0:
        half = p.shape[-1] // 2
        p = p[..., :half] + p[..., half:]
    return p.sum(-1) if p.shape[-1] > 1 else p[..., 0]


def selective_scan_ref(
    x: torch.Tensor,  # (Bt, S, Dn)
    dt: torch.Tensor,  # (Bt, S, Dn), positive (softplus applied)
    A: torch.Tensor,  # (Dn, N), negative
    B: torch.Tensor,  # (Bt, S, N)
    C: torch.Tensor,  # (Bt, S, N)
    D: torch.Tensor,  # (Dn,)
    h: Optional[torch.Tensor] = None,  # (Bt, Dn, N) initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (Bt, S, Dn) in x's dtype, h_last (Bt, Dn, N) float32).
    ``h`` is read, not written."""
    bt, s, dn = x.shape
    n = A.shape[1]
    xf, dtf = x.float(), dt.float()
    af, bf, cf, df = A.float(), B.float(), C.float(), D.float()
    state = (torch.zeros((bt, dn, n), dtype=torch.float32, device=x.device) if h is None
             else h.float().clone())
    y = torch.empty((bt, s, dn), dtype=torch.float32, device=x.device)
    for t in range(s):
        dtt, xt = dtf[:, t], xf[:, t]  # (Bt, Dn)
        decay = torch.exp(dtt[..., None] * af)  # (Bt, Dn, N)
        bx = (dtt * xt)[..., None] * bf[:, t, None, :]
        state = decay * state + bx
        y[:, t] = lane_sum(state * cf[:, t, None, :]) + df * xt
    return y.to(x.dtype), state
