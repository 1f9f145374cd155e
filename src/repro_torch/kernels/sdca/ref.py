"""Plain PyTorch version of the local SDCA inner loop, batched over workers.

The same arithmetic as the CUDA kernel (csrc/sdca.cu) and as the JAX
package's ``kernels/sdca/ref.py::local_sdca_ref`` and
``optim/cocoa.py::_local_sdca`` (hinge and smooth hinge): all m workers take
their t-th step together, and a Python loop runs the H steps in order.
It runs on any device; the CPU tests and the card's kernel check use it.
"""
from __future__ import annotations

from typing import Tuple

import torch


def local_sdca_ref(
    X: torch.Tensor,  # (m, nl, d) worker shards
    y: torch.Tensor,  # (m, nl)
    a: torch.Tensor,  # (m, nl) dual vars (a = alpha * y in [0, 1])
    w: torch.Tensor,  # (d,) current global model
    idx: torch.Tensor,  # (m, H) coordinate order
    sigma_prime: float,
    lam: float,
    n: float,
    loss: str = "hinge",
    gamma: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (new a (m, nl), dw (m, d))."""
    m = X.shape[0]
    lam_n = lam * n
    rows = torch.arange(m, device=X.device)
    a = a.clone()
    v = w.expand(m, -1).clone()
    for t in range(idx.shape[1]):
        j = idx[:, t]
        x = X[rows, j]  # (m, d)
        yj = y[rows, j]
        aj = a[rows, j]
        xx = torch.sum(x * x, dim=1)
        q = sigma_prime * xx / lam_n
        margin = yj * torch.sum(v * x, dim=1)
        if loss == "smooth_hinge":
            delta_raw = (1.0 - margin - gamma * aj) / (q + gamma)
        else:  # hinge
            delta_raw = torch.where(q > 0, (1.0 - margin) / torch.clamp(q, min=1e-30),
                                    0.0)
        a_new = torch.clamp(aj + delta_raw, 0.0, 1.0)
        delta = torch.where(xx > 0, a_new - aj, 0.0)
        a[rows, j] = aj + delta
        v = v + (sigma_prime * delta * yj)[:, None] * x / lam_n
    return a, (v - w) / sigma_prime
