"""Plain PyTorch version of the local-SGD worker chain, batched over workers.

The same arithmetic as the CUDA kernel (csrc/local_sgd.cu) and as the JAX
package's worker scans, ``repro/optim/sgd.py::_local_sgd_step`` (:106-129)
and ``repro/optim/simcluster.py::_ssp_outer_step`` (:59-78): all m workers
take their i-th step together, and a Python loop runs the H steps in order.
It runs on any device; the CPU tests and the card's kernel check use it.
"""
from __future__ import annotations

import numpy as np
import torch

LOSSES = ("hinge", "smooth_hinge", "logistic")


def step_sizes(t: float, h: int, steps: int, lr0: float, t0: float, lam: float
               ) -> np.ndarray:
    """The first ``steps`` step sizes of outer iteration t of a round of h
    steps, lr0 / (lam (t h + i + t0)) for i = 0 .. steps - 1, each operation
    in float32 in the reference's order (``t * h + step_i + t0``, left to
    right)."""
    f = np.float32
    i = np.arange(steps, dtype=np.float32)
    with np.errstate(divide="ignore", over="ignore"):
        return f(lr0) / (f(lam) * ((f(t) * f(h) + i) + f(t0)))


def loss_slope(z: torch.Tensor, loss: str, gamma: float) -> torch.Tensor:
    """d loss / d z at the margins z, as the reference writes it."""
    if loss == "hinge":
        return torch.where(z < 1.0, -1.0, 0.0)
    if loss == "smooth_hinge":
        # the reference compares with the Python float 1 - gamma, rounded to
        # float32 once; (z - 1) / gamma in float32
        edge = float(np.float32(1.0 - gamma))
        return torch.where(z >= 1.0, 0.0,
                           torch.where(z <= edge, -1.0, (z - 1.0) / float(np.float32(gamma))))
    return -torch.sigmoid(-z)


def local_sgd_ref(
    W0: torch.Tensor,  # (m, d) each worker's start vector
    X: torch.Tensor,  # (m, nl, d) worker shards
    y: torch.Tensor,  # (m, nl)
    idx: torch.Tensor,  # (m, S) the rows each worker visits, in order
    t: float,
    h: int,
    lr0: float,
    t0: float,
    lam: float,
    loss: str = "hinge",
    gamma: float = 1.0,
) -> torch.Tensor:
    """S = idx's width local SGD steps on each of m workers, step i at
    lr0 / (lam (t h + i + t0)): the reference's callers run S = h, the
    round's length; fewer steps are that round's first ones.  Returns the
    workers' vectors (m, d); W0 is not modified."""
    m = X.shape[0]
    rows = torch.arange(m, device=X.device)
    w = W0.clone()
    lam32 = float(np.float32(lam))
    for i, lr in enumerate(step_sizes(t, h, idx.shape[1], lr0, t0, lam).tolist()):
        j = idx[:, i]
        x = X[rows, j]  # (m, d)
        yj = y[rows, j]
        z = yj * torch.sum(x * w, dim=1)
        c = loss_slope(z, loss, gamma) * yj
        g = c[:, None] * x + lam32 * w
        w = w - lr * g
    return w


def first_gate_ties(
    W0: torch.Tensor, X: torch.Tensor, y: torch.Tensor, idx: torch.Tensor, t: float, h: int,
    lr0: float, t0: float, lam: float,
) -> torch.Tensor:
    """For the hinge: each worker's first step whose margin z, in the plain
    chain, lies within float32's bound on a dot product summed in another
    order, |y| d 2^-24 sum |x w|, of the gate at 1 (H where none does).

    The hinge's slope is -1 or 0, so two chains that differ only in the
    order of the dot's sum (the kernel's and ``local_sgd_ref``'s) take the
    same gates, and so compute the same bits, at least up to that step."""
    m, _, d = X.shape
    steps = idx.shape[1]
    rows = torch.arange(m, device=X.device)
    first = torch.full((m,), steps, dtype=torch.long, device=X.device)
    w = W0.clone()
    lam32 = float(np.float32(lam))
    for i, lr in enumerate(step_sizes(t, h, steps, lr0, t0, lam).tolist()):
        j = idx[:, i]
        x, yj = X[rows, j], y[rows, j]
        z = yj * torch.sum(x * w, dim=1)
        reach = yj.abs() * (d * 2.0 ** -24) * torch.sum((x * w).abs(), dim=1)
        first = torch.where(((z - 1.0).abs() <= reach) & (first == steps), i, first)
        g = (loss_slope(z, "hinge", 1.0) * yj)[:, None] * x + lam32 * w
        w = w - lr * g
    return first
