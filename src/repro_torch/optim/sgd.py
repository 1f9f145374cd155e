"""Mini-batch SGD, local-update SGD (Splash-like), and full GD baselines.

The paper compares CoCoA/CoCoA+ against parallel SGD with local updates and
Splash (Fig 1c); these are those baselines over m BSP workers, the
counterparts of ``repro/optim/sgd.py``.  Local SGD's m worker chains of a
round are one launch of the local-SGD kernel
(repro_torch.kernels.local_sgd, one warp a worker); mini-batch SGD's gather
and products and GD's full gradient are PyTorch products.

Row indices are drawn with a ``torch.Generator`` on the problem's device,
seeded with ``cfg.seed``; each ``run_*`` that draws them also takes them
from the caller (``indices``: round -> (m, B) or (m, H)), so a test can feed
the JAX reference's streams.  The clock covers a round's draw and its work
and stops after the device has finished, as in ``run_cocoa``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.device import synchronize
from repro_torch.kernels.local_sgd.ops import local_sgd
from repro_torch.kernels.local_sgd.ref import loss_slope
from repro_torch.optim.cocoa import IndexSource, RunRecord, draw_indices, partition
from repro_torch.optim.problems import ERMProblem


def _run_rounds(problem: ERMProblem, rounds: int,
                step: Callable[[int, torch.Tensor], torch.Tensor],
                record_every: int) -> RunRecord:
    """``rounds`` rounds of ``w = step(it, w)`` from w = 0, each timed from
    a synchronised device to a synchronised device; the primal recorded
    every ``record_every`` rounds and after the last."""
    device = problem.device
    w = torch.zeros((problem.d,), dtype=torch.float32, device=device)
    primal = []
    t_compute = 0.0
    for it in range(rounds):
        synchronize(device)
        t_start = time.perf_counter()
        w = step(it, w)
        synchronize(device)
        t_compute += time.perf_counter() - t_start
        if it % record_every == 0 or it == rounds - 1:
            primal.append(float(problem.primal(w)))
    return RunRecord.primal_only(primal, w, t_compute)


# ---------------------------------------------------------------------------
# Mini-batch SGD (Pegasos-style step size for SVM)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SGDConfig:
    n_workers: int
    outer_iters: int = 100
    batch_per_worker: int = 64
    lr0: Optional[float] = None  # default 1/(lam * (t + t0))
    t0: float = 100.0
    seed: int = 0


def minibatch_sgd_step(Xs: torch.Tensor, ys: torch.Tensor, w: torch.Tensor,
                       idx: torch.Tensor, lam: float, t: float, loss: str = "hinge",
                       gamma: float = 1.0, t0: float = 100.0,
                       lr0: Optional[float] = None) -> torch.Tensor:
    """One synchronous round; Xs (m, nl, d), idx (m, B) each worker's
    minibatch.  The averaged gradient step, then the Pegasos projection onto
    the ||w|| <= 1/sqrt(lam) ball."""
    m, b = idx.shape
    rows = torch.arange(m, device=Xs.device)[:, None]
    xb, yb = Xs[rows, idx], ys[rows, idx]  # (m, B, d), (m, B)
    z = yb * (xb @ w)
    grads = (xb.transpose(1, 2) @ (loss_slope(z, loss, gamma) * yb)[..., None])[..., 0] / b
    f = np.float32
    lam32 = f(lam)
    g = torch.mean(grads, 0) + float(lam32) * w
    lr = lr0 if lr0 is not None else float(f(1.0) / (lam32 * (f(t) + f(t0))))
    w_new = w - lr * g
    norm = torch.linalg.vector_norm(w_new)
    return w_new * torch.clamp(1.0 / (float(np.sqrt(lam32)) * norm + 1e-30), max=1.0)


def run_minibatch_sgd(problem: ERMProblem, cfg: SGDConfig, record_every: int = 1,
                      indices: Optional[IndexSource] = None) -> RunRecord:
    """``cfg.outer_iters`` rounds from w = 0; round it steps at t = it + 1.
    ``indices`` gives each round's (m, B) minibatches (default: uniform
    draws from a generator seeded with ``cfg.seed``)."""
    m, b = cfg.n_workers, cfg.batch_per_worker
    device = problem.device
    Xs, ys = partition(problem.X, problem.y, m)
    nl = Xs.shape[1]
    if indices is None:
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
        indices = lambda _it: torch.randint(0, nl, (m, b), generator=generator, device=device)

    def step(it: int, w: torch.Tensor) -> torch.Tensor:
        idx = torch.as_tensor(indices(it), device=device)
        return minibatch_sgd_step(Xs, ys, w, idx, problem.lam, float(it + 1), problem.loss,
                                  problem.smooth_gamma, cfg.t0, cfg.lr0)

    return _run_rounds(problem, cfg.outer_iters, step, record_every)


# ---------------------------------------------------------------------------
# Local-update SGD (Splash-like: local passes then averaging)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LocalSGDConfig:
    n_workers: int
    outer_iters: int = 100
    local_steps: Optional[int] = None  # default: one local epoch
    lr0: float = 1.0
    t0: float = 100.0
    seed: int = 0


def run_local_sgd(problem: ERMProblem, cfg: LocalSGDConfig, record_every: int = 1,
                  indices: Optional[IndexSource] = None) -> RunRecord:
    """``cfg.outer_iters`` rounds from w = 0: every worker runs H local
    steps from w (one kernel launch for the m workers), then w is their
    mean.  ``indices`` gives each round's (m, H) rows (default: the first H
    of a permutation of each shard when H <= nl, else uniform draws, from a
    generator seeded with ``cfg.seed``)."""
    m = cfg.n_workers
    device = problem.device
    Xs, ys = partition(problem.X, problem.y, m)
    nl = Xs.shape[1]
    h = cfg.local_steps or nl
    if indices is None:
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
        indices = lambda _it: draw_indices(m, nl, h, generator)

    def step(it: int, w: torch.Tensor) -> torch.Tensor:
        idx = torch.as_tensor(indices(it), device=device)
        W = local_sgd(w.expand(m, -1).contiguous(), Xs, ys, idx, float(it), h, cfg.lr0,
                      cfg.t0, problem.lam, problem.loss, problem.smooth_gamma)
        return torch.mean(W, 0)

    return _run_rounds(problem, cfg.outer_iters, step, record_every)


# ---------------------------------------------------------------------------
# Full gradient descent (convergence independent of m — §2.2)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class GDConfig:
    outer_iters: int = 100
    lr: float = 0.5


def run_gd(problem: ERMProblem, cfg: GDConfig, record_every: int = 1) -> RunRecord:
    return _run_rounds(problem, cfg.outer_iters,
                       lambda _it, w: w - cfg.lr * problem.grad(w), record_every)
