"""Distributed L-BFGS (quasi-Newton baseline, §2.2).

Gradients are computed data-parallel (the expensive part — one pass over the
shards, reduced); the two-loop recursion and line search are on the driver,
as in production L-BFGS-on-Spark/MLlib.  Requires a smooth loss
(logistic / smooth_hinge).

The counterpart of ``repro/optim/lbfgs.py``.  The reference differentiates
the primal with ``jax.value_and_grad``; here the value is ``problem.primal``
and the gradient the closed form ``problem.grad`` (the same function, its
float32 sums in another order).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Tuple

import torch

from repro_torch.device import synchronize
from repro_torch.optim.cocoa import RunRecord
from repro_torch.optim.problems import ERMProblem


@dataclasses.dataclass(frozen=True)
class LBFGSConfig:
    outer_iters: int = 100
    memory: int = 10
    c1: float = 1e-4
    backtrack: float = 0.5
    max_ls: int = 20


def run_lbfgs(problem: ERMProblem, cfg: LBFGSConfig,
              record_every: int = 1) -> RunRecord:
    if problem.loss == "hinge":
        raise ValueError("L-BFGS needs a smooth loss (logistic/smooth_hinge)")
    device = problem.device

    def value_and_grad(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return problem.primal(w), problem.grad(w)

    w = torch.zeros((problem.d,), dtype=torch.float32, device=device)
    s_list: List[torch.Tensor] = []
    y_list: List[torch.Tensor] = []
    primal = []
    t_compute = 0.0
    f, g = value_and_grad(w)
    for it in range(cfg.outer_iters):
        synchronize(device)
        t_start = time.perf_counter()
        # two-loop recursion
        q = g
        alphas = []
        for s, yv in zip(reversed(s_list), reversed(y_list)):
            rho = 1.0 / torch.clamp(torch.dot(yv, s), min=1e-12)
            a = rho * torch.dot(s, q)
            alphas.append((a, rho))
            q = q - a * yv
        if y_list:
            gamma = torch.dot(s_list[-1], y_list[-1]) / torch.clamp(
                torch.dot(y_list[-1], y_list[-1]), min=1e-12)
            q = gamma * q
        for (a, rho), s, yv in zip(reversed(alphas), s_list, y_list):
            b = rho * torch.dot(yv, q)
            q = q + (a - b) * s
        direction = -q
        # Armijo backtracking
        step = 1.0
        gtd = torch.dot(g, direction)
        f_new, g_new, w_new = f, g, w
        for _ in range(cfg.max_ls):
            w_try = w + step * direction
            f_try, g_try = value_and_grad(w_try)
            if float(f_try) <= float(f) + cfg.c1 * step * float(gtd):
                f_new, g_new, w_new = f_try, g_try, w_try
                break
            step *= cfg.backtrack
        else:
            # no sufficient decrease — take a tiny gradient step
            w_new = w - 1e-3 * g
            f_new, g_new = value_and_grad(w_new)
        s_list.append(w_new - w)
        y_list.append(g_new - g)
        if len(s_list) > cfg.memory:
            s_list.pop(0)
            y_list.pop(0)
        w, f, g = w_new, f_new, g_new
        synchronize(device)
        t_compute += time.perf_counter() - t_start
        if it % record_every == 0 or it == cfg.outer_iters - 1:
            primal.append(float(f))
    return RunRecord.primal_only(primal, w, t_compute)
