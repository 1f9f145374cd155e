"""CoCoA [NIPS'14] and CoCoA+ [ICML'15] — the paper's main subjects.

Data-parallel dual coordinate ascent: each of the m workers runs H local
SDCA steps on its own partition against a local view
v = w + sigma' * (local delta), then the delta-w's are combined:

  * CoCoA   (gamma = 1/m "averaging", sigma' = 1):  w += mean_k dw_k
  * CoCoA+  (gamma = 1  "adding",    sigma' = m):   w += sum_k dw_k

The m workers of a round are one launch of the SDCA kernel
(repro_torch.kernels.sdca), one block per worker.  Coordinate orders are
drawn with a ``torch.Generator`` on the problem's device; ``cocoa_outer_step``
takes them explicitly and ``run_cocoa`` accepts another source of them, so a
test can feed the JAX reference's orders.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import synchronize
from repro_torch.kernels.sdca.ops import local_sdca
from repro_torch.optim.problems import ERMProblem

# round number -> (m, H) coordinate indices for that round
IndexSource = Callable[[int], "torch.Tensor | np.ndarray"]


@dataclasses.dataclass(frozen=True)
class CocoaConfig:
    n_workers: int
    outer_iters: int = 100
    local_iters: Optional[int] = None  # default: one local epoch (n/m steps)
    plus: bool = False                 # CoCoA+ (adding) vs CoCoA (averaging)
    seed: int = 0


def partition(X: torch.Tensor, y: torch.Tensor, m: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shard (n, d) -> (m, n_local, d), zero-padding the tail (padded rows
    have ||x|| = 0 and are skipped by the update's curvature guard)."""
    n, d = X.shape
    nl = -(-n // m)
    pad = nl * m - n
    Xp = torch.nn.functional.pad(X, (0, 0, 0, pad))
    yp = torch.nn.functional.pad(y, (0, pad), value=1.0)
    return Xp.reshape(m, nl, d), yp.reshape(m, nl)


def draw_indices(m: int, nl: int, h: int, generator: torch.Generator
                 ) -> torch.Tensor:
    """Each worker's H coordinates: the first H of a random permutation of
    its nl rows when H <= nl, else H uniform draws with repeats."""
    device = generator.device
    if h <= nl:
        keys = torch.rand((m, nl), generator=generator, device=device)
        return torch.argsort(keys, dim=1)[:, :h]
    return torch.randint(0, nl, (m, h), generator=generator, device=device)


def cocoa_outer_step(Xs: torch.Tensor, ys: torch.Tensor, a: torch.Tensor,
                     w: torch.Tensor, idx: torch.Tensor, plus: bool,
                     lam: float, n: float, loss: str = "hinge",
                     gamma: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One BSP round; Xs (m, nl, d), a (m, nl), idx (m, H)."""
    m = Xs.shape[0]
    sigma_prime = float(m) if plus else 1.0
    a_new, dw = local_sdca(Xs, ys, a, w, idx, sigma_prime, lam, n, loss, gamma)
    w_new = w + (torch.sum(dw, 0) if plus else torch.mean(dw, 0))
    return a_new, w_new


@dataclasses.dataclass
class RunRecord:
    primal: np.ndarray
    dual: np.ndarray
    gap: np.ndarray
    w: np.ndarray
    compute_seconds: float  # measured seconds of the timed rounds (m workers a launch)

    @classmethod
    def primal_only(cls, primal: list, w: torch.Tensor, compute_seconds: float
                    ) -> "RunRecord":
        """A run that tracks the primal alone: dual and gap are NaN."""
        p = np.asarray(primal)
        nan = np.full_like(p, np.nan)
        return cls(p, nan, nan, w.cpu().numpy(), compute_seconds)


def run_cocoa(problem: ERMProblem, cfg: CocoaConfig, record_every: int = 1,
              indices: Optional[IndexSource] = None) -> RunRecord:
    """``cfg.outer_iters`` rounds from a = 0, w = 0.  ``indices`` gives each
    round's (m, H) coordinates; by default they are drawn from a generator
    seeded with ``cfg.seed`` on the problem's device.  The clock covers the
    index draw and the round, and stops after the device has finished."""
    m = cfg.n_workers
    device = problem.device
    Xs, ys = partition(problem.X, problem.y, m)
    nl = Xs.shape[1]
    h = cfg.local_iters or nl
    a = torch.zeros((m, nl), dtype=torch.float32, device=device)
    w = torch.zeros((problem.d,), dtype=torch.float32, device=device)
    if indices is None:
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
        indices = lambda _it: draw_indices(m, nl, h, generator)

    primal, dual, gap = [], [], []
    t_compute = 0.0
    for it in range(cfg.outer_iters):
        synchronize(device)
        t0 = time.perf_counter()
        idx = torch.as_tensor(indices(it), device=device)
        a, w = cocoa_outer_step(Xs, ys, a, w, idx, cfg.plus, problem.lam,
                                float(problem.n), problem.loss,
                                problem.smooth_gamma)
        synchronize(device)
        t_compute += time.perf_counter() - t0
        if it % record_every == 0 or it == cfg.outer_iters - 1:
            a_flat = a.reshape(-1)[: problem.n]
            primal.append(float(problem.primal(w)))
            dual.append(float(problem.dual(a_flat)))
            gap.append(primal[-1] - dual[-1])
    return RunRecord(np.asarray(primal), np.asarray(dual), np.asarray(gap),
                     w.cpu().numpy(), t_compute)
