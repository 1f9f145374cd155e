"""L2-regularized ERM problems + the synthetic MNIST stand-in (§2.3).

    P(w) = (1/n) sum_i phi(y_i, x_i . w) + (lam/2) ||w||^2

with hinge (linear SVM, as in the paper), smoothed hinge, or logistic loss.
For SDCA-family solvers we expose the dual objective and duality gap
(Shalev-Shwartz & Zhang 2013 formulation: w(alpha) = X^T alpha / (lam n),
alpha_i * y_i in [0, 1] for hinge).

The problem holds its data as float32 tensors on one device; every method
computes there.  The float32 products ``X @ w`` and ``X.T @ (a * y)`` run
in full float32: TF32 is switched off explicitly when a problem is built,
since the objectives are held to the JAX reference at rtol 1e-5 and TF32
keeps about three decimal digits.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.local_sgd.ref import loss_slope

LossName = Literal["hinge", "smooth_hinge", "logistic"]


@dataclasses.dataclass(frozen=True)
class ERMProblem:
    X: torch.Tensor  # (n, d) float32
    y: torch.Tensor  # (n,) in {-1, +1}
    lam: float
    loss: LossName = "hinge"
    smooth_gamma: float = 1.0  # smoothed-hinge smoothing

    def __post_init__(self):
        torch.backends.cuda.matmul.allow_tf32 = False

    @property
    def n(self) -> int:
        return self.X.shape[0]

    @property
    def d(self) -> int:
        return self.X.shape[1]

    @property
    def device(self) -> torch.device:
        return self.X.device

    # ------------------------------------------------------------------
    def margins(self, w: torch.Tensor) -> torch.Tensor:
        return self.y * (self.X @ w)

    def loss_values(self, z: torch.Tensor) -> torch.Tensor:
        if self.loss == "hinge":
            return torch.clamp(1.0 - z, min=0.0)
        if self.loss == "smooth_hinge":
            g = self.smooth_gamma
            return torch.where(
                z >= 1.0, 0.0,
                torch.where(z <= 1.0 - g, 1.0 - z - g / 2,
                            (1.0 - z) ** 2 / (2 * g)))
        # logistic
        return torch.logaddexp(torch.zeros_like(z), -z)

    def loss_grad_z(self, z: torch.Tensor) -> torch.Tensor:
        """d loss / d z (z = y * x.w)."""
        return loss_slope(z, self.loss, self.smooth_gamma)

    def primal(self, w: torch.Tensor) -> torch.Tensor:
        z = self.margins(w)
        return torch.mean(self.loss_values(z)) + 0.5 * self.lam * torch.sum(w * w)

    def grad(self, w: torch.Tensor) -> torch.Tensor:
        z = self.margins(w)
        gz = self.loss_grad_z(z)  # (n,)
        return (self.X.T @ (gz * self.y)) / self.n + self.lam * w

    # ------------------------------------------------------------------
    # SDCA dual (hinge / smooth hinge).  alpha parametrized so that
    # a_i := alpha_i * y_i in [0, 1];  w(alpha) = X^T (a*y) / (lam n).
    # ------------------------------------------------------------------
    def w_of_alpha(self, a: torch.Tensor) -> torch.Tensor:
        return self.X.T @ (a * self.y) / (self.lam * self.n)

    def dual(self, a: torch.Tensor) -> torch.Tensor:
        w = self.w_of_alpha(a)
        if self.loss == "smooth_hinge":
            conj = a - self.smooth_gamma * a * a / 2.0
        else:  # hinge
            conj = a
        return torch.mean(conj) - 0.5 * self.lam * torch.sum(w * w)

    def duality_gap(self, a: torch.Tensor) -> torch.Tensor:
        return self.primal(self.w_of_alpha(a)) - self.dual(a)


# ---------------------------------------------------------------------------
# Synthetic MNIST stand-in (MNIST unavailable offline; see DESIGN.md §6).
# numpy-only and identical to the JAX package's, so both see the same bits.
# ---------------------------------------------------------------------------
def synthetic_mnist(
    n: int = 60_000,
    d: int = 784,
    effective_rank: int = 40,
    positive_fraction: float = 0.09,
    noise: float = 0.35,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Low-rank-ish pixel data + imbalanced binary labels (digit==5 proxy).

    X = |Z W| scaled to [0,1]; labels from a hyperplane on the latent Z,
    thresholded at the (1 - positive_fraction) quantile.
    """
    rng = np.random.RandomState(seed)
    z = rng.randn(n, effective_rank)
    w_mix = rng.randn(effective_rank, d) / np.sqrt(effective_rank)
    x = z @ w_mix + noise * rng.randn(n, d)
    x = np.abs(x)
    x = x / (x.max() + 1e-9)
    direction = rng.randn(effective_rank)
    score = z @ direction
    thresh = np.quantile(score, 1.0 - positive_fraction)
    y = np.where(score >= thresh, 1.0, -1.0)
    return x.astype(np.float32), y.astype(np.float32)


def make_mnist_svm(cfg=None, device: DeviceLike = None) -> ERMProblem:
    """The paper's workload from configs/cocoa_mnist.py, on ``device``
    (the card when None)."""
    from repro_torch.configs import cocoa_mnist
    from repro_torch.convert import problem_from_numpy

    device = resolve_device(device)
    cfg = cfg or cocoa_mnist.config()
    x, y = synthetic_mnist(cfg.n_examples, cfg.n_features, cfg.effective_rank,
                           cfg.positive_fraction, cfg.noise, cfg.seed)
    return problem_from_numpy(x, y, cfg.lam, loss="hinge", device=device)
