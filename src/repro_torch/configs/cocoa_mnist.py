"""The paper's own experimental workload (§2.3, §4).

Binary classification (digit == 5) on MNIST, linear SVM loss, solved with
CoCoA / CoCoA+ while varying the degree of parallelism m in powers of two.
MNIST itself is not available offline, so we generate a synthetic stand-in
with the same shape (60000 x 784), a realistic low-rank covariance spectrum
and the same ~9% positive-class imbalance.  See repro_torch.optim.problems.
"""
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class CocoaMnistConfig:
    n_examples: int = 60_000
    n_features: int = 784
    positive_fraction: float = 0.09  # fraction of digit-5 labels in MNIST
    effective_rank: int = 40  # MNIST pixels are highly correlated
    noise: float = 0.35
    lam: float = 1e-4  # L2 regularization (lambda)
    seed: int = 0
    # sweep used by the paper: m = 1..128 in powers of 2
    parallelism_sweep: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128)
    target_suboptimality: float = 1e-4
    max_outer_iters: int = 500
    local_iters_fraction: float = 1.0  # H = fraction * n_local per outer iter


def config() -> CocoaMnistConfig:
    return CocoaMnistConfig()


def smoke_config() -> CocoaMnistConfig:
    return CocoaMnistConfig(
        n_examples=2_048,
        n_features=64,
        effective_rank=16,
        parallelism_sweep=(1, 2, 4, 8),
        max_outer_iters=60,
    )
