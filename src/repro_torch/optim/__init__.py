"""Distributed optimization algorithms modeled by Hemingway (CoCoA/CoCoA+)."""

from repro_torch.optim.cocoa import CocoaConfig, RunRecord, run_cocoa
from repro_torch.optim.problems import ERMProblem, make_mnist_svm, synthetic_mnist
from repro_torch.optim.simcluster import (
    ALGORITHMS,
    BSPCluster,
    CommModel,
    SimResult,
    run_algorithm,
    solve_reference,
)

__all__ = [
    "ALGORITHMS",
    "BSPCluster",
    "CocoaConfig",
    "CommModel",
    "ERMProblem",
    "RunRecord",
    "SimResult",
    "make_mnist_svm",
    "run_algorithm",
    "run_cocoa",
    "solve_reference",
    "synthetic_mnist",
]
