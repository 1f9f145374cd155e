"""Distributed optimization algorithms modeled by Hemingway."""

from repro_torch.optim.cocoa import CocoaConfig, RunRecord, run_cocoa
from repro_torch.optim.lbfgs import LBFGSConfig, run_lbfgs
from repro_torch.optim.problems import ERMProblem, make_mnist_svm, synthetic_mnist
from repro_torch.optim.sgd import (
    GDConfig,
    LocalSGDConfig,
    SGDConfig,
    run_gd,
    run_local_sgd,
    run_minibatch_sgd,
)
from repro_torch.optim.simcluster import (
    ALGORITHMS,
    BSPCluster,
    CommModel,
    SimResult,
    SSPLocalSGD,
    run_algorithm,
    solve_reference,
)

__all__ = [
    "ALGORITHMS",
    "BSPCluster",
    "CocoaConfig",
    "CommModel",
    "ERMProblem",
    "GDConfig",
    "LBFGSConfig",
    "LocalSGDConfig",
    "RunRecord",
    "SGDConfig",
    "SSPLocalSGD",
    "SimResult",
    "make_mnist_svm",
    "run_algorithm",
    "run_cocoa",
    "run_gd",
    "run_lbfgs",
    "run_local_sgd",
    "run_minibatch_sgd",
    "solve_reference",
    "synthetic_mnist",
]
