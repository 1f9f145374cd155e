"""Hemingway's contribution: system model + convergence model + planner."""
from repro_torch.core.adaptive import AdaptiveController, ResizeDecision
from repro_torch.core.convergence import ConvergenceData, ConvergenceModel
from repro_torch.core.ernest import ErnestModel
from repro_torch.core.expdesign import Candidate, default_candidate_grid, greedy_d_optimal
from repro_torch.core.features import FeatureLibrary
from repro_torch.core.hemingway import (
    CombinedModel,
    NoFeasiblePlan,
    PlanDecision,
    Planner,
)
from repro_torch.core.lasso import LassoFit, lasso_cv, lasso_fit, r2_score
from repro_torch.core.nnls import nnls, nnls_fit

__all__ = [
    "AdaptiveController",
    "Candidate",
    "CombinedModel",
    "ConvergenceData",
    "ConvergenceModel",
    "ErnestModel",
    "FeatureLibrary",
    "LassoFit",
    "NoFeasiblePlan",
    "PlanDecision",
    "Planner",
    "ResizeDecision",
    "default_candidate_grid",
    "greedy_d_optimal",
    "lasso_cv",
    "lasso_fit",
    "nnls",
    "nnls_fit",
    "r2_score",
]
