"""Quickstart: the Hemingway loop on the port.

Simulate CoCoA at several cluster sizes (each round one launch of the SDCA
kernel), fit the system model f(m) and the convergence model g(i, m),
combine them into h(t, m) = g(t / f(m), m), and ask the planner the paper's
two questions.  The counterpart of examples/quickstart.py; by default it
runs the paper's workload (configs/cocoa_mnist.py: 60000 x 784, m = 1..128)
on the CUDA device.

  python -m repro_torch.quickstart [--device cuda|cpu] [--n N] [--d D]
                                   [--ms 1 2 4 ...] [--iters I] [--ref-iters R]
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.configs import cocoa_mnist
from repro_torch.core import (CombinedModel, ConvergenceData, ConvergenceModel,
                              ErnestModel, Planner)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim import BSPCluster, make_mnist_svm
from repro_torch.optim.simcluster import solve_reference

SIM_ITERS = 40    # CoCoA rounds per cluster size
REF_ITERS = 150   # single-machine rounds for P*
EPS = 1e-3        # query 1: fastest (algorithm, m) to this suboptimality
BUDGET_S = 5.0    # query 2: best objective within this many seconds


def run(n: Optional[int] = None, d: Optional[int] = None,
        ms: Optional[Sequence[int]] = None, iters: int = SIM_ITERS,
        ref_iters: int = REF_ITERS, device: DeviceLike = None,
        log: Callable[[str], None] = print) -> dict:
    """Runs the loop and returns what it printed as numbers.  Raises if a
    planner answer is infeasible."""
    t_start = time.perf_counter()
    device = resolve_device(device)
    cfg = cocoa_mnist.config()
    cfg = dataclasses.replace(cfg, n_examples=n or cfg.n_examples,
                              n_features=d or cfg.n_features)
    ms = list(ms or cfg.parallelism_sweep)

    # 1. the (synthetic-)MNIST linear SVM, the paper's workload
    problem = make_mnist_svm(cfg, device=device)
    p_star, _ = solve_reference(problem, iters=ref_iters)
    log(f"problem: n={problem.n} d={problem.d} lam={problem.lam} on {device}")
    log(f"P* = {p_star:.6f}")

    # 2. profile the cluster sizes (real convergence, modeled wall-clock)
    cluster = BSPCluster()
    sims = {m: cluster.simulate(problem, "cocoa", m, iters) for m in ms}
    round_s = {m: sims[m].record.compute_seconds / iters for m in ms}
    for m in ms:
        log(f"m={m:3d}: measured round={round_s[m] * 1e3:8.3f} ms, "
            f"t_iter={sims[m].t_iter * 1e3:8.2f} ms, "
            f"final gap={sims[m].record.primal.min() - p_star:.2e}")

    # 3. fit f(m) (Ernest/NNLS) and g(i, m) (LassoCV over phi_j(i, m))
    sys_model = ErnestModel().fit(
        np.asarray(ms, float), np.full(len(ms), problem.n, float),
        np.asarray([sims[m].t_iter for m in ms]))
    curves = {m: np.minimum.accumulate(s.record.primal) for m, s in sims.items()}
    conv_model = ConvergenceModel().fit(
        ConvergenceData.from_curves(curves, p_star - 1e-6, stop_gap=1e-5))
    r2 = conv_model.r2(ConvergenceData.from_curves(curves, p_star - 1e-6))
    log(f"f(m) coefficients: {sys_model.coefficients()}")
    log(f"g(i,m) R^2 = {r2:.4f}")

    # 4. plan: h(t, m) = g(t / f(m), m)
    combined = CombinedModel(sys_model, conv_model, data_size=problem.n,
                             max_iters=10_000)
    planner = Planner({"cocoa": combined})
    d1 = planner.fastest_to_epsilon(EPS, m_grid=ms)
    if not d1:
        raise RuntimeError(f"query 1 infeasible: {d1.reason}")
    log(f"[query 1] eps={EPS:g}  -> use {d1.algorithm} on m={d1.m} "
        f"(predicted {d1.predicted_time:.2f}s)")
    d2 = planner.best_within_budget(BUDGET_S, m_grid=ms)
    if not d2:
        raise RuntimeError(f"query 2 infeasible: {d2.reason}")
    log(f"[query 2] t<={BUDGET_S:g}s     -> use {d2.algorithm} on m={d2.m} "
        f"(predicted objective {d2.predicted_value:.5f})")
    seconds = time.perf_counter() - t_start
    log(f"start to planner answer: {seconds:.1f} s")
    return {
        "p_star": p_star,
        "round_s": round_s,
        "t_iter": {m: sims[m].t_iter for m in ms},
        "final_gap": {m: float(sims[m].record.primal.min() - p_star) for m in ms},
        "f_m": sys_model.coefficients(),
        "r2": float(r2),
        "fastest_to_epsilon": (d1.algorithm, d1.m, d1.predicted_time),
        "best_within_budget": (d2.algorithm, d2.m, d2.predicted_value),
        "seconds": seconds,
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=None, help="examples (default 60000)")
    ap.add_argument("--d", type=int, default=None, help="features (default 784)")
    ap.add_argument("--ms", type=int, nargs="+", default=None,
                    help="cluster sizes (default 1 2 4 ... 128)")
    ap.add_argument("--iters", type=int, default=SIM_ITERS,
                    help="CoCoA rounds per cluster size")
    ap.add_argument("--ref-iters", type=int, default=REF_ITERS,
                    help="single-machine rounds for P*")
    args = ap.parse_args(argv)
    return run(args.n, args.d, args.ms, args.iters, args.ref_iters, args.device)


if __name__ == "__main__":
    main()
