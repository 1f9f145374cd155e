"""BSP cluster simulator: real convergence curves, modeled wall-clock.

The m "machines" are the m blocks of one SDCA kernel launch per round, so
the *algorithmic* trajectory (objective per outer iteration as a function
of m) is exactly what a real m-machine BSP cluster would produce.
Wall-clock is composed per DESIGN.md §3:

  t_iter(m) = measured_total_compute / m        (perfect compute scaling)
            + comm(m)                            (tree bcast/reduce model)
            + per_task * m + overhead            (driver/scheduler costs)

which is exactly the family Ernest's f(m) = th0 + th1*size/m + th2*log(m)
+ th3*m was designed for.  On a real cluster, replace `iteration_time` with
measured times; nothing downstream changes.

This slice of the port runs CoCoA and CoCoA+; the other algorithms of the
JAX package's menu are still to be ported (ROADMAP.md, modules to port).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.ernest import ErnestModel
from repro_torch.optim.cocoa import CocoaConfig, RunRecord, run_cocoa
from repro_torch.optim.problems import ERMProblem

ALGORITHMS = ("cocoa", "cocoa+")


@dataclasses.dataclass(frozen=True)
class CommModel:
    """EC2-flavoured BSP communication costs for a d-float model vector."""

    latency_s: float = 5e-4
    bandwidth_Bps: float = 1.2e9
    per_task_s: float = 1.5e-3   # driver-side per-task handling -> theta3 * m
    overhead_s: float = 0.05     # per-iteration scheduling floor -> theta0

    def iteration_comm(self, m: int, nbytes: float) -> float:
        if m <= 1:
            return self.overhead_s
        hops = math.ceil(math.log2(m))
        tree = 2.0 * (self.latency_s * hops + nbytes / self.bandwidth_Bps)
        return self.overhead_s + tree + self.per_task_s * m


@dataclasses.dataclass
class SimResult:
    algorithm: str
    m: int
    record: RunRecord
    t_iter: float              # modeled seconds per outer iteration
    wall_times: np.ndarray     # cumulative modeled wall-clock per recorded iter

    def curve(self) -> np.ndarray:
        return self.record.primal


def run_algorithm(problem: ERMProblem, algorithm: str, m: int,
                  outer_iters: int, seed: int = 0,
                  local_iters: Optional[int] = None) -> RunRecord:
    if algorithm in ALGORITHMS:
        return run_cocoa(problem, CocoaConfig(m, outer_iters, local_iters,
                                              plus=algorithm == "cocoa+",
                                              seed=seed))
    raise ValueError(
        f"unknown algorithm {algorithm!r}; the port runs {ALGORITHMS}, and the "
        "JAX package's others are still to be ported (see ROADMAP.md)")


def _prefix(problem: ERMProblem, rows: int) -> ERMProblem:
    return ERMProblem(problem.X[:rows], problem.y[:rows], problem.lam,
                      problem.loss, problem.smooth_gamma)


class BSPCluster:
    def __init__(self, comm: Optional[CommModel] = None):
        self.comm = comm or CommModel()
        self._floor_cache: dict = {}

    def iteration_time(self, m: int, compute_total_s: float, d: int) -> float:
        nbytes = 4.0 * d  # fp32 model vector broadcast + reduce
        return compute_total_s / m + self.comm.iteration_comm(m, nbytes)

    # ------------------------------------------------------------------
    def _dispatch_floor(self, problem: ERMProblem, algorithm: str,
                        m: int) -> float:
        """Fixed per-round host and launch cost of the simulator on this
        device — NOT part of the modeled cluster; measured with a
        near-empty shard and subtracted from measured compute (Ernest's
        size-scaling assumption needs per-example work).  The warm-up round
        loads (and on first use builds) the kernel, so no build time lands
        in the three timed rounds."""
        key = (algorithm, m)
        if key not in self._floor_cache:
            tiny = _prefix(problem, max(2 * m, 16))
            run_algorithm(tiny, algorithm, m, 1)  # warm-up
            rec = run_algorithm(tiny, algorithm, m, 3)
            self._floor_cache[key] = rec.compute_seconds / 3.0
        return self._floor_cache[key]

    def _net_compute(self, rec: RunRecord, problem: ERMProblem,
                     algorithm: str, m: int, iters: int) -> float:
        per_iter = rec.compute_seconds / max(iters, 1)
        floor = self._dispatch_floor(problem, algorithm, m)
        return max(per_iter - floor, per_iter * 0.02)

    # ------------------------------------------------------------------
    def simulate(self, problem: ERMProblem, algorithm: str, m: int,
                 outer_iters: int, seed: int = 0,
                 local_iters: Optional[int] = None) -> SimResult:
        run_algorithm(problem, algorithm, m, 1, seed=seed,
                      local_iters=local_iters)  # warm-up: a cold first round
        # would fold the kernel's build and load into the "measured" compute
        rec = run_algorithm(problem, algorithm, m, outer_iters, seed=seed,
                            local_iters=local_iters)
        per_iter_compute = self._net_compute(rec, problem, algorithm, m,
                                             len(rec.primal))
        t_iter = self.iteration_time(m, per_iter_compute, problem.d)
        wall = np.arange(1, len(rec.primal) + 1) * t_iter
        return SimResult(algorithm, m, rec, t_iter, wall)

    def sweep_parallelism(self, problem: ERMProblem, algorithm: str,
                          ms: Sequence[int], outer_iters: int,
                          seed: int = 0) -> Dict[int, SimResult]:
        return {m: self.simulate(problem, algorithm, m, outer_iters, seed=seed)
                for m in ms}

    # ------------------------------------------------------------------
    # Ernest data acquisition (small m, small data fractions)
    # ------------------------------------------------------------------
    def collect_ernest_samples(
        self, problem: ERMProblem, algorithm: str,
        configs: Sequence[Tuple[int, float]],  # (m, data_fraction)
        iters_per_sample: int = 3, seed: int = 0,
    ) -> List[Tuple[int, float, float]]:
        """Returns (m, size=fraction*n, t_iter) observations."""
        samples = []
        for m, frac in configs:
            n_sub = max(int(problem.n * frac), m * 2)
            sub = _prefix(problem, n_sub)
            run_algorithm(sub, algorithm, m, 1, seed=seed)  # warm-up
            rec = run_algorithm(sub, algorithm, m, iters_per_sample, seed=seed)
            per_iter = self._net_compute(rec, problem, algorithm, m,
                                         iters_per_sample)
            samples.append((m, float(n_sub),
                            self.iteration_time(m, per_iter, problem.d)))
        return samples

    def fit_ernest(self, samples: Sequence[Tuple[int, float, float]],
                   terms=None) -> ErnestModel:
        m, size, t = zip(*samples)
        model = ErnestModel(terms or ErnestModel().term_names)
        return model.fit(np.asarray(m), np.asarray(size), np.asarray(t))


def solve_reference(problem: ERMProblem, iters: int = 400,
                    seed: int = 0) -> Tuple[float, np.ndarray]:
    """High-accuracy P* via single-machine SDCA (m=1) run long."""
    rec = run_cocoa(problem, CocoaConfig(
        n_workers=1, outer_iters=iters, plus=False, seed=seed))
    return float(rec.primal.min()), rec.w
