"""BSP cluster simulator: real convergence curves, modeled wall-clock.

The m "machines" are the m workers of one kernel launch per round (the SDCA
kernel's for CoCoA/CoCoA+, the local-SGD kernel's for local SGD) or the
batch dimension of one PyTorch product (mini-batch SGD), so the
*algorithmic* trajectory (objective per outer iteration as a function of
m) is exactly what a real m-machine BSP cluster would produce.
Wall-clock is composed per DESIGN.md §3:

  t_iter(m) = measured_total_compute / m        (perfect compute scaling)
            + comm(m)                            (tree bcast/reduce model)
            + per_task * m + overhead            (driver/scheduler costs)

which is exactly the family Ernest's f(m) = th0 + th1*size/m + th2*log(m)
+ th3*m was designed for.  On a real cluster, replace `iteration_time` with
measured times; nothing downstream changes.

The menu is the JAX package's six algorithms (``ALGORITHMS``).
``SSPLocalSGD`` is the stepwise executor the chaos loop drives
(repro_torch.runtime.chaos).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.ernest import ErnestModel
from repro_torch.kernels.local_sgd.ops import local_sgd
from repro_torch.optim.cocoa import CocoaConfig, RunRecord, partition, run_cocoa
from repro_torch.optim.lbfgs import LBFGSConfig, run_lbfgs
from repro_torch.optim.problems import ERMProblem
from repro_torch.optim.sgd import (
    GDConfig,
    LocalSGDConfig,
    SGDConfig,
    run_gd,
    run_local_sgd,
    run_minibatch_sgd,
)

ALGORITHMS = ("cocoa", "cocoa+", "minibatch_sgd", "local_sgd", "gd", "lbfgs")

# (outer step t, m, h, nl) -> the (m, h) rows the workers visit in step t
SSPIndexSource = Callable[[int, int, int, int], "torch.Tensor | np.ndarray"]


def step_seed(seed: int, t: int) -> int:
    """The seed of outer step t's draws: a function of (seed, t) alone, as
    the reference's ``fold_in(PRNGKey(seed), t)``, so a replay draws the
    same rows whatever ran before."""
    return int(np.random.SeedSequence((seed, t)).generate_state(1, np.uint64)[0])


# ---------------------------------------------------------------------------
# SSP / staleness-aware local-SGD: the stepwise executor the chaos loop
# drives (repro_torch.runtime.chaos).  Unlike the run_* trajectory functions
# it advances ONE outer iteration at a time, so the control loop can change
# m (elastic resize), H (sync_relax mitigation), and the per-worker sync
# mask (SSP: a straggler skips the barrier, bounded-staleness) mid-run —
# each with a real algorithmic effect on the objective trajectory.
# ---------------------------------------------------------------------------
class SSPLocalSGD:
    """Stepwise staleness-aware local-SGD over m BSP workers, one launch of
    the local-SGD kernel an outer step.

    Implements the chaos-loop executor contract: ``outer_step`` advances one
    outer iteration (returns the primal objective at the synced iterate),
    ``resize`` re-shards the data to a new m from the current iterate (what
    the elastic path does from a checkpoint), ``relax`` switches to H>1
    local steps (sync_relax mitigation), and ``checkpoint``/``restore``
    snapshot/rewind the global iterate — a restore genuinely loses the work
    since the last checkpoint, exactly like a real restart.

    Determinism: step t's rows come from a generator seeded with
    ``step_seed(seed, t)`` (or from ``indices``), so a replayed run (same
    seed, same control actions) is bit-identical.
    """

    def __init__(self, problem: ERMProblem, m: int, *, local_steps: int = 1,
                 lr0: float = 1.0, t0: float = 100.0, seed: int = 0,
                 indices: Optional[SSPIndexSource] = None):
        self.problem = problem
        self.local_steps = int(local_steps)
        self.lr0 = float(lr0)
        self.t0 = float(t0)
        self.seed = int(seed)
        self.indices = indices or self._draw
        self.w = torch.zeros((problem.d,), dtype=torch.float32, device=problem.device)
        self.t = 0                      # outer-iteration counter (lr + draws)
        self._ckpt = None
        self.m = 0
        self.resize(m)

    def _draw(self, t: int, m: int, h: int, nl: int) -> torch.Tensor:
        device = self.problem.device
        generator = torch.Generator(device=device).manual_seed(step_seed(self.seed, t))
        return torch.randint(0, nl, (m, h), generator=generator, device=device)

    def _broadcast(self) -> torch.Tensor:
        return self.w.expand(self.m, -1).contiguous()

    # -- executor contract ---------------------------------------------
    def resize(self, m: int) -> None:
        """Re-partition the data over m workers, seeding every worker from
        the current global iterate (the elastic re-shard, simulated)."""
        self.m = int(m)
        self.Xs, self.ys = partition(self.problem.X, self.problem.y, self.m)
        self.W = self._broadcast()

    def relax(self, local_steps: int) -> None:
        self.local_steps = max(int(local_steps), 1)

    def checkpoint(self) -> None:
        self._ckpt = (self.w.cpu(), self.t, self.local_steps)

    def restore(self) -> None:
        if self._ckpt is None:
            raise RuntimeError("no checkpoint to restore")
        w, t, h = self._ckpt
        self.w = w.to(self.problem.device)
        self.t = t
        self.local_steps = h
        self.W = self._broadcast()

    def outer_step(self, sync_mask: Optional[Sequence[bool]] = None) -> float:
        """One SSP round: every worker runs h local SGD steps from its own
        (possibly stale) copy; workers with mask 1 push/pull at the
        barrier."""
        if sync_mask is None:
            mask = np.ones(self.m, np.float32)
        else:
            mask = np.asarray([1.0 if s else 0.0 for s in sync_mask],
                              np.float32)
            if mask.shape[0] < self.m:       # capacity shrank under us
                mask = np.concatenate(
                    [mask, np.ones(self.m - mask.shape[0], np.float32)])
            mask = mask[:self.m]
        if not mask.any():
            mask[0] = 1.0                    # someone must hold the iterate
        p = self.problem
        device = p.device
        idx = torch.as_tensor(self.indices(self.t, self.m, self.local_steps, self.Xs.shape[1]),
                              device=device)
        W2 = local_sgd(self.W, self.Xs, self.ys, idx, float(self.t), self.local_steps,
                       self.lr0, self.t0, p.lam, p.loss, p.smooth_gamma)  # (m, d) local results
        sync = torch.as_tensor(mask, device=device)[:, None]
        n_sync = float(max(mask.sum(), np.float32(1.0)))
        w_new = torch.sum(W2 * sync, 0) / n_sync
        # syncing workers pull the fresh average; stale workers keep diverging
        self.W = torch.where(sync > 0, w_new[None, :], W2)
        self.w = w_new
        self.t += 1
        return float(p.primal(self.w))

    # ------------------------------------------------------------------
    def reference_floor(self, iters: int = 300) -> float:
        """Deterministic lower-bound estimate of P* for gap computation:
        full-gradient descent run long, minus a small margin."""
        rec = run_gd(self.problem, GDConfig(outer_iters=iters),
                     record_every=50)
        return float(rec.primal.min()) - 1e-3


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
                  local_iters: Optional[int] = None,
                  batch_per_worker: int = 64) -> RunRecord:
    if algorithm == "cocoa":
        return run_cocoa(problem, CocoaConfig(m, outer_iters, local_iters,
                                              plus=False, seed=seed))
    if algorithm == "cocoa+":
        return run_cocoa(problem, CocoaConfig(m, outer_iters, local_iters,
                                              plus=True, seed=seed))
    if algorithm == "minibatch_sgd":
        return run_minibatch_sgd(problem, SGDConfig(
            m, outer_iters, batch_per_worker=batch_per_worker, seed=seed))
    if algorithm == "local_sgd":
        return run_local_sgd(problem, LocalSGDConfig(
            m, outer_iters, local_steps=local_iters, seed=seed))
    if algorithm == "gd":
        return run_gd(problem, GDConfig(outer_iters))
    if algorithm == "lbfgs":
        return run_lbfgs(problem, LBFGSConfig(outer_iters))
    raise ValueError(f"unknown algorithm {algorithm!r}; known {ALGORITHMS}")


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
