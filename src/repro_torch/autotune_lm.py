"""Hemingway for LM training (§6 "non-convex" extension, built).

The counterpart of examples/autotune_lm.py.  Collects REAL loss curves from
stablelm-1.6b trained at several data-parallel degrees m (same
tokens-per-shard, so m scales the global batch on one device: the modern
"degree of parallelism", not a data mesh), fits g(i, m) on log(loss -
floor), fits f(m) from the measured step time plus the BSP comm model, and
picks the m that reaches a target loss fastest, m = 8 included, which is
never run.  Runs on the CUDA device unless ``--device`` names another.

``--smoke`` (the default, the reference's only mode) trains the smoke
config and charges the reference's gradient bytes, 4 x 120e6;
``--no-smoke`` trains the full config (24 layers, d_model 2048, remat
"full") and charges 4 bytes a parameter of it.  ``--steps`` shortens the
curves (the reference's 60) for a quick run.

  PYTHONPATH=src python -m repro_torch.autotune_lm --device cpu
  PYTHONPATH=src python -m repro_torch.autotune_lm --no-smoke
"""
from __future__ import annotations

import argparse
import gc
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs import ArchConfig
from repro_torch.core import (CombinedModel, ConvergenceData, ConvergenceModel,
                              ErnestModel, Planner)
from repro_torch.device import DeviceLike, synchronize
from repro_torch.launch.train import Trainer, TrainerOptions
from repro_torch.optim.simcluster import CommModel

ARCH = "stablelm-1.6b"
MS = (1, 2, 4)            # the degrees trained
M_GRID = (1, 2, 4, 8)     # the degrees the planner weighs
STEPS = 60
SMOKE_GRAD_BYTES = 4.0 * 120e6  # the reference's "smoke model grads"


def loss_curve(m: int, steps: int = STEPS, *, smoke: bool = True,
               cfg: Optional[ArchConfig] = None, device: DeviceLike = None,
               state=None) -> Tuple[np.ndarray, float]:
    """Every step's loss of a trainer at global batch 2 m (seq 64, seed 1),
    and the trainer's build seconds (its draws waited for).  ``cfg``
    replaces the arch's config (a float32 copy in the tests); ``state``,
    (params, opt_state) in the reference's layout, replaces the drawn one.
    The trainer is freed before this returns."""
    t0 = time.perf_counter()
    trainer = Trainer(TrainerOptions(arch=ARCH, smoke=smoke, cfg=cfg, steps=steps, seq_len=64,
                                     global_batch=2 * m, log_every=0, seed=1, device=device))
    if state is not None:
        trainer.set_state(*state)
    synchronize(trainer.device)  # the draws are queued on the card
    build_s = time.perf_counter() - t0
    trainer.run()
    curve = np.asarray([loss for _, loss in trainer.history])
    del trainer
    gc.collect()
    return curve, build_s


def plan(curves: Dict[int, np.ndarray], compute_s: Dict[int, float], ms: Sequence[int],
         grad_bytes: float, m_grid: Sequence[int] = M_GRID) -> dict:
    """The example's models and query on running-minimum ``curves``:
    g(i, m) on log(loss - floor), f(m) from ``compute_s`` plus the BSP comm
    model of a ``grad_bytes`` gradient sync, the target the curves' median
    last loss + 0.1.  Raises when the planner finds no feasible m."""
    floor = min(c.min() for c in curves.values()) - 0.05
    data = ConvergenceData.from_curves(curves, floor)
    conv = ConvergenceModel().fit(data)
    comm = CommModel()
    times = [compute_s[m] + comm.iteration_comm(m, grad_bytes) for m in ms]
    sysm = ErnestModel().fit(np.asarray(ms, float), np.full(len(ms), 1.0), np.asarray(times))
    target = float(np.median([c[-1] for c in curves.values()])) + 0.1
    combined = CombinedModel(sysm, conv, 1.0, 5_000)
    planner = Planner({"adamw-dp": combined})
    decision = planner.fastest_to_epsilon(target - floor, m_grid=list(m_grid))
    if not decision:
        raise RuntimeError(f"unexpectedly infeasible: {decision.reason}")
    return {"decision": decision, "r2": conv.r2(data),
            "active": sorted(conv.active_features()), "target": target, "floor": floor,
            "step_s": dict(zip(ms, times)), "f_coefficients": sysm.coefficients(),
            "f_s": {m: float(sysm.predict(m, 1.0)) for m in m_grid},
            "iters": {m: combined.iters_to_epsilon(target - floor, m) for m in m_grid},
            "predicted_s": {m: t for (_, m), t in decision.table.items()}}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """The CLI; returns the curves, the measured step times and ``plan``'s
    result."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=True,
                    help="the smoke config (default) or the full one")
    ap.add_argument("--steps", type=int, default=STEPS,
                    help=f"steps a curve (the reference's {STEPS}; fewer for a short run)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    ms = list(MS)
    print("training tiny LM at data-parallel degrees", ms)
    curves, compute_s, build_s = {}, {}, {}
    for m in ms:
        t0 = time.perf_counter()
        curve, build_s[m] = loss_curve(m, args.steps, smoke=args.smoke, device=args.device)
        curves[m] = np.minimum.accumulate(curve)
        compute_s[m] = (time.perf_counter() - t0) / len(curves[m])
        print(f"  m={m}: final loss {curves[m][-1]:.3f} "
              f"({compute_s[m]*1e3:.0f} ms/step measured)")
        print(f"  m={m}: trainer built in {build_s[m]:.2f} s of the "
              f"{compute_s[m] * len(curves[m]):.2f} s measured")
    if args.smoke:
        grad_bytes, source = SMOKE_GRAD_BYTES, "the reference's smoke figure, 4 x 120e6"
    else:
        from repro_torch.configs import get_config

        grad_bytes, source = 4.0 * get_config(ARCH).param_count(), f"4 x {ARCH}'s parameters"
    print(f"gradient bytes a sync: {grad_bytes:.4g} ({source})")
    result = plan(curves, compute_s, ms, grad_bytes)
    print(f"g(i,m) R^2 = {result['r2']:.4f}; active: {result['active']}")
    print(f"f(m) coefficients: {result['f_coefficients']}")
    d = result["decision"]
    for m in M_GRID:
        t = result["predicted_s"].get(m)
        print(f"  m={m}: f(m) {result['f_s'][m] * 1e3:.1f} ms/step, g reaches the target at "
              f"step {result['iters'][m]}, predicted {'never' if t is None else f'{t:.1f}s'}"
              f"{'' if m in ms else ' (never run)'}")
    print(f"target loss {result['target']:.3f}: planner picks m={d.m} "
          f"(predicted {d.predicted_time:.1f}s) — note m=8 was never run; "
          "the model extrapolated it (paper §4.1).")
    return dict(result, curves=curves, compute_s=compute_s, build_s=build_s,
                grad_bytes=grad_bytes)


if __name__ == "__main__":
    main()
