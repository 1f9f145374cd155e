"""Elastic training with the adaptive parallelism controller (§6).

The counterpart of examples/elastic_train.py.  Trains with failure
injection AND an ``AdaptiveController`` that refits the convergence model
online from the trainer's losses, one observation a chunk of steps; when
the controller recommends a resize, the driver checkpoints, changes the
data-parallel degree (the global batch, 2 m, on one device) and resumes.
Runs on the CUDA device unless ``--device`` names another.

The reference's sequence is kept as it is, quirks included:

* each chunk replaces ``trainer.tcfg`` (total_steps = the step budget), but
  a built step keeps the config it was built with: the new total takes
  effect where the step is rebuilt, after a failure and in a trainer built
  at a resize;
* each chunk sets ``trainer.opts`` from the FIRST trainer's options (their
  global batch and failure injector), also after a resize; the data
  pipeline keeps the batch it was built with;
* each ``Trainer.run()`` first restores the newest checkpoint and ends with
  a blocking save.

At the example's constants (120 steps in chunks of 20, ``min_observations``
20) the controller sees 6 observations and never decides, so the run prints
``resize decisions: 0``; a schedule of more, shorter chunks and a smaller
``min_observations`` and ``refit_every`` (``run``'s arguments) reaches it.
``--no-smoke`` trains the full config (remat "full") in place of the smoke
one.

  PYTHONPATH=src python -m repro_torch.elastic_train --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs import ArchConfig
from repro_torch.core import AdaptiveController, ErnestModel
from repro_torch.device import DeviceLike
from repro_torch.launch.train import Trainer, TrainerOptions
from repro_torch.runtime.failures import FailureInjector

ARCH = "stablelm-1.6b"
# measured-ish step times (s) at m = 1, 2, 4, 8: the Ernest fit's points
SYSTEM_POINTS: Tuple[Tuple[int, float], ...] = ((1, 0.40), (2, 0.22), (4, 0.13), (8, 0.09))


def run(*, system_points: Sequence[Tuple[int, float]] = SYSTEM_POINTS,
        target_gap: float = 0.05, m_options: Sequence[int] = (1, 2, 4),
        refit_every: int = 15, min_observations: int = 20, reshard_cost_s: float = 1.0,
        step_budget: int = 120, chunk: int = 20, fail_at: int = 17, ckpt_every: int = 10,
        smoke: bool = True, cfg: Optional[ArchConfig] = None, device: DeviceLike = None,
        state=None, ckpt_dir: Optional[str] = None) -> dict:
    """The example's loop.  ``cfg`` is the config to train (the arch's
    smoke or full config, as ``smoke`` says, when None; ``smoke`` also sets
    remat); ``state``, (params, opt_state) in the reference's layout,
    replaces the first trainer's drawn state; checkpoints go to ``ckpt_dir``
    (a temporary directory when None).

    Returns ``history`` (every step's (step, loss) in the order run, across
    the trainers), ``records`` (the steps' metrics), ``decisions`` (each
    of the controller's, with the step and m it was made at),
    ``resizes`` ((step, m, m')), ``failures`` (the steps that failed),
    ``timings`` (every trainer's checkpoint saves and restores, in order),
    ``final_step``, ``final_loss``, ``m`` and the ``trainer`` the run ended
    with."""
    ms = np.asarray([m for m, _ in system_points])
    sys_model = ErnestModel().fit(ms, np.full(len(ms), 1.0),
                                  np.asarray([t for _, t in system_points]))
    ctrl = AdaptiveController(
        sys_model, target_gap=target_gap, p_star=0.0, m_options=list(m_options),
        refit_every=refit_every, min_observations=min_observations,
        reshard_cost_s=reshard_cost_s)
    out: Dict[str, List] = {"history": [], "records": [], "decisions": [], "resizes": [],
                            "timings": []}
    injector = FailureInjector.at(fail_at)

    def retire(trainer: Trainer) -> None:
        out["timings"] += trainer.ckpt.timings

    with (contextlib.nullcontext(ckpt_dir) if ckpt_dir else tempfile.TemporaryDirectory()) as td:
        m = 1
        opts = TrainerOptions(arch=ARCH, smoke=smoke, cfg=cfg, steps=40, seq_len=64,
                              global_batch=2 * m, log_every=0, ckpt_dir=td,
                              ckpt_every=ckpt_every, failure_injector=injector,
                              device=device)
        trainer = Trainer(opts)
        if state is not None:
            trainer.set_state(*state)
        while trainer.step < step_budget:
            n = min(chunk, step_budget - trainer.step)
            trainer.opts = dataclasses.replace(opts, steps=trainer.step + n)
            trainer.tcfg = dataclasses.replace(trainer.tcfg, total_steps=step_budget)
            seen = len(trainer.history)
            trainer.run()
            out["history"] += trainer.history[seen:]
            out["records"] += trainer.records[seen:]
            loss = trainer.history[-1][1]
            decision = ctrl.observe(trainer.step, m, loss)
            if decision is not None:
                out["decisions"].append(dict(dataclasses.asdict(decision),
                                             step=trainer.step, m=m))
            if decision and decision.resize:
                print(f"[elastic] step {trainer.step}: resize m={m} -> "
                      f"m={decision.target_m} ({decision.reason})")
                out["resizes"].append((trainer.step, m, decision.target_m))
                m = decision.target_m
                # checkpoint, rebuild at the new parallelism, restore
                trainer._save(block=True)
                retire(trainer)
                trainer = None  # freed before the new one is built
                gc.collect()
                trainer = Trainer(TrainerOptions(
                    arch=ARCH, smoke=smoke, cfg=cfg, steps=step_budget, seq_len=64,
                    global_batch=2 * m, log_every=0, ckpt_dir=td, ckpt_every=ckpt_every,
                    device=device))
                trainer.restore()
        retire(trainer)
        out.update(failures=sorted(injector.fired), final_step=trainer.step,
                   final_loss=trainer.history[-1][1], m=m, trainer=trainer)
        print(f"done at step {trainer.step}, final loss {trainer.history[-1][1]:.3f}, "
              f"resize decisions: {sum(1 for d in ctrl.decisions if d.resize)}")
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """The CLI, at the example's constants; returns ``run``'s result."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=True,
                    help="the smoke config (default) or the full one")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(smoke=args.smoke, device=args.device)


if __name__ == "__main__":
    main()
