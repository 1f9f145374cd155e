"""Training driver of the port (``repro/launch/train.py``): a config-driven
LM, the optimizer, the synthetic data pipeline, the train step, async
checkpoints, failure injection with restart, and straggler monitoring.

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
      --steps 8 --seq-len 128 --global-batch 8
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b --smoke \\
      --steps 8 --seq-len 32 --global-batch 2 --device cpu --ckpt-dir /tmp/ckpt

Without ``--device cpu`` it runs on the card or raises.  Differences from
the reference: ``--smoke`` is off by default, as in the port's serve CLI (the
default is the full config: never run it on a CPU); the weights are drawn
by ``LM.init_params`` from a generator on the device, in the config's dtype,
and the float32 master parameters start from those values (the reference
draws float32 masters with ``jax.random``); the LM's forward runs with the
reference's ``Runtime(remat="none" if smoke else "full", block_q=64,
block_k=64)``.  Not yet (ROADMAP.md): ``--compression`` and ``--chaos``
(the LM chaos executor, ``TrainerExecutor``/``run_chaos_lm``), and a mesh.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ArchConfig, get_config, get_smoke_config
from repro_torch.convert import tree_from_lm
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.models.model import LM
from repro_torch.models.runtime import Runtime
from repro_torch.runtime.failures import FailureInjector, RestartPolicy, SimulatedFailure
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.training.optimizers import get_optimizer
from repro_torch.training.trainer import TrainConfig, make_train_step
from repro_torch.training.tree import tree_map

NOT_PORTED = "not ported yet: see ROADMAP.md (queue 1 item 8, the LM chaos executor)"


@dataclasses.dataclass
class TrainerOptions:
    arch: str = "stablelm-1.6b"
    smoke: bool = True
    steps: int = 100
    seq_len: int = 128
    global_batch: int = 8
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    seed: int = 0
    optimizer: str = "adamw"
    learning_rate: float = 1e-3
    local_steps: int = 1  # H>1 => local-SGD outer sync
    compression: Optional[str] = None  # waits for the LM chaos executor
    mesh: Optional[Any] = None  # waits for the sharded trainer
    rules: Optional[Any] = None
    failure_injector: Optional[FailureInjector] = None
    log_every: int = 10
    # the port's additions: the device (the card when None) and a caller's
    # config in place of arch/smoke (a cut depth, another dtype)
    device: DeviceLike = None
    cfg: Optional[ArchConfig] = None


class Trainer:
    """Restartable trainer; ``run()`` survives ``SimulatedFailure`` via
    restore.  State: ``params`` (float32 master tree, the reference's
    layout), ``opt_state``, ``step``, and the data pipeline's position."""

    def __init__(self, opts: TrainerOptions):
        if opts.compression:
            raise NotImplementedError(f"--compression: {NOT_PORTED}")
        if opts.mesh is not None or opts.rules is not None:
            raise NotImplementedError("a mesh: the port trains on one card (ROADMAP.md, "
                                      "queue 1 item 7)")
        self.opts = opts
        cfg = opts.cfg or (get_smoke_config(opts.arch) if opts.smoke else get_config(opts.arch))
        self.cfg = cfg
        self.device = resolve_device(opts.device)
        self.rt = Runtime(remat="none" if opts.smoke else "full", block_q=64, block_k=64)
        self.lm = LM(cfg, self.device)
        self.opt = get_optimizer(opts.optimizer)
        self.tcfg = TrainConfig(learning_rate=opts.learning_rate, warmup_steps=20,
                                total_steps=opts.steps, local_steps=opts.local_steps)
        self.data = SyntheticTokens(cfg.vocab_size, opts.seq_len, opts.global_batch,
                                    seed=opts.seed, n_frontend=cfg.n_frontend_tokens,
                                    d_model=cfg.d_model)
        self.ckpt = CheckpointManager(opts.ckpt_dir) if opts.ckpt_dir else None
        self.monitor = StragglerMonitor()
        self.history: list = []  # (step, loss)
        self.records: List[Dict[str, float]] = []  # every step's metrics and step_time
        self._build_state()
        self._step_fn = self._make_step()

    # ------------------------------------------------------------------
    def _build_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.opts.seed)
        self.lm.init_params(gen).trainable()
        self.params = tree_from_lm(self.lm)
        self.opt_state = self.opt.init(self.params)
        self.step = 0

    def _make_step(self):
        return make_train_step(self.lm, self.opt, self.tcfg, rt=self.rt)

    def set_state(self, params, opt_state, step: int = 0) -> None:
        """Take another run's state (trees in the reference's layout, of
        tensors on any device), as a restore does."""
        self.params = tree_map(lambda t: t.to(self.device).clone(), params)
        self.opt_state = tree_map(lambda t: t.to(self.device).clone(), opt_state)
        self.step = int(step)

    # ------------------------------------------------------------------
    def restore(self, step: Optional[int] = None) -> bool:
        """Restore ``step`` (the newest complete one when None) from the
        checkpoint directory; False when there is none."""
        if self.ckpt is None:
            return False
        if step is None:
            step = self.ckpt.latest_step()
            if step is None:
                return False
        tree, meta = self.ckpt.restore(step)
        self.set_state(tree["params"], tree["opt_state"], int(meta["step"]))
        self.data.load_state_dict(meta["data_state"])
        return True

    def _save(self, block: bool = False):
        if self.ckpt is None:
            return
        handle = self.ckpt.save_async(
            self.step, {"params": self.params, "opt_state": self.opt_state},
            metadata={"data_state": self.data.state_dict(), "arch": self.cfg.name})
        if block:
            handle.wait()

    # ------------------------------------------------------------------
    def train_some(self, n_steps: int) -> Dict[str, float]:
        last: Dict[str, float] = {}
        for _ in range(n_steps):
            if self.opts.failure_injector is not None:
                self.opts.failure_injector.check(self.step)
            batch = self.data.next_batch()
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, batch, self.step)
            synchronize(self.device)
            dt = time.perf_counter() - t0
            self.monitor.observe(self.step, dt)
            last = {k: float(v) for k, v in metrics.items()}
            last["step_time"] = dt
            self.history.append((self.step, last["loss"]))
            self.records.append(dict(last, step=self.step))
            if self.opts.log_every and self.step % self.opts.log_every == 0:
                print(f"step {self.step:5d} loss={last['loss']:.4f} ({dt * 1e3:.0f} ms)",
                      flush=True)
            self.step += 1
            if self.ckpt and self.step % self.opts.ckpt_every == 0:
                self._save()
        return last

    def run(self) -> Dict[str, float]:
        """Train to opts.steps with automatic failure recovery."""
        policy = RestartPolicy()
        self.restore()
        last: Dict[str, float] = {}
        while self.step < self.opts.steps:
            try:
                last = self.train_some(self.opts.steps - self.step)
            except SimulatedFailure as e:
                if not policy.should_restart():
                    raise
                print(f"[failure] {e}; restoring from checkpoint", flush=True)
                if self.ckpt:
                    self.ckpt.wait()
                if not self.restore():
                    self._build_state()
                self._step_fn = self._make_step()
        if self.ckpt:
            self._save(block=True)
            self.ckpt.wait()
        return last


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (default: the full architecture)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "adafactor"])
    ap.add_argument("--compression", default=None)
    ap.add_argument("--chaos", default=None, metavar="TRACE.json")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the kernels' "
                         "plain versions)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    args = parse_args(argv)
    if args.chaos is not None:
        raise NotImplementedError(f"--chaos: {NOT_PORTED}")
    if args.compression is not None:
        raise NotImplementedError(f"--compression: {NOT_PORTED}")
    opts = TrainerOptions(arch=args.arch, smoke=args.smoke, steps=args.steps,
                          seq_len=args.seq_len, global_batch=args.global_batch,
                          ckpt_dir=args.ckpt_dir, optimizer=args.optimizer, device=args.device)
    trainer = Trainer(opts)
    last = trainer.run()
    times = [r["step_time"] for r in trainer.records[1:]]
    if times:
        tokens = args.seq_len * args.global_batch
        med = statistics.median(times)
        print(f"median step {med * 1e3:.1f} ms after the first ({tokens / med:.0f} tokens/s) "
              f"on {trainer.device}")
    print("final:", last)
    return last


if __name__ == "__main__":
    main()
