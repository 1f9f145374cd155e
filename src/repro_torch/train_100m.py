"""End-to-end driver: train a ~100M-parameter LM for a few hundred steps.

The counterpart of examples/train_100m.py.  Defines the example's custom
config (stablelm-family; the example calls it ~107M, its ``param_count()``
is 73.7 M), trains it with checkpointing and the full trainer stack.
``--scale 0.25`` (the default) gives a 3.3 M model on the identical code
path; ``--scale 1`` is the full one.  Runs on the CUDA device unless
``--device`` names another.

The reference builds a stablelm-1.6b smoke trainer and swaps the custom
config in place (a new LM at ``remat="none"``, block 64, a new
``SyntheticTokens`` at seed 0, a fresh state and step); here the trainer is
built on the config through ``TrainerOptions(cfg=...)`` with ``smoke=True``,
which gives the same runtime, data, state and step.

  PYTHONPATH=src python -m repro_torch.train_100m --steps 200 --device cpu
  PYTHONPATH=src python -m repro_torch.train_100m --scale 1
"""
from __future__ import annotations

import argparse
import statistics
import tempfile
from typing import Optional, Sequence

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.device import DeviceLike
from repro_torch.launch.train import Trainer, TrainerOptions


def config_100m(scale: float = 1.0) -> ArchConfig:
    d = max(int(512 * scale) // 64 * 64, 128)
    return ArchConfig(
        name=f"lm-100m-s{scale}",
        family="dense",
        n_layers=12 if scale >= 1 else 6,
        d_model=d,
        n_heads=max(d // 64, 2),
        n_kv_heads=max(d // 64, 2),
        head_dim=64,
        d_ff=3 * d,
        vocab_size=32_000 if scale >= 1 else 8_000,
        period=(LayerSpec(mixer="attn", ffn="dense"),),
        source="custom ~100M example",
    )


def build_trainer(cfg: ArchConfig, steps: int = 200, seq_len: int = 256,
                  global_batch: int = 4, ckpt_dir: Optional[str] = None,
                  device: DeviceLike = None) -> Trainer:
    """The example's trainer on ``cfg``: seed 0, AdamW at lr 1e-3, remat
    "none", a checkpoint every 50 steps, a loss line every 20."""
    return Trainer(TrainerOptions(arch="stablelm-1.6b", smoke=True, cfg=cfg, steps=steps,
                                  seq_len=seq_len, global_batch=global_batch,
                                  ckpt_dir=ckpt_dir, ckpt_every=50, log_every=20,
                                  device=device))


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    """The CLI; returns the trainer after its run."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = config_100m(args.scale)
    n = cfg.param_count()
    print(f"model: {cfg.name}: {n/1e6:.1f}M params")
    with tempfile.TemporaryDirectory() as td:
        trainer = build_trainer(cfg, args.steps, args.seq_len, args.global_batch, td,
                                args.device)
        trainer.run()
    losses = [loss for _, loss in trainer.history]
    times = [r["step_time"] for r in trainer.records[1:]]
    if times:
        print(f"median step {statistics.median(times) * 1e3:.1f} ms after the first on "
              f"{trainer.device}")
    print(f"trained {trainer.step} steps: loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return trainer


if __name__ == "__main__":
    main()
