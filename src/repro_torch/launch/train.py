"""Training driver of the port (``repro/launch/train.py``): a config-driven
LM, the optimizer, the synthetic data pipeline, the train step on one card
or on a data mesh, async checkpoints, failure injection with restart,
straggler monitoring, gradient compression, and the Hemingway adaptive
parallelism controller over the real trainer (observe loss -> refit g(i, m)
-> elastic resize: ``TrainerExecutor``, ``run_chaos_lm``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
      --steps 8 --seq-len 128 --global-batch 8 [--compression int8|topk|powersgd]
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b --smoke \\
      --steps 8 --seq-len 32 --global-batch 2 --device cpu --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --chaos trace.json --steps 30 \\
      [--chaos-seed 0] [--chaos-out run.json] [--device cpu]

Without ``--device cpu`` it runs on the card or raises.  Differences from
the reference: ``--smoke`` is off by default, as in the port's serve CLI (the
default is the full config: never run it on a CPU; ``--chaos`` runs the
smoke config whatever ``--smoke`` says, as the reference's executor does);
the weights are drawn by ``LM.init_params`` from a generator on the device,
in the config's dtype, and the float32 master parameters start from those
values (the reference draws float32 masters with ``jax.random``); the LM's
forward runs with the reference's ``Runtime(remat="none" if smoke else
"full", block_q=64, block_k=64)``.

``Trainer`` takes a data mesh (``TrainerOptions.mesh``, ``rules``: a
``DeviceMesh`` of ("data", "model") with "model" of size 1, and
``Rules.default``): each rank holds its block of every float32 master and
optimizer-state leaf and trains on its rows of the global batch
(``repro_torch.training.trainer``); checkpoints hold whole leaves, gathered
from the ranks and written by rank 0, and restore onto a mesh of any shape
(``CheckpointManager.restore_sharded``).  The CLI has no mesh flag, as the
reference's has none.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.compression.gradient import SCHEMES, CompressionConfig, GradientCompressor
from repro_torch.configs import ArchConfig, get_config, get_smoke_config
from repro_torch.convert import tree_from_lm
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.dist.partitioning import Rules
from repro_torch.models.model import LM, check_trainable_mesh
from repro_torch.models.runtime import Runtime
from repro_torch.runtime.elastic import (
    gather_leaf,
    gather_tree,
    mesh_device,
    reshard_tree,
    shardings_for,
)
from repro_torch.runtime.failures import FailureInjector, RestartPolicy, SimulatedFailure
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.training.optimizers import clip_by_global_norm, get_optimizer
from repro_torch.training.trainer import (
    DataMesh,
    TrainConfig,
    forward_backward,
    global_metrics,
    load_blocks_into_lm,
    local_rows,
    lr_schedule,
    make_train_step,
    meta_tree,
    reduce_grads,
    rescaled_config,
)
from repro_torch.training.tree import tree_leaves, tree_map


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
    compression: Optional[str] = None  # int8 | topk | powersgd
    mesh: Optional[Any] = None  # a ("data", "model") DeviceMesh, "model" of size 1
    rules: Optional[Rules] = None  # Rules.default(mesh) when None
    failure_injector: Optional[FailureInjector] = None
    log_every: int = 10
    # the port's additions: the device (the card when None; a mesh's rank
    # device with a mesh) and a caller's config in place of arch/smoke (a
    # cut depth, another dtype)
    device: DeviceLike = None
    cfg: Optional[ArchConfig] = None


def bits_digest(t: torch.Tensor) -> Tuple[int, int]:
    """(the sum of a tensor's bits as integers of its element width, the sum
    of those weighted by position mod 1009 + 1), exact in int64."""
    width = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    bits = t.detach().contiguous().reshape(-1).view(width).to(torch.int64)
    weights = torch.arange(bits.numel(), device=bits.device) % 1009 + 1
    return int(bits.sum()), int((bits * weights).sum())


class Trainer:
    """Restartable trainer; ``run()`` survives ``SimulatedFailure`` via
    restore.  State: ``params`` (float32 master tree, the reference's
    layout; on a mesh the rank's blocks), ``opt_state``, ``step``, and the
    data pipeline's position."""

    def __init__(self, opts: TrainerOptions):
        self.opts = opts
        cfg = opts.cfg or (get_smoke_config(opts.arch) if opts.smoke else get_config(opts.arch))
        self.cfg = cfg
        self.mesh = opts.mesh
        self.rules = opts.rules or (Rules.default(opts.mesh) if opts.mesh is not None else None)
        if self.mesh is not None and opts.device is None:
            self.device = mesh_device(self.mesh)
        else:
            self.device = resolve_device(opts.device)
        self.rt = Runtime(remat="none" if opts.smoke else "full", block_q=64, block_k=64,
                          mesh=self.mesh, rules=self.rules)
        if self.mesh is not None:
            check_trainable_mesh(self.rt)
        self.lm = LM(cfg, self.device)
        self.param_axes = self.lm.param_axes()
        self.opt = get_optimizer(opts.optimizer)
        self.tcfg = TrainConfig(learning_rate=opts.learning_rate, warmup_steps=20,
                                total_steps=opts.steps, local_steps=opts.local_steps)
        self.compressor = None
        if opts.compression:
            self.compressor = GradientCompressor(CompressionConfig(scheme=opts.compression))
        self.data = SyntheticTokens(cfg.vocab_size, opts.seq_len, opts.global_batch,
                                    seed=opts.seed, n_frontend=cfg.n_frontend_tokens,
                                    d_model=cfg.d_model)
        self.ckpt = CheckpointManager(opts.ckpt_dir) if opts.ckpt_dir else None
        self.monitor = StragglerMonitor()
        self.history: list = []  # (step, loss)
        self.records: List[Dict[str, float]] = []  # every step's metrics and step_time
        self.last: Dict[str, float] = {}  # the metrics run() ended with
        self.data_mesh = DataMesh(self.lm, self.rt) if self.mesh is not None else None
        if self.data_mesh is not None:
            self.shardings = {"params": self.data_mesh.shardings,
                              "opt_state": shardings_for(
                                  self.mesh, self.rules, self.opt.init_axes(self.param_axes),
                                  self.opt.init(meta_tree(self.lm)), self.device)}
            if self.data_mesh.rank == 0 and opts.log_every:
                import torch.distributed as dist

                print(f"data mesh: {self.data_mesh.world} rank(s), backend "
                      f"{dist.get_backend()} on {self.device.type}", flush=True)
        self._build_state()
        self._step_fn = self._make_step()

    # ------------------------------------------------------------------
    @property
    def is_writer(self) -> bool:
        """Rank 0 of a mesh (or the one process) writes checkpoints."""
        return self.data_mesh is None or self.data_mesh.rank == 0

    def _build_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.opts.seed)
        self.lm.init_params(gen).trainable()
        params = tree_from_lm(self.lm)
        if self.data_mesh is not None:
            params = reshard_tree(params, self.shardings["params"])
        self.params = params
        self.opt_state = self.opt.init(self.params)
        if self.data_mesh is not None:
            self._check_local_state()
        self.comp_state = None
        if self.compressor is not None:  # whole leaves, on every rank alike
            self.comp_state = self.compressor.init_state(meta_tree(self.lm), device=self.device)
        self.step = 0

    def _check_local_state(self) -> None:
        """The optimizer's state, initialised on the blocks, has the blocks'
        shapes of the whole state its own axes name."""
        whole = self.opt.init(meta_tree(self.lm))
        for local, full, sh in zip(tree_leaves(self.opt_state), tree_leaves(whole),
                                   tree_leaves(self.shardings["opt_state"])):
            if tuple(local.shape) != sh.local_shape(full.shape):
                raise ValueError(f"optimizer state block {tuple(local.shape)} is not the block "
                                 f"{sh.local_shape(full.shape)} of spec {sh.spec}")

    def _make_step(self):
        return make_train_step(self.lm, self.opt, self.tcfg, rt=self.rt)

    def set_state(self, params, opt_state, step: int = 0) -> None:
        """Take another run's state (trees in the reference's layout, of
        whole tensors on any device), as a restore does; on a mesh, the
        rank's blocks of them."""
        if self.data_mesh is not None:
            placed = reshard_tree({"params": params, "opt_state": opt_state}, self.shardings)
            self.params, self.opt_state = placed["params"], placed["opt_state"]
        else:
            self.params = tree_map(lambda t: t.to(self.device).clone(), params)
            self.opt_state = tree_map(lambda t: t.to(self.device).clone(), opt_state)
        self.step = int(step)

    def whole_state(self, device="cpu"):
        """(params, opt_state) as whole leaves on ``device``, gathered from
        the ranks on a mesh (every rank takes part)."""
        if self.data_mesh is None:
            return (tree_map(lambda t: t.to(device, copy=True), self.params),
                    tree_map(lambda t: t.to(device, copy=True), self.opt_state))
        return (gather_tree(self.params, self.shardings["params"], device),
                gather_tree(self.opt_state, self.shardings["opt_state"], device))

    def state_digest(self) -> List[Tuple[int, int]]:
        """Two integer sums of the bits of every whole leaf of params and
        optimizer state (on a mesh gathered from the ranks one leaf at a
        time, on the device; every rank takes part): equal digests are the
        same bits unless both sums collide."""
        sh = self.shardings if self.data_mesh is not None else None
        out = []
        for key in ("params", "opt_state"):
            shards = None if sh is None else tree_leaves(sh[key])
            for i, leaf in enumerate(tree_leaves(getattr(self, key))):
                whole = leaf if shards is None else gather_leaf(leaf, shards[i])
                out.append(bits_digest(whole))
        return out

    # ------------------------------------------------------------------
    def _sync_checkpoints(self) -> None:
        """Wait for this process's writes, then (on a mesh) for every
        rank's, so that each rank reads what rank 0 wrote."""
        if self.ckpt is not None:
            self.ckpt.wait()
        if self.data_mesh is not None and self.data_mesh.group is not None:
            import torch.distributed as dist

            dist.barrier(group=self.data_mesh.group)

    def restore(self, step: Optional[int] = None) -> bool:
        """Restore ``step`` (the newest complete one when None) from the
        checkpoint directory; False when there is none.  On a mesh every
        rank places its blocks (``restore_sharded``)."""
        if self.ckpt is None:
            return False
        self._sync_checkpoints()
        if step is None:
            step = self.ckpt.latest_step()
            if step is None:
                return False
        if self.data_mesh is not None:
            tree, meta = self.ckpt.restore_sharded(self.shardings, step)
            self.params, self.opt_state = tree["params"], tree["opt_state"]
            self.step = int(meta["step"])
        else:
            tree, meta = self.ckpt.restore(step)
            self.set_state(tree["params"], tree["opt_state"], int(meta["step"]))
        self.data.load_state_dict(meta["data_state"])
        return True

    def _save(self, block: bool = False):
        if self.ckpt is None:
            return
        if self.data_mesh is None:
            params, opt_state = self.params, self.opt_state
        else:
            params, opt_state = self.whole_state()
        if self.is_writer:
            handle = self.ckpt.save_async(
                self.step, {"params": params, "opt_state": opt_state},
                metadata={"data_state": self.data.state_dict(), "arch": self.cfg.name})
            if block:
                handle.wait()
        if block:
            self._sync_checkpoints()

    # ------------------------------------------------------------------
    def _compressed_step(self, batch) -> Dict[str, torch.Tensor]:
        """One step through the compressor, ``repro/launch/train.py:133-147``:
        value and grad, compress, clip, ``lr_schedule``, ``opt.update``;
        metrics loss and grad_norm.  On a mesh the gradient is summed over
        the group whole, compressed and clipped on every rank alike, and each
        rank updates its blocks."""
        mesh = self.data_mesh
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        shardings = None if mesh is None else mesh.shardings
        group = None if mesh is None else mesh.group
        if mesh is not None:
            batch = local_rows(batch, mesh.rank, mesh.world)
        load_blocks_into_lm(self.lm, self.params, shardings)
        for p in self.lm.parameters():
            p.grad = None
        loss, _, grads = forward_backward(self.lm, self.rt, batch)
        grads = reduce_grads(grads, shardings, group, scatter=False)
        grads, self.comp_state = self.compressor.compress(grads, self.comp_state)
        grads, gnorm = clip_by_global_norm(grads, self.tcfg.grad_clip)
        if mesh is not None:
            grads = reshard_tree(grads, shardings)
        lr = lr_schedule(self.tcfg, self.step, device=self.device)
        self.params, self.opt_state = self.opt.update(grads, self.opt_state, self.params, lr,
                                                      shards=shardings)
        return global_metrics({"loss": loss, "grad_norm": gnorm}, group, keys=("loss",))

    def train_some(self, n_steps: int) -> Dict[str, float]:
        last: Dict[str, float] = {}
        for _ in range(n_steps):
            if self.opts.failure_injector is not None:
                self.opts.failure_injector.check(self.step)
            batch = self.data.next_batch()
            t0 = time.perf_counter()
            if self.compressor is not None:
                metrics = self._compressed_step(batch)
            else:
                self.params, self.opt_state, metrics = self._step_fn(
                    self.params, self.opt_state, batch, self.step)
            synchronize(self.device)
            dt = time.perf_counter() - t0
            self.monitor.observe(self.step, dt)
            last = {k: float(v) for k, v in metrics.items()}
            last["step_time"] = dt
            self.history.append((self.step, last["loss"]))
            self.records.append(dict(last, step=self.step))
            if self.opts.log_every and self.step % self.opts.log_every == 0 and self.is_writer:
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
                if not self.restore():
                    self._build_state()
                self._step_fn = self._make_step()
        if self.ckpt:
            self._save(block=True)
        self.last = last
        return last


# ---------------------------------------------------------------------------
# Chaos mode: the closed elastic loop over the REAL trainer
# ---------------------------------------------------------------------------
class TrainerExecutor:
    """Chaos-loop executor backed by the real LM Trainer
    (``repro/launch/train.py:189-285``).

    Implements the ``repro_torch.runtime.chaos.ChaosLoop`` executor contract
    with the production mechanisms: ``checkpoint``/``restore`` go through
    the CheckpointManager, and ``resize`` rebuilds the trainer at the new
    data-parallel degree and re-places params and optimizer state onto the
    mesh through the elastic path (``repro_torch.runtime.elastic.
    rescale_training_state``) from the latest checkpoint: the same move a
    multi-host deployment makes, executed here on a (1, 1) debug mesh.  As
    in the reference, the degree m only sets the global batch, m x
    ``batch_per_worker``, and the learning rate, linearly scaled by m / m0
    from the base config at every rebuild.

    Without a process group the executor starts a world-1 group itself
    (rendezvous through a file under its checkpoint directory) and ends it
    in ``close()``.  The port's addition: ``device`` (the card when None)."""

    def __init__(self, arch: str, m0: int, *, ckpt_dir: str, batch_per_worker: int = 2,
                 seq_len: int = 32, total_steps: int = 200, seed: int = 0,
                 device: DeviceLike = None):
        import torch.distributed as dist

        from repro_torch.launch.mesh import init_distributed, make_debug_mesh

        self.arch = arch
        self.batch_per_worker = batch_per_worker
        self.seq_len = seq_len
        self.total_steps = total_steps
        self.seed = seed
        self.ckpt_dir = ckpt_dir
        self.device = device
        self.owns_group = not dist.is_initialized()
        if self.owns_group:
            os.makedirs(ckpt_dir, exist_ok=True)
            init_file = os.path.join(ckpt_dir, f"rendezvous_{os.getpid()}_{time.time_ns()}")
            init_distributed(0, 1, init_file, device, verbose=False)
        self.mesh = make_debug_mesh(1, 1, None if device is None else
                                    torch.device(device).type)
        self.rules = Rules.default(self.mesh)
        self.m0 = m0  # the base TrainConfig lr corresponds to m0's batch
        self.m = 0
        self._build(m0)

    # ------------------------------------------------------------------
    def _opts(self, m: int) -> TrainerOptions:
        return TrainerOptions(
            arch=self.arch, smoke=True, steps=self.total_steps, seq_len=self.seq_len,
            global_batch=m * self.batch_per_worker, ckpt_dir=self.ckpt_dir,
            ckpt_every=10 ** 9,  # the loop checkpoints
            seed=self.seed, log_every=0, mesh=self.mesh, rules=self.rules,
            device=self.device)

    def _build(self, m: int) -> None:
        # every rebuild starts from the BASE config, so the linear-scaling
        # ratio is always m/m0: per-resize ratios would compound wrongly
        ratio = m / self.m0
        self.trainer = Trainer(self._opts(m))
        if ratio != 1.0:
            self.trainer.tcfg = rescaled_config(self.trainer.tcfg, ratio)
            self.trainer._step_fn = self.trainer._make_step()
        self.m = m

    def _place_from_checkpoint(self) -> None:
        """Whole leaves from the newest checkpoint -> the rank's blocks on
        the current mesh (the elastic path)."""
        from repro_torch.runtime.elastic import rescale_training_state

        t = self.trainer
        tree, meta = t.ckpt.restore(t.ckpt.latest_step())
        placed = rescale_training_state(tree, self.mesh, self.rules, t.param_axes, t.opt,
                                        t.device)
        t.params, t.opt_state = placed["params"], placed["opt_state"]
        t.data.load_state_dict(meta["data_state"])
        t.step = int(meta["step"])

    # -- executor contract ---------------------------------------------
    def outer_step(self, sync_mask=None) -> float:
        metrics = self.trainer.train_some(1)
        return float(metrics["loss"])

    def checkpoint(self) -> None:
        self.trainer._save(block=True)

    def restore(self) -> None:
        self._place_from_checkpoint()

    def resize(self, m: int) -> None:
        self._build(m)
        self._place_from_checkpoint()

    def relax(self, local_steps: int) -> None:
        self.trainer.tcfg = rescaled_config(self.trainer.tcfg, 1.0, local_steps=local_steps)
        self.trainer._step_fn = self.trainer._make_step()

    def last_recovery_s(self, op: str) -> Optional[float]:
        """Measured wall time of the most recent restore or re-shard, read
        from the CheckpointManager's timing log (both reduce to the same
        place-shards-from-manifest move, recorded as a restore)."""
        timing = self.trainer.ckpt.last_timing("restore")
        return None if timing is None else float(timing["wall_s"])

    def close(self) -> None:
        """End the process group the executor started (if it did)."""
        import torch.distributed as dist

        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
            self.owns_group = False


def run_chaos_lm(arch: str, trace, ckpt_dir: str, *, m0: int = 1, m_options=(1, 2, 4),
                 seed: int = 0, device: DeviceLike = None):
    """Closed-loop elastic training of a real (smoke) LM under a chaos
    trace (``repro/launch/train.py:288-304``): simulated step times and
    failures, real losses, real checkpoint restores, real re-shards."""
    from repro_torch.core.adaptive import AdaptiveController
    from repro_torch.runtime.chaos import ChaosLoop, ClusterSim, default_system_model
    from repro_torch.telemetry import DriftConfig, StreamingCost

    executor = TrainerExecutor(arch, m0, ckpt_dir=ckpt_dir, total_steps=trace.steps, seed=seed,
                               device=device)
    try:
        system = default_system_model()
        # objective = train loss; loss > 0 so p_star=0 is a valid gap floor
        controller = AdaptiveController(
            system, target_gap=1.0, p_star=0.0, m_options=m_options, refit_every=15,
            window=80, reshard_cost_s=2.0, min_observations=20)
        # the real trainer reports real restore wall-times (CheckpointManager
        # timings), so the loop charges, and learns, measured recovery costs
        # instead of the assumed constants
        measured = StreamingCost(
            "recovery:lm", controller.reshard_cost_s,
            DriftConfig(window=8, threshold=0.5, min_points=3, cooldown=8))
        loop = ChaosLoop(ClusterSim(trace), executor, controller, base_compute_s=1.0, d=64,
                         ckpt_every=10, restore_cost_s=3.0, measured_costs=measured)
        log = loop.run()
    finally:
        executor.close()
    log.meta.update(seed=seed, arch=arch, mode="lm")
    return log


# ---------------------------------------------------------------------------
# K ranks on a data mesh, one process each
# ---------------------------------------------------------------------------
TRAINING_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv", "flash_bwd_dv",
                    "flash_bwd_dk", "selective_scan", "selective_scan_bwd",
                    "selective_scan_bwd_reduce")


def _training_wrappers() -> Dict[str, Any]:
    """The training path's kernel wrappers, by kernel name (each counts its
    launches)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssm_scan import ops as ss_ops

    return {name: getattr(fa_ops if name.startswith("flash") else ss_ops, name)
            for name in TRAINING_KERNELS}


def run_data_parallel(world: int, job: Dict[str, Any], device: DeviceLike = None,
                      timeout_s: Optional[float] = None) -> List[Dict[str, Any]]:
    """Spawn ``world`` ranks (``torch.multiprocessing``, the ``spawn`` start
    method), each joining a group through a file rendezvous in a fresh
    temporary directory (``repro_torch.launch.mesh.init_distributed``: a
    card each over nccl, or gloo where they share one or run on the CPU),
    building the (world, 1) data mesh and running ``_data_parallel_job``;
    returns every rank's report, in rank order.  A rank that fails raises
    here, and so does a group still running after ``timeout_s`` (its ranks
    killed).

    ``job``: ``opts`` (``TrainerOptions`` fields, no mesh), ``steps``, and
    optionally ``state`` (whole params and optimizer state to start from),
    ``restore`` (a step of ``opts["ckpt_dir"]`` to restore first, through
    ``restore_sharded``; the report has the placed state's
    ``Trainer.state_digest``) and ``save_after`` (write a checkpoint after
    that many of the steps; the report has the saved state's digest).
    Each report has the steps' records, the training kernels' launches
    over them, the rank's float32 state bytes and its peak memory."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="repro_torch_dp_") as tmp:
        ctx = mp.start_processes(_data_parallel_rank, args=(world, job, device, tmp),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"the {world} ranks did not finish in {timeout_s} s")
        reports = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                   for r in range(world)]
    return reports


def _data_parallel_rank(rank: int, world: int, job: Dict[str, Any], device: DeviceLike,
                        tmp: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_debug_mesh

    if device is not None and torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    dev, backend = init_distributed(rank, world, os.path.join(tmp, "rendezvous"), device,
                                    verbose=rank == 0)
    report = _data_parallel_job(job, make_debug_mesh(world, 1), dev)
    report.update(rank=rank, world=world, backend=backend, device=str(dev))
    torch.save(report, os.path.join(tmp, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _data_parallel_job(job: Dict[str, Any], mesh, dev: torch.device) -> Dict[str, Any]:
    """One rank's part of ``run_data_parallel``: the trainer on ``mesh``,
    its steps, and what the caller holds it to."""
    opts = dict(job["opts"], mesh=mesh)
    if dev.type == "cpu":
        opts["device"] = "cpu"
    trainer = Trainer(TrainerOptions(**opts))
    report: Dict[str, Any] = {}
    if job.get("state") is not None:
        trainer.set_state(*job["state"])
    if job.get("restore") is not None:
        t0 = time.perf_counter()
        trainer.restore(job["restore"])
        synchronize(trainer.device)
        report.update(restore_s=time.perf_counter() - t0,
                      restore_timing=trainer.ckpt.last_timing("restore"),
                      placed_digest=trainer.state_digest())
    wrappers = _training_wrappers()
    for w in wrappers.values():
        w.launches = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    save_after = job.get("save_after")
    if save_after is not None:
        trainer.train_some(save_after)
        report["saved_digest"] = trainer.state_digest()
        trainer._save(block=True)
        report.update(saved_step=trainer.step, save_timing=trainer.ckpt.last_timing("save"))
    trainer.train_some(job["steps"] - (save_after or 0))
    report.update(
        launches={name: w.launches for name, w in wrappers.items()},
        records=trainer.records, n_layers=trainer.cfg.n_layers, remat=trainer.rt.remat,
        state_bytes=sum(t.numel() * t.element_size() for t in
                        tree_leaves(trainer.params) + tree_leaves(trainer.opt_state)),
        peak_memory_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                        if dev.type == "cuda" else None))
    return report


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
    ap.add_argument("--compression", default=None, choices=SCHEMES)
    ap.add_argument("--chaos", default=None, metavar="TRACE.json",
                    help="run the closed-loop elastic trainer under this chaos trace "
                         "(generated with --chaos-seed if the file does not exist)")
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--chaos-out", default=None, help="write the replayable run log JSON here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the kernels' "
                         "plain versions)")
    return ap.parse_args(argv)


def chaos_main(args: argparse.Namespace):
    """``--chaos``: the LM chaos loop on the trace file (generated when it
    does not exist), its checkpoints under ``--ckpt-dir`` or a temporary
    directory; returns the run log."""
    import tempfile
    from pathlib import Path

    from repro_torch.runtime.chaos import ChaosTrace

    path = Path(args.chaos)
    if path.exists():
        trace = ChaosTrace.load(path)
    else:
        trace = ChaosTrace.generate(args.chaos_seed, args.steps, n_hosts=4)
        trace.save(path)
        print(f"[chaos] generated trace -> {path}")
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="chaos_ckpt_")
    log = run_chaos_lm(args.arch, trace, ckpt_dir, seed=args.chaos_seed, device=args.device)
    if args.chaos_out:
        log.save(args.chaos_out)
        print(f"[chaos] run log -> {args.chaos_out}")
    print(f"[chaos] steps={len(log.rows)} mitigations={log.n_mitigations()} "
          f"resizes={log.n_resizes()} final_m={log.meta['final_m']} "
          f"final_loss={log.meta['final_objective']:.4f}")
    return log


def run(argv: Optional[Sequence[str]] = None):
    """The CLI's work: with ``--chaos`` the LM chaos loop's run log, else
    the trainer after its run (its ``records`` hold every step's metrics)."""
    args = parse_args(argv)
    if args.chaos is not None:
        return chaos_main(args)
    opts = TrainerOptions(arch=args.arch, smoke=args.smoke, steps=args.steps,
                          seq_len=args.seq_len, global_batch=args.global_batch,
                          ckpt_dir=args.ckpt_dir, optimizer=args.optimizer,
                          compression=args.compression, device=args.device)
    trainer = Trainer(opts)
    last = trainer.run()
    times = [r["step_time"] for r in trainer.records[1:]]
    if times:
        tokens = args.seq_len * args.global_batch
        med = statistics.median(times)
        print(f"median step {med * 1e3:.1f} ms after the first ({tokens / med:.0f} tokens/s) "
              f"on {trainer.device}")
    print("final:", last)
    return trainer


def main(argv: Optional[Sequence[str]] = None):
    """The CLI; returns the last step's metrics (``--chaos``: the run log)."""
    out = run(argv)
    return out.last if isinstance(out, Trainer) else out


if __name__ == "__main__":
    main()
