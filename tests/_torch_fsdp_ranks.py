"""The ranks of tests/test_torch_fsdp.py and tests/test_torch_tp_train.py: a
CPU process group (gloo), one process a rank, running jobs on a (K / M, M)
mesh (a data mesh at M = 1).  Kept apart from the test modules so that a
spawned rank imports the port alone, not JAX."""
import os
import traceback

import torch


class Ranks:
    """``rank_main`` started in ``world`` spawned processes on ``jobs``;
    ``results()`` waits for them (the caller may work meanwhile)."""

    def __init__(self, world: int, jobs: dict, workdir: str, timeout_s: float,
                 model: int = 1):
        import time

        import torch.multiprocessing as mp

        self.world, self.workdir = world, workdir
        self.deadline = time.monotonic() + timeout_s
        init_file = os.path.join(workdir, "rendezvous")
        self.ctx = mp.start_processes(rank_main, args=(world, init_file, jobs, workdir, model),
                                      nprocs=world, join=False, start_method="spawn")

    def results(self) -> list:
        """Each rank's results; raises if a rank fails or the group does not
        finish before the deadline."""
        import time

        while not self.ctx.join(timeout=1.0):
            if time.monotonic() > self.deadline:
                for p in self.ctx.processes:
                    p.kill()
                raise TimeoutError(f"the {self.world} ranks did not finish in time")
        out = [torch.load(os.path.join(self.workdir, f"rank{r}.pt"), weights_only=False)
               for r in range(self.world)]
        for r, res in enumerate(out):
            if "error" in res:
                raise RuntimeError(f"rank {r}: {res['error']}")
        return out


def rank_main(rank: int, world: int, init_file: str, jobs: dict, workdir: str,
              model: int = 1) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_debug_mesh

    torch.set_num_threads(1)
    results = {}
    try:
        init_distributed(rank, world, init_file, "cpu", verbose=False)
        mesh = make_debug_mesh(world // model, model)
        for name, job in jobs.items():
            results[name] = JOBS[job["kind"]](job, mesh, workdir)
        dist.barrier()
    except Exception:  # noqa: BLE001 - reported to the test through the file
        results = {"error": traceback.format_exc()}
    torch.save(results, os.path.join(workdir, f"rank{rank}.pt"))
    if dist.is_initialized():
        dist.destroy_process_group()


def _numpy_tree(tree):
    from repro_torch.convert import tree_to_numpy

    return tree_to_numpy(tree)


def step_job(job, mesh, workdir):
    """``make_train_step`` on the data mesh from the reference's weights:
    each step's metrics, then the params and optimizer state gathered whole
    from the ranks; also the whole initial params gathered back from their
    blocks (bit for bit the ones placed)."""
    from repro_torch.convert import lm_params_from_numpy, tree_from_numpy
    from repro_torch.dist.partitioning import Rules
    from repro_torch.models.runtime import Runtime
    from repro_torch.runtime.elastic import gather_tree, reshard_tree, shardings_for
    from repro_torch.training import optimizers, trainer
    from repro_torch.training.trainer import meta_tree

    lm = lm_params_from_numpy(job["cfg"], job["params"], device="cpu").trainable()
    rt = Runtime(block_q=16, block_k=16, mesh=mesh, rules=Rules.default(mesh))
    opt = optimizers.get_optimizer(job["optimizer"])
    step = trainer.make_train_step(lm, opt, trainer.TrainConfig(**job["tcfg"]), rt=rt)
    psh = trainer.param_shardings(lm, rt)
    osh = shardings_for(mesh, rt.rules, opt.init_axes(lm.param_axes()), opt.init(meta_tree(lm)))
    whole = tree_from_numpy(job["params"], "cpu")
    params = reshard_tree(whole, psh)
    regathered = gather_tree(params, psh)
    same = all(torch.equal(a, b) for a, b in zip(_leaves(regathered), _leaves(whole)))
    state = opt.init(params)
    metrics = []
    for i, batch in enumerate(job["batches"]):
        params, state, m = step(params, state, batch, i)
        metrics.append({k: float(v) for k, v in m.items()})
    n_split = sum(1 for sh in _leaves(psh) if sh.split_dims())
    return {"metrics": metrics, "params": _numpy_tree(gather_tree(params, psh)),
            "opt_state": _numpy_tree(gather_tree(state, osh)), "regathered_same": same,
            "split_leaves": n_split, "leaves": len(_leaves(psh))}


def _leaves(tree):
    from repro_torch.training.tree import tree_leaves

    return tree_leaves(tree)


def moe_job(job, mesh, workdir):
    """One MoE layer's training forward on this rank's rows of x: its output
    rows, its aux share (and their sum over the group), its dispatch loads
    and capacity."""
    import torch.distributed as dist

    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import moe
    from repro_torch.models.runtime import Runtime
    from repro_torch.training.trainer import local_rows

    lm = lm_params_from_numpy(job["cfg"], job["params"], device="cpu")
    rank, world = dist.get_rank(), dist.get_world_size()
    x = local_rows({"x": torch.from_numpy(job["x"])}, rank, world)["x"]
    loads = []
    dispatch = moe.dispatch_compute_combine

    def counting(xt, ids, probs, wg, wu, wd, cap=None, e0=0):
        loads.append((torch.bincount(ids.reshape(-1), minlength=wg.shape[0]).numpy(), cap))
        return dispatch(xt, ids, probs, wg, wu, wd, cap, e0=e0)

    moe.dispatch_compute_combine = counting
    try:
        group = mesh.get_group("data")
        y, aux = moe.apply_moe(lm.layers[job["layer"]].ffn, x, job["cfg"], train=True,
                               rt=Runtime(mesh=mesh))
    finally:
        moe.dispatch_compute_combine = dispatch
    total = aux.detach().clone()
    dist.all_reduce(total, group=group)
    return {"y": y.detach().numpy(), "aux": float(aux), "aux_sum": float(total),
            "loads": loads}


def trainer_job(job, mesh, workdir):
    """``Trainer`` on the data mesh (the smoke config, float32): its steps,
    a checkpoint at the end (whole leaves, written by rank 0); then a MoE
    arch's ``Trainer`` on a "model" axis of 2 (its expert-parallel path,
    ``job["tp_cfg"]``): its first step and the rank's expert count."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import Trainer, TrainerOptions

    opts = TrainerOptions(**job["opts"], mesh=mesh, device="cpu",
                          ckpt_dir=os.path.join(workdir, "ckpt"))
    t = Trainer(opts)
    t.set_state(job["params"], job["opt_state"])
    t.train_some(job["steps"])
    t._save(block=True)
    params, state = t.whole_state()
    out = {"history": t.history, "params": _numpy_tree(params),
           "opt_state": _numpy_tree(state), "step": t.step}
    tp = make_debug_mesh(1, dist.get_world_size())
    moe = Trainer(TrainerOptions(**dict(job["opts"], arch="", cfg=job["tp_cfg"]), mesh=tp,
                                 device="cpu"))
    moe.train_some(1)
    out["tp_moe"] = {"history": moe.history, "local_experts": int(
        moe.lm.layers[-1].ffn["w_gate"].shape[0])}
    return out


def tp_step_job(job, mesh, workdir):
    """``make_train_step`` on a (data, model) mesh from the reference's
    whole weights: the rank's tensor-parallel LM (``train_lm``), its blocks
    of the weights and of the optimizer state; each step's metrics, then the
    params and the optimizer state gathered whole."""
    from repro_torch.convert import tree_from_numpy
    from repro_torch.dist.partitioning import Rules
    from repro_torch.models.runtime import Runtime
    from repro_torch.runtime.elastic import gather_tree, reshard_tree
    from repro_torch.training import optimizers, trainer

    rt = Runtime(block_q=16, block_k=16, mesh=mesh, rules=Rules.default(mesh))
    lm = trainer.train_lm(job["cfg"], rt, "cpu").trainable()
    opt = optimizers.get_optimizer(job["optimizer"])
    step = trainer.make_train_step(lm, opt, trainer.TrainConfig(**job["tcfg"]), rt=rt)
    psh, osh = trainer.param_shardings(lm, rt), trainer.state_shardings(lm, rt, opt)
    params = reshard_tree(tree_from_numpy(job["params"], "cpu"), psh)
    state = opt.init(params)
    metrics = []
    for i, batch in enumerate(job["batches"]):
        params, state, m = step(params, state, batch, i)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "params": _numpy_tree(gather_tree(params, psh)),
            "opt_state": _numpy_tree(gather_tree(state, osh)),
            "local_heads": lm.cfg.n_heads, "local_kv_heads": lm.cfg.n_kv_heads,
            "split_leaves": sum(
                1 for sh in _leaves(psh) if sh.split_dims())}


JOBS = {"step": step_job, "moe": moe_job, "trainer": trainer_job, "tp_step": tp_step_job}
