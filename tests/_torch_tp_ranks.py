"""The ranks of tests/test_torch_tp.py: a CPU process group (gloo), one
process a rank, running jobs on a (1, K) mesh.  Kept apart from the test
module so that a spawned rank imports the port alone, not JAX."""
import os
import traceback

import numpy as np
import torch


def spawn_ranks(world: int, jobs: dict, workdir: str, timeout_s: float) -> list:
    """Run ``rank_main`` in ``world`` spawned processes on ``jobs`` and
    return each rank's results; raises if a rank fails or the group does not
    finish within ``timeout_s``."""
    import time

    import torch.multiprocessing as mp

    init_file = os.path.join(workdir, "rendezvous")
    ctx = mp.start_processes(rank_main, args=(world, init_file, jobs, workdir), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the {world} ranks did not finish in {timeout_s} s")
    out = [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
           for r in range(world)]
    for r, res in enumerate(out):
        if "error" in res:
            raise RuntimeError(f"rank {r}: {res['error']}")
    return out


def rank_main(rank: int, world: int, init_file: str, jobs: dict, workdir: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_debug_mesh

    torch.set_num_threads(1)
    results = {}
    try:
        init_distributed(rank, world, init_file, "cpu", verbose=False)
        mesh = make_debug_mesh(1, world)
        for name, job in jobs.items():
            results[name] = JOBS[job["kind"]](job, mesh)
        dist.barrier()
    except Exception:  # noqa: BLE001 - reported to the test through the file
        results = {"error": traceback.format_exc()}
    torch.save(results, os.path.join(workdir, f"rank{rank}.pt"))
    if dist.is_initialized():
        dist.destroy_process_group()


def _whole_lm(job):
    """The whole float32 model, the reference's weights through convert."""
    from repro_torch.convert import lm_params_from_numpy

    return lm_params_from_numpy(job["cfg"], job["params"], device="cpu")


def engine_job(job, mesh):
    """The serve trace through a TP engine on ``mesh`` (its model sliced
    from the reference's weights): per request the tokens and every step's
    logits; then the CLI's prefix-reuse check on it; then whether a
    migration is refused."""
    from repro_torch.launch.serve import _verify_prefix_reuse
    from repro_torch.serve import ServeEngine, snapshot_engine

    whole = _whole_lm(job)
    eng = ServeEngine("", lm=whole, mesh=mesh, paged_impl="stream", **job["engine"])
    reqs = [eng.submit(p, gen, arrival_step=arr) for p, gen, arr, _ in job["specs"]]
    eng.run()
    out = {"dtensor_checked": _check_against_dtensor(eng, whole, mesh),
           "tokens": [r.generated for r in reqs],
           "logits": [np.stack(r.logits_trace) for r in reqs],
           "steps": eng.step_count, "local_heads": (eng.cfg.n_heads, eng.cfg.n_kv_heads),
           "vocab_rows": int(eng.lm.embed.shape[0])}
    try:
        snapshot_engine(eng)
        out["migrate"] = None
    except NotImplementedError as e:
        out["migrate"] = str(e)
    ok, _ = _verify_prefix_reuse(eng, 0)
    out["prefix_reuse_bit_identical"] = ok
    return out


def _check_against_dtensor(eng, whole, mesh) -> int:
    """Each rank's tensor against ``distribute_tensor`` of the whole one
    with the placements of its spec (``partitioning.placements``), bit for
    bit; Mamba's ``in_proj`` (a slice of each half) is held by the test
    module.  Returns the leaves checked."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.dist.partitioning import placements

    checked = 0
    pairs = zip(eng.plan.param_specs(whole), eng.lm.init_entries())
    for (t, name, _, spec), (dst, _, _) in pairs:
        if name == "in_proj":
            continue
        local = distribute_tensor(t, mesh, placements(spec, mesh)).to_local()
        if not torch.equal(local, dst):
            raise AssertionError(f"{name}: the rank's tensor is not DTensor's shard")
        checked += 1
    return checked


def server_job(job, mesh):
    """``Server(mesh=...).generate`` on the whole model's weights."""
    from repro_torch.launch.serve import Server

    server = Server("", mesh=mesh, lm=_whole_lm(job), max_seq=48)
    return server.generate(job["prompts"], job["gen"])["tokens"]


JOBS = {"engine": engine_job, "server": server_job}
