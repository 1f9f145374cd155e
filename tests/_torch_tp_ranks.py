"""The ranks of tests/test_torch_tp.py, test_torch_moe_ep.py,
test_torch_mla_tp.py, test_torch_long_context.py and test_torch_migrate.py:
a CPU process group (gloo), one process a rank, running jobs on a (data, K)
mesh (data 1 unless the caller names another).  Kept apart from the test
modules so that a spawned rank imports the port alone, not JAX."""
import os
import traceback

import numpy as np
import torch


class Spawned:
    """``world`` spawned ranks running ``rank_main`` on ``jobs`` over a
    (data, world / data) mesh; ``results()`` waits for them."""

    def __init__(self, world: int, jobs: dict, workdir: str, timeout_s: float, data: int = 1):
        import time

        import torch.multiprocessing as mp

        self.world, self.workdir, self.timeout_s = world, workdir, timeout_s
        init_file = os.path.join(workdir, "rendezvous")
        self.ctx = mp.start_processes(rank_main, args=(world, init_file, jobs, workdir, data),
                                      nprocs=world, join=False, start_method="spawn")
        self.deadline = time.monotonic() + timeout_s

    def results(self) -> list:
        import time

        while not self.ctx.join(timeout=1.0):
            if time.monotonic() > self.deadline:
                for p in self.ctx.processes:
                    p.kill()
                raise TimeoutError(f"the {self.world} ranks did not finish in "
                                   f"{self.timeout_s} s")
        out = [torch.load(os.path.join(self.workdir, f"rank{r}.pt"), weights_only=False)
               for r in range(self.world)]
        for r, res in enumerate(out):
            if "error" in res:
                raise RuntimeError(f"rank {r}: {res['error']}")
        return out


def spawn_ranks(world: int, jobs: dict, workdir: str, timeout_s: float, data: int = 1) -> list:
    """Run ``rank_main`` in ``world`` spawned processes on ``jobs`` and
    return each rank's results; raises if a rank fails or the group does not
    finish within ``timeout_s``."""
    return Spawned(world, jobs, workdir, timeout_s, data).results()


def rank_main(rank: int, world: int, init_file: str, jobs: dict, workdir: str,
              data: int = 1) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_debug_mesh

    torch.set_num_threads(1)
    results = {}
    try:
        init_distributed(rank, world, init_file, "cpu", verbose=False)
        mesh = make_debug_mesh(data, world // data)
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
    logits; then the CLI's prefix-reuse check on it; then its snapshot's
    cache leaves' shapes (gathered whole over "model")."""
    from repro_torch.launch.serve import _verify_prefix_reuse
    from repro_torch.serve import ServeEngine, snapshot_engine

    whole = _whole_lm(job)
    eng = ServeEngine("", lm=whole, mesh=mesh, paged_impl="stream", **job["engine"])
    reqs = [eng.submit(p, gen, arrival_step=arr) for p, gen, arr, _ in job["specs"]]
    eng.run()
    if job.get("tokens_only"):  # the chunked and speculative engine
        from repro_torch.launch.serve import _document_extension

        reqs += _document_extension(eng, 0)  # drafts from the prefix cache
        return {"tokens": [r.generated for r in reqs],
                "logits": [np.stack(r.logits_trace) for r in reqs],
                "stats": {k: v for k, v in eng.stats().items()
                          if k in ("prefill_chunks", "verify_steps", "draft_accepted")}}
    out = {"dtensor_checked": _check_against_dtensor(eng, whole, mesh),
           "tokens": [r.generated for r in reqs],
           "logits": [np.stack(r.logits_trace) for r in reqs],
           "steps": eng.step_count, "local_heads": (eng.cfg.n_heads, eng.cfg.n_kv_heads),
           "vocab_rows": int(eng.lm.embed.shape[0])}
    snap = snapshot_engine(eng)
    out["snapshot_shapes"] = [{k: tuple(v.shape) for k, v in layer.items()}
                              for layer in snap["cache"]]
    out["local_shapes"] = [{k: tuple(v.shape) for k, v in layer.items()} for layer in eng.cache]
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


def _coords(mesh):
    """(the rank's coordinate on "data", on "model"), the mesh's sizes."""
    coords = tuple(int(c) for c in mesh.get_coordinate())
    return coords, tuple(int(n) for n in mesh.shape)


def moe_rank_params(whole: dict, cfg, data_index: int, model_rank: int, model: int,
                    embed_blocks: int) -> dict:
    """The rank's MoE leaves of the whole ``whole`` (numpy): experts
    ``r E / K ..`` (their d_model dim cut in ``embed_blocks`` blocks, block
    ``data_index`` kept), the router's and the shared experts' columns,
    ``sh_down``'s rows."""
    e, d = cfg.moe.n_routed_experts, cfg.d_model
    el, dl = e // model, d // embed_blocks
    ex, dx = slice(model_rank * el, (model_rank + 1) * el), slice(data_index * dl,
                                                                  (data_index + 1) * dl)
    out = {"router": whole["router"][:, ex], "w_gate": whole["w_gate"][ex][:, dx],
           "w_up": whole["w_up"][ex][:, dx], "w_down": whole["w_down"][ex][:, :, dx]}
    if "sh_gate" in whole:
        fl = whole["sh_gate"].shape[1] // model
        fx = slice(model_rank * fl, (model_rank + 1) * fl)
        out.update(sh_gate=whole["sh_gate"][:, fx], sh_up=whole["sh_up"][:, fx],
                   sh_down=whole["sh_down"][fx])
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def moe_job(job, mesh):
    """The MoE FFN on the rank: the expert-parallel path (``job["path"]``
    "ep": ``Rules.default``, the tokens over "data") or the 2-D path ("2d":
    the tokens replicated, the experts' d_model in blocks over "data"), in
    eval and in training (the loss sum(y ct) + aux, backward); y, aux and
    every local leaf's gradient and x's.  In eval also the output of the
    kept rows with the other rows' tokens changed (a token's output alone)."""
    import dataclasses

    from repro_torch.dist.partitioning import Rules
    from repro_torch.models.moe import apply_moe
    from repro_torch.models.runtime import Runtime

    (i, r), (data, model) = _coords(mesh)
    two_d = job["path"] == "2d"
    cfg = job["cfg"]
    local = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, expert_shards=model, embed_shards=data if two_d else 1))
    rules = Rules.default(mesh)
    if two_d:
        rules = rules.override(acts={"batch": None})
    rt = Runtime(mesh=mesh, rules=rules)
    x, ct = torch.from_numpy(job["x"]), torch.from_numpy(job["ct"])
    if not two_d:  # the rank's rows over "data"
        n = x.shape[0] // data
        x, ct = x[i * n:(i + 1) * n], ct[i * n:(i + 1) * n]
    out = {}
    for train in (False, True):
        p = moe_rank_params(job["params"], cfg, i if two_d else 0, r, model,
                            data if two_d else 1)
        xx = x.clone().requires_grad_(train)
        if train:
            for t in p.values():
                t.requires_grad_(True)
            y, aux = apply_moe(p, xx, local, train=True, rt=rt)
            ((y * ct).sum() + aux).backward()
            out["train"] = {"y": y.detach().numpy(), "aux": float(aux.detach()),
                            "grads": {k: t.grad.numpy() for k, t in p.items()},
                            "x_grad": xx.grad.numpy()}
        else:
            with torch.no_grad():
                y = apply_moe(p, xx, local, rt=rt)
                other = xx.clone()
                other[:, job["keep"]:] = torch.from_numpy(job["other"])[:xx.shape[0],
                                                                        job["keep"]:]
                y_other = apply_moe(p, other, local, rt=rt)
            out["eval"] = {"y": y.numpy(), "kept_alone": bool(torch.equal(
                y[:, :job["keep"]], y_other[:, :job["keep"]]))}
    return out


def train_grads_job(job, mesh):
    """One training forward and backward of the rank's tensor-parallel
    slice of the whole model (``ShardingPlan.shard_params`` of the
    reference's weights, made trainable) on ``job["batch"]``: the loss, its
    parts and every parameter's gradient, by name in ``init_entries``
    order."""
    from repro_torch.dist.partitioning import Rules
    from repro_torch.models.runtime import Runtime
    from repro_torch.serve.sharding import ShardingPlan

    whole = _whole_lm(job)
    plan = ShardingPlan(mesh, Rules.for_serving(mesh))
    lm = plan.shard_params(whole.cfg, source=whole).trainable()
    rt = Runtime(mesh=mesh, block_q=16, block_k=16, remat=job.get("remat", "none"))
    loss, extra = lm.loss_fn({k: torch.from_numpy(v) for k, v in job["batch"].items()}, rt)
    loss.backward()
    names = [name for _, name, _, _ in plan.param_specs(whole)]
    return {"loss": float(loss.detach()), "ce": float(extra["ce"]), "aux": float(extra["aux"]),
            "grads": [(name, t.grad.numpy().copy()) for name, (t, _, _) in
                      zip(names, lm.init_entries())],
            "local_heads": lm.cfg.n_heads}


def long_context_rules(mesh, seq_len: int):
    """``rules_for_cell``'s long-context rules on ``mesh`` (one row: the
    batch cannot fill "data"): the cache's positions over the batch axes,
    the tokens replicated."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.dist.partitioning import Rules
    from repro_torch.launch.inputs import rules_for_cell

    return rules_for_cell(Rules.default(mesh), ShapeSpec("long", seq_len, 1, "decode"), mesh)


def split_attention_job(job, mesh):
    """The contiguous attention decode of one layer
    (``attention.apply_attention_decode``) over a cache split along its
    sequence over "data": the rank's block of the whole cache in, y and the
    rank's block after the step out."""
    from repro_torch.models.attention import apply_attention_decode
    from repro_torch.models.runtime import Runtime

    (i, _), (data, _) = _coords(mesh)
    k, v = job["k"], job["v"]
    n = k.shape[2] // data
    cache = {name: torch.from_numpy(np.ascontiguousarray(a[:, :, i * n:(i + 1) * n]))
             for name, a in (("k", k), ("v", v))}
    rt = Runtime(mesh=mesh, rules=long_context_rules(mesh, k.shape[2]))
    p = {name: torch.from_numpy(a) for name, a in job["params"].items()}
    y = apply_attention_decode(p, torch.from_numpy(job["x"]), job["cfg"], rt, cache,
                               torch.from_numpy(job["lengths"]))
    return {"y": y.numpy(), "k": cache["k"].numpy(), "v": cache["v"].numpy(), "block": i}


def long_decode_job(job, mesh):
    """The smoke LM's contiguous decode (``LM.decode_step``) on ``mesh``
    under the long-context rules: the rank's tensor-parallel LM (its MoE
    on the 2-D path, its experts' d_model in blocks over "data"), its blocks
    of the whole model's float32 masters gathered over "data" but for the
    experts', and its block of the whole cache (``launch.inputs.decode_sds``'s
    shardings); ``job["steps"]`` greedy steps from each of
    ``job["starts"]``.  Returns each run's logits a step."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import tree_from_lm
    from repro_torch.launch.inputs import decode_sds
    from repro_torch.models.model import LM
    from repro_torch.models.runtime import Runtime
    from repro_torch.runtime.elastic import reshard_tree
    from repro_torch.training.trainer import load_blocks_into_lm, param_shardings, train_lm

    cfg, seq = job["cfg"], job["seq"]
    whole = LM(cfg, "cpu").init_params(torch.Generator().manual_seed(job["seed"]))
    rt = Runtime(mesh=mesh, rules=long_context_rules(mesh, seq))
    lm = train_lm(cfg, rt, "cpu")
    shardings = param_shardings(lm, rt)
    with torch.no_grad():
        load_blocks_into_lm(lm, reshard_tree(tree_from_lm(whole), shardings), shardings)
    _, _, placed = decode_sds(cfg, ShapeSpec("long", seq, 1, "decode"), mesh, rt.rules, lm)
    out = {"embed_shards": lm.cfg.moe.embed_shards, "expert_shards": lm.cfg.moe.expert_shards,
           "runs": []}
    for start in job["starts"]:
        cache = [{name: placed.shardings[li][name].place(leaf) for name, leaf in layer.items()}
                 for li, layer in enumerate(job["cache"])]
        tokens = torch.tensor([job["token"]])
        logits = []
        for step in range(job["steps"]):
            step_logits, cache = lm.decode_step(tokens, torch.tensor([start + step],
                                                                      dtype=torch.int32),
                                                cache, rt=rt)
            logits.append(step_logits.numpy())
            tokens = step_logits.argmax(-1)
        out["runs"].append(logits)
    return out


def tp_migrate_job(job, mesh):
    """A K-way engine's handoff mid-trace: the control (the trace served
    unmigrated), then for each step of ``job["steps"]`` a K-way engine
    snapshotted there (every rank at the same step), restored onto a fresh
    K-way engine on the same ``LM`` and run to the end, and the same
    snapshot restored onto an unsharded engine (K = 1) on the whole model
    and run to the end: each run's tokens and logits, the snapshot's bytes
    and its cache leaves' shapes."""
    from repro_torch.serve import ServeEngine, restore_engine, snapshot_engine
    from repro_torch.serve.migrate import snapshot_nbytes

    whole = _whole_lm(job)
    geom = dict(job["engine"], paged_impl="stream", collect_logits=True)
    rank_lm = ServeEngine("", lm=whole, mesh=mesh, **geom).lm

    def make(on_mesh=True):
        return ServeEngine("", lm=rank_lm if on_mesh else whole, mesh=mesh if on_mesh else None,
                           **geom)

    def results(reqs):
        return {"tokens": [r.generated for r in reqs],
                "logits": [np.stack(r.logits_trace) for r in reqs]}

    control = make()
    reqs = [control.submit(p, g, arrival_step=a) for p, g, a in job["specs"]]
    control.run()
    out = {"control": results(reqs), "runs": {}}
    for step in job["steps"]:
        src = make()
        reqs = [src.submit(p, g, arrival_step=a) for p, g, a in job["specs"]]
        while src.step_count < step:
            src.step()
        in_flight = sum(r is not None for r in src.scheduler.slots)
        snap = snapshot_engine(src)
        run = {"in_flight": in_flight, "nbytes": snapshot_nbytes(snap),
               "shapes": [{k: tuple(v.shape) for k, v in layer.items()}
                          for layer in snap["cache"]]}
        for name, on_mesh in (("same_k", True), ("k1", False)):
            dst = make(on_mesh)
            rid_map = restore_engine(dst, snap)
            dst.run()
            run[name] = results([rid_map[r.rid] for r in reqs])
        out["runs"][step] = run
    return out


JOBS = {"engine": engine_job, "server": server_job, "moe": moe_job, "tp_migrate": tp_migrate_job,
        "train_grads": train_grads_job, "split_attention": split_attention_job,
        "long_decode": long_decode_job}
