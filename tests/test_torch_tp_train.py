"""The trainer's tensor parallelism (``repro_torch.training.trainer`` on a
(data, model) mesh, the collectives' backwards in
``repro_torch.dist.collectives``) against the JAX package, on the CPU: gloo
ranks, one process each, float32 smoke configs cut to 2 layers, sequence
16, global batch 4.

The reference's sharded step fails on this host's JAX (its embedding
gather raises, ROADMAP.md queue 3), and GSPMD makes that step one
computation over the global batch; so the port's meshed step is held
against the reference's unsharded ``make_train_step`` on the same global
batch, from the reference's weights:

* smoke stablelm-1.6b (dense attention, GQA), smoke qwen3-14b (GQA and
  qk-norm) and smoke falcon-mamba-7b (Mamba: ``in_proj``'s halves sliced
  per rank) under AdamW, and stablelm and falcon-mamba under Adafactor
  (its factored moments' means summed over the model-split dims), on
  (1, 2) and (2, 2) meshes, 2 steps at lr 1e-3: each step's loss within
  1e-5 and grad norm within 1e-4 relative on every rank, the params
  gathered from the ranks within 1e-4 of the reference's and the same bits
  on every rank;
* a rank's float32 masters drawn one tensor at a time (``draw_blocks``)
  are the blocks of the whole model's draws, bit for bit (the MoE archs'
  expert leaves too: dim 0 over "model", ``embed`` over "data");
* a (1, 1) mesh (a one-rank gloo group in this process): bit for bit the
  port's unmeshed step;
* the MoE and MLA smoke archs (deepseek-moe-16b, deepseek-v2-236b with
  MLA and MoE, jamba with Mamba and MoE) under AdamW on the same meshes
  and bounds: the MoE on its expert-parallel path (E / 2 experts a rank),
  MLA over the rank's heads; their MoE layers at a capacity factor of E /
  k, under which no token drops on either count (on the (2, 2) mesh the
  port's capacity counts a rank's rows, the reference's the whole batch:
  tests/test_torch_moe_ep.py holds the drops).  Their params are held
  within ``MOE_MLA_PARAM_ATOL`` = 2e-4 of the reference's: AdamW moves an
  element whose gradient is within rounding of zero by up to lr a step
  whatever that gradient's bits, and jamba's eight layers (2 x 8 gloo
  sums a step) have such elements; the bound is a tenth of two steps' most.

The two groups (2 and 4 ranks) run at once, each rank on one thread, their
rendezvous files under temporary directories, never a fixed port.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fsdp_ranks import Ranks
from repro.configs import get_smoke_config as ref_smoke_config
from repro.data.pipeline import SyntheticTokens as RefTokens
from repro.models.model import LM as RefLM
from repro.models.runtime import Runtime as RefRuntime
from repro.training import optimizers as ref_opt
from repro.training import trainer as ref_trainer
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy, tree_from_lm, tree_from_numpy
from repro_torch.dist.partitioning import Rules
from repro_torch.launch.mesh import StandInMesh, init_distributed, make_debug_mesh
from repro_torch.models.model import LM
from repro_torch.models.runtime import Runtime
from repro_torch.runtime.elastic import reshard_tree
from repro_torch.training import optimizers as port_opt
from repro_torch.training import trainer as port_trainer
from repro_torch.training.tree import tree_leaves

SEQ, BATCH, STEPS = 16, 4, 2
TCFG = dict(learning_rate=1e-3, warmup_steps=0, total_steps=10)
SPAWN_TIMEOUT_S = 240
# case: (arch, optimizer)
CASES = {"stablelm-1.6b": ("stablelm-1.6b", "adamw"),
         "falcon-mamba-7b": ("falcon-mamba-7b", "adamw"),
         "qwen3-14b": ("qwen3-14b", "adamw"),
         "stablelm-1.6b-adafactor": ("stablelm-1.6b", "adafactor"),
         "falcon-mamba-7b-adafactor": ("falcon-mamba-7b", "adafactor"),
         "deepseek-moe-16b": ("deepseek-moe-16b", "adamw"),
         "deepseek-v2-236b": ("deepseek-v2-236b", "adamw"),
         "jamba-1.5-large-398b": ("jamba-1.5-large-398b", "adamw")}
MESHES = {"1x2": (2, 2), "2x2": (4, 2)}  # name: (world, model)
MOE_MLA = ("deepseek-moe-16b", "deepseek-v2-236b", "jamba-1.5-large-398b")
MOE_MLA_PARAM_ATOL = 2e-4


def _configs(arch):
    ref, port = ref_smoke_config(arch), get_smoke_config(arch)
    # 2 layers, or jamba's period of 8 (one attention layer, four MoE)
    cut = dict(n_layers=max(2, port.first_k_dense + len(port.period)), dtype="float32")
    if port.moe is not None:  # capacity = the dispatch's tokens: no drops
        cf = port.moe.n_routed_experts / port.moe.top_k
        cut_ref = dict(cut, moe=dataclasses.replace(ref.moe, capacity_factor=cf))
        cut = dict(cut, moe=dataclasses.replace(port.moe, capacity_factor=cf))
        return dataclasses.replace(ref, **cut_ref), dataclasses.replace(port, **cut)
    return dataclasses.replace(ref, **cut), dataclasses.replace(port, **cut)


def _inputs():
    data = RefTokens(256, SEQ, BATCH, seed=0)
    batches = [data.next_batch() for _ in range(STEPS)]
    archs = {}
    for arch in {arch for arch, _ in CASES.values()}:
        ref_cfg, cfg = _configs(arch)
        ref_lm = RefLM(ref_cfg, RefRuntime(remat="none", block_q=16, block_k=16))
        params, _ = ref_lm.init(jax.random.PRNGKey(0))
        archs[arch] = dict(cfg=cfg, ref_lm=ref_lm, params=jax.tree.map(np.asarray, params))
    cases = {case: dict(archs[arch], optimizer=optimizer)
             for case, (arch, optimizer) in CASES.items()}
    return batches, cases


def _reference(ref_lm, params, batches, optimizer):
    opt = ref_opt.get_optimizer(optimizer)
    step = jax.jit(ref_trainer.make_train_step(ref_lm, opt, ref_trainer.TrainConfig(**TCFG)))
    p, s, metrics = params, opt.init(params), []
    for i, batch in enumerate(batches):
        p, s, m = step(p, s, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.int32(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both groups' results, started as soon as their inputs exist, and the
    reference's, computed while the ranks run."""
    batches, cases = _inputs()
    jobs = {case: dict(kind="tp_step", cfg=c["cfg"], params=c["params"],
                       optimizer=c["optimizer"], batches=batches, tcfg=TCFG)
            for case, c in cases.items()}
    groups = {name: Ranks(world, jobs, str(tmp_path_factory.mktemp(f"tp_{name}")),
                          SPAWN_TIMEOUT_S, model=model)
              for name, (world, model) in MESHES.items()}
    reference = {case: _reference(c["ref_lm"], c["params"], batches, c["optimizer"])
                 for case, c in cases.items()}
    return batches, cases, reference, {name: g.results() for name, g in groups.items()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", list(CASES))
def test_tp_step_matches_the_reference_unsharded_step(case, mesh, run):
    _, cases, reference, results = run
    want_metrics, want_params = reference[case]
    got = [r[case] for r in results[mesh]]
    assert got[0]["split_leaves"] > 0
    cfg = cases[case]["cfg"]
    if cfg.n_heads:
        assert all(g["local_heads"] == cfg.n_heads // 2 for g in got)
        assert all(g["local_kv_heads"] == cfg.n_kv_heads // 2 for g in got)
    for i, want in enumerate(want_metrics):
        for g in got:  # every rank reports the global values
            m = g["metrics"][i]
            assert abs(m["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"]), (i, m, want)
            assert abs(m["grad_norm"] - want["grad_norm"]) <= 1e-4 * want["grad_norm"]
    for g in got[1:]:
        for a, b in zip(tree_leaves(g["params"]), tree_leaves(got[0]["params"])):
            assert np.array_equal(a, b)  # the ranks' gathered params are the same bits
    leaves = [np.asarray(x) for x in jax.tree.leaves(want_params)]
    atol = MOE_MLA_PARAM_ATOL if case in MOE_MLA else 1e-4
    for g, w in zip(tree_leaves(got[0]["params"]), leaves):
        assert g.shape == w.shape and np.abs(g - w).max() <= atol, (g.shape, np.abs(g - w).max())


@pytest.mark.parametrize("arch", ["qwen3-14b", "falcon-mamba-7b", "musicgen-medium",
                                  "deepseek-moe-16b", "deepseek-v2-236b"])
def test_drawn_blocks_are_the_whole_draw_s_blocks(arch):
    cfg = get_smoke_config(arch)
    whole = tree_from_lm(LM(cfg, "cpu").init_params(torch.Generator().manual_seed(3)))
    for coords in [(0, 0), (0, 1), (1, 0), (1, 1)]:
        mesh = StandInMesh((2, 2), ("data", "model"), coords=coords, device="cpu")
        rt = Runtime(mesh=mesh, rules=Rules.default(mesh))
        psh = port_trainer.param_shardings(port_trainer.train_lm(cfg, rt, "cpu"), rt)
        got = port_trainer.draw_blocks(cfg, psh, torch.Generator().manual_seed(3), "cpu")
        want = tree_leaves(reshard_tree(whole, psh))
        assert any(tuple(g.shape) != tuple(w.shape) for g, w in
                   zip(tree_leaves(got), tree_leaves(whole)))  # the rank holds blocks
        assert len(tree_leaves(got)) == len(want)
        for g, w in zip(tree_leaves(got), want):
            assert g.dtype == w.dtype == torch.float32 and torch.equal(g, w)


def test_one_rank_mesh_is_the_unmeshed_step_bit_for_bit(run, tmp_path):
    import torch.distributed as dist

    batches, cases, _, _ = run
    c = cases["falcon-mamba-7b"]
    runs = []
    init_distributed(0, 1, str(tmp_path / "rendezvous"), "cpu", verbose=False)
    try:
        mesh = make_debug_mesh(1, 1)
        for rt in (Runtime(block_q=16, block_k=16),
                   Runtime(block_q=16, block_k=16, mesh=mesh)):
            lm = lm_params_from_numpy(c["cfg"], c["params"], device="cpu").trainable()
            opt = port_opt.get_optimizer("adamw")
            step = port_trainer.make_train_step(lm, opt, port_trainer.TrainConfig(**TCFG), rt=rt)
            p = tree_from_numpy(c["params"], "cpu")
            s = opt.init(p)
            metrics = []
            for i, batch in enumerate(batches):
                p, s, m = step(p, s, batch, i)
                metrics.append(m)
            runs.append((metrics, tree_leaves(p) + tree_leaves(s)))
    finally:
        dist.destroy_process_group()
    (m0, s0), (m1, s1) = runs
    assert all(set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
               for a, b in zip(m0, m1))
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))
