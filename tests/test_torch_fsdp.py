"""The port's trainer on a data mesh (FSDP over "data", ``Rules.default``:
``repro_torch.training.trainer``, the loss shares of ``LM.loss_fn`` and
``models/moe.py``, the data group's collectives) against the JAX package,
on the CPU: two ranks, one process each, over gloo, float32 smoke configs
cut to 2 layers, sequence 16, global batch 4 (two rows a rank).

The reference's own sharded step fails on this host's JAX (the embedding
gather raises ``ShardingTypeError``, as its sharded serve engine does), and
GSPMD makes that step one computation over the global batch; so the port's
2-rank step is held against the reference's unsharded ``make_train_step``
on the same global batch:

* stablelm-1.6b (AdamW and Adafactor, whose statistics sum over the ranks
  where a dim is split), falcon-mamba-7b (Mamba) and deepseek-v2-236b (MLA,
  with its smoke MoE layer at a capacity factor of E / k, under which no
  token drops on either count: the reference's capacity counts the whole
  batch's tokens, the port's ``shard_map`` rule each rank's, so where a
  token drops the two steps differ by design; the MoE case below holds
  that rule): 2 steps at lr 1e-3, each step's loss within 1e-5 and grad
  norm within 1e-4 relative, the params gathered from the ranks within
  1e-4 of the reference's (measured within 2.2e-5), AdamW's moments within
  1e-5 of each leaf's largest;
* the master parameters placed as the ranks' blocks and gathered back: the
  same bits;
* deepseek-moe-16b: each rank's MoE output against the reference's
  local-path ``apply_moe`` on that rank's rows (capacity over those rows)
  within 1e-5 of its largest, with drops on at least one rank; the ranks'
  aux shares summed against the reference's ``_route`` aux on the whole
  batch within 1e-6 relative;
* ``Trainer(mesh=...)``: 3 steps as the port's unmeshed trainer's within
  1e-5, its checkpoint (whole leaves, written by rank 0) restored by an
  unmeshed trainer at data 1 bit for bit the ranks' gathered state, and a
  "model" axis of 2 refused by name;
* a (1, 1) mesh (a one-rank gloo group in this process): bit for bit the
  port's unmeshed step, and ``make_train_step(compressor=...)`` raises.

All the module's two-rank cases run in one spawned group (a module
fixture), each rank on one thread, its rendezvous file under a temporary
directory, never a fixed port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fsdp_ranks import Ranks
from repro.configs import get_smoke_config as ref_smoke_config
from repro.data.pipeline import SyntheticTokens as RefTokens
from repro.models import moe as ref_moe
from repro.models.model import LM as RefLM
from repro.models.runtime import Runtime as RefRuntime
from repro.training import optimizers as ref_opt
from repro.training import trainer as ref_trainer
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy, tree_from_numpy, tree_to_numpy
from repro_torch.launch.mesh import init_distributed, make_debug_mesh
from repro_torch.launch.train import Trainer, TrainerOptions
from repro_torch.models.runtime import Runtime
from repro_torch.training import optimizers as port_opt
from repro_torch.training import trainer as port_trainer
from repro_torch.training.tree import tree_leaves

SEQ, BATCH, WORLD, STEPS = 16, 4, 2, 2
TCFG = dict(learning_rate=1e-3, warmup_steps=0, total_steps=10)
SPAWN_TIMEOUT_S = 240
MOE = "deepseek-moe-16b"
CASES = {"stablelm-adamw": ("stablelm-1.6b", "adamw"),
         "stablelm-adafactor": ("stablelm-1.6b", "adafactor"),
         "mamba-adamw": ("falcon-mamba-7b", "adamw"),
         "mla-adamw": ("deepseek-v2-236b", "adamw")}
TRAINER_OPTS = dict(arch="stablelm-1.6b", smoke=True, steps=10, seq_len=SEQ,
                    global_batch=BATCH, log_every=0)


def _no_drop(cfg):
    """deepseek-v2's smoke MoE at capacity factor E / k: capacity = the
    dispatch's tokens, on the whole batch and on a rank's rows alike."""
    if cfg.moe is None:
        return cfg
    moe = dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.n_routed_experts /
                              cfg.moe.top_k)
    return dataclasses.replace(cfg, moe=moe)


def _configs(arch):
    ref = _no_drop(dataclasses.replace(ref_smoke_config(arch), n_layers=2, dtype="float32"))
    port = _no_drop(dataclasses.replace(get_smoke_config(arch), n_layers=2, dtype="float32"))
    return ref, port


def _reference_params(ref_cfg):
    lm = RefLM(ref_cfg, RefRuntime(remat="none", block_q=16, block_k=16))
    params, _ = lm.init(jax.random.PRNGKey(0))
    return lm, jax.tree.map(np.asarray, params)


def _batches(n):
    data = RefTokens(256, SEQ, BATCH, seed=0)
    return [data.next_batch() for _ in range(n)]


def _reference_steps(ref_lm, params, name, batches):
    opt = ref_opt.get_optimizer(name)
    step = jax.jit(ref_trainer.make_train_step(ref_lm, opt, ref_trainer.TrainConfig(**TCFG)))
    p, s, metrics = params, opt.init(params), []
    for i, batch in enumerate(batches):
        p, s, m = step(p, s, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.int32(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s)


def _inputs():
    """The reference's weights of each case, the MoE layer's input and the
    smoke trainer's start state."""
    out = {"batches": _batches(STEPS), "cases": {}}
    for case, (arch, name) in CASES.items():
        ref_cfg, cfg = _configs(arch)
        ref_lm, params = _reference_params(ref_cfg)
        out["cases"][case] = dict(cfg=cfg, params=params, optimizer=name, ref_lm=ref_lm)
    ref_cfg = dataclasses.replace(ref_smoke_config(MOE), dtype="float32")
    _, params = _reference_params(ref_cfg)
    x = np.random.RandomState(0).randn(BATCH, SEQ, ref_cfg.d_model).astype(np.float32)
    out["moe"] = dict(cfg=dataclasses.replace(get_smoke_config(MOE), dtype="float32"),
                      ref_cfg=ref_cfg, params=params, x=x)
    tcfg = dataclasses.replace(get_smoke_config("stablelm-1.6b"), n_layers=2, dtype="float32")
    t = Trainer(TrainerOptions(**TRAINER_OPTS, device="cpu", cfg=tcfg))
    out["trainer"] = dict(cfg=tcfg, params=tree_to_numpy(t.params),
                          opt_state=tree_to_numpy(t.opt_state), unmeshed=t)
    return out


def _jobs(inputs):
    jobs = {case: dict(kind="step", cfg=c["cfg"], params=c["params"], optimizer=c["optimizer"],
                       batches=inputs["batches"], tcfg=TCFG)
            for case, c in inputs["cases"].items()}
    m = inputs["moe"]
    jobs["moe"] = dict(kind="moe", cfg=m["cfg"], params=m["params"], x=m["x"], layer=1)
    t = inputs["trainer"]
    jobs["trainer"] = dict(kind="trainer", opts=dict(TRAINER_OPTS, cfg=t["cfg"]), steps=3,
                           params=tree_from_numpy(t["params"], "cpu"),
                           opt_state=tree_from_numpy(t["opt_state"], "cpu"))
    return jobs


def _reference(inputs):
    """What the ranks are held against: the reference's unsharded steps of
    each case, its MoE on each rank's rows and its aux on the whole batch,
    and the port's unmeshed trainer's 3 steps."""
    out = {"cases": {case: _reference_steps(c["ref_lm"], c["params"], c["optimizer"],
                                            inputs["batches"])
                     for case, c in inputs["cases"].items()}}
    m = inputs["moe"]
    p1 = jax.tree.map(lambda a: a[0], m["params"]["periods"]["pos0"]["ffn"])  # layer 1, a MoE
    rows = BATCH // WORLD
    out["moe_y"] = [np.asarray(ref_moe.apply_moe(p1, jnp.asarray(m["x"][r * rows:(r + 1) * rows]),
                                                 m["ref_cfg"], train=True)[0])
                    for r in range(WORLD)]
    out["moe_aux"] = float(ref_moe._route(p1, jnp.asarray(m["x"]), m["ref_cfg"], True)[2])
    t = inputs["trainer"]["unmeshed"]
    t.train_some(3)
    out["history"] = t.history
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two ranks' results, started as soon as their inputs exist, and
    the reference's, computed while the ranks run."""
    inputs = _inputs()
    workdir = tmp_path_factory.mktemp("fsdp_ranks")
    ranks = Ranks(WORLD, _jobs(inputs), str(workdir), SPAWN_TIMEOUT_S)
    reference = _reference(inputs)
    return inputs, reference, ranks.results(), workdir


def _pairs(got_tree, want_tree):
    got = [np.asarray(x) for x in tree_leaves(got_tree)]
    want = [np.asarray(x) for x in jax.tree.leaves(want_tree)]
    assert len(got) == len(want)
    return zip(got, want)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_the_reference_unsharded_step(case, run):
    inputs, reference, results, _ = run
    want_metrics, want_params, want_state = reference["cases"][case]
    got = [r[case] for r in results]
    assert all(g["regathered_same"] for g in got)
    assert got[0]["split_leaves"] > 0  # FSDP split some leaves over "data"
    for i, want in enumerate(want_metrics):
        for g in got:  # every rank reports the global values
            m = g["metrics"][i]
            assert abs(m["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"]), (i, m, want)
            assert abs(m["grad_norm"] - want["grad_norm"]) <= 1e-4 * want["grad_norm"]
            assert abs(m["ce"] - want["ce"]) <= 1e-5 * abs(want["loss"])
            assert m["tokens"] == want["tokens"] == BATCH * SEQ
    for a, b in zip(tree_leaves(got[0]["params"]), tree_leaves(got[1]["params"])):
        assert np.array_equal(a, b)  # the ranks' gathered params are the same bits
    for g, w in _pairs(got[0]["params"], want_params):
        assert np.abs(g - w).max() <= 1e-4, (g.shape, np.abs(g - w).max())
    if inputs["cases"][case]["optimizer"] == "adamw":
        for key in ("mu", "nu"):
            for g, w in _pairs(got[0]["opt_state"][key], want_state[key]):
                assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max() + 1e-12


def test_moe_capacity_over_a_ranks_rows_and_aux_over_the_batch(run):
    inputs, reference, results, _ = run
    want_aux = reference["moe_aux"]
    got = [r["moe"] for r in results]
    drops = 0
    for g, w in zip(got, reference["moe_y"]):
        assert np.abs(g["y"] - w).max() <= 1e-5 * np.abs(w).max()
        (counts, cap), = g["loads"]
        # the capacity of the rank's rows, not of the whole batch's
        assert cap == ref_moe._capacity(BATCH // WORLD * SEQ, inputs["moe"]["ref_cfg"].moe, True)
        drops += int(np.maximum(counts - cap, 0).sum())
    assert drops > 0, "no token dropped: the capacity rule is not exercised"
    assert got[0]["aux_sum"] == got[1]["aux_sum"]
    assert abs(got[0]["aux"] + got[1]["aux"] - want_aux) <= 1e-6 * want_aux
    assert abs(got[0]["aux_sum"] - want_aux) <= 1e-6 * want_aux


def test_mesh_trainer_and_its_checkpoint_at_data_one(run):
    inputs, reference, results, workdir = run
    want = reference["history"]
    got = [r["trainer"] for r in results]
    for g in got:
        assert [s for s, _ in g["history"]] == [s for s, _ in want]
        for (_, a), (_, b) in zip(g["history"], want):
            assert abs(a - b) <= 1e-5 * abs(b)
        assert "the trainer's tensor parallelism" in g["tp_refused"]
    # the ranks' checkpoint (whole leaves) restored at data 1, no mesh
    t = Trainer(TrainerOptions(**TRAINER_OPTS, device="cpu", cfg=inputs["trainer"]["cfg"],
                               ckpt_dir=str(workdir / "ckpt")))
    assert t.restore() and t.step == got[0]["step"] == 3
    for a, b in zip(tree_leaves(tree_to_numpy(t.params)) + tree_leaves(tree_to_numpy(t.opt_state)),
                    tree_leaves(got[0]["params"]) + tree_leaves(got[0]["opt_state"])):
        assert np.array_equal(a, b)


def test_one_rank_mesh_is_the_unmeshed_step_bit_for_bit(run, tmp_path):
    import torch.distributed as dist

    inputs = run[0]
    c = inputs["cases"]["stablelm-adafactor"]
    batches = inputs["batches"]
    runs = []
    init_distributed(0, 1, str(tmp_path / "rendezvous"), "cpu", verbose=False)
    try:
        mesh = make_debug_mesh(1, 1)
        for rt in (Runtime(block_q=16, block_k=16),
                   Runtime(block_q=16, block_k=16, mesh=mesh)):
            lm = lm_params_from_numpy(c["cfg"], c["params"], device="cpu").trainable()
            opt = port_opt.get_optimizer("adafactor")
            step = port_trainer.make_train_step(lm, opt, port_trainer.TrainConfig(**TCFG), rt=rt)
            p = tree_from_numpy(c["params"], "cpu")
            s = opt.init(p)
            metrics = []
            for i, batch in enumerate(batches):
                p, s, m = step(p, s, batch, i)
                metrics.append(m)
            runs.append((metrics, tree_leaves(p) + tree_leaves(s)))
        with pytest.raises(TypeError, match="GradientCompressor.apply"):
            port_trainer.make_train_step(lm, opt, port_trainer.TrainConfig(), compressor=object())
    finally:
        dist.destroy_process_group()
    (m0, s0), (m1, s1) = runs
    assert all(set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
               for a, b in zip(m0, m1))
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))
