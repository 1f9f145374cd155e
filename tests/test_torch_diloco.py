"""``make_diloco_inner_step`` (``repro_torch.training.trainer``) against the
reference's (``repro/training/trainer.py:117-141``), on the CPU: smoke
stablelm-1.6b cut to 2 layers in float32, 2 replicas of 2 rows each,
sequence 16, 2 inner steps at lr 1e-3, then ``outer_sync``.

* every replica's AdamW moments within 1e-5 of each leaf's largest of the
  reference's (its jitted ``vmap`` over the replica axis), its parameters
  within 1e-4 after the inner steps and after the sync (the single step's
  tolerance in ``tests/test_torch_fsdp.py``: AdamW's normalised update of
  a near-zero gradient moves an element by up to ~3e-5 between the
  packages); each step's metrics (a replica axis each) within 1e-5
  relative;
* each replica's result is the same bits as ``make_train_step`` alone on
  its rows: the replicas run one after the other and share nothing.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.data.pipeline import SyntheticTokens as RefTokens
from repro.models.model import LM as RefLM
from repro.models.runtime import Runtime as RefRuntime
from repro.training import optimizers as ref_opt
from repro.training import trainer as ref_trainer
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy, tree_from_numpy
from repro_torch.models.runtime import Runtime
from repro_torch.training import optimizers as port_opt
from repro_torch.training import trainer as port_trainer
from repro_torch.training.tree import tree_leaves, tree_map

ARCH, SEQ, ROWS, REPLICAS, STEPS = "stablelm-1.6b", 16, 2, 2, 2
TCFG = dict(learning_rate=1e-3, warmup_steps=0, total_steps=10)


def _inputs():
    cut = dict(n_layers=2, dtype="float32")
    ref_cfg = dataclasses.replace(ref_smoke_config(ARCH), **cut)
    cfg = dataclasses.replace(get_smoke_config(ARCH), **cut)
    ref_lm = RefLM(ref_cfg, RefRuntime(remat="none", block_q=16, block_k=16))
    params, _ = ref_lm.init(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    data = RefTokens(256, SEQ, ROWS * REPLICAS, seed=0)
    batches = [{k: v.reshape(REPLICAS, ROWS, *v.shape[1:]) for k, v in data.next_batch().items()}
               for _ in range(STEPS)]
    return cfg, ref_lm, params, batches


def _reference(ref_lm, params, batches):
    opt = ref_opt.get_optimizer("adamw")
    inner, outer_sync = ref_trainer.make_diloco_inner_step(
        ref_lm, opt, ref_trainer.TrainConfig(**TCFG), REPLICAS)
    inner = jax.jit(inner)
    p = jax.tree.map(lambda x: jnp.stack([x] * REPLICAS), params)
    s = jax.vmap(opt.init)(p)
    metrics = []
    for i, batch in enumerate(batches):
        p, s, m = inner(p, s, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.int32(i))
        metrics.append({k: np.asarray(v) for k, v in m.items()})
    synced = outer_sync(p)
    return metrics, [jax.tree.map(np.asarray, t) for t in (p, s, synced)]


def _port(cfg, params, batches):
    lm = lm_params_from_numpy(cfg, params, device="cpu").trainable()
    opt = port_opt.get_optimizer("adamw")
    tcfg = port_trainer.TrainConfig(**TCFG)
    inner, outer_sync = port_trainer.make_diloco_inner_step(lm, opt, tcfg, REPLICAS,
                                                            rt=Runtime(block_q=16, block_k=16))
    one = tree_from_numpy(params, "cpu")
    p = tree_map(lambda x: torch.stack([x] * REPLICAS), one)
    s = tree_map(lambda *xs: torch.stack(xs), *[opt.init(one) for _ in range(REPLICAS)])
    metrics = []
    for i, batch in enumerate(batches):
        p, s, m = inner(p, s, batch, i)
        metrics.append(m)
    # each replica alone through make_train_step on its rows
    step = port_trainer.make_train_step(lm, opt, tcfg, rt=Runtime(block_q=16, block_k=16))
    alone = []
    for r in range(REPLICAS):
        pr, sr = one, opt.init(one)
        for i, batch in enumerate(batches):
            pr, sr, _ = step(pr, sr, {k: v[r] for k, v in batch.items()}, i)
        alone.append((pr, sr))
    return metrics, p, s, outer_sync(p), alone


def test_diloco_inner_step_and_outer_sync_match_the_reference():
    cfg, ref_lm, params, batches = _inputs()
    want_metrics, (want_p, want_s, want_synced) = _reference(ref_lm, params, batches)
    metrics, p, s, synced, alone = _port(cfg, params, batches)
    for got, want in zip(metrics, want_metrics):
        for k in ("loss", "grad_norm", "ce"):
            g, w = got[k].numpy(), want[k]
            assert g.shape == w.shape == (REPLICAS,)
            assert np.all(np.abs(g - w) <= 1e-5 * np.abs(w)), (k, g, w)
    for got, want in ((s["mu"], want_s["mu"]), (s["nu"], want_s["nu"])):
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            g, w = g.numpy(), np.asarray(w)
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max() + 1e-12
    # the parameters as tests/test_torch_fsdp.py holds the single step's:
    # AdamW's normalised update of a near-zero gradient moves an element by
    # up to ~3e-5 between the packages (measured 3.05e-5 here)
    for got, want in ((p, want_p), (synced, want_synced)):
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            g, w = g.numpy(), np.asarray(w)
            assert g.shape == w.shape and np.abs(g - w).max() <= 1e-4
    for leaf in tree_leaves(synced):  # the mean on every replica
        assert torch.equal(leaf[0], leaf[1])
    for r, (pr, sr) in enumerate(alone):
        for a, b in zip(tree_leaves(p) + tree_leaves(s), tree_leaves(pr) + tree_leaves(sr)):
            assert torch.equal(a[r], b)
