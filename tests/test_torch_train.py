"""Port parity: LM training (``LM.loss_fn``, the optimizers, ``make_train_step``,
the data pipeline and the trainer CLI) against the JAX package, at the smoke
configs cut to 2 layers, in float32, the reference's weights converted
through numpy.

falcon-mamba-7b trains through the selective scan's plain backward,
deepseek-moe-16b through the MoE's training capacity, whose drops the test
sees happen, and its router aux loss; deepseek-v2-236b through MLA (the
flash backward at unequal key and value dims, (24, 16) in the smoke
config) and the same MoE; jamba through its smoke period of 8 layers
(Mamba, attention at position 4, top-2 MoE on the odd layers, which a cut
to 2 layers would not keep).  In bf16 jamba's top-2 routing flips at near
ties against the reference's (ROADMAP.md, queue 3), so there a step's loss,
aux and gradients are held to be the same bits twice.

Tolerances, float32 throughout:
* the loss, and the aux loss, within 1e-5 of the loss, and every gradient
  leaf within 1e-4 of the leaf's max |g| (the same arithmetic summed in
  another order: measured about 1e-6 of it);
* the remat modes the same function: loss and gradients within 1e-6 of
  max |g| of ``remat="none"``'s;
* train steps: loss within 1e-5 relative, grad_norm within 1e-4 relative,
  lr within 1e-7 relative.  Parameters are bounded in units of the step's
  lr: Adam's first steps move a weight by about lr * sign(g), so where an
  entry of g is near 0 (within the two frameworks' rounding of it) the two
  may step opposite ways, 2 lr apart, and later steps carry that on.  So
  every parameter within 2 lr per step taken, and all but 1% of them within
  1e-3 lr (the rounding of the rest).  Adafactor divides by a factored
  second moment, whose sign flips cost the same: the same bounds;
* the optimizers alone, on the same gradient trees: within 1e-6 relative;
* the data pipeline: the same batches exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.data.pipeline import SyntheticTokens as RefTokens
from repro.models.model import LM as RefLM
from repro.models.runtime import Runtime as RefRuntime
from repro.training import optimizers as ref_opt
from repro.training import trainer as ref_trainer
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy, tree_from_lm, tree_from_numpy, tree_to_numpy
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch import train as train_cli
from repro_torch.models import moe as port_moe
from repro_torch.models.model import LM
from repro_torch.models.runtime import Runtime
from repro_torch.training import optimizers as port_opt
from repro_torch.training import trainer as port_trainer
from repro_torch.training.tree import tree_leaves

ARCHS = ["stablelm-1.6b", "qwen3-14b", "falcon-mamba-7b", "deepseek-moe-16b",
         "deepseek-v2-236b", "jamba-1.5-large-398b"]
JAMBA = "jamba-1.5-large-398b"
RT = Runtime(block_q=16, block_k=16)
SEQ, BATCH = 32, 4


def _layers(arch):
    """2 layers, or one whole period where it is longer (jamba's 8)."""
    return max(2, len(get_smoke_config(arch).period))


def _models(arch):
    ref_cfg = dataclasses.replace(ref_smoke_config(arch), n_layers=_layers(arch), dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(arch), n_layers=_layers(arch), dtype="float32")
    ref = RefLM(ref_cfg, RefRuntime(remat="none", block_q=16, block_k=16))
    params, _ = ref.init(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    port = lm_params_from_numpy(cfg, params, device="cpu").trainable()
    return ref, params, port


def _batches(n, batch=BATCH):
    data = RefTokens(256, SEQ, batch, seed=0)
    return [data.next_batch() for _ in range(n)]


def _leaf_pairs(got_tree, want_tree):
    got = tree_leaves(tree_to_numpy(got_tree))
    want = [np.asarray(x) for x in jax.tree.leaves(want_tree)]
    assert len(got) == len(want)
    return zip(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, monkeypatch):
    ref, params, port = _models(arch)
    loads = []  # (tokens routed to each expert, capacity) of each MoE dispatch
    dispatch = port_moe.dispatch_compute_combine

    def counting_dispatch(xt, ids, probs, wg, wu, wd, cap=None):
        loads.append((torch.bincount(ids.reshape(-1), minlength=wg.shape[0]), cap))
        return dispatch(xt, ids, probs, wg, wu, wd, cap)

    monkeypatch.setattr(port_moe, "dispatch_compute_combine", counting_dispatch)
    batch = _batches(1)[0]
    (want_loss, want_aux), want_g = jax.jit(jax.value_and_grad(ref.loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads = {}
    for remat in ("none", "full", "dots"):
        loss, aux = port.loss_fn(tb, dataclasses.replace(RT, remat=remat))
        loss.backward()
        loss = loss.detach()
        grads[remat] = tree_from_lm(port, grads=True)
        port.zero_grad(set_to_none=True)
        assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
        ce = float(aux["ce"].detach())
        assert abs(ce - float(want_aux["ce"])) <= 1e-5 * abs(float(want_loss))
        got_aux = float(aux["aux"].detach())
        assert abs(got_aux - float(want_aux["aux"])) <= 1e-5 * abs(float(want_loss))
        assert float(aux["tokens"]) == float(want_aux["tokens"])
    if port.cfg.moe is not None:  # the training capacity drops tokens here
        assert float(want_aux["aux"]) > 0 and loads
        assert any(int(counts.max()) > cap for counts, cap in loads)
    for got, want in _leaf_pairs(grads["none"], want_g):
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 1e-4 * scale + 1e-12, (got.shape, scale)
    for remat in ("full", "dots"):
        for got, want in zip(tree_leaves(grads[remat]), tree_leaves(grads["none"])):
            assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max()) + 1e-12


def _bounded_in_lr(got, want, lr_sum):
    for g, w in _leaf_pairs(got, want):
        err = np.abs(g - w)
        assert err.max() <= 2 * lr_sum + 1e-7, (g.shape, err.max(), lr_sum)
        assert np.mean(err > 1e-3 * lr_sum) <= 0.01, (g.shape, np.mean(err > 1e-3 * lr_sum))


@pytest.mark.parametrize("name, steps", [("adamw", 3), ("adafactor", 1)])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_reference(name, steps, microbatches):
    ref, params, port = _models("qwen3-14b")
    kw = dict(learning_rate=1e-2, warmup_steps=0, total_steps=10, microbatches=microbatches)
    ref_step = jax.jit(ref_trainer.make_train_step(ref, ref_opt.get_optimizer(name),
                                                   ref_trainer.TrainConfig(**kw)))
    step = port_trainer.make_train_step(port, port_opt.get_optimizer(name),
                                        port_trainer.TrainConfig(**kw), rt=RT)
    opt = port_opt.get_optimizer(name)
    p_ref, s_ref = params, ref_opt.get_optimizer(name).init(params)
    p, s = tree_from_numpy(params, "cpu"), opt.init(tree_from_numpy(params, "cpu"))
    lr_sum = 0.0
    for i, batch in enumerate(_batches(steps)):
        p_ref, s_ref, want = ref_step(p_ref, s_ref, {k: jnp.asarray(v) for k, v in batch.items()},
                                      jnp.int32(i))
        p, s, got = step(p, s, batch, i)
        assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-5 * abs(float(want["loss"]))
        assert abs(float(got["grad_norm"]) - float(want["grad_norm"])) <= \
            1e-4 * float(want["grad_norm"])
        assert abs(float(got["lr"]) - float(want["lr"])) <= 1e-7 * float(want["lr"])
        assert set(got) == set(want)
        lr_sum += float(want["lr"])
    _bounded_in_lr(p, p_ref, lr_sum)
    assert int(s["count"]) == int(s_ref["count"]) == steps


def _random_tree(seed):
    rng = np.random.RandomState(seed)
    return {"embed": rng.randn(16, 8).astype(np.float32),
            "final_norm": rng.randn(8).astype(np.float32),
            "periods": {"pos0": {"ln1": rng.randn(2, 8).astype(np.float32),
                                 "mixer": {"wq": rng.randn(2, 8, 12).astype(np.float32)}}}}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_update_matches_reference(name):
    params, grads = _random_tree(0), _random_tree(1)
    ref = ref_opt.get_optimizer(name)
    want_p, want_s = ref.update(grads, ref.init(params), params, jnp.float32(3e-3))
    want_p, want_s = ref.update(grads, want_s, want_p, jnp.float32(2e-3))  # a second step
    opt = port_opt.get_optimizer(name)
    tp, tg = tree_from_numpy(params, "cpu"), tree_from_numpy(grads, "cpu")
    got_p, got_s = opt.update(tg, opt.init(tp), tp, torch.tensor(3e-3))
    got_p, got_s = opt.update(tg, got_s, got_p, torch.tensor(2e-3))
    for got, want in list(_leaf_pairs(got_p, want_p)) + list(_leaf_pairs(got_s, want_s)):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


def test_clip_by_global_norm_matches_reference():
    tree = _random_tree(2)
    for max_norm in (0.5, 1e3):
        want, want_norm = ref_opt.clip_by_global_norm(tree, max_norm)
        got, got_norm = port_opt.clip_by_global_norm(tree_from_numpy(tree, "cpu"), max_norm)
        np.testing.assert_allclose(float(got_norm), float(want_norm), rtol=1e-6)
        for g, w in _leaf_pairs(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-9)
    assert port_opt.default_optimizer_for(int(50e9)) == "adafactor"
    assert port_opt.default_optimizer_for(int(1.6e9)) == "adamw"
    with pytest.raises(ValueError):
        port_opt.get_optimizer("sgd")


def test_lr_schedule_and_rescale_match_reference():
    cfg = port_trainer.TrainConfig(learning_rate=1e-3, warmup_steps=5, total_steps=20)
    ref_cfg = ref_trainer.TrainConfig(learning_rate=1e-3, warmup_steps=5, total_steps=20)
    for s in (0, 3, 5, 12, 20, 25):
        assert float(port_trainer.lr_schedule(cfg, s)) == pytest.approx(
            float(ref_trainer.lr_schedule(ref_cfg, jnp.int32(s))), rel=1e-6, abs=1e-12)
    got = port_trainer.rescaled_config(cfg, 2.0, local_steps=4)
    want = ref_trainer.rescaled_config(ref_cfg, 2.0, local_steps=4)
    assert (got.learning_rate, got.local_steps) == (want.learning_rate, want.local_steps)


def test_data_pipeline_matches_reference():
    ref, port = RefTokens(256, 24, 3, seed=7), SyntheticTokens(256, 24, 3, seed=7)
    for _ in range(3):
        want, got = ref.next_batch(), port.next_batch()
        assert set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)
    state = port.state_dict()
    assert state == ref.state_dict()
    ref2, port2 = RefTokens(256, 24, 3, seed=7), SyntheticTokens(256, 24, 3, seed=7)
    ref2.load_state_dict(state)
    port2.load_state_dict(state)
    want, got = ref2.next_batch(), port2.next_batch()
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert np.array_equal(got["tokens"], ref.next_batch()["tokens"])


def test_trainer_cli_on_the_cpu(tmp_path):
    """The CLI trains, plain and with ``--compression`` (whose metrics are
    the reference's compression path's, loss and grad_norm); ``--chaos``
    runs the LM chaos loop on a generated trace (tests/test_torch_chaos_lm.py
    holds both against the JAX package)."""
    common = ["--arch", "stablelm-1.6b", "--smoke", "--steps", "3", "--seq-len", "16",
              "--global-batch", "2", "--device", "cpu"]
    last = train_cli.main(common)
    assert np.isfinite(last["loss"]) and np.isfinite(last["grad_norm"])
    last = train_cli.main(common + ["--compression", "int8"])
    assert set(last) == {"loss", "grad_norm", "step_time"} and np.isfinite(last["loss"])
    log = train_cli.main(common + ["--chaos", str(tmp_path / "trace.json"),
                                   "--ckpt-dir", str(tmp_path / "ckpt")])
    assert len(log.rows) == 3 and (tmp_path / "trace.json").exists()


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "deepseek-moe-16b", "deepseek-v2-236b",
                                  JAMBA, "musicgen-medium"])
def test_trainer_cli_trains_mamba_and_moe_on_the_cpu(arch, capsys):
    """The CLI trains the archs (smoke): Mamba, MoE, MLA with MoE, jamba's
    hybrid period, and a frontend arch on the pipeline's embeddings; the
    aux loss reaches the step records and the CLI's final line, as the
    reference's trainer logs it: the MoE router's, 0 without MoE."""
    last = train_cli.main(["--arch", arch, "--smoke", "--steps", "2", "--seq-len", "16",
                           "--global-batch", "2", "--device", "cpu"])
    assert np.isfinite(last["loss"]) and np.isfinite(last["grad_norm"])
    assert (last["aux"] > 0) == (get_smoke_config(arch).moe is not None)
    assert last["loss"] == pytest.approx(last["ce"] + last["aux"], rel=1e-6)
    assert "'aux'" in capsys.readouterr().out


def test_jamba_bf16_step_gradient_is_the_same_bits_twice():
    """jamba's smoke period in its bf16 config: one step's loss, aux and
    every gradient, taken twice from the same weights and batch, the same
    bits (the dispatch's gradient sums in a fixed order)."""
    lm = LM(get_smoke_config(JAMBA), device="cpu").init_params(
        torch.Generator().manual_seed(0)).trainable()
    batch = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    runs = []
    for _ in range(2):
        loss, aux = lm.loss_fn(batch, RT)
        loss.backward()
        runs.append((loss.detach(), aux["aux"].detach(), [p.grad.clone() for p in lm.parameters()]))
        lm.zero_grad(set_to_none=True)
    (l1, a1, g1), (l2, a2, g2) = runs
    assert float(a1) > 0 and torch.isfinite(l1)
    assert torch.equal(l1, l2) and torch.equal(a1, a2)
    assert all(torch.equal(x, y) for x, y in zip(g1, g2))
