"""Gradient compression in the port (``repro_torch.compression.gradient``
and the trainer's ``--compression`` path) against the JAX package, on the
CPU in float32.

* The round trips on seeded numpy leaves (a matrix, a 3-D leaf, a vector,
  values with exact ties and halves of the quantisation step):
  ``topk_roundtrip`` bit for bit (the same threshold, ties kept);
  ``int8_roundtrip`` bit for bit (the scale, the division by it and the
  rounding half to even are the same float32 operations);
  ``powersgd_roundtrip`` within 1e-5 of the leaf's largest value: its QR
  may flip a column's sign against the reference's LAPACK, which leaves the
  approximation p p^T mat unchanged but not the carried q, so the
  approximations are compared, not q.
* ``GradientCompressor.compress`` over three steps of seeded gradient
  trees, carrying each package's own state: the compressed trees and the
  error-feedback residuals, bit for bit for int8 and topk, within 1e-5 of
  the largest entry of the leaf compressed (gradient plus residual) for
  powersgd.
* The trainer with each scheme against the reference's unsharded
  ``Trainer`` with the same scheme (its ``train_some`` compression path,
  ``repro/launch/train.py:133-147``, under one ``jax.jit``), from the
  reference's weights, on the smoke stablelm-1.6b in float32: losses and
  grad norms within 1e-4 relative over 3 steps.  One reference run a
  scheme, module-scoped.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.train as ref_train
from repro.compression import gradient as ref_gc
from repro_torch.compression import gradient as gc
from repro_torch.configs import get_smoke_config
from repro_torch.convert import tree_from_numpy, tree_to_numpy
from repro_torch.launch.train import Trainer, TrainerOptions
from repro_torch.training.tree import tree_leaves

SCHEMES = ["int8", "topk", "powersgd"]
STEPS, SEQ, BATCH = 3, 16, 4
POWERSGD_ATOL_OF_MAX = 1e-5


def _leaves(seed):
    rng = np.random.RandomState(seed)
    ties = np.repeat(rng.randn(10).astype(np.float32), 4).reshape(8, 5)
    halves = (np.arange(-20, 21, dtype=np.float32) / 40.0 * 127.0 / 127.5).reshape(41)
    return [rng.randn(24, 40).astype(np.float32), rng.randn(3, 16, 12).astype(np.float32),
            rng.randn(50).astype(np.float32), ties, halves]


def _tree(seed):
    a, b, c, d, e = _leaves(seed)
    return {"w": a, "stack": b, "bias": c, "head_layers": ({"ties": d}, {"halves": e})}


def test_round_trips_match_the_reference():
    for seed in range(3):
        for g in _leaves(seed):
            want = np.asarray(ref_gc.int8_roundtrip(jnp.asarray(g)))
            assert np.array_equal(gc.int8_roundtrip(torch.from_numpy(g)).numpy(), want)
            for ratio in (0.05, 0.3):
                want = np.asarray(ref_gc.topk_roundtrip(jnp.asarray(g), ratio))
                got = gc.topk_roundtrip(torch.from_numpy(g), ratio).numpy()
                assert np.array_equal(got, want)
            want, _ = ref_gc.powersgd_roundtrip(jnp.asarray(g), None, 4)
            got, q = gc.powersgd_roundtrip(torch.from_numpy(g), None, 4)
            assert np.abs(got.numpy() - np.asarray(want)).max() <= \
                POWERSGD_ATOL_OF_MAX * np.abs(g).max()
            assert (q is None) == (g.ndim < 2)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_compressor_over_three_steps_matches_the_reference(scheme):
    ref = ref_gc.GradientCompressor(ref_gc.CompressionConfig(scheme=scheme))
    port = gc.GradientCompressor(gc.CompressionConfig(scheme=scheme))
    ref_state = ref.init_state(_tree(0))
    state = port.init_state(tree_from_numpy(_tree(0), "cpu"))
    for step in range(STEPS):
        grads = _tree(10 + step)
        want, ref_state = ref.compress(grads, ref_state)
        got, state = port.compress(tree_from_numpy(grads, "cpu"), state)
        for g, w, ge, we in zip(tree_leaves(tree_to_numpy(got)), tree_leaves(want),
                                tree_leaves(tree_to_numpy(state["ef"])),
                                tree_leaves(ref_state["ef"])):
            w, we = np.asarray(w), np.asarray(we)
            if scheme == "powersgd":  # of the leaf compressed: g + ef = comp + new ef
                scale = POWERSGD_ATOL_OF_MAX * np.abs(w + we).max()
                assert np.abs(g - w).max() <= scale and np.abs(ge - we).max() <= scale
            else:
                assert np.array_equal(g, w) and np.array_equal(ge, we), (scheme, step, g.shape)
    assert port.compressed_bytes_ratio() == ref.compressed_bytes_ratio()


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _reference_steps(t, n):
    """``n`` steps of the reference Trainer ``t``'s compression path, the
    body of its ``train_some`` (``repro/launch/train.py:133-147``) under one
    ``jax.jit``: run eagerly it takes about 10 s for a first step on this
    CPU.  Returns each step's loss and grad norm."""
    import jax

    from repro.training.optimizers import clip_by_global_norm
    from repro.training.trainer import lr_schedule

    @jax.jit
    def body(params, opt_state, comp_state, batch, step):
        (loss, _), grads = jax.value_and_grad(t.lm.loss_fn, has_aux=True)(params, batch)
        grads, comp_state = t.compressor.compress(grads, comp_state)
        grads, gnorm = clip_by_global_norm(grads, t.tcfg.grad_clip)
        lr = lr_schedule(t.tcfg, step)
        params, opt_state = t.opt.update(grads, opt_state, params, lr)
        return params, opt_state, comp_state, loss, gnorm

    out = []
    for _ in range(n):
        batch = {k: jnp.asarray(v) for k, v in t.data.next_batch().items()}
        t.params, t.opt_state, t.comp_state, loss, gnorm = body(
            t.params, t.opt_state, t.comp_state, batch, jnp.float32(t.step))
        t.step += 1
        out.append({"loss": float(loss), "grad_norm": float(gnorm)})
    return out


@pytest.fixture(scope="module")
def reference_runs():
    """Per scheme: the reference Trainer's initial params and optimizer
    state, and its 3 steps' losses and grad norms (the smoke stablelm in
    float32)."""
    out = {}
    real = ref_train.get_smoke_config
    ref_train.get_smoke_config = lambda arch: _f32(real(arch))
    try:
        for scheme in SCHEMES:
            t = ref_train.Trainer(ref_train.TrainerOptions(
                arch="stablelm-1.6b", smoke=True, steps=10, seq_len=SEQ, global_batch=BATCH,
                compression=scheme, log_every=0))
            start = (_np(t.params), _np(t.opt_state))
            out[scheme] = start, _reference_steps(t, STEPS)
    finally:
        ref_train.get_smoke_config = real
    return out


def _np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_trainer_with_compression_matches_the_reference(scheme, reference_runs):
    (params, opt_state), want = reference_runs[scheme]
    t = Trainer(TrainerOptions(arch="stablelm-1.6b", smoke=True, steps=10, seq_len=SEQ,
                               global_batch=BATCH, compression=scheme, log_every=0, device="cpu",
                               cfg=_f32(get_smoke_config("stablelm-1.6b"))))
    t.set_state(tree_from_numpy(params, "cpu"), tree_from_numpy(opt_state, "cpu"))
    for w in want:
        got = t.train_some(1)
        assert set(got) == {"loss", "grad_norm", "step_time"}
        assert abs(got["loss"] - w["loss"]) <= 1e-4 * abs(w["loss"])
        assert abs(got["grad_norm"] - w["grad_norm"]) <= 1e-4 * w["grad_norm"]
