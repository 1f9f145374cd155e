"""Port parity: the MoE FFN's training semantics (``repro_torch/models/moe.py``
with ``train=True``) against ``repro.models.moe``: the Switch/GShard
capacity, the router's ids, probabilities and load-balance aux loss, the
dispatch at a capacity that drops tokens (forward and gradient), and
``apply_moe(train=True)`` with its aux, at the smoke deepseek-moe-16b's
widths (d_model 64, 8 experts of d_ff 64, top-2, one shared expert) and a
wider routing (32 experts, top-6, two shared), in float32.

Tolerances: the same arithmetic (router, top-k, the experts' products, the
float32 combine in the reference's order) with the products summed in
another order, so values within 1e-5 of the largest magnitude and gradients
within 1e-4 of each leaf's largest (``tests/test_torch_train.py``'s bound);
the routing (ids, and so which assignments drop) exactly.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import moe as ref_moe
from repro.models.param import split_tree
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe

ARCH = "deepseek-moe-16b"
RTOL, GRAD_RTOL = 1e-5, 1e-4
WIDE = dict(n_routed_experts=32, n_shared_experts=2, top_k=6)
CASES = [({}, 1.25), ({}, 0.5), (WIDE, 1.25), (WIDE, 0.5)]
IDS = ["smoke", "smoke-cf0.5", "wide", "wide-cf0.5"]


def _cfgs(capacity_factor=1.25, **moe_kw):
    moe_kw = dict(moe_kw, capacity_factor=capacity_factor)
    return tuple(dataclasses.replace(c, dtype="float32",
                                     moe=dataclasses.replace(c.moe, **moe_kw))
                 for c in (ref_smoke_config(ARCH), get_smoke_config(ARCH)))


def _params(ref_cfg, seed=0):
    ref_p, _ = split_tree(ref_moe.init_moe(jax.random.PRNGKey(seed), ref_cfg))
    ref_p = jax.tree.map(np.asarray, ref_p)
    return ref_p, {k: torch.from_numpy(np.array(v)) for k, v in ref_p.items()}


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()) + 1e-12, (what, err, np.abs(want).max())


def test_capacity_matches_reference():
    for moe_kw, cf in CASES:
        _, cfg = _cfgs(cf, **moe_kw)
        for t in (1, 7, 64, 128, 1000, 1024):
            for train in (False, True):
                assert moe.capacity(t, cfg.moe, train) == ref_moe._capacity(t, cfg.moe, train)
    assert moe.capacity(1024, get_smoke_config(ARCH).moe, True) == 320  # 1024 x 2 / 8 x 1.25


@pytest.mark.parametrize("moe_kw, cf", CASES, ids=IDS)
def test_route_train_matches_reference(moe_kw, cf):
    ref_cfg, cfg = _cfgs(cf, **moe_kw)
    ref_p, p = _params(ref_cfg)
    x = np.random.RandomState(1).randn(2, 24, cfg.d_model).astype(np.float32)
    want_ids, want_probs, want_aux = ref_moe._route(ref_p, jnp.asarray(x), ref_cfg, True)
    ids, probs, aux = moe.route(p, torch.from_numpy(x).reshape(48, -1), cfg, train=True)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids).reshape(48, -1))
    _close(probs.numpy(), np.asarray(want_probs).reshape(48, -1), RTOL, "probs")
    assert float(want_aux) > 0
    assert abs(float(aux) - float(want_aux)) <= RTOL * float(want_aux)
    no_aux = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, router_aux_loss=0.0))
    assert float(moe.route(p, torch.from_numpy(x).reshape(48, -1), no_aux, train=True)[2]) == 0


@pytest.mark.parametrize("moe_kw, cf", CASES, ids=IDS)
def test_dispatch_with_drops_matches_reference(moe_kw, cf):
    """Forward and gradient (in xt, probs and the experts' weights) of the
    dispatch at the training capacity of 64 tokens, which at a capacity
    factor of 0.5 drops assignments (checked), against the reference's."""
    ref_cfg, cfg = _cfgs(cf, **moe_kw)
    ref_p, p = _params(ref_cfg)
    rng = np.random.RandomState(2)
    t = 64
    xt = rng.randn(t, cfg.d_model).astype(np.float32)
    ids, probs = moe.route(p, torch.from_numpy(xt), cfg)
    cap = moe.capacity(t, cfg.moe, train=True)
    counts = torch.bincount(ids.reshape(-1), minlength=cfg.moe.n_routed_experts)
    assert cf != 0.5 or int(counts.max()) > cap
    dy = rng.randn(t, cfg.d_model).astype(np.float32)

    def ref_loss(xt_, probs_, wg, wu, wd):
        y = ref_moe._dispatch_compute_combine(xt_, jnp.asarray(ids.numpy()), probs_, wg, wu, wd,
                                              jnp.int32(0), cap, "float32")
        return jnp.sum(y * dy), y

    (_, want_y), want_g = jax.value_and_grad(ref_loss, argnums=range(5), has_aux=True)(
        jnp.asarray(xt), jnp.asarray(probs.numpy()), ref_p["w_gate"], ref_p["w_up"],
        ref_p["w_down"])
    ins = [torch.from_numpy(xt), probs.clone(), p["w_gate"], p["w_up"], p["w_down"]]
    ins = [v.clone().requires_grad_() for v in ins]
    y = moe.dispatch_compute_combine(ins[0], ids, *ins[1:], cap)
    _close(y.detach().numpy(), np.asarray(want_y), RTOL, "y")
    y.backward(torch.from_numpy(dy))
    for name, v, w in zip(("xt", "probs", "w_gate", "w_up", "w_down"), ins, want_g):
        _close(v.grad.numpy(), np.asarray(w), GRAD_RTOL, name)


@pytest.mark.parametrize("moe_kw, cf", CASES, ids=IDS)
def test_apply_moe_train_matches_reference(moe_kw, cf):
    """y and aux of one dispatch over all B x S tokens, and the gradient of
    sum(y dy) + aux in x and every parameter."""
    ref_cfg, cfg = _cfgs(cf, **moe_kw)
    ref_p, p = _params(ref_cfg, seed=3)
    rng = np.random.RandomState(4)
    x = rng.randn(2, 32, cfg.d_model).astype(np.float32)
    dy = rng.randn(2, 32, cfg.d_model).astype(np.float32)

    def ref_loss(params, x_):
        y, aux = ref_moe.apply_moe(params, x_, ref_cfg, train=True)
        return jnp.sum(y * dy) + aux, (y, aux)

    (_, (want_y, want_aux)), (want_gp, want_gx) = jax.value_and_grad(
        ref_loss, argnums=(0, 1), has_aux=True)(ref_p, jnp.asarray(x))
    params = {k: v.clone().requires_grad_() for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = moe.apply_moe(params, xt, cfg, train=True)
    _close(y.detach().numpy(), np.asarray(want_y), RTOL, "y")
    assert abs(float(aux.detach()) - float(want_aux)) <= RTOL * float(want_aux)
    ((y * torch.from_numpy(dy)).sum() + aux).backward()
    _close(xt.grad.numpy(), np.asarray(want_gx), GRAD_RTOL, "x")
    for name, v in params.items():
        _close(v.grad.numpy(), np.asarray(want_gp[name]), GRAD_RTOL, name)


def test_eval_call_keeps_its_signature_and_bits():
    """The eval call keeps its signature and its bits: (ids, probs) from
    ``route``, y alone from ``apply_moe``, dropless, the same as the
    training dispatch at the dropless capacity."""
    ref_cfg, cfg = _cfgs()
    _, p = _params(ref_cfg)
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 16, cfg.d_model).astype(np.float32))
    ids, probs = moe.route(p, x.reshape(32, -1), cfg)
    y = moe.apply_moe(p, x, cfg)
    assert isinstance(y, torch.Tensor)
    want = moe.dispatch_compute_combine(x.reshape(32, -1), ids, probs, p["w_gate"], p["w_up"],
                                        p["w_down"], moe.capacity(32))
    want = want + moe.shared_ffn(p, x.reshape(32, -1))
    assert torch.equal(y.reshape(32, -1), want)
