"""Port parity: the MoE FFN's eval path (``repro_torch/models/moe.py``,
dropless, without a mesh) with the reference's weights against
``repro.models.moe.apply_moe(train=False)``, at the smoke deepseek-v2's
widths (d_model 64, 8 experts of d_ff 64, top-2, one shared expert) and at
a wider routing (32 experts, top-6, two shared), and the port's own
row-stability guarantee.

Tolerances.  float32: the same arithmetic (router, top-k, the experts'
products, the float32 combine in the reference's order) with the products
summed in another order, so outputs within 1e-5 of the largest magnitude;
both sides pick the same experts, checked separately.  bf16: one rounding
of each product's output and of the result moves by a bf16 step where the
float32 sums differ, so within 2^-7 of the largest magnitude.  Row stability is bitwise, inside the port.
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

ARCH = "deepseek-v2-236b"
RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


def _cfgs(dtype, **moe_kw):
    ref_cfg, cfg = ref_smoke_config(ARCH), get_smoke_config(ARCH)
    return tuple(dataclasses.replace(c, dtype=dtype, moe=dataclasses.replace(c.moe, **moe_kw))
                 for c in (ref_cfg, cfg))


def _params(ref_cfg, dtype, seed=0):
    ref_p, _ = split_tree(ref_moe.init_moe(jax.random.PRNGKey(seed), ref_cfg))
    p = {k: torch.from_numpy(np.array(v)) for k, v in ref_p.items()}
    return ref_p, {k: v if k in moe.FLOAT32_PARAMS else v.to(getattr(torch, dtype))
                   for k, v in p.items()}


WIDE = dict(n_routed_experts=32, n_shared_experts=2, top_k=6)


@pytest.mark.parametrize("moe_kw", [{}, WIDE], ids=["smoke", "wide"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_moe_matches_reference(dtype, moe_kw):
    ref_cfg, cfg = _cfgs(dtype, **moe_kw)
    ref_p, p = _params(ref_cfg, dtype)
    x = np.random.RandomState(0).randn(2, 19, cfg.d_model).astype(np.float32)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    want, aux = ref_moe.apply_moe(ref_p, xj, ref_cfg, train=False)
    got = moe.apply_moe(p, torch.from_numpy(x).to(getattr(torch, dtype)), cfg)
    assert got.dtype == getattr(torch, dtype) and float(aux) == 0.0
    want = np.asarray(want.astype(jnp.float32), np.float64)
    err = np.abs(got.float().numpy() - want)
    assert err.max() <= RTOL[dtype] * np.abs(want).max(), (err.max(), np.abs(want).max())
    ref_ids, ref_probs, _ = ref_moe._route(ref_p, xj, ref_cfg, train=False)
    ids, probs = moe.route(p, torch.from_numpy(x).to(getattr(torch, dtype)).reshape(38, -1),
                           cfg)
    np.testing.assert_array_equal(np.sort(ids.numpy(), 1),
                                  np.sort(np.asarray(ref_ids).reshape(38, -1), 1))
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref_probs).reshape(38, -1),
                               rtol=0, atol=1e-6)


def test_capacity_is_dropless():
    assert [moe.capacity(t) for t in (0, 1, 7, 1024)] == [1, 1, 7, 1024]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["after", "before", "all"])
def test_a_tokens_output_does_not_depend_on_the_other_tokens(dtype, which):
    """Port only, bitwise: tokens 10..14 of a 32-token dispatch give the
    same bits when the tokens after them, before them, or all others are
    replaced (and with them every expert's other rows)."""
    _, cfg = _cfgs(dtype, **WIDE)
    _, p = _params(_cfgs(dtype, **WIDE)[0], dtype)
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(1, 32, cfg.d_model).astype(np.float32)).to(
        getattr(torch, dtype))
    other = torch.from_numpy(rng.randn(1, 32, cfg.d_model).astype(np.float32)).to(x.dtype)
    keep = slice(10, 15)
    mask = torch.zeros(32, dtype=torch.bool)
    mask[{"after": slice(15, None), "before": slice(0, 10), "all": slice(None)}[which]] = True
    mask[keep] = False
    y = moe.apply_moe(p, torch.where(mask[None, :, None], other, x), cfg)
    assert torch.equal(y[:, keep], moe.apply_moe(p, x, cfg)[:, keep])
