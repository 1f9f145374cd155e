"""Port parity: the flash backward's plain version (K3-bwd's counterpart on
the CPU, ``flash_bwd_ref``), the forward's log-sum-exp and the autograd
``FlashAttention`` against the JAX package: ``jax.grad`` of
``repro.kernels.flash_attention.ops.flash_attention`` (its custom VJP,
``_flash_bwd``) and of the naive ``ref.attention_ref``.

Tolerance: float32 throughout.  Against the custom VJP both sides run the
same blocked arithmetic (p = exp(s - lse) from the same key tiles, delta
from dout * out), summed in another order by XLA and PyTorch: atol 2e-5 on
gradients of magnitude up to about 6.  Against ``attention_ref`` (one
softmax over all keys, no saved lse) the float32 roundings differ more:
atol 5e-5.  The lse within 1e-5 of the reference's.

A case's head dim is D (equal key and value dims) or a pair (DK, DV): the
smoke deepseek-v2's (24, 16), (48, 32), and MLA's (192, 128), whose
backward the reference takes with ``dv_dim = v.shape[3]`` (``ops.py:122``).
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import _flash_fwd_impl
from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import flash_bwd_ref, flash_fwd_ref

ATOL_VJP, ATOL_NAIVE, ATOL_LSE = 2e-5, 5e-5, 1e-5

CASES = [  # b, hq, hk, sq, skv, d or (dk, dv), kv_lens, q_offset, block
    (2, 4, 4, 33, 33, 16, None, 0, 16),          # MHA (G 1), S not a multiple of the block
    (2, 4, 2, 17, 17, 16, [17, 9], 0, 16),       # G 2, kv_lens < S
    (1, 8, 2, 40, 40, 32, None, 0, 16),          # G 4
    (2, 4, 1, 21, 53, 16, [50, 37], 29, 16),     # q_offset > 0, kv_lens < Skv, G 4
    (1, 4, 2, 30, 30, 16, [0], 0, 64),           # a row of no keys; one tile over all
    # unequal key and value dims
    (2, 4, 2, 33, 33, (24, 16), [33, 20], 0, 16),  # the smoke deepseek-v2's, G 2, ragged
    (2, 4, 1, 21, 53, (24, 16), [50, 37], 29, 16),  # q_offset > 0, kv_lens < Skv, G 4
    (1, 4, 4, 40, 40, (48, 32), None, 0, 16),    # MHA
    (1, 2, 2, 24, 24, (192, 128), [24], 0, 16),  # MLA's, at a short S
    (2, 2, 1, 20, 20, (192, 128), [20, 11], 0, 64),  # G 2, ragged, one tile over all
]


def _dims(d):
    """(dk, dv) of a case's head dim: D, or the pair itself."""
    return (d, d) if isinstance(d, int) else d


def _inputs(b, hq, hk, sq, skv, d, seed=0):
    dk, dv = _dims(d)
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32)
            for shape in ((b, hq, sq, dk), (b, hk, skv, dk), (b, hk, skv, dv), (b, hq, sq, dv))]


def _jax_grads(fn, q, k, v, do):
    return jax.jit(jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) * do),
                            argnums=(0, 1, 2)))(q, k, v)


@pytest.mark.parametrize("b, hq, hk, sq, skv, d, lens, q_offset, block", CASES)
def test_plain_backward_matches_reference(b, hq, hk, sq, skv, d, lens, q_offset, block):
    q, k, v, do = _inputs(b, hq, hk, sq, skv, d)
    d = _dims(d)[0]
    kl = np.full(b, skv, np.int32) if lens is None else np.asarray(lens, np.int32)
    kw = dict(causal=True, q_offset=q_offset)
    vjp = _jax_grads(lambda q, k, v: jax_flash_attention(
        q, k, v, kv_lens=jnp.asarray(kl, jnp.float32), block_q=block, block_k=block, **kw),
        q, k, v, do)
    naive = _jax_grads(lambda q, k, v: attention_ref(q, k, v, kv_lens=jnp.asarray(kl), **kw),
                       q, k, v, do)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    lens_t = torch.from_numpy(kl)
    out, lse = flash_fwd_ref(*t, lens_t, sm_scale=d ** -0.5, block_q=block, block_k=block,
                             return_lse=True, **kw)
    got = flash_bwd_ref(*t, lens_t, out, lse, torch.from_numpy(do), sm_scale=d ** -0.5,
                        block_q=block, block_k=block, **kw)
    for name, g, w1, w2 in zip(("dq", "dk", "dv"), got, vjp, naive):
        g = g.numpy()
        np.testing.assert_allclose(g, np.asarray(w1), rtol=0, atol=ATOL_VJP, err_msg=name)
        if lens is None or min(lens) > 0:  # the naive oracle's empty rows are NaN
            np.testing.assert_allclose(g, np.asarray(w2), rtol=0, atol=ATOL_NAIVE, err_msg=name)


@pytest.mark.parametrize("b, hq, hk, sq, skv, d, lens, q_offset, block", CASES)
def test_lse_matches_reference(b, hq, hk, sq, skv, d, lens, q_offset, block):
    q, k, v, _ = _inputs(b, hq, hk, sq, skv, d, seed=1)
    d = _dims(d)[0]
    kl = np.full(b, skv, np.int32) if lens is None else np.asarray(lens, np.int32)
    g = hq // hk
    _, want = _flash_fwd_impl(jnp.asarray(q).reshape(b, hk, g, sq, d), jnp.asarray(k),
                              jnp.asarray(v), jnp.asarray(kl, jnp.float32), True, d ** -0.5,
                              q_offset, block, block)
    _, got = flash_fwd_ref(*(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(kl),
                           causal=True, sm_scale=d ** -0.5, q_offset=q_offset, block_q=block,
                           block_k=block, return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(b, hq, sq), rtol=1e-6,
                               atol=ATOL_LSE)


def test_autograd_function_runs_the_plain_backward(d=16):
    """``flash_attention`` with grad: the output is the forward's bits and
    the gradients ``flash_bwd_ref``'s, on CPU tensors."""
    q, k, v, do = _inputs(2, 4, 2, 24, 24, d, seed=2)
    scale = _dims(d)[0] ** -0.5
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = ops.flash_attention(*t, block_q=16, block_k=16)
    with torch.no_grad():
        assert torch.equal(out, ops.flash_attention(*t, block_q=16, block_k=16))
    out.backward(torch.from_numpy(do))
    lens = torch.full((2,), 24, dtype=torch.int32)
    o, lse = flash_fwd_ref(*(x.detach() for x in t), lens, causal=True, sm_scale=scale,
                           q_offset=0, block_q=16, block_k=16, return_lse=True)
    want = flash_bwd_ref(*(x.detach() for x in t), lens, o, lse, torch.from_numpy(do),
                         causal=True, sm_scale=scale, q_offset=0, block_q=16, block_k=16)
    for x, w in zip(t, want):
        assert torch.equal(x.grad, w)


@pytest.mark.parametrize("d", [(24, 16), (192, 128)])
def test_autograd_function_at_unequal_dims(d):
    test_autograd_function_runs_the_plain_backward(d)


def test_no_grad_takes_the_forward_alone():
    q, k, v, _ = _inputs(1, 2, 2, 8, 8, 16)
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    with torch.no_grad():
        out = ops.flash_attention(*t)
    assert out.grad_fn is None
