"""Port parity: the flash forward's plain version (K3's counterpart on the
CPU) against the JAX package's ``kernels/flash_attention/ops.flash_attention``
and, for the MHA causal case, against its Pallas kernel in interpret mode.

Tolerances.  float32: both sides run the same per-row arithmetic (float32
scores, online softmax over the same key tiles), summed in another order by
XLA and PyTorch, so atol 1e-5 on outputs of size about 1.  bf16 inputs and
outputs: the float32 arithmetic inside differs in its last bits, which can
move the final rounding to bf16 by one step, so one bf16 ulp of the output.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_within_bf16_ulp
from repro.kernels.flash_attention.kernel import flash_attention_fwd_pallas
from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro_torch.kernels.flash_attention import ops

ATOL_F32 = 1e-5


def _inputs(seed, b, hq, hk, sq, skv, d):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, hq, sq, d).astype(np.float32)
    k = rng.randn(b, hk, skv, d).astype(np.float32)
    v = rng.randn(b, hk, skv, d).astype(np.float32)
    return q, k, v


def _port(q, k, v, dtype, **kw):
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    if kw.get("kv_lens") is not None:
        kw["kv_lens"] = torch.from_numpy(np.asarray(kw["kv_lens"], np.int32))
    return ops.flash_attention(*t, **kw).float().numpy()


def _jax(q, k, v, dtype, **kw):
    t = [jnp.asarray(x).astype(dtype) for x in (q, k, v)]
    if kw.get("kv_lens") is not None:
        kw["kv_lens"] = jnp.asarray(np.asarray(kw["kv_lens"], np.float32))
    return np.asarray(jax_flash_attention(*t, **kw).astype(jnp.float32))


CASES = [  # b, hq, hk, sq, skv, d, kv_lens, q_offset
    (2, 4, 4, 33, 33, 16, None, 0),          # MHA (G = 1), odd length
    (2, 4, 2, 17, 17, 16, [17, 9], 0),       # G = 2, ragged kv_lens
    (1, 10, 2, 40, 40, 32, None, 0),         # G = 5
    (2, 10, 2, 21, 53, 16, [50, 37], 29),    # chunk at q_offset > 0, kv_lens < Skv
    (1, 4, 4, 1, 1, 16, None, 0),            # one position
]


@pytest.mark.parametrize("b, hq, hk, sq, skv, d, kv_lens, q_offset", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_reference(b, hq, hk, sq, skv, d, kv_lens, q_offset, dtype):
    q, k, v = _inputs(sq + hq, b, hq, hk, sq, skv, d)
    kw = dict(causal=True, kv_lens=kv_lens, q_offset=q_offset, block_q=16, block_k=16)
    got = _port(q, k, v, getattr(torch, dtype), **kw)
    want = _jax(q, k, v, getattr(jnp, dtype), **kw)
    assert got.shape == (b, hq, sq, d)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_F32)
    else:
        assert_within_bf16_ulp(got, want)
    assert ops.flash_fwd.launches == 0  # CPU tensors never reach the kernel


def test_flash_attention_matches_pallas_kernel_in_interpret_mode():
    b, h, s, d = 2, 3, 40, 16
    q, k, v = _inputs(7, b, h, h, s, s, d)
    want = flash_attention_fwd_pallas(
        jnp.asarray(q.reshape(b * h, s, d)), jnp.asarray(k.reshape(b * h, s, d)),
        jnp.asarray(v.reshape(b * h, s, d)), causal=True, block_q=16, block_k=16,
        interpret=True)
    got = _port(q, k, v, torch.float32, causal=True, block_q=16, block_k=16)
    np.testing.assert_allclose(got.reshape(b * h, s, d), np.asarray(want), rtol=0,
                               atol=ATOL_F32)


def test_default_blocks_clamp_as_the_reference():
    """Blocks larger than the sequence clamp to max(seq, 16), as there."""
    q, k, v = _inputs(3, 1, 2, 1, 24, 24, 16)
    got = _port(q, k, v, torch.float32, block_q=512, block_k=512)
    want = _jax(q, k, v, jnp.float32, block_q=512, block_k=512)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_F32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_of_a_prefix_do_not_depend_on_sq(dtype):
    """A query row's bits depend only on its own q and the keys it may see:
    the first rows give the same bits whatever the total Sq (the serve
    engine's prefix guarantee rests on this)."""
    q, k, v = _inputs(11, 1, 10, 2, 96, 96, 16)
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    full = ops.flash_attention(*t, block_q=16, block_k=16)
    for sq in (1, 17, 37, 41):
        part = ops.flash_attention(t[0][:, :, :sq], t[1][:, :, :sq], t[2][:, :, :sq],
                                   block_q=16, block_k=16)
        assert torch.equal(part, full[:, :, :sq]), sq


@pytest.mark.parametrize("dk, dv, hq", [(24, 16, 4), (192, 128, 2)])
@pytest.mark.parametrize("kv_lens", [None, [40, 23]])
def test_value_dim_other_than_key_dim_matches_reference(dk, dv, hq, kv_lens):
    """MLA's prefill shapes, float32: key dim nope + rope, value dim v, as
    the smoke deepseek-v2 (24, 16) and the full one (192, 128) run them."""
    rng = np.random.RandomState(dk)
    q = rng.randn(2, hq, 40, dk).astype(np.float32)
    k = rng.randn(2, hq, 40, dk).astype(np.float32)
    v = rng.randn(2, hq, 40, dv).astype(np.float32)
    kw = dict(causal=True, sm_scale=dk ** -0.5, kv_lens=kv_lens, block_q=16, block_k=16)
    got = _port(q, k, v, torch.float32, **kw)
    assert got.shape == (2, hq, 40, dv)
    np.testing.assert_allclose(got, _jax(q, k, v, jnp.float32, **kw), rtol=0, atol=ATOL_F32)
    assert ops.flash_fwd.launches == 0
