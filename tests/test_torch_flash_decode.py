"""Port parity: contiguous flash decode (K5's plain version), the plain
``decode_attention``, ``decode_attention_auto`` in both settings, and the
paged prefill path (``gather_pages``, ``paged_prefill_attention``) against
the JAX package on the same numpy inputs.

K5's plain version is held against the Pallas kernel itself,
``flash_decode_pallas(..., interpret=True)``, with the KV heads repeated G
times as the reference's ``decode_attention_auto`` repeats them; the port
groups them in place.

Tolerances: float32 atol 1e-5, as the K2 parity tests use (the same float32
arithmetic, summed in another order by XLA and PyTorch); bf16 outputs within
one bf16 ulp plus 1e-5 (the same float32 values rounded to bf16 once, so a
last-bit difference may move the rounding by one step).  A row of length 0
is held exactly: zeros for K5, the mean of V for ``decode_attention``, as in
the reference.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_within_bf16_ulp
from repro.kernels.flash_attention.ops import decode_attention as jax_decode_attention
from repro.kernels.flash_decode.kernel import flash_decode_pallas
from repro.kernels.flash_decode.ops import decode_attention_auto as jax_decode_auto
from repro.kernels.flash_decode.ops import gather_pages as jax_gather_pages
from repro.kernels.flash_decode.ops import paged_prefill_attention as jax_paged_prefill
from repro_torch.kernels.flash_attention.ops import decode_attention
from repro_torch.kernels.flash_decode import ops
from repro_torch.kernels.flash_decode.ref import flash_decode_ref

ATOL_F32 = 1e-5
S = 50  # a multiple of neither 16 nor 64
LENGTHS = [0, 1, S, 23]
DTYPES = {"float32": (np.float32, torch.float32, jnp.float32),
          "bfloat16": (np.float32, torch.bfloat16, jnp.bfloat16)}


def _inputs(seed, b, hq, hk, s, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, hq, d).astype(np.float32), rng.randn(b, hk, s, d).astype(np.float32),
            rng.randn(b, hk, s, d).astype(np.float32), np.asarray(LENGTHS[:b], np.int32))


def _torch(dtype, *arrays):
    *xs, lens = arrays
    return [torch.from_numpy(x).to(dtype) for x in xs] + [torch.from_numpy(lens)]


def _jax(dtype, *arrays):
    *xs, lens = arrays
    return [jnp.asarray(x, dtype) for x in xs] + [jnp.asarray(lens)]


def _compare(got: torch.Tensor, want, dtype_name: str) -> None:
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype_name == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_F32)
    else:
        assert_within_bf16_ulp(got, want, atol=ATOL_F32)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("block_k", [16, 64, S])
@pytest.mark.parametrize("g", [1, 4])
def test_flash_decode_plain_matches_pallas_kernel(dtype_name, block_k, g):
    _, tdt, jdt = DTYPES[dtype_name]
    b, hk, d = 4, 2, 16
    arrays = _inputs(0, b, hk * g, hk, S, d)
    q, k, v, lens = _jax(jdt, *arrays)
    want = flash_decode_pallas(q, jnp.repeat(k, g, axis=1), jnp.repeat(v, g, axis=1), lens,
                               block_k=block_k, interpret=True)
    tq, tk, tv, tlens = _torch(tdt, *arrays)
    got = flash_decode_ref(tq, tk, tv, tlens, sm_scale=d ** -0.5, block_k=block_k)
    assert got.dtype == tdt
    _compare(got, want, dtype_name)
    assert not got[0].float().abs().any()  # length 0: zeros, as the Pallas kernel gives
    assert not np.asarray(want[0], np.float32).any()
    # on CPU tensors K5's wrapper takes the plain version and launches nothing
    launches = ops.flash_decode.launches
    assert torch.equal(ops.flash_decode(tq, tk, tv, tlens, sm_scale=d ** -0.5,
                                        block_k=block_k), got)
    assert ops.flash_decode.launches == launches


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("g", [1, 4])
def test_decode_attention_matches_reference(dtype_name, g):
    _, tdt, jdt = DTYPES[dtype_name]
    b, hk, d = 4, 2, 16
    arrays = _inputs(1, b, hk * g, hk, S, d)
    want = jax_decode_attention(*_jax(jdt, *arrays))
    tq, tk, tv, tlens = _torch(tdt, *arrays)
    got = decode_attention(tq, tk, tv, tlens)
    assert got.dtype == tdt
    _compare(got, want, dtype_name)
    # length 0: every score masked, p = exp(0) = 1 everywhere, the mean of V
    mean_v = tv[0].float().mean(dim=1).repeat_interleave(g, dim=0)
    if dtype_name == "float32":
        np.testing.assert_allclose(got[0].numpy(), mean_v.numpy(), rtol=0, atol=ATOL_F32)
    else:
        assert_within_bf16_ulp(got[0].float().numpy(), mean_v.numpy(), atol=ATOL_F32)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("block_k", [16, 64])
def test_decode_attention_auto_matches_reference(use_kernel, block_k):
    b, hk, g, d = 4, 2, 4, 16
    arrays = _inputs(2, b, hk * g, hk, S, d)
    want = jax_decode_auto(*_jax(jnp.float32, *arrays), use_pallas=use_kernel, interpret=True,
                           block_k=block_k)
    t = _torch(torch.float32, *arrays)
    got = ops.decode_attention_auto(*t, use_kernel=use_kernel, block_k=block_k)
    _compare(got, want, "float32")
    plain = (flash_decode_ref(*t, sm_scale=d ** -0.5, block_k=block_k) if use_kernel
             else decode_attention(*t))
    assert torch.equal(got, plain)


def test_gather_pages_matches_reference():
    rng = np.random.RandomState(3)
    pool4 = rng.randn(9, 2, 4, 8).astype(np.float32)  # (n_pages, Hk, page, d)
    pool3 = rng.randn(9, 4, 6).astype(np.float32)  # (n_pages, page, r)
    tables = np.asarray([[3, 1, 7], [0, 8, 2]], np.int32)
    for pool in (pool4, pool3):
        want = np.asarray(jax_gather_pages(jnp.asarray(pool), jnp.asarray(tables)))
        got = ops.gather_pages(torch.from_numpy(pool), torch.from_numpy(tables)).numpy()
        assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="rank"):
        ops.gather_pages(torch.zeros(9, 4), torch.from_numpy(tables))


@pytest.mark.parametrize("chunk", [8, 16])
def test_paged_prefill_attention_matches_reference(chunk):
    """A 30-token prompt in chunks, each attending over the whole gathered
    page row with its absolute q_offset and kv_lens, as the tuner's
    prefill_chunk family drives it."""
    rng = np.random.RandomState(4)
    p, hk, g, d, page, npp = 30, 2, 2, 16, 8, 5
    kp = rng.randn(npp + 1, hk, page, d).astype(np.float32)
    vp = rng.randn(npp + 1, hk, page, d).astype(np.float32)
    table = (rng.permutation(npp)[None] + 1).astype(np.int32)
    for s0 in range(0, p, chunk):
        q = rng.randn(1, hk * g, chunk, d).astype(np.float32)
        lens = np.asarray([min(s0 + chunk, p)], np.int32)
        want = jax_paged_prefill(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                 jnp.asarray(lens), jnp.asarray(table), q_offset=s0)
        got = ops.paged_prefill_attention(
            torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(lens), torch.from_numpy(table), q_offset=s0)
        _compare(got, want, "float32")
