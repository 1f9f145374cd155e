"""Port parity: paged decode's plain versions (K2's counterparts on the CPU)
against the JAX package's ``kernels/flash_decode/ops.paged_decode_attention``
with ``impl="stream"``.  The reference's Pallas K2 does not run on this jax
(ROADMAP.md caveats), so its jnp oracle is the reference.

K2's MLA latent form (``paged_latent_decode_attention``: one latent pool as
keys and values, every head on it, the ``q_pe . kpe`` score term) is held
the same way against the reference's ``paged_latent_decode_attention``.

Tolerances: float32 atol 1e-5 against the reference (the same blocked
online softmax, summed in another order by XLA and PyTorch); inside the port
``stream`` and ``gather`` are bitwise equal, as DESIGN.md §10 requires of the
reference's pair.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode.ops import paged_decode_attention as jax_paged_decode
from repro.kernels.flash_decode.ops import (
    paged_latent_decode_attention as jax_latent_decode,
)
from repro_torch.kernels.flash_decode import ops

ATOL_F32 = 1e-5


def _case(seed, b, hk, g, d, n_pages, page, npp, lengths, shuffle=True):
    """A pool with random contents and per-row page tables drawn without
    repeats from pages 1.. (page 0 is the scratch page), out of order;
    rows of length 1 point every entry at the scratch page, as idle slots."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, hk * g, d).astype(np.float32)
    kp = rng.randn(n_pages, hk, page, d).astype(np.float32)
    vp = rng.randn(n_pages, hk, page, d).astype(np.float32)
    tables = np.zeros((b, npp), np.int32)
    free = rng.permutation(np.arange(1, n_pages)) if shuffle else np.arange(1, n_pages)
    for i, n in enumerate(lengths):
        if n == 1:
            continue  # scratch row
        need = -(-n // page)
        tables[i, :need] = free[:need]
        free = free[need:]
    return q, kp, vp, np.asarray(lengths, np.int32), tables


CASES = [  # seed, b, hk, g, d, n_pages, page, npp, lengths, ppp
    (0, 4, 2, 2, 16, 40, 16, 6, [1, 17, 33, 96], 4),       # scratch row, npp % ppp != 0
    (1, 3, 2, 5, 16, 30, 16, 7, [5, 112, 64], 4),         # G = 5, full table, ppp 4
    (2, 5, 1, 4, 32, 50, 8, 9, [1, 1, 9, 72, 40], 2),     # two scratch rows, page 8
    (3, 2, 2, 2, 16, 12, 16, 5, [80, 31], 3),             # ppp 3 over 5 pages
]


def _port(q, kp, vp, lengths, tables, impl, ppp):
    t = [torch.from_numpy(x) for x in (q, kp, vp, lengths, tables)]
    return ops.paged_decode_attention(*t, impl=impl, pages_per_program=ppp).numpy()


@pytest.mark.parametrize("seed, b, hk, g, d, n_pages, page, npp, lengths, ppp", CASES)
def test_paged_decode_matches_reference(seed, b, hk, g, d, n_pages, page, npp, lengths, ppp):
    q, kp, vp, lens, tables = _case(seed, b, hk, g, d, n_pages, page, npp, lengths)
    want = np.asarray(jax_paged_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(lens),
        jnp.asarray(tables), impl="stream", pages_per_program=ppp))
    stream = _port(q, kp, vp, lens, tables, "stream", ppp)
    gather = _port(q, kp, vp, lens, tables, "gather", ppp)
    kernel_path = _port(q, kp, vp, lens, tables, "kernel", ppp)
    assert stream.shape == (b, hk * g, d)
    np.testing.assert_allclose(stream, want, rtol=0, atol=ATOL_F32)
    assert np.array_equal(stream, gather)
    # on CPU tensors the kernel's wrapper takes the stream plain version
    assert np.array_equal(stream, kernel_path)
    assert ops.paged_decode.launches == 0
    assert np.isfinite(stream).all()


def test_stream_and_gather_bitwise_in_bf16():
    q, kp, vp, lens, tables = _case(5, 4, 2, 5, 16, 40, 16, 6, [1, 23, 50, 96])
    t = [torch.from_numpy(x) for x in (q, kp, vp, lens, tables)]
    t[:3] = [x.to(torch.bfloat16) for x in t[:3]]
    stream = ops.paged_decode_attention(*t, impl="stream")
    gather = ops.paged_decode_attention(*t, impl="gather")
    assert stream.dtype == torch.bfloat16
    assert torch.equal(stream, gather)


def test_page_order_does_not_matter():
    """The same contents through a shuffled page table give the same bits."""
    q, kp, vp, lens, tables = _case(6, 2, 2, 2, 16, 20, 16, 4, [60, 33], shuffle=False)
    perm = np.random.RandomState(0).permutation(np.arange(1, 20))
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[perm], vp2[perm] = kp[1:], vp[1:]
    tables2 = np.where(tables > 0, perm[np.maximum(tables - 1, 0)], 0).astype(np.int32)
    a = _port(q, kp, vp, lens, tables, "stream", 4)
    b = _port(q, kp2, vp2, lens, tables2, "stream", 4)
    assert np.array_equal(a, b)


def test_unknown_impl_raises():
    q, kp, vp, lens, tables = _case(0, 1, 1, 1, 16, 4, 16, 2, [3])
    with pytest.raises(ValueError):
        _port(q, kp, vp, lens, tables, "pallas", 4)


def _latent_case(seed, b, h, r, dr, n_pages, page, npp, lengths, shuffle=True):
    """Latent and rope pools with random contents; rows of length 0 or 1
    point every entry at the scratch page, as idle slots."""
    rng = np.random.RandomState(seed)
    q_lat = rng.randn(b, h, r).astype(np.float32)
    q_pe = rng.randn(b, h, dr).astype(np.float32)
    ckv = rng.randn(n_pages, page, r).astype(np.float32)
    kpe = rng.randn(n_pages, page, dr).astype(np.float32)
    tables = np.zeros((b, npp), np.int32)
    free = rng.permutation(np.arange(1, n_pages)) if shuffle else np.arange(1, n_pages)
    for i, n in enumerate(lengths):
        need = -(-n // page) if n > 1 else 0
        tables[i, :need] = free[:need]
        free = free[need:]
    return q_lat, q_pe, ckv, kpe, np.asarray(lengths, np.int32), tables


LATENT_CASES = [  # seed, b, h, r, dr, n_pages, page, npp, lengths, ppp
    (0, 4, 4, 16, 8, 24, 16, 5, [0, 1, 80, 37], 4),     # smoke widths; empty, scratch, full
    (1, 3, 8, 32, 8, 20, 8, 6, [48, 9, 17], 4),         # page 8, full row first, npp % ppp
    (2, 2, 16, 64, 16, 16, 16, 6, [96, 1], 3),          # ppp 3 over 6 pages
]


def _port_latent(args, impl, ppp, scale):
    t = [torch.from_numpy(x) for x in args]
    return ops.paged_latent_decode_attention(*t, sm_scale=scale, impl=impl,
                                             pages_per_program=ppp).numpy()


@pytest.mark.parametrize("seed, b, h, r, dr, n_pages, page, npp, lengths, ppp", LATENT_CASES)
def test_latent_decode_matches_reference(seed, b, h, r, dr, n_pages, page, npp, lengths, ppp):
    args = _latent_case(seed, b, h, r, dr, n_pages, page, npp, lengths)
    scale = (r // 2 + dr) ** -0.5
    want = np.asarray(jax_latent_decode(*(jnp.asarray(x) for x in args), sm_scale=scale,
                                        impl="stream", pages_per_program=ppp))
    stream = _port_latent(args, "stream", ppp, scale)
    assert stream.shape == (b, h, r)
    np.testing.assert_allclose(stream, want, rtol=0, atol=ATOL_F32)
    assert np.array_equal(stream, _port_latent(args, "gather", ppp, scale))
    assert np.array_equal(stream, _port_latent(args, "kernel", ppp, scale))
    assert ops.paged_latent_decode.launches == 0
    for i, n in enumerate(lengths):
        if n == 0:  # an empty row gives zeros, as the reference's stream
            assert not stream[i].any()


def test_latent_stream_and_gather_bitwise_in_bf16_and_page_order_does_not_matter():
    args = _latent_case(5, 4, 4, 16, 8, 24, 16, 5, [1, 23, 80, 50], shuffle=False)
    t = [torch.from_numpy(x) for x in args]
    t[:4] = [x.to(torch.bfloat16) for x in t[:4]]
    stream = ops.paged_latent_decode_attention(*t, sm_scale=0.2, impl="stream")
    assert stream.dtype == torch.bfloat16
    assert torch.equal(stream, ops.paged_latent_decode_attention(*t, sm_scale=0.2,
                                                                 impl="gather"))
    perm = torch.from_numpy(np.random.RandomState(0).permutation(np.arange(1, 24)))
    ckv2, kpe2 = t[2].clone(), t[3].clone()
    ckv2[perm], kpe2[perm] = t[2][1:], t[3][1:]
    tables2 = torch.where(t[5] > 0, perm[(t[5] - 1).clamp(min=0).long()], 0).to(torch.int32)
    shuffled = ops.paged_latent_decode_attention(t[0], t[1], ckv2, kpe2, t[4], tables2,
                                                 sm_scale=0.2, impl="stream")
    assert torch.equal(stream, shuffled)
