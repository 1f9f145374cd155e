"""K1's order of sums, modelled on the CPU over a long chain.

The local SDCA kernel (``repro_torch/kernels/sdca/csrc/sdca.cu``) runs a
worker's H steps on one warp: lane l owns the entries l, l + 32, ... of v
and of each row (its e-th entry is l + 32 e), forms its partial ||x_j||^2
and <v, x_j> in four accumulators (entry e into accumulator e % 4, in order
of e, by fused multiply-adds, the four then added pairwise), and an xor
butterfly of shuffles (offsets 16, 8, 4, 2, 1) adds the 32 partials; every
other operation of a step is the reference's, in the reference's order.
``warp_order_sdca`` is a plain model of that arithmetic (a fused
multiply-add as a float64 product and sum rounded once to float32), held
here against the port's plain version
(``local_sdca_ref``, sums in PyTorch's order) and the JAX package's
``kernels/sdca/ref.py::local_sdca_ref`` and ``optim/cocoa.py::_local_sdca``
(sums in XLA's), at the paper's width d 784, nl 4096 and H = 2 nl (draws with
repeats), for both losses.

Tolerance: the card's limits (``chip_smoke.py``, ``tests/
test_torch_sdca_gpu.py``), |da| <= 1e-5 and |ddw| <= 1e-5 max |dw|.  The
orders differ in the last bits of each step's two sums, and 8192 dependent
steps compound that; the model shows the limits cover the new order over a
long chain, where a fault of order shows as errors of the order of the
values.  The kernel itself is held against ``local_sdca_ref`` on the card.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sdca.ref import local_sdca_ref as jax_local_sdca_ref
from repro.optim import cocoa as ref_cocoa
from repro.optim.problems import synthetic_mnist
from repro_torch.kernels.sdca.ops import LANES, kernel_plan
from repro_torch.kernels.sdca.ref import local_sdca_ref
from repro_torch.optim.cocoa import partition

A_ATOL = 1e-5
DW_RTOL_OF_MAX = 1e-5
LAM = 1e-4


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to float32 (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _lane_partial(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A lane's sum of x * v over its entries (axis -2, lanes on the last
    axis): four accumulators in order of the entry, added pairwise."""
    acc = [torch.zeros(x.shape[:-2] + x.shape[-1:]) for _ in range(4)]
    for e in range(x.shape[-2]):
        acc[e % 4] = _fma(x[..., e, :], v[..., e, :], acc[e % 4])
    return (acc[0] + acc[1]) + (acc[2] + acc[3])


def _butterfly(p: torch.Tensor) -> torch.Tensor:
    """The xor butterfly over the last axis (32 lanes): every lane ends with
    the same sum."""
    lanes = torch.arange(LANES)
    for off in (16, 8, 4, 2, 1):
        p = p + p[..., lanes ^ off]
    return p


def warp_order_sdca(X, y, a, w, idx, sigma_prime, lam, n, loss="hinge", gamma=1.0):
    """The kernel's arithmetic, batched over workers: returns (a, dw)."""
    m, nl, d = X.shape
    k = -(-d // LANES)
    pad = LANES * k - d
    # entry i = l + 32 e at [e, l]; the entries past d are 0
    Xl = torch.nn.functional.pad(X, (0, pad)).reshape(m, nl, k, LANES)
    v = torch.nn.functional.pad(w, (0, pad)).reshape(k, LANES).expand(m, k, LANES).clone()
    lam_n = lam * n
    rows = torch.arange(m)
    a = a.clone()
    # ||x_j||^2 does not depend on v: every row's, in the kernel's order, at once
    row_xx = _butterfly(_lane_partial(Xl, Xl))[..., 0]
    for t in range(idx.shape[1]):
        j = idx[:, t]
        x = Xl[rows, j]  # (m, k, 32)
        sxx, sxv = row_xx[rows, j], _butterfly(_lane_partial(x, v))[:, 0]
        yj, aj = y[rows, j], a[rows, j]
        q = sigma_prime * sxx / lam_n
        margin = yj * sxv
        if loss == "smooth_hinge":
            delta_raw = (1.0 - margin - gamma * aj) / (q + gamma)
        else:
            delta_raw = torch.where(q > 0, (1.0 - margin) / torch.clamp(q, min=1e-30), 0.0)
        a_new = torch.clamp(aj + delta_raw, 0.0, 1.0)
        delta = torch.where(sxx > 0, a_new - aj, 0.0)
        a[rows, j] = aj + delta
        v = v + (sigma_prime * delta * yj)[:, None, None] * x / lam_n
    v = v.reshape(m, k * LANES)[:, :d]
    return a, (v - w) / sigma_prime


def _assert_close(got, want, what):
    ga, gdw = (np.asarray(t) for t in got)
    wa, wdw = (np.asarray(t) for t in want)
    err_a = float(np.abs(ga - wa).max())
    err_dw = float(np.abs(gdw - wdw).max())
    assert err_a <= A_ATOL, (what, err_a)
    assert err_dw <= DW_RTOL_OF_MAX * float(np.abs(wdw).max()), (what, err_dw)


@pytest.mark.parametrize("loss", ["hinge", "smooth_hinge"])
def test_warp_order_over_a_long_chain(loss):
    m, nl, d = 1, 4096, 784
    n = m * nl
    X, y = synthetic_mnist(n, d, 16, 0.09, 0.35, 0)
    Xs, ys = partition(torch.from_numpy(X), torch.from_numpy(y), m)
    rng = np.random.RandomState(1)
    a = np.zeros((m, nl), np.float32)
    w = (0.01 * rng.randn(d)).astype(np.float32)
    idx = rng.randint(0, nl, (m, 2 * nl)).astype(np.int32)  # H = 2 nl, with repeats
    assert len(np.unique(idx[0])) < nl
    gamma = 0.5
    args = (Xs, ys, torch.from_numpy(a), torch.from_numpy(w), torch.from_numpy(idx))
    got = warp_order_sdca(*args, 1.0, LAM, float(n), loss, gamma)
    assert got[1].abs().max() > 0 and (got[0] > 0).any()
    _assert_close(got, local_sdca_ref(*args, 1.0, LAM, float(n), loss, gamma), "port plain")
    jargs = [jnp.asarray(np.asarray(t)) for t in args]
    cocoa = jax.vmap(lambda Xk, yk, ak, ik: ref_cocoa._local_sdca(
        (loss, gamma), Xk, yk, ak, jargs[3], ik, 1.0, LAM, float(n)))(
        jargs[0], jargs[1], jargs[2], jargs[4])
    _assert_close(got, cocoa, "reference _local_sdca")
    if loss == "hinge":
        kernel_ref = jax.vmap(lambda Xk, yk, ak, ik: jax_local_sdca_ref(
            Xk, yk, ak, jargs[3], ik, 1.0, LAM, float(n)))(jargs[0], jargs[1], jargs[2],
                                                           jargs[4])
        _assert_close(got, kernel_ref, "reference local_sdca_ref")


def test_warp_order_keeps_padded_rows_and_matches_at_small_widths():
    """Zero rows leave a bit for bit, and widths off the lane count (d 33, one
    entry past a lane multiple) agree with the plain version."""
    m, n, d = 3, 301, 33
    X, y = synthetic_mnist(n, d, 8, 0.2, 0.35, 2)
    Xs, ys = partition(torch.from_numpy(X), torch.from_numpy(y), m)
    nl = Xs.shape[1]
    pad = m * nl - n
    assert pad > 0
    rng = np.random.RandomState(3)
    a = torch.from_numpy(rng.uniform(0, 1, (m, nl)).astype(np.float32))
    w = torch.from_numpy((0.05 * rng.randn(d)).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, nl, (m, 3 * nl)).astype(np.int32))
    for loss in ("hinge", "smooth_hinge"):
        got = warp_order_sdca(Xs, ys, a, w, idx, 3.0, 1e-3, float(n), loss)
        assert torch.equal(got[0][-1, -pad:], a[-1, -pad:])
        _assert_close(got, local_sdca_ref(Xs, ys, a, w, idx, 3.0, 1e-3, float(n), loss), loss)


def test_kernel_plan_covers_every_width():
    """The register path up to 64 entries a lane (d 2048), the shared-memory
    path above it, every plan within the shared memory a block may use."""
    from repro_torch.kernels._build import MAX_SMEM_PER_BLOCK
    from repro_torch.kernels.sdca.ops import MAX_D, REGISTER_MAX_D

    assert kernel_plan(784) == (25, 16, 128 + 16 * 128 * 25)
    assert kernel_plan(33)[:2] == (2, 16)
    assert kernel_plan(REGISTER_MAX_D)[:2] == (64, 8)
    assert kernel_plan(REGISTER_MAX_D + 1)[:2] == (0, 4)
    assert kernel_plan(MAX_D)[:2] == (0, 2)
    for d in list(range(1, 300)) + [784, 2047, 2048, 2049, 4096, MAX_D, 19360]:
        e, ring, smem = kernel_plan(d)
        assert smem <= MAX_SMEM_PER_BLOCK and ring >= 2
        assert e == 0 or LANES * e >= d
    assert kernel_plan(19392)[2] > MAX_SMEM_PER_BLOCK  # past what shared memory holds
