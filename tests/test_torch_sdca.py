"""Port parity: the local SDCA inner loop's plain version against the JAX
package's ``kernels/sdca/ref.py::local_sdca_ref`` and
``optim/cocoa.py::_local_sdca``.

Both sides run the same float32 arithmetic in the same order except for the
two dot products of each step, which XLA and PyTorch sum in another order.
The H dependent steps compound that last-bit difference, so ``a`` and ``dw``
are held to atol 1e-5.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import reference_round_indices
from repro.kernels.sdca.ref import local_sdca_ref as jax_local_sdca_ref
from repro.optim import cocoa as ref_cocoa
from repro.optim.problems import synthetic_mnist
from repro_torch.kernels.sdca import ops
from repro_torch.optim.cocoa import partition

ATOL = 1e-5
LAM = 1e-3


def _case(m, n, d, h_factor, seed):
    """Partitioned data with a zero-padded tail, a random a in [0, 1], a
    small w, and the reference's coordinate orders for one round."""
    X, y = synthetic_mnist(n, d, 8, 0.2, 0.35, seed)
    Xs, ys = partition(torch.from_numpy(X), torch.from_numpy(y), m)
    nl = Xs.shape[1]
    rng = np.random.RandomState(seed)
    a = rng.uniform(0, 1, (m, nl)).astype(np.float32)
    w = (0.05 * rng.randn(d)).astype(np.float32)
    h = int(h_factor * nl)
    idx = reference_round_indices(jax.random.PRNGKey(seed), m, nl, h)
    return Xs.numpy(), ys.numpy(), a, w, idx


def _port(Xs, ys, a, w, idx, sigma, n, loss="hinge", gamma=1.0):
    a_new, dw = ops.local_sdca(*(torch.from_numpy(t) for t in (Xs, ys, a, w, idx)),
                               sigma, LAM, float(n), loss, gamma)
    return a_new.numpy(), dw.numpy()


CASES = [  # m, n, d, H / nl (1.0: a permutation, 2.5: draws with repeats)
    (4, 250, 16, 1.0),
    (4, 250, 16, 2.5),
    (3, 301, 24, 0.5),
    (1, 200, 8, 1.0),
]


@pytest.mark.parametrize("plus", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_hinge_matches_kernel_oracle(case, plus):
    m, n, d, hf = case
    Xs, ys, a, w, idx = _case(m, n, d, hf, seed=m + d)
    sigma = float(m) if plus else 1.0
    ar, dwr = jax.vmap(lambda Xk, yk, ak, ik: jax_local_sdca_ref(
        Xk, yk, ak, jnp.asarray(w), ik, sigma, LAM, float(n)))(
        jnp.asarray(Xs), jnp.asarray(ys), jnp.asarray(a), jnp.asarray(idx))
    ap, dwp = _port(Xs, ys, a, w, idx, sigma, n)
    np.testing.assert_allclose(ap, np.asarray(ar), atol=ATOL)
    np.testing.assert_allclose(dwp, np.asarray(dwr), atol=ATOL)


@pytest.mark.parametrize("loss", ["hinge", "smooth_hinge"])
@pytest.mark.parametrize("plus", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_matches_cocoa_local_sdca(case, plus, loss):
    m, n, d, hf = case
    Xs, ys, a, w, idx = _case(m, n, d, hf, seed=2 * m + d)
    sigma = float(m) if plus else 1.0
    gamma = 0.5
    ar, dwr = jax.vmap(lambda Xk, yk, ak, ik: ref_cocoa._local_sdca(
        (loss, gamma), Xk, yk, ak, jnp.asarray(w), ik, sigma, LAM, float(n)))(
        jnp.asarray(Xs), jnp.asarray(ys), jnp.asarray(a), jnp.asarray(idx))
    ap, dwp = _port(Xs, ys, a, w, idx, sigma, n, loss, gamma)
    np.testing.assert_allclose(ap, np.asarray(ar), atol=ATOL)
    np.testing.assert_allclose(dwp, np.asarray(dwr), atol=ATOL)


def test_padded_rows_are_left_alone():
    """Zero rows (the partition's padded tail) give Delta = 0 exactly, for
    both losses, even where the raw smooth-hinge step is not zero."""
    Xs, ys, a, w, idx = _case(3, 301, 24, 2.0, seed=9)
    pad = Xs.shape[0] * Xs.shape[1] - 301
    assert pad > 0 and not Xs[-1, -pad:].any()
    for loss in ("hinge", "smooth_hinge"):
        ap, _ = _port(Xs, ys, a, w, idx, 3.0, 301, loss)
        np.testing.assert_array_equal(ap[-1, -pad:], a[-1, -pad:])


def test_cpu_tensors_do_not_count_launches():
    before = ops.local_sdca.launches
    _port(*_case(2, 64, 8, 1.0, seed=1), 1.0, 64)
    assert ops.local_sdca.launches == before


def test_rejects_unsupported_loss():
    with pytest.raises(ValueError, match="logistic"):
        _port(*_case(2, 64, 8, 1.0, seed=1), 1.0, 64, "logistic")
