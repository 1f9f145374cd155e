"""Port parity: ERM problems and the synthetic MNIST data.

The data must be bitwise equal (both packages run the same numpy code).
Objectives and gradients at the same (w, a) are float32 reductions taken in
another order by XLA and by PyTorch, so they agree to rtol 1e-5; gradient
entries near zero get an absolute floor of 1e-5 times the largest entry.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import cocoa_mnist as ref_cocoa_mnist
from repro.optim import problems as ref
from repro_torch.configs import cocoa_mnist
from repro_torch.convert import problem_from_numpy
from repro_torch.optim import problems as port

RTOL = 1e-5


@pytest.mark.parametrize("args", [(), (512, 32, 16, 0.2, 0.5, 3), (1000, 7, 40, 0.09, 0.35, 1)])
def test_synthetic_mnist_bitwise(args):
    xr, yr = ref.synthetic_mnist(*args) if args else ref.synthetic_mnist(2048, 64)
    xp, yp = port.synthetic_mnist(*args) if args else port.synthetic_mnist(2048, 64)
    assert xr.dtype == xp.dtype == np.float32
    np.testing.assert_array_equal(xr, xp)
    np.testing.assert_array_equal(yr, yp)


def test_make_mnist_svm_matches_reference():
    cfg_ref = ref_cocoa_mnist.smoke_config()
    cfg = cocoa_mnist.smoke_config()
    assert cfg == cfg.__class__(**vars(cfg_ref))
    pr = ref.make_mnist_svm(cfg_ref)
    pp = port.make_mnist_svm(cfg, device="cpu")
    np.testing.assert_array_equal(np.asarray(pr.X), pp.X.numpy())
    np.testing.assert_array_equal(np.asarray(pr.y), pp.y.numpy())
    assert (pp.lam, pp.loss) == (pr.lam, pr.loss)


@pytest.fixture(scope="module")
def data():
    X, y = ref.synthetic_mnist(600, 48, 16, 0.15, 0.35, 5)
    rng = np.random.RandomState(0)
    w = (0.2 * rng.randn(48)).astype(np.float32)
    a = rng.uniform(0.0, 1.0, 600).astype(np.float32)
    return X, y, w, a


def _close(port_value, ref_value, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(port_value.numpy(), np.asarray(ref_value),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("loss", ["hinge", "smooth_hinge", "logistic"])
def test_objectives_match_reference(data, loss):
    X, y, w, a = data
    pr = ref.ERMProblem(jnp.asarray(X), jnp.asarray(y), 1e-3, loss, 0.7)
    pp = problem_from_numpy(X, y, 1e-3, loss, 0.7, device="cpu")
    wt, at = torch.from_numpy(w), torch.from_numpy(a)
    _close(pp.primal(wt), pr.primal(jnp.asarray(w)))
    _close(pp.dual(at), pr.dual(jnp.asarray(a)))
    _close(pp.duality_gap(at), pr.duality_gap(jnp.asarray(a)))
    _close(pp.w_of_alpha(at), pr.w_of_alpha(jnp.asarray(a)),
           atol=RTOL * float(np.abs(np.asarray(pr.w_of_alpha(jnp.asarray(a)))).max()))
    g_ref = np.asarray(pr.grad(jnp.asarray(w)))
    _close(pp.grad(wt), g_ref, atol=RTOL * float(np.abs(g_ref).max()))
    z = np.linspace(-3, 3, 41).astype(np.float32)
    _close(pp.loss_values(torch.from_numpy(z)), pr.loss_values(jnp.asarray(z)))
    _close(pp.loss_grad_z(torch.from_numpy(z)), pr.loss_grad_z(jnp.asarray(z)))
