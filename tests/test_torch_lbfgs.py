"""Port parity: L-BFGS against ``repro.optim.lbfgs.run_lbfgs``.

The reference differentiates the primal with ``jax.value_and_grad``; the
port uses the closed form ``ERMProblem.grad``: the same function, its float32
sums in another order (gradients about 1e-7 apart, relative).  The two-loop
recursion multiplies such a difference by up to the inverse of the smallest
curvature, about 1 / lambda = 1000 here, so the iterates agree less closely
than the objectives: over the first twelve iterations w measured at most
4.2e-6 of max |w| apart, held within 5e-5 of it; the primal curves at most
1.3e-7 apart, held at rtol 1e-6.  Past convergence (thirty iterations) the
line search compares objectives that agree to float32's resolution, and the
iterates wander along the flattest directions by up to 5e-4 of max |w|
while the objective does not move: there only the primal curve is held, at
the same rtol 1e-6.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import jax.numpy as jnp
import numpy as np
import pytest

from repro.optim import lbfgs as ref_lbfgs
from repro.optim.problems import ERMProblem as RefProblem
from repro.optim.problems import synthetic_mnist
from repro_torch.convert import problem_from_numpy
from repro_torch.optim import LBFGSConfig, run_lbfgs

N, D, LAM = 600, 24, 1e-3
W_RTOL_OF_MAX = 5e-5
CURVE_RTOL = 1e-6


@pytest.fixture(scope="module")
def data():
    return synthetic_mnist(N, D, 12, 0.15, 0.35, 4)


@pytest.mark.parametrize("loss", ["smooth_hinge", "logistic"])
@pytest.mark.parametrize("iters", [12, 30])
def test_lbfgs_matches_reference(data, loss, iters):
    X, y = data
    rp = RefProblem(jnp.asarray(X), jnp.asarray(y), LAM, loss)
    pp = problem_from_numpy(X, y, LAM, loss, device="cpu")
    want = ref_lbfgs.run_lbfgs(rp, ref_lbfgs.LBFGSConfig(iters))
    got = run_lbfgs(pp, LBFGSConfig(iters))
    assert got.primal.shape == want.primal.shape == (iters,)
    np.testing.assert_allclose(got.primal, want.primal, rtol=CURVE_RTOL)
    assert got.primal[-1] < 0.7 * got.primal[0]  # it optimised
    assert np.isnan(got.dual).all() and np.isnan(got.gap).all()
    if iters == 12:
        err = float(np.abs(got.w - want.w).max())
        assert err <= W_RTOL_OF_MAX * float(np.abs(want.w).max()), err


def test_lbfgs_refuses_the_hinge(data):
    X, y = data
    pp = problem_from_numpy(X, y, LAM, "hinge", device="cpu")
    with pytest.raises(ValueError, match="smooth loss"):
        run_lbfgs(pp, LBFGSConfig(3))
    with pytest.raises(ValueError, match="smooth loss"):
        ref_lbfgs.run_lbfgs(RefProblem(jnp.asarray(X), jnp.asarray(y), LAM, "hinge"),
                            ref_lbfgs.LBFGSConfig(3))
