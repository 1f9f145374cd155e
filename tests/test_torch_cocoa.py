"""Port parity: CoCoA/CoCoA+ rounds against ``repro.optim.cocoa``.

Each round the test recomputes the reference's coordinate orders from the
same round key (cocoa.py:85-89) and injects them into the port.  After one
round ``a`` and ``w`` agree to atol 1e-5 (see test_torch_sdca.py: only the
order of each step's two float32 sums differs).  Over five rounds the
objective curves agree to rtol 1e-4: a last-bit difference can move a
coordinate across its clip at 0 or 1, which changes later rounds a little
but leaves the objectives close.  The gap is the difference of two float32
objectives, each rounded to its own last bit, so where it is small it also
gets an absolute floor of four float32 spacings of the primal.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import reference_round_indices
from repro.optim import cocoa as ref_cocoa
from repro.optim.problems import ERMProblem as RefProblem
from repro.optim.problems import synthetic_mnist
from repro_torch.convert import cocoa_state_from_numpy, problem_from_numpy
from repro_torch.optim import cocoa

N, D, LAM, ROUNDS = 600, 24, 1e-3, 5


@pytest.fixture(scope="module")
def data():
    return synthetic_mnist(N, D, 12, 0.15, 0.35, 4)


@pytest.mark.parametrize("loss", ["hinge", "smooth_hinge"])
@pytest.mark.parametrize("plus", [False, True])
@pytest.mark.parametrize("m", [1, 2, 4, 8, 16])
def test_rounds_match_reference(data, m, plus, loss):
    X, y = data
    rp = RefProblem(jnp.asarray(X), jnp.asarray(y), LAM, loss)
    pp = problem_from_numpy(X, y, LAM, loss, device="cpu")
    Xs_r, ys_r = ref_cocoa.partition(rp.X, rp.y, m)
    nl = Xs_r.shape[1]
    a_r = jnp.zeros((m, nl), jnp.float32)
    w_r = jnp.zeros((D,), jnp.float32)
    Xs, ys, a, w = cocoa_state_from_numpy(Xs_r, ys_r, a_r, w_r, device="cpu")
    Xs_p, ys_p = cocoa.partition(pp.X, pp.y, m)
    np.testing.assert_array_equal(Xs_p.numpy(), Xs.numpy())
    np.testing.assert_array_equal(ys_p.numpy(), ys.numpy())

    key = jax.random.PRNGKey(m + 3 * plus)
    ref_curve, port_curve = [], []
    for it in range(ROUNDS):
        key, sub = jax.random.split(key)
        a_r, w_r = ref_cocoa.cocoa_outer_step(
            (loss, 1.0), Xs_r, ys_r, a_r, w_r, plus, (LAM, float(N)), None, sub)
        idx = torch.from_numpy(reference_round_indices(sub, m, nl, nl))
        a, w = cocoa.cocoa_outer_step(Xs, ys, a, w, idx, plus, LAM, float(N), loss)
        if it == 0:
            np.testing.assert_allclose(a.numpy(), np.asarray(a_r), atol=1e-5)
            np.testing.assert_allclose(w.numpy(), np.asarray(w_r), atol=1e-5)
        a_flat_r, a_flat = a_r.reshape(-1)[:N], a.reshape(-1)[:N]
        ref_curve.append([float(rp.primal(w_r)), float(rp.dual(a_flat_r))])
        port_curve.append([float(pp.primal(w)), float(pp.dual(a_flat))])
    ref_curve, port_curve = np.asarray(ref_curve), np.asarray(port_curve)
    np.testing.assert_allclose(port_curve, ref_curve, rtol=1e-4)
    np.testing.assert_allclose(port_curve[:, 0] - port_curve[:, 1],
                               ref_curve[:, 0] - ref_curve[:, 1], rtol=1e-4,
                               atol=_gap_floor(ref_curve[:, 0]))


def _gap_floor(primal):
    return 4 * float(np.spacing(np.float32(np.abs(primal).max())))


def test_run_cocoa_with_reference_indices_matches_reference(data):
    from _torch_parity import reference_index_source

    X, y = data
    m, rounds = 4, 4
    rp = RefProblem(jnp.asarray(X), jnp.asarray(y), LAM)
    rec_r = ref_cocoa.run_cocoa(rp, ref_cocoa.CocoaConfig(m, rounds, plus=True, seed=7))
    pp = problem_from_numpy(X, y, LAM, device="cpu")
    nl = -(-N // m)
    rec = cocoa.run_cocoa(pp, cocoa.CocoaConfig(m, rounds, plus=True, seed=7),
                          indices=reference_index_source(7, m, nl, nl, rounds))
    np.testing.assert_allclose(rec.primal, rec_r.primal, rtol=1e-4)
    np.testing.assert_allclose(rec.dual, rec_r.dual, rtol=1e-4)
    np.testing.assert_allclose(rec.gap, rec_r.gap, rtol=1e-4,
                               atol=_gap_floor(rec_r.primal))
    assert rec.compute_seconds > 0


@pytest.mark.parametrize("h_factor", [0.5, 2.0])
def test_own_index_draw(h_factor):
    """Permutation prefixes when H <= nl, draws with repeats when H > nl,
    reproducible from the generator's seed."""
    m, nl = 3, 40
    h = int(h_factor * nl)
    idx = cocoa.draw_indices(m, nl, h, torch.Generator().manual_seed(1))
    again = cocoa.draw_indices(m, nl, h, torch.Generator().manual_seed(1))
    assert idx.shape == (m, h) and torch.equal(idx, again)
    assert int(idx.min()) >= 0 and int(idx.max()) < nl
    if h <= nl:
        assert all(len(set(row.tolist())) == h for row in idx)
    else:
        assert any(len(set(row.tolist())) < h for row in idx)
