"""Port parity, end to end: simulate -> fit f(m), g(i, m) -> plan.

A smaller port of tests/test_hemingway_e2e.py.  The reference runs its own
BSPCluster; the port replays each cluster size with the reference's
coordinate orders injected, and its per-round objectives agree to rtol 1e-4
(see test_torch_cocoa.py).  Fed the reference's measured t_iter, the port's
curves give the planner the same decisions.  With the port's own measured
times (here on the CPU, through the plain SDCA loop) both queries stay
feasible.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import reference_index_source
from repro import core as ref_core
from repro.optim import BSPCluster as RefCluster
from repro.optim import ERMProblem as RefProblem
from repro.optim import synthetic_mnist
from repro.optim.simcluster import solve_reference as ref_solve_reference
from repro_torch import core
from repro_torch.convert import problem_from_numpy
from repro_torch.optim import BSPCluster, CocoaConfig, run_cocoa

N, D, LAM, SEED, ITERS = 512, 32, 1e-3, 2, 20
MS = (1, 2, 4, 8, 16)
EPS = 0.02      # query 1: suboptimality target
BUDGET_S = 1.0  # query 2: wall-clock budget


@pytest.fixture(scope="module")
def setup():
    X, y = synthetic_mnist(N, D, 16, 0.09, 0.35, 0)
    rp = RefProblem(jnp.asarray(X), jnp.asarray(y), lam=LAM, loss="hinge")
    p_star, _ = ref_solve_reference(rp, iters=80)
    ref_sims = {m: RefCluster().simulate(rp, "cocoa", m, ITERS, seed=SEED) for m in MS}
    pp = problem_from_numpy(X, y, LAM, device="cpu")
    port_curves = {}
    for m in MS:
        nl = -(-N // m)
        rec = run_cocoa(pp, CocoaConfig(m, ITERS, seed=SEED),
                        indices=reference_index_source(SEED, m, nl, nl, ITERS))
        port_curves[m] = rec.primal
    return pp, p_star, ref_sims, port_curves


def _plan(lib, curves, t_iter, p_star):
    """The Hemingway fit and both queries, with one package's core."""
    ms = sorted(curves)
    sys_model = lib.ErnestModel().fit(np.asarray(ms, float), np.full(len(ms), N, float),
                                      np.asarray([t_iter[m] for m in ms]))
    best = {m: np.minimum.accumulate(c) for m, c in curves.items()}
    conv = lib.ConvergenceModel().fit(
        lib.ConvergenceData.from_curves(best, p_star - 1e-5))
    planner = lib.Planner({"cocoa": lib.CombinedModel(sys_model, conv, N, 2000)})
    return (planner.fastest_to_epsilon(EPS, m_grid=ms),
            planner.best_within_budget(BUDGET_S, m_grid=ms))


def test_curves_match_reference(setup):
    _, _, ref_sims, port_curves = setup
    for m in MS:
        np.testing.assert_allclose(port_curves[m], ref_sims[m].record.primal,
                                   rtol=1e-4, err_msg=f"m={m}")


def test_planner_decisions_match_on_reference_times(setup):
    _, p_star, ref_sims, port_curves = setup
    t_iter = {m: s.t_iter for m, s in ref_sims.items()}
    ref_curves = {m: s.record.primal for m, s in ref_sims.items()}
    r1, r2 = _plan(ref_core, ref_curves, t_iter, p_star)
    p1, p2 = _plan(core, port_curves, t_iter, p_star)
    assert r1 and r2
    assert (p1.algorithm, p1.m) == (r1.algorithm, r1.m)
    assert (p2.algorithm, p2.m) == (r2.algorithm, r2.m)
    np.testing.assert_allclose(p1.predicted_time, r1.predicted_time, rtol=1e-2)
    np.testing.assert_allclose(p2.predicted_value, r2.predicted_value, rtol=1e-4)


def test_planner_feasible_on_own_times(setup):
    pp, p_star, _, _ = setup
    cluster = BSPCluster()
    sims = {m: cluster.simulate(pp, "cocoa", m, ITERS, seed=SEED) for m in MS}
    for m, s in sims.items():
        assert s.t_iter > 0 and np.all(np.isfinite(s.record.primal)), m
    d1, d2 = _plan(core, {m: s.record.primal for m, s in sims.items()},
                   {m: s.t_iter for m, s in sims.items()}, p_star)
    assert d1, d1.reason
    assert d2, d2.reason
    assert d1.m in MS and d1.predicted_time > 0
    assert d2.m in MS and np.isfinite(d2.predicted_value)


def test_ernest_samples_and_fit(setup):
    """Ernest's data acquisition on the port: small m, data fractions, one
    positive t_iter per (m, size); the NNLS fit predicts positive times."""
    pp = setup[0]
    cluster = BSPCluster()
    samples = cluster.collect_ernest_samples(pp, "cocoa+", [(1, 0.25), (2, 0.5), (4, 1.0)])
    assert [(m, size) for m, size, _ in samples] == [(1, 128.0), (2, 256.0), (4, 512.0)]
    assert all(t > 0 for _, _, t in samples)
    model = cluster.fit_ernest(samples)
    assert np.all(model.predict(np.asarray([1.0, 8.0]), N) > 0)


def test_unported_algorithms_raise(setup):
    """The port runs the reference's six algorithms; a name outside that
    menu raises with the reference's message, naming the menu."""
    with pytest.raises(ValueError, match=r"unknown algorithm 'admm'; known \('cocoa'"):
        BSPCluster().simulate(setup[0], "admm", 2, 1)
