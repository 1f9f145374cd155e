"""Port parity: mini-batch SGD, local SGD and GD against ``repro.optim.sgd``,
and the local-SGD worker chain's plain version (K6's, ``local_sgd_ref``)
against the reference's worker scan.

Each run is fed the reference's own index streams, recomputed from its key
schedule (a round key split from the run's key, split over the workers, then
``randint`` or ``permutation``: sgd.py:38-41, :104-110).

What differs from the reference, and so each tolerance:
- The float32 sums: the dot products and the averages over workers are
  summed in another order, and XLA's CPU backend fuses the reference's
  ``lam * w + c * x`` and ``w - lr * g`` into fused multiply-adds, where the
  port rounds every product as written (so the kernel on the card, which
  does the same, agrees with the plain version up to the dot's order).  One
  round of 150 to 600 steps measured at most 6e-7 of max |w| apart; five
  rounds of local SGD, twenty of mini-batch SGD and fifty of GD at most
  4.5e-7.  So w is held within W_RTOL_OF_MAX = 1e-5 of max |w| and the primal
  curves at rtol 1e-5, twenty times that.
- The hinge's gate ``z < 1`` is a step function: where the two runs' z
  straddle 1, one steps by lr y x and the other does not, and their w part
  by lr |x| (lr is 10 at lambda 1e-3).  The test bounds that.  While the two
  runs agree within delta = W_RTOL_OF_MAX max |w|, a step's z differs by at
  most |y| (sum |x| delta + d 2^-24 sum |x w|) (the carried difference, and
  float32's bound on a dot product summed in any order); every hinge run here
  asserts that each step's |z - 1| exceeds that bound (``_hinge_gate_clear``),
  so no gate was within reach of a flip and the comparison above holds.  A
  seed whose run passes that close to a gate fails that assertion, rather
  than being compared as if it had not.
- The smooth hinge is continuous, but at gamma 0.5 with lr 10 its chain
  amplifies a one-ulp change of its input to more than 1e-3 of max |w|
  after five rounds, in the plain version alone
  (``test_smooth_hinge_sensitivity_sets_where_it_is_compared``): the
  algorithm's own sensitivity there, which no port can be held to at float
  tolerance.  The smooth hinge runs at gamma 1 (the ERMProblem default and
  the chaos run's), where the same change moves w by under 1e-5.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    reference_index_source,
    reference_minibatch_source,
    reference_ssp_indices,
)
from repro.optim import sgd as ref_sgd
from repro.optim import simcluster as ref_sim
from repro.optim.problems import ERMProblem as RefProblem
from repro.optim.problems import synthetic_mnist
from repro_torch.convert import problem_from_numpy
from repro_torch.kernels.local_sgd.ops import local_sgd
from repro_torch.kernels.local_sgd.ref import local_sgd_ref, step_sizes
from repro_torch.optim import sgd
from repro_torch.optim.cocoa import partition

N, D, LAM = 600, 24, 1e-3
W_RTOL_OF_MAX = 1e-5
CURVE_RTOL = 1e-5
LOSSES = ("hinge", "smooth_hinge", "logistic")


@pytest.fixture(scope="module")
def data():
    return synthetic_mnist(N, D, 12, 0.15, 0.35, 4)


def _problems(data, loss):
    X, y = data
    return (RefProblem(jnp.asarray(X), jnp.asarray(y), LAM, loss),
            problem_from_numpy(X, y, LAM, loss, device="cpu"))


def _assert_w_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    assert err <= W_RTOL_OF_MAX * float(np.abs(want).max()), (what, err)


def _assert_gate_clear(z, x, y, w, what):
    """Every margin z (of rows x, labels y, at w: x (..., d), w (..., d) or
    (d,)) farther from the hinge's gate at 1 than the bound above."""
    delta = W_RTOL_OF_MAX * float(w.abs().max())
    dot_err = x.shape[-1] * 2.0 ** -24 * (x * w).abs().sum(-1)
    reach = y.abs() * (x.abs().sum(-1) * delta + dot_err)
    assert bool(((z - 1.0).abs() > reach).all()), f"{what}: a hinge gate within reach"


def _hinge_gate_clear(W0, X, y, idx, t, lr0, t0, lam):
    """Replays the plain chain (the same operations as ``local_sgd_ref``),
    holding every step's margins clear of the gate.  Returns the chain's
    end, which must equal ``local_sgd_ref``'s."""
    m = X.shape[0]
    rows = torch.arange(m)
    w = W0.clone()
    h = idx.shape[1]
    for i, lr in enumerate(step_sizes(t, h, h, lr0, t0, lam).tolist()):
        j = idx[:, i]
        x, yj = X[rows, j], y[rows, j]
        z = yj * torch.sum(x * w, dim=1)
        _assert_gate_clear(z, x, yj, w, f"step {i}")
        g = (torch.where(z < 1.0, -1.0, 0.0) * yj)[:, None] * x + float(np.float32(lam)) * w
        w = w - lr * g
    return w


@pytest.mark.parametrize("loss", LOSSES)
def test_worker_chain_matches_reference_scan(data, loss):
    """K6's plain version against the reference's worker scan
    (``_ssp_outer_step`` with only worker 0 syncing, which returns every
    worker's local result as it is: the others are stale, and worker 0's
    average over one is itself), from four different start vectors, with
    draws with repeats (H = 2 nl)."""
    X, y = data
    m, h, t, lr0, t0 = 4, 300, 3, 1.0, 100.0
    Xs_r, ys_r = ref_sim.partition(jnp.asarray(X), jnp.asarray(y), m)
    nl = Xs_r.shape[1]
    W0 = (0.05 * np.random.RandomState(0).randn(m, D)).astype(np.float32)
    mask = np.array([1, 0, 0, 0], np.float32)
    want, _ = ref_sim._ssp_outer_step((loss, 1.0, lr0, t0), Xs_r, ys_r, jnp.asarray(W0), h,
                                      jnp.asarray(mask), LAM, jnp.float32(t),
                                      jax.random.fold_in(jax.random.PRNGKey(5), t))
    idx = torch.from_numpy(reference_ssp_indices(5, t, m, h, nl))
    args = (torch.from_numpy(W0), torch.from_numpy(np.array(Xs_r)),
            torch.from_numpy(np.array(ys_r)), idx)
    got = local_sgd_ref(*args, t, h, lr0, t0, LAM, loss)
    assert np.abs(np.asarray(want) - W0).max() > 0.1  # the chain moved w
    _assert_w_close(got, want, loss)
    if loss == "hinge":
        assert torch.equal(_hinge_gate_clear(*args, t, lr0, t0, LAM), got)
    # the wrapper takes the plain version for CPU tensors, and so does
    # use_kernel=False; neither counts as a kernel launch
    before = local_sgd.launches
    assert torch.equal(local_sgd(*args, t, h, lr0, t0, LAM, loss), got)
    assert torch.equal(local_sgd(*args, t, h, lr0, t0, LAM, loss, use_kernel=False), got)
    assert local_sgd.launches == before


def test_step_sizes_are_the_references_float32():
    """lr0 / (lam (t h + i + t0)), each operation in float32, as the
    reference's scan computes it from float32 t and step_i."""
    t, h, lr0, t0, lam = 7, 3750, 1.0, 100.0, 1e-4
    want = jax.jit(lambda i: lr0 / (jnp.float32(lam) * (jnp.float32(t) * h + i + t0)))(
        jnp.arange(h, dtype=jnp.float32))
    np.testing.assert_array_equal(step_sizes(t, h, h, lr0, t0, lam), np.asarray(want))
    np.testing.assert_array_equal(step_sizes(t, h, 10, lr0, t0, lam), np.asarray(want)[:10])


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("m", [1, 4, 16])
def test_local_sgd_matches_reference(data, m, loss):
    rp, pp = _problems(data, loss)
    rounds = 5
    nl = -(-N // m)
    want = ref_sgd.run_local_sgd(rp, ref_sgd.LocalSGDConfig(m, rounds, seed=m))
    # the local-SGD draws follow the same schedule as CoCoA's (cocoa.py:85-89)
    source = reference_index_source(m, m, nl, nl, rounds)
    got = sgd.run_local_sgd(pp, sgd.LocalSGDConfig(m, rounds, seed=m), indices=source)
    _assert_w_close(got.w, want.w, (loss, m))
    np.testing.assert_allclose(got.primal, want.primal, rtol=CURVE_RTOL)
    assert np.isnan(got.dual).all() and np.isnan(got.gap).all()
    assert got.primal.shape == (rounds,) and got.compute_seconds > 0
    if loss == "hinge":  # every round's chains clear of the gate
        Xs, ys = partition(pp.X, pp.y, m)
        w = torch.zeros(D)
        for it in range(rounds):
            W = _hinge_gate_clear(w.expand(m, -1).contiguous(), Xs, ys,
                                  torch.as_tensor(source(it)), it, 1.0, 100.0, LAM)
            w = torch.mean(W, 0)
        np.testing.assert_array_equal(w.numpy(), got.w)


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("m", [1, 4, 16])
def test_minibatch_sgd_matches_reference(data, m, loss):
    """Pegasos steps on (m, 16) minibatches with the projection.  For the
    hinge, every round's minibatch margins are held clear of the gate as the
    local chains' are (a flip moves the round's step by lr y x / (m B))."""
    rp, pp = _problems(data, loss)
    rounds, b = 20, 16
    nl = -(-N // m)
    want = ref_sgd.run_minibatch_sgd(rp, ref_sgd.SGDConfig(m, rounds, batch_per_worker=b,
                                                           seed=m))
    source = reference_minibatch_source(m, m, nl, b, rounds)
    got = sgd.run_minibatch_sgd(pp, sgd.SGDConfig(m, rounds, batch_per_worker=b, seed=m),
                                indices=source)
    _assert_w_close(got.w, want.w, (loss, m))
    np.testing.assert_allclose(got.primal, want.primal, rtol=CURVE_RTOL)
    assert np.isnan(got.gap).all()
    if loss == "hinge":
        Xs, ys = partition(pp.X, pp.y, m)
        rows = torch.arange(m)[:, None]
        w = torch.zeros(D)
        for it in range(rounds):
            idx = torch.as_tensor(source(it))
            xb, yb = Xs[rows, idx], ys[rows, idx]
            _assert_gate_clear(yb * (xb @ w), xb, yb, w, f"round {it}")
            w = sgd.minibatch_sgd_step(Xs, ys, w, idx, LAM, it + 1.0)
        np.testing.assert_array_equal(w.numpy(), got.w)


@pytest.mark.parametrize("loss", LOSSES)
def test_gd_matches_reference(data, loss):
    rp, pp = _problems(data, loss)
    want = ref_sgd.run_gd(rp, ref_sgd.GDConfig(50), record_every=5)
    got = sgd.run_gd(pp, sgd.GDConfig(50), record_every=5)
    _assert_w_close(got.w, want.w, loss)
    np.testing.assert_allclose(got.primal, want.primal, rtol=CURVE_RTOL)
    assert got.primal.shape == want.primal.shape == (11,)


def test_port_draws_are_seeded_and_shaped(data):
    """Without ``indices`` each run draws from a generator seeded with
    ``cfg.seed``: the same seed gives the same run, another seed another."""
    _, pp = _problems(data, "hinge")
    a = sgd.run_local_sgd(pp, sgd.LocalSGDConfig(4, 3, local_steps=50, seed=1))
    b = sgd.run_local_sgd(pp, sgd.LocalSGDConfig(4, 3, local_steps=50, seed=1))
    c = sgd.run_local_sgd(pp, sgd.LocalSGDConfig(4, 3, local_steps=50, seed=2))
    np.testing.assert_array_equal(a.w, b.w)
    assert not np.array_equal(a.w, c.w)
    d = sgd.run_minibatch_sgd(pp, sgd.SGDConfig(4, 3, seed=1))
    e = sgd.run_minibatch_sgd(pp, sgd.SGDConfig(4, 3, seed=1))
    np.testing.assert_array_equal(d.w, e.w)
    # Pegasos' projection keeps w in the ball ||w|| <= 1 / sqrt(lam)
    assert np.linalg.norm(d.w) <= 1.0 / np.sqrt(LAM) * (1 + 1e-6)


@pytest.mark.parametrize("algorithm", ["cocoa", "cocoa+", "minibatch_sgd", "local_sgd", "gd",
                                       "lbfgs"])
def test_run_algorithm_runs_the_whole_menu(data, algorithm):
    """The reference's six names, each through ``run_algorithm`` and
    ``BSPCluster.simulate`` on CPU tensors (L-BFGS on the smooth hinge)."""
    from repro.optim.simcluster import ALGORITHMS as REF_ALGORITHMS
    from repro_torch.optim import ALGORITHMS, BSPCluster, run_algorithm

    assert ALGORITHMS == REF_ALGORITHMS and algorithm in ALGORITHMS
    _, pp = _problems(data, "smooth_hinge" if algorithm == "lbfgs" else "hinge")
    rec = run_algorithm(pp, algorithm, 4, 3, seed=1, local_iters=40, batch_per_worker=8)
    assert rec.primal.shape == (3,) and np.isfinite(rec.primal).all()
    assert rec.w.shape == (D,) and np.isfinite(rec.w).all()
    sim = BSPCluster().simulate(pp, algorithm, 4, 3, local_iters=40)
    assert sim.t_iter > 0 and sim.wall_times.shape == (3,)


def test_run_algorithm_names_the_menu_on_an_unknown_name(data):
    from repro.optim.simcluster import run_algorithm as ref_run_algorithm
    from repro_torch.optim import run_algorithm

    _, pp = _problems(data, "hinge")
    with pytest.raises(ValueError) as ours:
        run_algorithm(pp, "admm", 2, 1)
    with pytest.raises(ValueError) as theirs:
        ref_run_algorithm(RefProblem(pp.X.numpy(), pp.y.numpy(), LAM), "admm", 2, 1)
    assert str(ours.value) == str(theirs.value)


def test_first_gate_ties_finds_a_margin_at_the_gate():
    """``first_gate_ties`` (the card's check of the hinge, see
    tests/test_torch_local_sgd_gpu.py) names each worker's first step whose
    margin lies within the dot's rounding bound of 1, and H where none does."""
    from repro_torch.kernels.local_sgd.ref import first_gate_ties

    X = torch.tensor([[[1.0, 0.0], [0.0, 1.0]], [[1.0, 0.0], [0.0, 1.0]]])
    y = torch.ones((2, 2))
    W0 = torch.tensor([[0.5, 0.0], [0.5, 1.0]])
    idx = torch.tensor([[0, 1, 0], [0, 1, 1]])
    # lr0 = 0 leaves w as it is: worker 0's margins 0.5, 0, 0.5 (no tie);
    # worker 1's 0.5, then 1 at step 1
    ties = first_gate_ties(W0, X, y, idx, 0, 3, 0.0, 100.0, 1e-2)
    assert ties.tolist() == [3, 1]
    # a margin one float32 step below 1 is within reach too
    W0[1, 1] = float(np.nextafter(np.float32(1.0), np.float32(0.0)))
    assert first_gate_ties(W0, X, y, idx, 0, 3, 0.0, 100.0, 1e-2).tolist() == [3, 1]


def test_smooth_hinge_sensitivity_sets_where_it_is_compared(data):
    """The docstring's reason for comparing the smooth hinge at gamma 1: in
    the plain version alone, one ulp added to a tenth of X's entries moves
    w after five rounds of local SGD (m 4, lr 10 at the start) by over 1e-3
    of max |w| at gamma 0.5, and by under W_RTOL_OF_MAX at gamma 1."""
    X, y = data
    X2 = X.copy()
    sel = np.random.RandomState(0).rand(*X.shape) < 0.1
    X2[sel] = np.nextafter(X2[sel], np.float32(2.0))
    source = reference_index_source(4, 4, N // 4, N // 4, 5)
    moved = {}
    for gamma in (0.5, 1.0):
        a, b = (sgd.run_local_sgd(problem_from_numpy(x, y, LAM, "smooth_hinge", gamma,
                                                     device="cpu"),
                                  sgd.LocalSGDConfig(4, 5), indices=source).w for x in (X, X2))
        moved[gamma] = float(np.abs(a - b).max() / np.abs(a).max())
    assert moved[0.5] > 1e-3 and moved[1.0] < W_RTOL_OF_MAX, moved
