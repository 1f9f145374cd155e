"""K6's ring of staged rows and its order lookahead, modelled on the CPU.

The local-SGD kernel (``repro_torch/kernels/local_sgd/csrc/local_sgd.cu``)
runs a worker's chain on one warp and never loads a row on the chain: a ring
of the next P rows sits in shared memory, row r in slot r % P, each copy
completing on its slot's barrier, whose (r // P)-th phase a step awaits
before it reads row r.  The register path (w in registers) stages B =
``refill_rows(P)`` rows every B steps, before it awaits and reads step t +
1's row, refilling the slots of rows t - B + 1 .. t, which earlier steps
read into registers; the shared-memory path reads rows t and t + 1 from
their slots in step t and refills row t's slot after it.  The order's
indices, labels and step sizes come a block of 32 steps at a time, lane l
holding step b + l's, and a step takes its label and size, a staging its
row index, from lane t % 32 of the current block or the next.

``RingModel`` and ``OrderModel`` mirror that schedule line by line (the
kernel's ``Ring``, ``Order``, ``ring_step`` and ``local_sgd_smem_kernel``)
and record what each step does.  The tests hold the schedule to what the
kernel's correctness rests on, for every round length from 0 to 3 P + 5 at
P in {2, 4, 12, 16} on both paths, with rows drawn more than once:
- every row is issued exactly once, by a step before the one that awaits it;
- a step awaits the barrier phase its row's copy completes (the n-th copy
  into a slot completes phase n, parity n % 2), and no slot has two copies
  in flight;
- no slot is refilled before every read of the row in it;
- the rows, labels and step sizes a step receives are idx's order, so a
  chain fed by the model is ``local_sgd_ref`` bit for bit, and the JAX
  package's worker scan within its tolerance.
The kernel runs rounds of at most two steps (the chaos run's) without its
ring, loading their rows straight into registers; the ring's code takes any
round, and the model runs it for every length.  The kernel itself is held
against ``local_sgd_ref`` on the card (``tests/test_torch_local_sgd_gpu.py``).
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import reference_ssp_indices
from repro.optim import simcluster as ref_sim
from repro.optim.problems import synthetic_mnist
from repro_torch.kernels._build import MAX_SMEM_PER_BLOCK
from repro_torch.kernels.local_sgd.ops import (
    LANES,
    MAX_D,
    REGISTER_MAX_D,
    kernel_plan,
    refill_rows,
)
from repro_torch.kernels.local_sgd.ref import local_sgd_ref, step_sizes
from repro_torch.optim.cocoa import partition

RINGS = (2, 4, 12, 16)
W_RTOL_OF_MAX = 1e-5  # the port against the reference's scan (test_torch_sgd.py)


class OrderModel:
    """The kernel's ``Order`` for one worker: lane l's row index, label and
    step size for the current block of 32 steps and the next."""

    def __init__(self, idx, y, sizes):
        self.idx, self.y, self.sizes = list(idx), list(y), list(sizes)
        self.steps = len(self.idx)
        self.j, self.lab, self.lr = self._block(0, labels=True)
        self.nj, _, self.nlr = self._block(LANES, labels=False)
        self.nlab = [None] * LANES  # not yet read
        self.block = 0

    def _index(self, i):
        return self.idx[i] if i < self.steps else 0

    def _block(self, base, labels):
        j = [self._index(base + lane) for lane in range(LANES)]
        lab = [self.y[j[lane]] if labels and base + lane < self.steps else 0.0
               for lane in range(LANES)]
        lr = [self.sizes[base + lane] if base + lane < self.steps else None
              for lane in range(LANES)]
        return j, lab, lr

    def advance(self, t):
        if t % LANES == 0 and t > 0:
            assert None not in self.nlab, f"step {t}: the block's labels were never read"
            self.j, self.lab, self.lr = self.nj, self.nlab, self.nlr
            self.nj, _, self.nlr = self._block(t + LANES, labels=False)
            self.nlab = [None] * LANES
            self.block += 1
        elif t % LANES == LANES // 2:
            base = t + LANES // 2
            self.nlab = [self.y[self.nj[lane]] if base + lane < self.steps else 0.0
                         for lane in range(LANES)]
        assert self.block == t // LANES

    def label(self, t):
        return self.lab[t % LANES]

    def size(self, t):
        return self.lr[t % LANES]

    def row(self, r, t):
        """Row r's index at step t: from the current block or the next."""
        assert t // LANES <= r // LANES <= t // LANES + 1, (r, t)
        return (self.j if r // LANES == t // LANES else self.nj)[r % LANES]


class RingModel:
    """The kernel's ring for one worker, with the events in program order:
    each slot's content, copies in flight, barrier phases and reads."""

    def __init__(self, order, rows, ring, batch):
        self.order, self.rows = order, rows
        self.P, self.B = ring, batch
        self.slots = [None] * ring      # (row r, its data) that landed last
        self.in_flight = [None] * ring  # (row r, its data, the issuing step)
        self.fills = [0] * ring         # copies completed into each slot
        self.issued_at = {}             # row -> the step that issued it
        self.awaited_at = {}
        self.unread = {}                # slot -> row not yet read since landing
        self.events = []

    def stage(self, t, first, count):
        for r in range(first, min(first + count, self.order.steps)):
            s = r % self.P
            assert self.in_flight[s] is None, f"slot {s} has two copies in flight"
            if self.slots[s] is not None:
                prev = self.slots[s][0]
                assert prev in self.awaited_at, f"row {r} overruns row {prev}"
                assert self.unread.get(s) is None, f"row {r} refills {s} before {prev} is read"
            assert r not in self.issued_at
            self.issued_at[r] = t
            # the prologue (step -1) stages with the first block current
            self.in_flight[s] = (r, self.rows[self.order.row(r, max(t, 0))], t)
            self.events.append(("stage", t, r, s))

    def wait(self, t, r):
        s = r % self.P
        parity = (r // self.P) % 2  # the kernel's
        assert self.in_flight[s] is not None and self.in_flight[s][0] == r, \
            f"step {t} awaits row {r}, not in flight in slot {s}"
        assert self.issued_at[r] < t or (t == -1 and self.issued_at[r] == -1)
        assert parity == self.fills[s] % 2  # the phase this copy completes
        self.slots[s] = self.in_flight[s][:2]
        self.in_flight[s] = None
        self.fills[s] += 1
        self.awaited_at[r] = t
        self.unread[s] = r
        self.events.append(("wait", t, r, s, parity))

    def read(self, t, r):
        s = r % self.P
        assert self.slots[s] is not None and self.slots[s][0] == r, (t, r)
        assert self.in_flight[s] is None, f"step {t} reads slot {s} with a copy in flight to it"
        self.unread[s] = None
        self.events.append(("read", t, r, s))
        return self.slots[s][1]

    def assert_refills_follow_reads(self):
        """Every copy into a slot comes after the last read of the row the
        slot held."""
        last_read = {}
        for k, e in enumerate(self.events):
            if e[0] == "read":
                last_read[e[2]] = k
        for k, e in enumerate(self.events):
            if e[0] == "stage" and e[2] >= self.P:
                prev = e[2] - self.P
                assert last_read.get(prev, -1) < k, f"row {e[2]} staged before {prev}'s last read"


def run_schedule(idx, rows, y, sizes, ring, batch, registers):
    """The kernel's schedule for one worker's round (``idx`` its order):
    the model's ring, and each step's row data, label and size as the
    kernel's step receives them.  ``registers``: the register path
    (``local_sgd_kernel``), else the shared-memory path."""
    order = OrderModel(idx, y, sizes)
    rg = RingModel(order, rows, ring, batch)
    steps = order.steps
    got_rows, got_labels, got_sizes = [], [], []
    rg.stage(-1, 0, ring)                      # the prologue
    if steps > 0:
        rg.wait(-1, 0)
        x = rg.read(-1, 0)                     # row 0's partial dot
    for t in range(steps):
        order.advance(t)
        nx = t + 1
        if registers:
            if nx % batch == 0:                # rows up to t are in registers
                rg.stage(t, t + ring - batch + 1, batch)
            if nx < steps:
                rg.wait(t, nx)
                xn = rg.read(t, nx)            # into registers, its partial dot
            got_rows.append(x)                 # step t's update, from registers
            x = xn if nx < steps else None
        else:
            if nx < steps:
                rg.wait(t, nx)
            got_rows.append(rg.read(t, t))     # the update reads row t's slot
            if nx < steps:
                rg.read(t, nx)                 # fused with row t + 1's dot
            if nx % batch == 0:
                rg.stage(t, t + ring - batch + 1, batch)
        got_labels.append(order.label(t))
        got_sizes.append(order.size(t))
    assert all(v is None for v in rg.in_flight), "copies in flight at the end"
    rg.assert_refills_follow_reads()
    return rg, got_rows, got_labels, got_sizes


def _order(steps, nl, seed):
    return np.random.default_rng(seed).integers(0, nl, steps).tolist()


@pytest.mark.parametrize("registers", [True, False], ids=["registers", "shared"])
@pytest.mark.parametrize("ring", RINGS)
def test_schedule_issues_awaits_and_refills_in_order(ring, registers):
    """Every round length 0 .. 3 P + 5, rows drawn with repeats (nl 5)."""
    batch = refill_rows(ring)
    for steps in range(3 * ring + 6):
        nl = 5
        idx = _order(steps, nl, steps)
        rows = [f"row {j}" for j in range(nl)]
        y = [float(j) for j in range(nl)]
        rg, got, _, _ = run_schedule(idx, rows, y, range(steps), ring, batch, registers)
        assert got == [rows[j] for j in idx]
        assert sorted(rg.issued_at) == list(range(steps))
        assert sorted(rg.awaited_at) == list(range(steps))
        for r in range(steps):
            assert rg.issued_at[r] < rg.awaited_at[r] or r < ring
            # row r is staged in the prologue, or by a step after its slot's
            # last row was read (step r - P - 1 or later on either path)
            assert rg.issued_at[r] == -1 if r < ring else rg.issued_at[r] >= r - ring
        waits = [e for e in rg.events if e[0] == "wait"]
        assert [(e[2], e[3], e[4]) for e in waits] == \
            [(r, r % ring, (r // ring) % 2) for r in range(steps)]


@pytest.mark.parametrize("ring", RINGS)
def test_schedule_keeps_rows_staged_ahead(ring):
    """The register path issues each row at least P - B steps before the
    step that awaits it (rows of the prologue aside): the lead the ring
    buys over the copies' latency."""
    batch = refill_rows(ring)
    steps = 5 * ring + 3
    rg, *_ = run_schedule(_order(steps, 7, 1), list(range(7)), [1.0] * 7, range(steps), ring,
                          batch, registers=True)
    lead = min(rg.awaited_at[r] - rg.issued_at[r] for r in range(ring, steps))
    assert lead == ring - batch


@pytest.mark.parametrize("steps", [1, 31, 32, 33, 47, 48, 64, 100, 161])
def test_order_blocks_hand_out_idx_labels_and_sizes(steps):
    """The order's lookahead: block rotations, labels read half a block
    ahead, every step's label and size that of its row and index."""
    nl = 40
    idx = _order(steps, nl, steps)
    y = [float(np.float32(np.sin(j))) for j in range(nl)]
    sizes = step_sizes(3.0, steps, steps, 1.0, 100.0, 1e-4).tolist()
    _, _, labels, got_sizes = run_schedule(idx, list(range(nl)), y, sizes, 16, 4, True)
    assert labels == [y[j] for j in idx]
    assert got_sizes == sizes


def _chain_inputs(m, nl, d, steps, seed):
    X, y = synthetic_mnist(m * nl, d, min(8, d), 0.15, 0.35, seed)
    Xs, ys = partition(torch.from_numpy(X), torch.from_numpy(y), m)
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(0, nl, (m, steps)))
    W0 = torch.from_numpy(0.05 * rng.standard_normal((m, d)).astype(np.float32))
    return Xs, ys, idx, W0


def _fed_by_model(W0, Xs, ys, idx, t, h, lr0, t0, lam, loss, ring, registers):
    """local_sgd_ref fed, worker by worker, the rows and labels the model's
    steps receive (in step order, with their sizes checked bitwise)."""
    m, _, d = Xs.shape
    steps = idx.shape[1]
    sizes = step_sizes(t, h, steps, lr0, t0, lam).tolist()
    rows, labels = torch.empty((m, steps, d)), torch.empty((m, steps))
    for k in range(m):
        _, got, lab, lr = run_schedule(idx[k].tolist(), list(Xs[k]), ys[k].tolist(), sizes,
                                       ring, refill_rows(ring), registers)
        assert lr == sizes
        if steps:
            rows[k] = torch.stack(got)
        labels[k] = torch.tensor(lab)
    order = torch.arange(steps).expand(m, steps)
    return local_sgd_ref(W0, rows, labels, order, t, h, lr0, t0, lam, loss)


@pytest.mark.parametrize("loss", ["hinge", "smooth_hinge", "logistic"])
@pytest.mark.parametrize("ring,registers", [(16, True), (12, True), (4, False), (2, False)])
def test_chain_fed_by_the_model_is_the_plain_version_bit_for_bit(ring, registers, loss):
    """h > nl (repeats), a round not a multiple of the block or the batch."""
    Xs, ys, idx, W0 = _chain_inputs(3, 20, 33, 75, 7)
    args = (W0, Xs, ys, idx, 5.0, 75, 0.01, 100.0, 1e-2, loss)
    got = _fed_by_model(*args[:-1], loss, ring, registers)
    assert torch.equal(got, local_sgd_ref(*args))


@pytest.mark.parametrize("steps", [0, 1, 5, 16, 17])
def test_short_rounds_fed_by_the_model(steps):
    """The chaos run's launches are short (H 1 or 2 at d 32): rounds shorter
    than the ring, and not a multiple of the batch."""
    Xs, ys, idx, W0 = _chain_inputs(4, 128, 32, steps, steps)
    args = (W0, Xs, ys, idx, 37.0, max(steps, 1), 0.01, 100.0, 1e-2, "smooth_hinge")
    assert torch.equal(_fed_by_model(*args, 16, True), local_sgd_ref(*args))


def test_chain_fed_by_the_model_matches_the_reference_scan():
    """The slice against the JAX package: SSP's worker scan
    (``repro/optim/simcluster.py::_ssp_outer_step`` with only worker 0
    syncing, which returns every worker's local result as it is) from four
    stale start vectors at the chaos run's width, step sizes and its draws
    with repeats (h 300 over nl 128), and the model-fed chain."""
    m, h, t, lr0, t0, lam = 4, 300, 9, 0.01, 100.0, 1e-2
    X, y = synthetic_mnist(512, 32, 8, 0.15, 0.35, 3)
    Xs, ys = ref_sim.partition(jnp.asarray(X), jnp.asarray(y), m)
    W0 = (0.05 * np.random.RandomState(3).randn(m, 32)).astype(np.float32)
    want, _ = ref_sim._ssp_outer_step(("smooth_hinge", 1.0, lr0, t0), Xs, ys, jnp.asarray(W0),
                                      h, jnp.asarray(np.array([1, 0, 0, 0], np.float32)), lam,
                                      jnp.float32(t), jax.random.fold_in(jax.random.PRNGKey(5), t))
    idx = torch.from_numpy(reference_ssp_indices(5, t, m, h, Xs.shape[1]))
    got = _fed_by_model(torch.from_numpy(W0), torch.from_numpy(np.array(Xs)),
                        torch.from_numpy(np.array(ys)), idx, float(t), h, lr0, t0, lam,
                        "smooth_hinge", 16, True)
    want = np.asarray(want)
    assert np.abs(want - W0).max() > 1e-3  # the chain moved w
    err = float(np.abs(got.numpy() - want).max())
    assert err <= W_RTOL_OF_MAX * float(np.abs(want).max()), err


def test_kernel_plan_covers_every_width():
    """E covers d, the ring holds 2 to 16 rows, and shared memory stays
    within 227 KB, the register path's within 64 KB of rows (the launcher
    opts in past 48 KB)."""
    assert kernel_plan(784) == (25, 16, 128 + 16 * 128 * 25)  # opts in: 51328 > 48 KB
    assert kernel_plan(32) == (1, 16, 128 + 16 * 128)         # the chaos run's: 2176
    assert kernel_plan(33)[:2] == (2, 16)
    assert kernel_plan(REGISTER_MAX_D)[:2] == (40, 12)
    assert kernel_plan(REGISTER_MAX_D + 1)[:2] == (0, 4)
    assert kernel_plan(MAX_D) == (0, 2, 128 + 3 * 128 * 382)
    assert refill_rows(16) == refill_rows(12) == 4 and refill_rows(4) == refill_rows(2) == 1
    for d in range(1, MAX_D + 1):
        e, ring, smem = kernel_plan(d)
        assert 2 <= ring <= 16, d
        assert smem <= MAX_SMEM_PER_BLOCK, d
        if e:
            assert LANES * e >= d and d <= REGISTER_MAX_D and smem <= 128 + 64 * 1024, d
        else:
            k = -(-d // LANES)
            assert d > REGISTER_MAX_D and smem == 128 + (ring + 1) * 4 * LANES * k, d
