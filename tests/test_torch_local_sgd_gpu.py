"""The local-SGD CUDA kernel (K6) against its plain version, on the card.

Marked ``gpu``: without a CUDA device each test skips from inside itself, so
every worker collects the same tests.  Run on the card with
``python -m pytest -q --noconftest -m gpu tests/test_torch_local_sgd_gpu.py``.

The kernel and the plain version do the same operations, each rounded as
written, except the dot product's order of summation (the kernel's: 32 lane
partials, each strided over d, then an xor butterfly).  So:
- the hinge, whose slope is -1 or 0, gives the same bits unless some step's
  margin lies within the two sums' difference of the gate at 1; each worker
  of a hinge case is held bit for bit, or, where it differs, to a margin
  within float32's bound on the dot of the gate (``first_gate_ties``), with
  the kernel's chain bit for bit the plain version's up to that step;
- the smooth hinge and the logistic loss carry the sums' last-bit
  difference through a continuous slope; at the chaos run's step sizes
  (lr0 0.01, lambda 1e-2: each step a contraction) W is held within
  W_RTOL_OF_MAX = 1e-5 of max |W|, as on the CPU against the reference.
The cases: the chaos run's shapes (n 512, d 32, m 1 to 4, H 1 and 2, stale
start vectors, t > 0), the paper's (60000 x 784, hinge, m 16 and 128, and a
whole m = 1 round of 60000 steps), the shared-memory path (d 1281 and
MAX_D) and widths off the lane count; and the ring of staged rows: rounds
of 0 to 2 steps (run without the ring) and longer ones shorter than the
ring and not a multiple of the refill batch, rows drawn
forty times a round, a shard that is not 16-byte aligned (the 4-byte copy
route, the same bits as the bulk route), SSP's stale start vectors at the
paper's d, and the library's plan against ``ops.kernel_plan``.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import ctypes

import pytest
import torch

from repro_torch.kernels.local_sgd import ops
from repro_torch.kernels.local_sgd.ref import first_gate_ties, local_sgd_ref
from repro_torch.optim.cocoa import draw_indices, partition
from repro_torch.optim.problems import synthetic_mnist

pytestmark = pytest.mark.gpu

W_RTOL_OF_MAX = 1e-5


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _shards(dev, m, n, d, seed=0):
    X, y = synthetic_mnist(n, d, min(16, d), 0.09, 0.35, seed)
    return partition(torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev), m)


def check_hinge(W0, Xs, ys, idx, t, lr0, t0, lam):
    """Bit for bit, or each differing worker's difference explained by a
    gate tie, the kernel's chain bit for bit the plain version's up to it
    (a run of the round's first steps).  Returns the differing workers."""
    h = idx.shape[1]
    got = ops.local_sgd(W0, Xs, ys, idx, t, h, lr0, t0, lam, "hinge")
    want = local_sgd_ref(W0, Xs, ys, idx, t, h, lr0, t0, lam, "hinge")
    differ = (got != want).any(1).nonzero().flatten().tolist()
    if differ:
        ties = first_gate_ties(W0, Xs, ys, idx, t, h, lr0, t0, lam)
        for k in differ:
            tie = int(ties[k])
            assert tie < h, f"worker {k} differs with no gate within reach"
            head = idx[:, :tie].contiguous()
            assert torch.equal(ops.local_sgd(W0, Xs, ys, head, t, h, lr0, t0, lam, "hinge")[k],
                               local_sgd_ref(W0, Xs, ys, head, t, h, lr0, t0, lam, "hinge")[k])
    return differ


@pytest.mark.parametrize("loss", ["hinge", "smooth_hinge", "logistic"])
@pytest.mark.parametrize("m,h", [(1, 1), (2, 2), (4, 1), (4, 2)])
def test_kernel_matches_plain_at_the_chaos_shapes(m, h, loss):
    dev = _card()
    Xs, ys = _shards(dev, m, 512, 32, seed=m)
    nl = Xs.shape[1]
    gen = torch.Generator(device=dev).manual_seed(m + h)
    W0 = 0.1 * torch.randn((m, 32), generator=gen, device=dev)  # stale copies
    for t in (0, 37, 159):
        idx = torch.randint(0, nl, (m, h), generator=gen, device=dev)
        if loss == "hinge":
            check_hinge(W0, Xs, ys, idx, t, 0.01, 100.0, 1e-2)
            continue
        args = (W0, Xs, ys, idx, t, h, 0.01, 100.0, 1e-2, loss)
        before = ops.local_sgd.launches
        got = ops.local_sgd(*args)
        torch.cuda.synchronize()
        assert ops.local_sgd.launches == before + 1
        want = local_sgd_ref(*args)
        assert float((got - want).abs().max()) <= W_RTOL_OF_MAX * float(want.abs().max())


@pytest.mark.parametrize("m", [1, 16, 128])
def test_kernel_matches_plain_at_the_papers_shape(m):
    """One round of the paper's 60000 x 784 hinge SVM at lambda 1e-4, each
    worker one local epoch (H = nl)."""
    dev = _card()
    Xs, ys = _shards(dev, m, 60000, 784)
    nl = Xs.shape[1]
    idx = draw_indices(m, nl, nl, torch.Generator(device=dev).manual_seed(m))
    W0 = torch.zeros((m, 784), device=dev)
    check_hinge(W0, Xs, ys, idx, 0, 1.0, 100.0, 1e-4)


@pytest.mark.parametrize("d", [1, 31, 33, 784, 1280, 1281, ops.MAX_D])
def test_kernel_matches_plain_at_every_path(d):
    """Register path (d <= 1280) and shared-memory path, widths off the
    lane count, draws with repeats (H = 3 nl)."""
    dev = _card()
    m, n = 3, 301
    Xs, ys = _shards(dev, m, n, d, seed=d)
    nl = Xs.shape[1]
    gen = torch.Generator(device=dev).manual_seed(d)
    idx = torch.randint(0, nl, (m, 3 * nl), generator=gen, device=dev)
    W0 = 0.05 * torch.randn((m, d), generator=gen, device=dev)
    check_hinge(W0, Xs, ys, idx, 3, 0.01, 100.0, 1e-2)
    h = idx.shape[1]
    got = ops.local_sgd(W0, Xs, ys, idx, 3, h, 0.01, 100.0, 1e-2, "logistic")
    want = local_sgd_ref(W0, Xs, ys, idx, 3, h, 0.01, 100.0, 1e-2, "logistic")
    assert float((got - want).abs().max()) <= W_RTOL_OF_MAX * float(want.abs().max())


def test_two_launches_give_the_same_bits_and_inputs_stay():
    dev = _card()
    Xs, ys = _shards(dev, 16, 6000, 784)
    idx = draw_indices(16, Xs.shape[1], Xs.shape[1], torch.Generator(device=dev).manual_seed(0))
    W0 = torch.full((16, 784), 0.01, device=dev)
    keep = W0.clone()
    h = idx.shape[1]
    a = ops.local_sgd(W0, Xs, ys, idx, 2, h, 1.0, 100.0, 1e-4, "smooth_hinge")
    b = ops.local_sgd(W0, Xs, ys, idx, 2, h, 1.0, 100.0, 1e-4, "smooth_hinge")
    assert torch.equal(a, b) and torch.equal(W0, keep)
    assert ops.local_sgd(W0, Xs, ys, idx[:, :0].contiguous(), 2, h, 1.0, 100.0, 1e-4).equal(W0)


def test_kernel_rejects_what_it_cannot_take():
    """The wrapper refuses CUDA tensors the kernel cannot take, and counts
    no launch for them; use_kernel=False names the plain version."""
    dev = _card()
    Xs, ys = _shards(dev, 2, 64, 8)
    idx = torch.zeros((2, 4), dtype=torch.int32, device=dev)
    W0 = torch.zeros((2, 8), device=dev)
    before = ops.local_sgd.launches
    bad = [
        ((W0.double(), Xs, ys, idx), TypeError),
        ((W0, Xs.half(), ys, idx), TypeError),
        ((W0, Xs, ys, idx.float()), TypeError),
        ((W0[:1], Xs, ys, idx), ValueError),
        ((W0, Xs, ys[:, :3], idx), ValueError),
        ((W0, Xs, ys, idx[0]), ValueError),
        ((W0.t().contiguous().t(), Xs, ys, idx), ValueError),
        ((W0, Xs.transpose(1, 2).contiguous().transpose(1, 2), ys, idx), ValueError),
        ((W0, Xs, ys, idx.cpu()), ValueError),
    ]
    for args, error in bad:
        with pytest.raises(error):
            ops.local_sgd(*args, 0, 4, 1.0, 100.0, 1e-2)
    with pytest.raises(ValueError, match="supports"):
        ops.local_sgd(W0, Xs, ys, idx, 0, 4, 1.0, 100.0, 1e-2, "squared")
    wide = torch.zeros((1, 1, ops.MAX_D + 1), device=dev)
    with pytest.raises(ValueError, match="d="):
        ops.local_sgd(torch.zeros((1, ops.MAX_D + 1), device=dev), wide,
                      torch.ones((1, 1), device=dev), torch.zeros((1, 1), dtype=torch.int32,
                                                                  device=dev), 0, 1, 1.0, 1.0,
                      1.0)
    assert ops.local_sgd.launches == before
    plain = ops.local_sgd(W0, Xs, ys, idx, 0, 4, 1.0, 100.0, 1e-2, use_kernel=False)
    assert ops.local_sgd.launches == before and plain.device.type == "cuda"


def test_chain_probe_runs():
    """The library's chain probe (chip_smoke.py's chain floor) at the
    paper's and the chaos run's widths."""
    from repro_torch.kernels.local_sgd import build

    dev = _card()
    out = torch.empty(1, device=dev)
    lib = build.load()
    for d in (32, 784):
        err = lib.local_sgd_chain_launch(d, 1000, 1.0, 100.0, 1e-4, out.data_ptr(),
                                         torch.cuda.current_stream().cuda_stream)
        build.LIBRARY.check(err, "local_sgd_chain")
        torch.cuda.synchronize()
        assert bool(torch.isfinite(out).all())
    assert lib.local_sgd_register_entries(784) == 25
    assert lib.local_sgd_register_entries(1281) == 0
    assert lib.local_sgd_max_d() == ops.MAX_D


@pytest.mark.parametrize("d", [32, 784])
def test_ring_probe_runs(d):
    """The library's ring probe (chip_smoke.py's K6 step in parts) in both
    its modes at the paper's and the chaos run's widths; other modes and the
    shared-memory path refused."""
    from repro_torch.kernels.local_sgd import build

    dev = _card()
    m = 4
    Xs, ys = _shards(dev, m, 4 * 300, d)
    nl = Xs.shape[1]
    idx = torch.randint(0, nl, (m, nl), generator=torch.Generator(device=dev).manual_seed(0),
                        device=dev).to(torch.int32)
    W0, W = torch.zeros((m, d), device=dev), torch.empty((m, d), device=dev)
    lib = build.load()

    def probe(mode, width=d):
        return lib.local_sgd_probe_launch(W0.data_ptr(), Xs.data_ptr(), ys.data_ptr(),
                                          idx.data_ptr(), W.data_ptr(), m, nl, width, nl, 0.0,
                                          nl, 1.0, 100.0, 1e-4, mode,
                                          torch.cuda.current_stream().cuda_stream)

    for mode in (1, 2):
        build.LIBRARY.check(probe(mode), "local_sgd_probe")
        torch.cuda.synchronize()
        assert bool(torch.isfinite(W).all())
    assert probe(0) != 0 and probe(3) != 0 and probe(1, width=1281) != 0


@pytest.mark.parametrize("d", [32, 33, 784, 1281])
def test_rounds_shorter_than_the_ring_and_ragged_batches(d):
    """Rounds of 0 to 33 steps: up to 2 without the ring (the register
    path's direct rounds), then fewer than the ring's rows and not a
    multiple of the four rows staged together; both copy routes (d 33 the
    4-byte one) and the shared-memory path (d 1281)."""
    dev = _card()
    m = 3
    Xs, ys = _shards(dev, m, 3 * 40, d, seed=d)
    gen = torch.Generator(device=dev).manual_seed(d)
    W0 = 0.05 * torch.randn((m, d), generator=gen, device=dev)
    for steps in (0, 1, 2, 3, 5, 15, 16, 17, 18, 31, 33):
        idx = torch.randint(0, Xs.shape[1], (m, steps), generator=gen, device=dev)
        check_hinge(W0, Xs, ys, idx, 3, 0.01, 100.0, 1e-2)
        args = (W0, Xs, ys, idx, 3, max(steps, 1), 0.01, 100.0, 1e-2, "logistic")
        got, want = ops.local_sgd(*args), local_sgd_ref(*args)
        assert float((got - want).abs().max()) <= W_RTOL_OF_MAX * float(want.abs().max())


def test_rows_drawn_many_times_in_a_round():
    """h = 40 nl at the paper's d: each row is staged again and again, up to
    several times within one ring's span."""
    dev = _card()
    m = 4
    Xs, ys = _shards(dev, m, 4 * 5, 784, seed=5)
    gen = torch.Generator(device=dev).manual_seed(5)
    idx = torch.randint(0, Xs.shape[1], (m, 200), generator=gen, device=dev)
    W0 = 0.05 * torch.randn((m, 784), generator=gen, device=dev)
    check_hinge(W0, Xs, ys, idx, 1, 0.01, 100.0, 1e-2)
    args = (W0, Xs, ys, idx, 1, 200, 0.01, 100.0, 1e-2, "smooth_hinge")
    got, want = ops.local_sgd(*args), local_sgd_ref(*args)
    assert float((got - want).abs().max()) <= W_RTOL_OF_MAX * float(want.abs().max())


def test_a_storage_offset_takes_the_4_byte_route_with_the_same_bits():
    """X one float past a 16-byte boundary (contiguous, a storage offset of
    1) at the paper's d: the kernel stages by 4-byte copies and gives the
    bulk route's bits."""
    dev = _card()
    m = 16
    Xs, ys = _shards(dev, m, 60000, 784)
    nl = Xs.shape[1]
    X_off = torch.empty(Xs.numel() + 1, device=dev)[1:].view(Xs.shape)
    X_off.copy_(Xs)
    assert X_off.is_contiguous() and X_off.storage_offset() == 1
    assert ops.copy_route(Xs) == "bulk" and ops.copy_route(X_off) == "cp.async 4-byte"
    idx = draw_indices(m, nl, nl, torch.Generator(device=dev).manual_seed(3))
    W0 = torch.zeros((m, 784), device=dev)
    for args in ((0, nl, 1.0, 100.0, 1e-4, "hinge"), (2, nl, 0.01, 100.0, 1e-2, "logistic")):
        assert torch.equal(ops.local_sgd(W0, X_off, ys, idx, *args),
                           ops.local_sgd(W0, Xs, ys, idx, *args))
    check_hinge(W0, X_off, ys, idx[:, :500].contiguous(), 0, 1.0, 100.0, 1e-4)


def test_ssp_stale_start_vectors_at_the_papers_width():
    """SSP's outer step at the paper's d: every worker from its own stale
    copy, t > 0, one local epoch of draws with replacement."""
    dev = _card()
    m = 16
    Xs, ys = _shards(dev, m, 60000, 784)
    nl = Xs.shape[1]
    gen = torch.Generator(device=dev).manual_seed(7)
    W0 = 0.01 * torch.randn((m, 784), generator=gen, device=dev)
    idx = torch.randint(0, nl, (m, nl), generator=gen, device=dev)
    check_hinge(W0, Xs, ys, idx, 7, 1.0, 100.0, 1e-4)
    args = (W0, Xs, ys, idx, 7, nl, 0.01, 100.0, 1e-2, "smooth_hinge")
    got, want = ops.local_sgd(*args), local_sgd_ref(*args)
    assert float((got - want).abs().max()) <= W_RTOL_OF_MAX * float(want.abs().max())


def test_library_plan_equals_kernel_plan():
    """The library's ``local_sgd_plan`` at every width against its Python
    mirror (entries a lane, ring rows, rows staged together, shared bytes),
    and widths outside 1 .. MAX_D refused."""
    from repro_torch.kernels.local_sgd import build

    _card()
    lib = build.load()
    out = (ctypes.c_int * 4)()
    for d in range(1, ops.MAX_D + 1):
        assert lib.local_sgd_plan(d, out) == 0, d
        e, ring, smem = ops.kernel_plan(d)
        assert list(out) == [e, ring, ops.refill_rows(ring), smem], d
        assert lib.local_sgd_register_entries(d) == e, d
    assert lib.local_sgd_plan(0, out) != 0 and lib.local_sgd_plan(ops.MAX_D + 1, out) != 0
