"""The SDCA CUDA kernel against its plain version, on the card.

Marked ``gpu``: without a CUDA device each test skips from inside itself, so
every worker collects the same tests.  Run on the card with
``python -m pytest -q -m gpu tests/test_torch_sdca_gpu.py``.

The kernel and the plain version differ only in the order of each step's two
float32 sums (the kernel's: 32 lane partials, each strided over d, then an
xor butterfly; ``tests/test_torch_sdca_order.py`` models it on the CPU).  On
an H100 at 60000 x 784 one call differs by about 1e-6 in both a and dw
(chip_smoke.py); the tests allow 1e-5 on a and 1e-5 times max |dw| on dw.
The cases cover the kernel's paths: v in registers (d 33, 784, 2048, the
last width there), v in shared memory (2049, MAX_D), 16-byte and 4-byte row
copies (d % 4), a whole m = 1 round at the paper's 60000 x 784, and
coordinates that recur within the ring's window of staged rows.  Every case
has lam n >= 0.1 (the paper's loop has 6): the update divides by lam n, so a
small lam n magnifies each step's rounding, and on an H100 at lam n = 0.06
(n 600, d 2048) the plain version on the CPU and on the card already differ
by 1.0e-5 max |dw| after one round (chip_smoke.py phase 3b).  The longer a
step's sums, the more so: at d = MAX_D (12224) and lam n = 0.8 they differ
by 7.7e-6 max |dw|, as much as the kernel differs from the plain version
there, so that case runs at lam 1e-3 (lam n = 8).
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import pytest
import torch

import numpy as np

from repro_torch.kernels.sdca import ops
from repro_torch.kernels.sdca.ref import local_sdca_ref
from repro_torch.optim.cocoa import draw_indices, partition
from repro_torch.optim.problems import synthetic_mnist

pytestmark = pytest.mark.gpu


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _shards(dev, m, n, d):
    X, y = synthetic_mnist(n, d, 16, 0.09, 0.35, m)
    Xs, ys = partition(torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev), m)
    gen = torch.Generator(device=dev).manual_seed(m + d)
    a = torch.rand((m, Xs.shape[1]), generator=gen, device=dev)
    w = 0.01 * torch.randn(d, generator=gen, device=dev)
    return Xs, ys, a, w, gen


def _check(Xs, ys, a, w, idx, sigma, n, loss, lam=1e-4):
    before = ops.local_sdca.launches
    ak, dwk = ops.local_sdca(Xs, ys, a, w, idx, sigma, lam, float(n), loss)
    torch.cuda.synchronize()
    assert ops.local_sdca.launches == before + 1
    ap, dwp = local_sdca_ref(Xs, ys, a, w, idx, sigma, lam, float(n), loss)
    assert float((ak - ap).abs().max()) <= 1e-5
    assert float((dwk - dwp).abs().max()) <= 1e-5 * float(dwp.abs().max())
    m, nl = a.shape
    if m * nl > n:
        assert torch.equal(ak.reshape(-1)[n:], a.reshape(-1)[n:])
    return ak, dwk


@pytest.mark.parametrize("loss", ["hinge", "smooth_hinge"])
@pytest.mark.parametrize("m, n, d, h_factor, plus, lam", [
    (16, 8000, 784, 1, False, 1e-4),
    (7, 8000, 784, 1, True, 1e-4),     # padded tail
    (16, 8000, 784, 2, False, 1e-4),   # H > nl: repeated coordinates
    (3, 1000, 33, 1, True, 1e-4),      # d not a multiple of 4: 4-byte row copies
    (1, 60000, 784, 1, False, 1e-4),   # a whole m = 1 round at the paper's shape
    (2, 8000, ops.REGISTER_MAX_D, 1, False, 1e-4),     # the last width with v in registers
    (3, 8000, ops.REGISTER_MAX_D + 1, 1, True, 1e-4),  # v in shared memory, padded tail
    (1, 8000, ops.MAX_D, 1, False, 1e-3),              # the widest the kernel takes
])
def test_kernel_matches_plain(m, n, d, h_factor, plus, lam, loss):
    dev = _card()
    Xs, ys, a, w, gen = _shards(dev, m, n, d)
    idx = draw_indices(m, Xs.shape[1], h_factor * Xs.shape[1], gen)
    _check(Xs, ys, a, w, idx, float(m) if plus else 1.0, n, loss, lam)


@pytest.mark.parametrize("loss", ["hinge", "smooth_hinge"])
def test_kernel_reads_a_after_its_last_write(loss):
    """H = 3 nl drawn from 24 coordinates of each shard: a coordinate recurs
    within the 16 rows the ring stages ahead, often in the next step, so
    each step must read the a its predecessors wrote; and two calls give the
    same bits (the kernel has no atomics)."""
    dev = _card()
    m, n, d = 4, 4000, 784
    Xs, ys, a, w, gen = _shards(dev, m, n, d)
    nl = Xs.shape[1]
    rng = np.random.RandomState(5)
    idx = torch.from_numpy(rng.randint(0, 24, (m, 3 * nl)).astype(np.int32)).to(dev)
    assert bool((idx[:, 1:] == idx[:, :-1]).any())
    first = _check(Xs, ys, a, w, idx, 1.0, n, loss)
    again = ops.local_sdca(Xs, ys, a, w, idx, 1.0, 1e-4, float(n), loss)
    assert all(torch.equal(p, q) for p, q in zip(first, again))


@pytest.mark.parametrize("b", [0.8, 6.0, 1.9999999, 3.0, 0.06, 2.0 ** -20, 2.0 ** 20,
                               1234.567])
def test_division_matches_ieee_bit_for_bit(b):
    """The kernel divides by lam n without the compiler's branchy division
    (csrc/sdca.cu's div_by, two Markstein corrections of a * RN(1 / b)) where
    the dividend is 0 or within 2^+-100, by '/' elsewhere: every quotient has
    the bits of IEEE division, over random dividends across the exponent
    range, every significand of two binades, and the edge values."""
    from repro_torch.kernels.sdca import build

    dev = _card()
    lib = build.load()
    gen = torch.Generator(device=dev).manual_seed(17)
    sign = torch.randint(0, 2, (1 << 22,), generator=gen, device=dev, dtype=torch.int32) << 31
    expo = torch.randint(127 - 110, 127 + 111, (1 << 22,), generator=gen, device=dev,
                         dtype=torch.int32) << 23
    mant = torch.randint(0, 1 << 23, (1 << 22,), generator=gen, device=dev, dtype=torch.int32)
    every = torch.arange(1 << 23, device=dev, dtype=torch.int32)
    edges = torch.tensor([0.0, -0.0, 2.0 ** -100, -(2.0 ** -100), 2.0 ** 100, 2.0 ** -101,
                          2.0 ** 101, 1e-40, -1e-45, float("inf"), float("-inf"), float("nan"),
                          1.0, b, -b, 3.0 * b], device=dev)
    a = torch.cat([(sign | expo | mant).view(torch.float32),
                   (every | (127 << 23)).view(torch.float32),
                   (every | ((127 + 37) << 23)).view(torch.float32), edges]).contiguous()
    q = torch.empty_like(a)
    err = lib.sdca_divide_launch(a.data_ptr(), q.data_ptr(), a.numel(), b,
                                 torch.cuda.current_stream().cuda_stream)
    assert err == 0
    want = a / torch.tensor(b, dtype=torch.float32, device=dev)
    differ = q.view(torch.int32) != want.view(torch.int32)
    assert not bool(differ.any()), a[differ][:8].tolist()


def test_kernel_rejects_bad_inputs():
    dev = _card()
    Xs = torch.zeros((2, 4, 8), device=dev)
    ys, a = torch.ones((2, 4), device=dev), torch.zeros((2, 4), device=dev)
    w, idx = torch.zeros(8, device=dev), torch.zeros((2, 3), dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):
        ops.local_sdca(Xs.double(), ys, a, w, idx, 1.0, 1e-3, 8.0)
    with pytest.raises(ValueError):
        ops.local_sdca(Xs, ys, a, w[:4], idx, 1.0, 1e-3, 8.0)
    with pytest.raises(ValueError):
        ops.local_sdca(Xs.transpose(1, 2).contiguous().transpose(1, 2), ys, a, w, idx,
                       1.0, 1e-3, 8.0)
    with pytest.raises(ValueError):
        ops.local_sdca(Xs, ys.cpu(), a, w, idx, 1.0, 1e-3, 8.0)
    wide = ops.MAX_D + 1
    with pytest.raises(ValueError, match="d="):
        ops.local_sdca(torch.zeros((1, 2, wide), device=dev), ys[:1, :2], a[:1, :2],
                       torch.zeros(wide, device=dev), idx[:1], 1.0, 1e-3, 2.0)
