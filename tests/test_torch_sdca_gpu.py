"""The SDCA CUDA kernel against its plain version, on the card.

Marked ``gpu``: without a CUDA device each test skips from inside itself, so
every worker collects the same tests.  Run on the card with
``python -m pytest -q -m gpu tests/test_torch_sdca_gpu.py``.

The kernel and the plain version differ only in the order of each step's two
float32 sums.  On an H100 at 60000 x 784 one call differs by about 1e-6 in
both a and dw (chip_smoke.py); at these smaller shapes the tests allow 1e-5
on a and 1e-5 times max |dw| on dw.
"""
import pytest
import torch

from repro_torch.kernels.sdca import ops
from repro_torch.kernels.sdca.ref import local_sdca_ref
from repro_torch.optim.cocoa import draw_indices, partition
from repro_torch.optim.problems import synthetic_mnist

pytestmark = pytest.mark.gpu


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("loss", ["hinge", "smooth_hinge"])
@pytest.mark.parametrize("m, n, d, h_factor, plus", [
    (16, 8000, 784, 1, False),
    (7, 8000, 784, 1, True),     # padded tail
    (16, 8000, 784, 2, False),   # H > nl: repeated coordinates
    (3, 1000, 33, 1, True),      # d not a multiple of the block
])
def test_kernel_matches_plain(m, n, d, h_factor, plus, loss):
    dev = _card()
    X, y = synthetic_mnist(n, d, 16, 0.09, 0.35, m)
    Xs, ys = partition(torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev), m)
    nl = Xs.shape[1]
    gen = torch.Generator(device=dev).manual_seed(m)
    a = torch.rand((m, nl), generator=gen, device=dev)
    w = 0.01 * torch.randn(d, generator=gen, device=dev)
    idx = draw_indices(m, nl, h_factor * nl, gen)
    sigma = float(m) if plus else 1.0
    before = ops.local_sdca.launches
    ak, dwk = ops.local_sdca(Xs, ys, a, w, idx, sigma, 1e-4, float(n), loss)
    torch.cuda.synchronize()
    assert ops.local_sdca.launches == before + 1
    ap, dwp = local_sdca_ref(Xs, ys, a, w, idx, sigma, 1e-4, float(n), loss)
    assert float((ak - ap).abs().max()) <= 1e-5
    assert float((dwk - dwp).abs().max()) <= 1e-5 * float(dwp.abs().max())
    if m * nl > n:
        assert torch.equal(ak.reshape(-1)[n:], a.reshape(-1)[n:])


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
