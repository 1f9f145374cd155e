"""The local-SGD worker chain: the Hopper kernel (K6) for CUDA tensors, the
plain version for CPU tensors.

A CUDA tensor goes to the kernel (csrc/local_sgd.cu) or the call raises;
nothing falls back to the plain version.  ``local_sgd.launches`` counts the
kernel's launches, and only those.  ``use_kernel=False`` names the plain
version on any device, as ``local_sdca``'s does.  Local SGD and the SSP
executor pass neither, so on the card they always run the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.local_sgd import build
from repro_torch.kernels.local_sgd.ref import LOSSES, local_sgd_ref

# csrc/local_sgd.cu's kMaxD: w in shared memory past d 1280, under 48 KB
MAX_D = 12224


def local_sgd(
    W0: torch.Tensor,  # (m, d) float32, each worker's start vector
    X: torch.Tensor,  # (m, nl, d) float32
    y: torch.Tensor,  # (m, nl) float32
    idx: torch.Tensor,  # (m, S) integer rows in [0, nl), each worker's order
    t: float,
    h: int,
    lr0: float,
    t0: float,
    lam: float,
    loss: str = "hinge",
    gamma: float = 1.0,
    *,
    use_kernel: bool = True,
) -> torch.Tensor:
    """S = idx's width local SGD steps on each of m workers, step i of outer
    iteration t at lr0 / (lam (t h + i + t0)): h is the round's length, S = h
    for local SGD and SSP, and fewer steps are the round's first ones.
    Returns the workers' vectors (m, d); the inputs are not modified."""
    if loss not in LOSSES:
        raise ValueError(f"local SGD supports {LOSSES}, not {loss!r}")
    if X.device.type == "cpu" or not use_kernel:
        return local_sgd_ref(W0, X, y, idx, t, h, lr0, t0, lam, loss, gamma)
    if X.device.type != "cuda":
        raise ValueError(f"local_sgd runs on cpu or cuda tensors, not {X.device}")

    m, nl, d = X.shape
    steps = idx.shape[1] if idx.dim() == 2 else -1
    for name, tensor, shape in (("W0", W0, (m, d)), ("X", X, (m, nl, d)), ("y", y, (m, nl)),
                                ("idx", idx, (m, steps))):
        if tuple(tensor.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(tensor.shape)}, expected {shape}")
        if tensor.device != X.device:
            raise ValueError(f"{name} is on {tensor.device}, X on {X.device}")
        if name != "idx" and tensor.dtype != torch.float32:
            raise TypeError(f"{name} is {tensor.dtype}; the kernel takes float32")
        if not tensor.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx is {idx.dtype}; expected an integer tensor")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"d={d}: the kernel takes 1 <= d <= {MAX_D} (shared memory)")
    idx32 = idx.to(torch.int32).contiguous()

    W = torch.empty_like(W0)
    lib = build.load()
    with torch.cuda.device(X.device):
        err = lib.local_sgd_launch(
            W0.data_ptr(), X.data_ptr(), y.data_ptr(), idx32.data_ptr(), W.data_ptr(),
            m, nl, d, steps, t, h, lr0, t0, lam, LOSSES.index(loss), 1.0 - gamma, gamma,
            torch.cuda.current_stream().cuda_stream)
    build.LIBRARY.check(err, "local_sgd kernel")
    local_sgd.launches += 1
    return W


local_sgd.launches = 0
