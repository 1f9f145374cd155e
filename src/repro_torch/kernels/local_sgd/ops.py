"""The local-SGD worker chain: the Hopper kernel (K6) for CUDA tensors, the
plain version for CPU tensors (on "meta" tensors an empty output, and under
the dry-run's counter one record a call: ``repro_torch.dist.op_costs``).

A CUDA tensor goes to the kernel (csrc/local_sgd.cu) or the call raises;
nothing falls back to the plain version.  ``local_sgd.launches`` counts the
kernel's launches, and only those.  ``use_kernel=False`` names the plain
version on any device, as ``local_sdca``'s does.  Local SGD and the SSP
executor pass neither, so on the card they always run the kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.dist.op_costs import counted
from repro_torch.kernels._build import MAX_SMEM_PER_BLOCK
from repro_torch.kernels.local_sgd import build
from repro_torch.kernels.local_sgd.ref import LOSSES, local_sgd_ref

# csrc/local_sgd.cu's layout: one warp a worker, lane l owning w's entries l,
# l + 32, ...; a row's ring slot holds 32 ceil(d / 32) floats, after
# BARRIER_BYTES of the slots' barriers.  Up to REGISTER_MAX_D w lives in
# registers and the ring holds RING_BYTES of rows (2 to 16 rows); above it w
# takes a row's room in shared memory and the ring 4 rows, or 2 where 5 do
# not fit.  MAX_D is the widest row the kernel takes (kMaxD).
LANES = 32
REGISTER_ENTRIES = (1, 2, 4, 6, 8, 12, 16, 20, 25, 32, 40)
REGISTER_MAX_D = LANES * REGISTER_ENTRIES[-1]
RING_BYTES = 64 * 1024
MAX_RING = 16
BARRIER_BYTES = 128
MAX_D = 12224


def refill_rows(ring: int) -> int:
    """Rows the kernel stages together: four every four steps where the
    ring holds at least eight, else one a step (csrc/local_sgd.cu's
    refill_rows)."""
    return 4 if ring >= 8 else 1


def kernel_plan(d: int) -> Tuple[int, int, int]:
    """(w's entries a lane in registers, 0 for w in shared memory; rows in
    the ring; shared memory in bytes) of the kernel at width d: csrc/
    local_sgd.cu's plan_for, mirrored so that tests check it without
    building (the library's ``local_sgd_plan``)."""
    k = -(-d // LANES)
    for e in REGISTER_ENTRIES:
        if k <= e:
            ring = min(MAX_RING, max(2, RING_BYTES // (4 * LANES * e)))
            return e, ring, BARRIER_BYTES + ring * 4 * LANES * e
    row = 4 * LANES * k
    ring = 4 if BARRIER_BYTES + 5 * row <= MAX_SMEM_PER_BLOCK else 2
    return 0, ring, BARRIER_BYTES + (ring + 1) * row


def copy_route(X: torch.Tensor) -> str:
    """How the kernel stages X's rows in a round of more than two steps
    (csrc/local_sgd.cu; shorter rounds load them straight into registers):
    one bulk copy a row where d % 4 == 0 and X starts on 16 bytes (then so
    does every worker's shard), else 4-byte ``cp.async`` copies by every
    lane (an odd width, or a tensor with a storage offset)."""
    d = X.shape[-1]
    return "bulk" if d % 4 == 0 and X.data_ptr() % 16 == 0 else "cp.async 4-byte"


def _sgd_cost(W0, X, y, idx, *args, use_kernel: bool = True, **kwargs):
    """K6's launch record (``roofline.local_sgd_cost``); None where the call
    names the plain version."""
    from repro_torch.kernels.tune.roofline import local_sgd_cost

    if not use_kernel:
        return None
    m, nl, d = X.shape
    return [("local_sgd", *local_sgd_cost(m, nl, idx.shape[-1], d, X.element_size()))]


@counted(_sgd_cost)
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
    if X.device.type == "meta":
        return torch.empty_like(W0)
    if X.device.type != "cuda":
        raise ValueError(f"local_sgd runs on cpu, cuda or meta tensors, not {X.device}")

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
