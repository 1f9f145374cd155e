"""The local SDCA inner loop: the Hopper kernel for CUDA tensors, the plain
version for CPU tensors (on "meta" tensors an empty output, and under the
dry-run's counter one record a call: ``repro_torch.dist.op_costs``).

A CUDA tensor goes to the kernel (csrc/sdca.cu) or the call raises; nothing
falls back to the plain version.  ``local_sdca.launches`` counts the
kernel's launches, and only those.  ``use_kernel=False`` names the plain
version on any device, as ``use_pallas=False`` does in the reference
(``repro/kernels/sdca/ops.py:27``); ``tuned=True`` takes that choice from the
autotuner's config cache (its ``sdca`` family).  The CoCoA path passes
neither, so on the card it always runs the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.dist.op_costs import counted
from repro_torch.kernels._build import MAX_SMEM_PER_BLOCK
from repro_torch.kernels.sdca import build
from repro_torch.kernels.sdca.ref import local_sdca_ref

LOSS_CODES = {"hinge": 0, "smooth_hinge": 1}
# csrc/sdca.cu's layout: one warp a worker, lane l owning v's entries l,
# l + 32, ...; a row's ring slot holds 32 ceil(d / 32) floats, after
# BARRIER_BYTES of the slots' barriers.  Up to REGISTER_MAX_D v lives in
# registers and the ring holds RING_BYTES of rows (2 to 16 rows); above it v
# takes a row's room in shared memory and the ring 4 rows, or 2 where 5 do
# not fit.
LANES = 32
REGISTER_ENTRIES = (1, 2, 4, 6, 8, 12, 16, 20, 25, 32, 40, 48, 56, 64)
REGISTER_MAX_D = LANES * REGISTER_ENTRIES[-1]
RING_BYTES = 64 * 1024
MAX_RING = 16
BARRIER_BYTES = 128


def kernel_plan(d: int) -> Tuple[int, int, int]:
    """(entries a lane in registers, 0 for v in shared memory; rows in the
    ring; shared memory in bytes) of the kernel at width d: csrc/sdca.cu's
    plan_for, mirrored so the tuner and the wrapper check it without
    building."""
    k = -(-d // LANES)
    for e in REGISTER_ENTRIES:
        if k <= e:
            ring = min(MAX_RING, max(2, RING_BYTES // (4 * LANES * e)))
            return e, ring, BARRIER_BYTES + ring * 4 * LANES * e
    row = 4 * LANES * k
    ring = 4 if BARRIER_BYTES + 5 * row <= MAX_SMEM_PER_BLOCK else 2
    return 0, ring, BARRIER_BYTES + (ring + 1) * row


# The widest row the wrapper takes.  v and a ring of two rows would fit up
# to 32 * floor((MAX_SMEM_PER_BLOCK - BARRIER_BYTES) / 384) = 19360 floats,
# but a step's two sums run over d terms, and at d 19360 the kernel's and
# the plain version's float32 sums (and the plain version's on the CPU and
# on the card) differ by up to 1e-5 max |dw| after a round, the card's limit
# (tests/test_torch_sdca_gpu.py); 12224 keeps every width the wrapper ever
# took, on the shared-memory path with its two-row ring.
MAX_D = 12224


def _sdca_cost(X, y, a, w, idx, *args, use_kernel: bool = True, tuned: bool = False,
               **kwargs):
    """K1's launch record (``roofline.sdca_cost``); None where the call names
    the plain version."""
    from repro_torch.kernels.tune.roofline import sdca_cost

    if not use_kernel or tuned:
        return None
    m, nl, d = X.shape
    return [("local_sdca", *sdca_cost(m, nl, idx.shape[1], d, X.element_size()))]


@counted(_sdca_cost)
def local_sdca(
    X: torch.Tensor,  # (m, nl, d) float32
    y: torch.Tensor,  # (m, nl) float32
    a: torch.Tensor,  # (m, nl) float32
    w: torch.Tensor,  # (d,) float32
    idx: torch.Tensor,  # (m, H) integer coordinates in [0, nl)
    sigma_prime: float,
    lam: float,
    n: float,
    loss: str = "hinge",
    gamma: float = 1.0,
    *,
    use_kernel: bool = True,
    tuned: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """H local SDCA steps on each of m workers.  Returns (new a (m, nl),
    dw (m, d)); the inputs are not modified."""
    if loss not in LOSS_CODES:
        raise ValueError(f"local SDCA supports {sorted(LOSS_CODES)}, not {loss!r}")
    if tuned:
        from repro_torch.kernels.flash_decode.ops import _tuned_value

        shape = {"m": X.shape[0], "nl": X.shape[1], "d": X.shape[2], "h": idx.shape[1]}
        use_kernel = bool(_tuned_value("sdca", shape, X.dtype, "use_pallas", int(use_kernel),
                                       X.device.type))
    if X.device.type == "cpu" or not use_kernel:
        return local_sdca_ref(X, y, a, w, idx, sigma_prime, lam, n, loss, gamma)
    if X.device.type == "meta":
        return torch.empty_like(a), torch.empty((X.shape[0], X.shape[2]), device=X.device)
    if X.device.type != "cuda":
        raise ValueError(f"local_sdca runs on cpu, cuda or meta tensors, not {X.device}")

    m, nl, d = X.shape
    h = idx.shape[1] if idx.dim() == 2 else -1
    for name, t, shape in (("X", X, (m, nl, d)), ("y", y, (m, nl)), ("a", a, (m, nl)),
                           ("w", w, (d,)), ("idx", idx, (m, h))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.device != X.device:
            raise ValueError(f"{name} is on {t.device}, X on {X.device}")
        if name != "idx" and t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx is {idx.dtype}; expected an integer tensor")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"d={d}: the kernel takes 1 <= d <= {MAX_D} (shared memory)")
    idx32 = idx.to(torch.int32).contiguous()

    a_out = torch.empty_like(a)
    dw = torch.empty((m, d), dtype=torch.float32, device=X.device)
    lib = build.load()
    with torch.cuda.device(X.device):
        err = lib.sdca_launch(
            X.data_ptr(), y.data_ptr(), a.data_ptr(), w.data_ptr(), idx32.data_ptr(),
            a_out.data_ptr(), dw.data_ptr(), m, nl, d, h,
            ctypes.c_float(sigma_prime), ctypes.c_float(lam * n),
            LOSS_CODES[loss], ctypes.c_float(gamma),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sdca kernel launch failed: {build.error_string(err)}")
    local_sdca.launches += 1
    return a_out, dw


local_sdca.launches = 0
