"""The local SDCA inner loop: the Hopper kernel for CUDA tensors, the plain
version for CPU tensors.

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

from repro_torch.kernels.sdca import build
from repro_torch.kernels.sdca.ref import local_sdca_ref

LOSS_CODES = {"hinge": 0, "smooth_hinge": 1}
# v lives in the block's dynamic shared memory, within the 48 KB a block may
# use without opting in, less 256 bytes kept for the kernel's static shared
# memory (80 bytes on sm_90a)
MAX_D = (48 * 1024 - 256) // 4


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
    if X.device.type != "cuda":
        raise ValueError(f"local_sdca runs on cpu or cuda tensors, not {X.device}")

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
    if d > MAX_D:
        raise ValueError(f"d={d} exceeds the kernel's shared-memory limit of {MAX_D}")
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
