"""Selective scan (Mamba-1): the Hopper kernel (K4, csrc/selective_scan.cu)
for CUDA tensors, the plain version (ref.py) for CPU tensors.

``selective_scan`` is the model-facing call and the kernel's wrapper: the
signature of ``repro/kernels/ssm_scan/ops.py::selective_scan`` with an
initial state that is updated in place, so at S = 1 it is the decode step
``selective_scan_step``.  A CUDA tensor goes to the kernel or the call
raises, nothing falls back to the plain version, and
``selective_scan.launches`` counts the kernel's launches and only those;
``selective_scan.step_launches`` counts those of them at S = 1, which run
the kernel's decode body.

``B`` and ``C`` come out of a split of ``x_proj``'s output, so they are
strided views: the wrapper passes the kernel their batch and time strides
(the last axis must have stride 1) instead of copying them.

``d_block`` is the number of channels a block of the kernel's prefill body
owns, the autotuner's knob (``tuned=True`` takes it from the tuner's config
cache).  The kernel scans time in fixed tiles of 256 positions anchored at
position 0, with the same tree whatever the channels a block, so y and the
state are bit-identical for every d_block it takes; the decode body (S = 1)
has no blocking.  ``chunk`` is the reference's argument, kept in the
signature: in the reference it groups the associative scan's terms, here
the kernel's grouping is fixed, so it changes nothing (it must be
positive).  The plain version is a serial loop and ignores both.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels._build import MAX_SMEM_PER_BLOCK, KernelLibrary
from repro_torch.kernels.ssm_scan.ref import selective_scan_ref

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARY = KernelLibrary(
    Path(__file__).resolve().parent / "csrc" / "selective_scan.cu", "selective_scan",
    {"selective_scan_launch": ([_p] * 8 + [_i] * 6 + [_ll] * 4 + [_p], ctypes.c_int),
     "selective_scan_smem_bytes": ([_i, _i], ctypes.c_int)},
    error_fn="selective_scan_error_string")

KERNEL_STATE_SIZES = (4, 8, 16, 32)  # N: the kernel's instantiations
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
KERNEL_D_BLOCKS = (8, 16, 32)  # channels a block of the prefill body (8 warps)
DEFAULT_D_BLOCK = 16  # the serve path's value
DEFAULT_CHUNK = 128  # the reference's default, which the kernel does not use


def scan_d_block(x: torch.Tensor, A: torch.Tensor, d_block: int, tuned: bool) -> int:
    """The channels a block a call runs at: the tuner's cache entry for
    ``{bt, s, dn, n}`` on x's device type when ``tuned``, else ``d_block``."""
    if not tuned:
        return int(d_block)
    from repro_torch.kernels.flash_decode.ops import _tuned_value

    bt, s, dn = x.shape
    shape = {"bt": bt, "s": s, "dn": dn, "n": A.shape[1]}
    return _tuned_value("ssm_scan", shape, x.dtype, "d_block", int(d_block), x.device.type)


def selective_scan(
    x: torch.Tensor,  # (Bt, S, Dn) bf16 or float32
    dt: torch.Tensor,  # (Bt, S, Dn) float32
    A: torch.Tensor,  # (Dn, N) float32
    B: torch.Tensor,  # (Bt, S, N) in x's dtype
    C: torch.Tensor,  # (Bt, S, N) in x's dtype
    D: torch.Tensor,  # (Dn,) float32
    h: Optional[torch.Tensor] = None,  # (Bt, Dn, N) float32
    *,
    chunk: int = DEFAULT_CHUNK,
    d_block: int = DEFAULT_D_BLOCK,
    tuned: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (Bt, S, Dn) in x's dtype, h_last (Bt, Dn, N) float32).
    When ``h`` is given it is the initial state and is overwritten with
    h_last, which is ``h`` itself; otherwise the scan starts from zeros."""
    d_block = scan_d_block(x, A, d_block, tuned)
    if chunk < 1:
        raise ValueError(f"chunk={chunk} must be positive")
    if d_block not in KERNEL_D_BLOCKS:
        raise ValueError(f"d_block={d_block}: the kernel takes {KERNEL_D_BLOCKS} channels a "
                         "block")
    if x.device.type == "cpu":
        y, h_last = selective_scan_ref(x, dt, A, B, C, D, h)
        if h is None:
            return y, h_last
        h.copy_(h_last)
        return y, h
    if x.device.type != "cuda":
        raise ValueError(f"selective_scan runs on cpu or cuda tensors, not {x.device}")
    if x.dim() != 3:
        raise ValueError(f"x has shape {tuple(x.shape)}, expected (Bt, S, Dn)")
    bt, s, dn = x.shape
    if A.dim() != 2 or A.shape[0] != dn:
        raise ValueError(f"A has shape {tuple(A.shape)}, expected ({dn}, N)")
    n = A.shape[1]
    if n not in KERNEL_STATE_SIZES:
        raise ValueError(f"N={n}: the kernel takes state sizes {KERNEL_STATE_SIZES}")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"x is {x.dtype}; the kernel takes bfloat16 or float32")
    if h is None:
        h = torch.zeros((bt, dn, n), dtype=torch.float32, device=x.device)
    expected = {"x": ((bt, s, dn), x.dtype), "dt": ((bt, s, dn), torch.float32),
                "A": ((dn, n), torch.float32), "B": ((bt, s, n), x.dtype),
                "C": ((bt, s, n), x.dtype), "D": ((dn,), torch.float32),
                "h": ((bt, dn, n), torch.float32)}
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C), ("D", D), ("h", h)):
        shape, dtype = expected[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes {dtype} here")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if name in ("B", "C"):
            if t.stride(2) != 1:
                raise ValueError(f"{name}'s last axis has stride {t.stride(2)}, the kernel "
                                 "takes 1")
        elif not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    y = torch.empty_like(x)
    if bt * s * dn == 0:
        return y, h
    lib = LIBRARY.load()
    smem = lib.selective_scan_smem_bytes(n, d_block)
    if smem > MAX_SMEM_PER_BLOCK:
        raise ValueError(f"N={n}, d_block={d_block} need {smem} bytes of shared memory, more "
                         f"than the {MAX_SMEM_PER_BLOCK} a block may use")
    with torch.cuda.device(x.device):
        err = lib.selective_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            D.data_ptr(), h.data_ptr(), y.data_ptr(), bt, s, dn, n,
            int(x.dtype == torch.bfloat16), d_block, B.stride(0), B.stride(1), C.stride(0),
            C.stride(1), torch.cuda.current_stream().cuda_stream)
    LIBRARY.check(err, "selective_scan kernel")
    selective_scan.launches += 1
    selective_scan.step_launches += int(s == 1)
    return y, h


selective_scan.launches = 0
selective_scan.step_launches = 0
