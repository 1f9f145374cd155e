"""Paged decode attention: the Hopper kernel (K2, csrc/paged_decode.cu) for
CUDA tensors, the plain versions (ref.py) for CPU tensors or when named.

``paged_decode_attention`` is the model-facing call, with the signature of
``repro/kernels/flash_decode/ops.py::paged_decode_attention``.  Its ``impl``
is ``"kernel"`` (``paged_decode``: K2 for CUDA tensors, the ``stream`` plain
version for CPU tensors), or ``"stream"`` / ``"gather"`` (the plain versions
on any device, taken only when named).  ``paged_decode`` is the kernel's
wrapper: a CUDA tensor goes to the kernel or the call raises, nothing falls
back, and ``paged_decode.launches`` counts the kernel's launches and only
those.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels._build import MAX_SMEM_PER_BLOCK, KernelLibrary
from repro_torch.kernels.flash_decode.ref import paged_decode_gather, paged_decode_stream
from repro_torch.models.runtime import DEFAULT_PAGES_PER_PROGRAM, PAGED_IMPLS

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIBRARY = KernelLibrary(
    Path(__file__).resolve().parent / "csrc" / "paged_decode.cu", "paged_decode",
    {"paged_decode_launch": ([_p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _f, _p],
                             ctypes.c_int),
     "paged_decode_smem_bytes": ([_i, _i, _i], ctypes.c_int)},
    error_fn="paged_decode_error_string")


def paged_decode(
    q: torch.Tensor,  # (B, Hk, G, d) bfloat16
    k_pages: torch.Tensor,  # (n_pages, Hk, page, d) bfloat16
    v_pages: torch.Tensor,  # (n_pages, Hk, page, d) bfloat16
    lengths: torch.Tensor,  # (B,) valid positions incl. the new token
    page_tables: torch.Tensor,  # (B, npp) physical page ids
    *,
    scale: float,
    pages_per_program: int = DEFAULT_PAGES_PER_PROGRAM,
) -> torch.Tensor:
    """Returns (B, Hk, G, d) in q's dtype."""
    if q.device.type == "cpu":
        return paged_decode_stream(q, k_pages, v_pages, lengths, page_tables,
                                   scale=scale, pages_per_program=pages_per_program)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode runs on cpu or cuda tensors, not {q.device}")
    b, hk, g, d = q.shape
    if k_pages.dim() != 4 or k_pages.shape[1] != hk or k_pages.shape[3] != d:
        raise ValueError(f"k_pages has shape {tuple(k_pages.shape)}, q {tuple(q.shape)}")
    n_pages, _, page, _ = k_pages.shape
    if tuple(v_pages.shape) != tuple(k_pages.shape):
        raise ValueError(f"v_pages {tuple(v_pages.shape)} must match k_pages "
                         f"{tuple(k_pages.shape)} (the kernel takes dv == dk)")
    if d % 16 or not 16 <= d <= 256:
        raise ValueError(f"head dim {d}: the kernel takes multiples of 16 up to 256")
    if page_tables.dim() != 2 or page_tables.shape[0] != b:
        raise ValueError(f"page_tables has shape {tuple(page_tables.shape)}, batch {b}")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths has shape {tuple(lengths.shape)}, expected ({b},)")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("lengths", lengths), ("page_tables", page_tables)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if name in ("lengths", "page_tables"):
            if t.dtype != torch.int32:
                raise TypeError(f"{name} is {t.dtype}; the kernel takes int32")
        elif t.dtype != torch.bfloat16:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    npp = page_tables.shape[1]
    ppp = max(1, min(int(pages_per_program), npp))
    lib = LIBRARY.load()
    smem = lib.paged_decode_smem_bytes(g, d, ppp * page)
    if smem > MAX_SMEM_PER_BLOCK:
        raise ValueError(f"G={g}, d={d}, {ppp} x {page}-position pages need {smem} bytes of "
                         f"shared memory, more than the {MAX_SMEM_PER_BLOCK} a block may use")
    out = torch.empty_like(q)
    if b * hk * g == 0:
        return out
    with torch.cuda.device(q.device):
        err = lib.paged_decode_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), lengths.data_ptr(),
            page_tables.data_ptr(), out.data_ptr(), b, hk, g, d, n_pages, page, npp, ppp,
            ctypes.c_float(scale), torch.cuda.current_stream().cuda_stream)
    LIBRARY.check(err, "paged_decode kernel")
    paged_decode.launches += 1
    return out


paged_decode.launches = 0


def paged_decode_attention(
    q: torch.Tensor,  # (B, Hq, d) one new query token per sequence
    k_pages: torch.Tensor,  # (n_pages, Hk, page, d) physical page pool
    v_pages: torch.Tensor,  # (n_pages, Hk, page, d)
    lengths: torch.Tensor,  # (B,) valid positions incl. the new token
    page_tables: torch.Tensor,  # (B, pages_per_seq) int32
    *,
    sm_scale: Optional[float] = None,
    impl: str = "kernel",
    pages_per_program: Optional[int] = None,
) -> torch.Tensor:
    """GQA decode attention over the paged KV pool; returns (B, Hq, d).
    ``pages_per_program=None`` takes the reference's default (4): the
    autotuner's config cache is not ported."""
    b, hq, d = q.shape
    hk = k_pages.shape[1]
    if hq % hk:
        raise ValueError(f"Hq={hq} not a multiple of Hk={hk}")
    if impl not in PAGED_IMPLS:
        raise ValueError(f"impl={impl!r} not in {PAGED_IMPLS}")
    scale = float(sm_scale) if sm_scale is not None else 1.0 / (d ** 0.5)
    ppp = DEFAULT_PAGES_PER_PROGRAM if pages_per_program is None else int(pages_per_program)
    q4 = q.reshape(b, hk, hq // hk, d)
    args = (q4, k_pages, v_pages, lengths, page_tables)
    if impl == "kernel":
        out = paged_decode(*args, scale=scale, pages_per_program=ppp)
    elif impl == "stream":
        out = paged_decode_stream(*args, scale=scale, pages_per_program=ppp)
    else:
        out = paged_decode_gather(*args, scale=scale, pages_per_program=ppp)
    return out.reshape(b, hq, v_pages.shape[3])
