"""Decode attention: the Hopper kernels for paged (K2, csrc/paged_decode.cu)
and contiguous (K5, csrc/flash_decode.cu) caches for CUDA tensors, which share
one block body (csrc/decode_tile.cuh), and K2's MLA latent form
(csrc/paged_latent_decode.cu); their plain versions (ref.py) for CPU tensors
or when named.

``paged_decode_attention`` is the model-facing call, with the signature of
``repro/kernels/flash_decode/ops.py::paged_decode_attention``.  Its ``impl``
is ``"kernel"`` (``paged_decode``: K2 for CUDA tensors, the ``stream`` plain
version for CPU tensors), or ``"stream"`` / ``"gather"`` (the plain versions
on any device, taken only when named).  ``pages_per_program=None`` takes the
autotuner's config cache entry for the call's (shape, dtype, device) key
(``repro_torch.kernels.tune``), else ``DEFAULT_PAGES_PER_PROGRAM``.

``paged_latent_decode_attention`` is the counterpart of the reference's MLA
absorbed-latent call (``ops.py:376``): one latent pool serves as keys and
values, every query head reads it, and a rope term ``q_pe . kpe`` joins the
scores.  ``"kernel"`` runs ``paged_latent_decode`` (K2's latent form on the
card, the ``stream`` plain version with the q_pe term on the CPU).

``decode_attention_auto`` is the reference's contiguous-cache dispatch
(``ops.py:51``) with ``use_pallas`` named ``use_kernel``: ``True`` runs
``flash_decode`` (K5 for CUDA tensors, its plain version ``flash_decode_ref``
for CPU tensors), ``False`` the plain ``decode_attention`` on any device.

``paged_decode``, ``paged_latent_decode`` and ``flash_decode`` are the
kernels' wrappers: a CUDA tensor goes to the kernel or the call raises,
nothing falls back, and each wrapper's ``launches`` counts its kernel's
launches and only those.  K2, its latent form and K5 are split-KV: one call
launches the split kernel and, when the cache holds more than one split, the
kernel that merges the splits; the two count as one launch.  On "meta"
tensors (the dry-run's analysis) each returns an empty output of its
kernel's shape, and under the dry-run's counter each records its launch's
FLOPs and bytes on every device alike, counting every position of the
cache (``repro_torch.dist.op_costs.counted``).

``gather_pages`` and ``paged_prefill_attention`` (``ops.py:272, 292``) are
gathers plus the flash forward (K3) with ``kv_lens`` and a static
``q_offset``: chunked prefill over the page pool, which the autotuner's
``prefill_chunk`` family times.  ``fold_verify_batch`` and
``paged_verify_attention`` (``ops.py:323, 348``) fold a speculative verify
window of T positions a sequence into the batch axis, sequence-major (row
``s * T + t``), as the reference does; the serve engine folds its verify
step draft-major instead, so that each draft index is one block of
``max_batch`` rows shaped like a decode step (``repro_torch.serve.engine``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.dist.op_costs import counted
from repro_torch.kernels._build import MAX_SMEM_PER_BLOCK, KernelLibrary
from repro_torch.kernels.flash_attention.ops import decode_attention, flash_attention
from repro_torch.kernels.flash_decode.ref import (
    flash_decode_ref,
    paged_decode_gather,
    paged_decode_stream,
)
from repro_torch.models.runtime import DEFAULT_PAGES_PER_PROGRAM, POOL_IMPLS

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_CSRC = Path(__file__).resolve().parent / "csrc"
LIBRARY = KernelLibrary(
    _CSRC / "paged_decode.cu", "paged_decode",
    {"paged_decode_launch": ([_p] * 7 + [_i] * 8 + [_f, _p], ctypes.c_int),
     "paged_decode_smem_bytes": ([_i, _i, _i], ctypes.c_int),
     "paged_decode_splits": ([_i, _i], ctypes.c_int)},
    error_fn="paged_decode_error_string", includes=[_CSRC / "decode_tile.cuh"])
DECODE_LIBRARY = KernelLibrary(
    _CSRC / "flash_decode.cu", "flash_decode",
    {"flash_decode_launch": ([_p] * 6 + [_i] * 6 + [_f, _p], ctypes.c_int),
     "flash_decode_smem_bytes": ([_i, _i, _i], ctypes.c_int),
     "flash_decode_splits": ([_i, _i], ctypes.c_int)},
    error_fn="flash_decode_error_string", includes=[_CSRC / "decode_tile.cuh"])
LATENT_LIBRARY = KernelLibrary(
    _CSRC / "paged_latent_decode.cu", "paged_latent_decode",
    {"paged_latent_decode_launch": ([_p] * 8 + [_i] * 7 + [_f, _p],
                                    ctypes.c_int),
     "paged_latent_decode_smem_bytes": ([_i, _i], ctypes.c_int),
     "paged_latent_decode_splits": ([_i], ctypes.c_int)},
    error_fn="paged_latent_decode_error_string")
# (latent width r, rope width dr) the latent kernel is built for: DeepSeek-V2's
# and its smoke variant's
LATENT_WIDTHS = ((512, 64), (16, 8))
# The latent kernel's blocking (paged_latent_decode.cu's kHeads, kTile and
# kSplitPositions): query heads a block, the M rows of its products; positions
# a tile, from position 0, whatever the page size and pages_per_program; and
# positions a split, from position 0
LATENT_HEADS = 64
LATENT_TILE = 64
LATENT_SPLIT_POSITIONS = 192

# Prompt tokens a chunked-prefill step takes when the tuner has no entry
# (the reference's, ops.py:48)
DEFAULT_PREFILL_CHUNK = 32

# K5's tile.  The reference's default, 512 positions, is a TPU tile: K5 keeps
# a tile of K and V in shared memory, and at head dim 128 a 512-position tile
# needs 278 KB, more than the 227 KB a block may use.
DEFAULT_DECODE_BLOCK_K = 128


def _check_aligned(**tensors: torch.Tensor) -> None:
    """The kernels stage rows with 16-byte copies."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def _split_scratch(b: int, hk: int, g: int, d: int, splits: int, device) -> torch.Tensor:
    """Float32 scratch for the split-KV partials, (m, l) and acc per (row,
    KV head, split, query head), as decode_tile.cuh lays them out."""
    return torch.empty(max(1, b * hk * splits * g * (d + 2)), dtype=torch.float32,
                       device=device)


def _tuned_value(family: str, shape: dict, dtype, name: str, default: int,
                 backend: str) -> int:
    """Config-cache lookup (lazy import: the tuner imports this module's
    functions for sweeping)."""
    from repro_torch.kernels.tune import lookup

    cfg = lookup(family, shape, dtype, backend)
    if cfg and name in cfg:
        return int(cfg[name])
    return default


def pages_per_program_for(b: int, hq: int, hk: int, d: int, page: int, npp: int, dtype,
                          backend: str) -> int:
    """K2's ``pages_per_program`` for a paged decode of this shape: the tuner's
    cache entry for ``{b, hk, g, d, page, npp}`` on ``backend`` ("cuda" or
    "cpu"), else ``DEFAULT_PAGES_PER_PROGRAM``."""
    shape = {"b": b, "hk": hk, "g": hq // hk, "d": d, "page": page, "npp": npp}
    return _tuned_value("flash_decode_paged", shape, dtype, "pages_per_program",
                        DEFAULT_PAGES_PER_PROGRAM, backend)


def latent_shape(b: int, h: int, r: int, dr: int, page: int, npp: int) -> dict:
    """The tuner's ``flash_decode_paged`` key for the latent form: the
    reference's (``ops.py:397-401``: one KV head, all H heads grouped on it,
    d = r) with the rope width ``dr``, which the latent kernel's shared memory
    depends on and which keeps it apart from a GQA shape of one KV head."""
    return {"b": b, "hk": 1, "g": h, "d": r, "dr": dr, "page": page, "npp": npp}


def _paged_cost(q, k_pages, v_pages, lengths, page_tables, **kwargs):
    """K2's launch record (``roofline.decode_cost`` over the capacity)."""
    from repro_torch.kernels.tune.roofline import decode_cost

    b, hk, g, d = q.shape
    s = page_tables.shape[1] * k_pages.shape[2]
    return [("paged_decode", *decode_cost(b, hk * g, hk, s, d, b * s, q.element_size()))]


@counted(_paged_cost)
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
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode runs on cpu, cuda or meta tensors, not {q.device}")
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
    _check_aligned(q=q, k_pages=k_pages, v_pages=v_pages)
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
    scratch = _split_scratch(b, hk, g, d, lib.paged_decode_splits(npp * page, ppp * page),
                             q.device)
    with torch.cuda.device(q.device):
        err = lib.paged_decode_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), lengths.data_ptr(),
            page_tables.data_ptr(), scratch.data_ptr(), out.data_ptr(), b, hk, g, d, n_pages,
            page, npp, ppp, ctypes.c_float(scale), torch.cuda.current_stream().cuda_stream)
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
    ``pages_per_program=None`` consults the autotuner's config cache for
    this (shape, dtype, device) key, falling back to
    ``DEFAULT_PAGES_PER_PROGRAM``."""
    b, hq, d = q.shape
    hk, page = k_pages.shape[1], k_pages.shape[2]
    if hq % hk:
        raise ValueError(f"Hq={hq} not a multiple of Hk={hk}")
    if impl not in POOL_IMPLS:
        raise ValueError(f"impl={impl!r} not in {POOL_IMPLS}")
    scale = float(sm_scale) if sm_scale is not None else 1.0 / (d ** 0.5)
    if pages_per_program is None:
        ppp = pages_per_program_for(b, hq, hk, d, page, page_tables.shape[1], q.dtype,
                                    q.device.type)
    else:
        ppp = int(pages_per_program)
    q4 = q.reshape(b, hk, hq // hk, d)
    args = (q4, k_pages, v_pages, lengths, page_tables)
    if impl == "kernel":
        out = paged_decode(*args, scale=scale, pages_per_program=ppp)
    elif impl == "stream":
        out = paged_decode_stream(*args, scale=scale, pages_per_program=ppp)
    else:
        out = paged_decode_gather(*args, scale=scale, pages_per_program=ppp)
    return out.reshape(b, hq, v_pages.shape[3])


def _latent_cost(q_lat, q_pe, ckv_pages, kpe_pages, lengths, page_tables, **kwargs):
    """K2-latent's launch record (``roofline.latent_decode_cost`` over the
    capacity)."""
    from repro_torch.kernels.tune.roofline import latent_decode_cost

    b, h, r = q_lat.shape
    s = page_tables.shape[1] * ckv_pages.shape[1]
    return [("paged_latent_decode", *latent_decode_cost(b, h, s, r, q_pe.shape[2], b * s,
                                                        q_lat.element_size()))]


@counted(_latent_cost)
def paged_latent_decode(
    q_lat: torch.Tensor,  # (B, H, r) bfloat16
    q_pe: torch.Tensor,  # (B, H, dr) bfloat16
    ckv_pages: torch.Tensor,  # (n_pages, page, r) bfloat16
    kpe_pages: torch.Tensor,  # (n_pages, page, dr) bfloat16
    lengths: torch.Tensor,  # (B,) valid positions incl. the new token
    page_tables: torch.Tensor,  # (B, npp) physical page ids
    *,
    scale: float,
    pages_per_program: int = DEFAULT_PAGES_PER_PROGRAM,
) -> torch.Tensor:
    """K2's latent form: returns the latent context (B, H, r) in q_lat's
    dtype.  ``pages_per_program`` groups the pages of the plain version on
    the CPU; the kernel's tile is ``LATENT_TILE`` positions whatever it is."""
    if q_lat.device.type == "cpu":
        return _latent_plain(paged_decode_stream, q_lat, q_pe, ckv_pages, kpe_pages, lengths,
                             page_tables, scale, pages_per_program)
    if q_lat.device.type == "meta":
        return torch.empty_like(q_lat)
    if q_lat.device.type != "cuda":
        raise ValueError(f"paged_latent_decode runs on cpu, cuda or meta tensors, not "
                         f"{q_lat.device}")
    if q_lat.dim() != 3 or q_pe.dim() != 3 or q_pe.shape[:2] != q_lat.shape[:2]:
        raise ValueError(f"q_lat {tuple(q_lat.shape)} and q_pe {tuple(q_pe.shape)} must be "
                         "(B, H, r) and (B, H, dr)")
    b, h, r = q_lat.shape
    dr = q_pe.shape[2]
    if (r, dr) not in LATENT_WIDTHS:
        raise ValueError(f"(r, dr) = ({r}, {dr}): the kernel is built for {LATENT_WIDTHS}")
    if ckv_pages.dim() != 3 or ckv_pages.shape[2] != r:
        raise ValueError(f"ckv_pages has shape {tuple(ckv_pages.shape)}, "
                         f"q_lat {tuple(q_lat.shape)}")
    n_pages, page, _ = ckv_pages.shape
    if tuple(kpe_pages.shape) != (n_pages, page, dr):
        raise ValueError(f"kpe_pages has shape {tuple(kpe_pages.shape)}, expected "
                         f"{(n_pages, page, dr)}")
    if page_tables.dim() != 2 or page_tables.shape[0] != b:
        raise ValueError(f"page_tables has shape {tuple(page_tables.shape)}, batch {b}")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths has shape {tuple(lengths.shape)}, expected ({b},)")
    for name, t in (("q_lat", q_lat), ("q_pe", q_pe), ("ckv_pages", ckv_pages),
                    ("kpe_pages", kpe_pages), ("lengths", lengths),
                    ("page_tables", page_tables)):
        if t.device != q_lat.device:
            raise ValueError(f"{name} is on {t.device}, q_lat on {q_lat.device}")
        if name in ("lengths", "page_tables"):
            if t.dtype != torch.int32:
                raise TypeError(f"{name} is {t.dtype}; the kernel takes int32")
        elif t.dtype != torch.bfloat16:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    _check_aligned(q_lat=q_lat, q_pe=q_pe, ckv_pages=ckv_pages, kpe_pages=kpe_pages)
    npp = page_tables.shape[1]
    lib = LATENT_LIBRARY.load()
    smem = lib.paged_latent_decode_smem_bytes(r, dr)
    if smem > MAX_SMEM_PER_BLOCK:
        raise ValueError(f"r={r}, dr={dr} need {smem} bytes of shared memory, more than the "
                         f"{MAX_SMEM_PER_BLOCK} a block may use")
    out = torch.empty_like(q_lat)
    if b * h == 0:
        return out
    splits = lib.paged_latent_decode_splits(npp * page)
    groups = -(-h // LATENT_HEADS)
    # the split-KV partials, (m, l) and acc per (row, head group, split, head)
    scratch = torch.empty(b * groups * splits * LATENT_HEADS * (r + 2) if splits > 1 else 1,
                          dtype=torch.float32, device=q_lat.device)
    with torch.cuda.device(q_lat.device):
        err = lib.paged_latent_decode_launch(
            q_lat.data_ptr(), q_pe.data_ptr(), ckv_pages.data_ptr(), kpe_pages.data_ptr(),
            lengths.data_ptr(), page_tables.data_ptr(), scratch.data_ptr(), out.data_ptr(), b,
            h, r, dr, n_pages, page, npp, ctypes.c_float(scale),
            torch.cuda.current_stream().cuda_stream)
    LATENT_LIBRARY.check(err, "paged_latent_decode kernel")
    paged_latent_decode.launches += 1
    return out


paged_latent_decode.launches = 0


def _latent_plain(plain, q_lat, q_pe, ckv_pages, kpe_pages, lengths, page_tables, scale: float,
                  pages_per_program: int) -> torch.Tensor:
    """A plain version (``paged_decode_stream`` or ``_gather``) on the latent
    form, called as the reference calls it (``ops.py:402-415``): one KV head
    (a size-1 axis), the latent pool passed as both K and V."""
    pool = ckv_pages[:, None]
    return plain(q_lat[:, None], pool, pool, lengths, page_tables, scale=scale,
                 pages_per_program=pages_per_program, q_pe=q_pe[:, None],
                 kpe_pages=kpe_pages[:, None])[:, 0]


def paged_latent_decode_attention(
    q_lat: torch.Tensor,  # (B, H, r) absorbed queries (latent space)
    q_pe: torch.Tensor,  # (B, H, dr)
    ckv_pages: torch.Tensor,  # (n_pages, page, r) latent page pool
    kpe_pages: torch.Tensor,  # (n_pages, page, dr)
    lengths: torch.Tensor,  # (B,) valid positions incl. the new token
    page_tables: torch.Tensor,  # (B, pages_per_seq) int32
    *,
    sm_scale: float,
    impl: str = "kernel",
    pages_per_program: Optional[int] = None,
) -> torch.Tensor:
    """MLA latent decode over the paged (c_kv, k_pe) pools; returns the
    latent context (B, H, r).  Scores ``q_lat . ckv + q_pe . kpe``, the
    context accumulated against ``ckv`` itself (the absorbed form: the pool
    is both keys and values).  ``"stream"`` and ``"gather"`` are the plain
    versions with the pool passed as K and V and a size-1 head axis, as the
    reference calls them.  ``pages_per_program=None`` consults the tuner's
    cache at ``latent_shape``, falling back to ``DEFAULT_PAGES_PER_PROGRAM``."""
    if impl not in POOL_IMPLS:
        raise ValueError(f"impl={impl!r} not in {POOL_IMPLS}")
    b, h, r = q_lat.shape
    page, npp = ckv_pages.shape[1], page_tables.shape[1]
    if pages_per_program is None:
        shape = latent_shape(b, h, r, q_pe.shape[2], page, npp)
        ppp = _tuned_value("flash_decode_paged", shape, q_lat.dtype, "pages_per_program",
                           DEFAULT_PAGES_PER_PROGRAM, q_lat.device.type)
    else:
        ppp = int(pages_per_program)
    if impl == "kernel":
        return paged_latent_decode(q_lat, q_pe, ckv_pages, kpe_pages, lengths, page_tables,
                                   scale=float(sm_scale), pages_per_program=ppp)
    plain = paged_decode_stream if impl == "stream" else paged_decode_gather
    return _latent_plain(plain, q_lat, q_pe, ckv_pages, kpe_pages, lengths, page_tables,
                         float(sm_scale), ppp)


def _decode_cost(q, k_cache, v_cache, lengths, **kwargs):
    """K5's launch record (``roofline.decode_cost`` over the capacity)."""
    from repro_torch.kernels.tune.roofline import decode_cost

    b, hq, d = q.shape
    hk, s = k_cache.shape[1], k_cache.shape[2]
    return [("flash_decode", *decode_cost(b, hq, hk, s, d, b * s, q.element_size()))]


@counted(_decode_cost)
def flash_decode(
    q: torch.Tensor,  # (B, Hq, d) bfloat16
    k_cache: torch.Tensor,  # (B, Hk, S, d) bfloat16, Hq = G * Hk
    v_cache: torch.Tensor,  # (B, Hk, S, d) bfloat16
    lengths: torch.Tensor,  # (B,) int32 valid positions
    *,
    sm_scale: float,
    block_k: int = DEFAULT_DECODE_BLOCK_K,
) -> torch.Tensor:
    """K5's wrapper: one-token decode over a contiguous cache in tiles of
    ``min(block_k, S)`` positions.  Returns (B, Hq, d) in q's dtype."""
    if q.device.type == "cpu":
        return flash_decode_ref(q, k_cache, v_cache, lengths, sm_scale=sm_scale,
                                block_k=block_k)
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cpu, cuda or meta tensors, not {q.device}")
    if q.dim() != 3:
        raise ValueError(f"q has shape {tuple(q.shape)}, expected (B, Hq, d)")
    b, hq, d = q.shape
    if k_cache.dim() != 4 or k_cache.shape[0] != b or k_cache.shape[3] != d:
        raise ValueError(f"k_cache has shape {tuple(k_cache.shape)}, q {tuple(q.shape)}")
    _, hk, s, _ = k_cache.shape
    if tuple(v_cache.shape) != tuple(k_cache.shape):
        raise ValueError(f"v_cache {tuple(v_cache.shape)} must match k_cache "
                         f"{tuple(k_cache.shape)} (the kernel takes dv == dk)")
    if hq % hk:
        raise ValueError(f"Hq={hq} not a multiple of Hk={hk}")
    if d % 16 or not 16 <= d <= 256:
        raise ValueError(f"head dim {d}: the kernel takes multiples of 16 up to 256")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths has shape {tuple(lengths.shape)}, expected ({b},)")
    if block_k < 1:
        raise ValueError(f"block_k={block_k} must be positive")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if name == "lengths":
            if t.dtype != torch.int32:
                raise TypeError(f"lengths is {t.dtype}; the kernel takes int32")
        elif t.dtype != torch.bfloat16:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    _check_aligned(q=q, k_cache=k_cache, v_cache=v_cache)
    g = hq // hk
    out = torch.empty_like(q)
    if b * hq == 0:
        return out
    if s == 0:
        return out.zero_()
    bk = min(int(block_k), s)
    lib = DECODE_LIBRARY.load()
    smem = lib.flash_decode_smem_bytes(g, d, bk)
    if smem > MAX_SMEM_PER_BLOCK:
        raise ValueError(f"G={g}, d={d}, block_k={bk} need {smem} bytes of shared memory, "
                         f"more than the {MAX_SMEM_PER_BLOCK} a block may use")
    scratch = _split_scratch(b, hk, g, d, lib.flash_decode_splits(s, bk), q.device)
    with torch.cuda.device(q.device):
        err = lib.flash_decode_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), b, hk, g, s, d, bk, ctypes.c_float(sm_scale),
            torch.cuda.current_stream().cuda_stream)
    DECODE_LIBRARY.check(err, "flash_decode kernel")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def decode_attention_auto(
    q: torch.Tensor,  # (B, Hq, D)
    k_cache: torch.Tensor,  # (B, Hk, S, D)
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    use_kernel: bool = True,
    block_k: int = DEFAULT_DECODE_BLOCK_K,
    sm_scale: Optional[float] = None,
    tuned: bool = False,
) -> torch.Tensor:
    """Decode attention over a contiguous cache: ``use_kernel=True`` runs
    ``flash_decode`` (K5 on the card, its plain version on the CPU) with KV
    grouped in place, never repeated; ``use_kernel=False`` the plain
    ``decode_attention``.  ``tuned=True`` takes ``block_k`` from the
    autotuner's config cache when an entry exists."""
    if tuned:
        shape = {"b": q.shape[0], "h": q.shape[1], "s": k_cache.shape[2], "d": q.shape[2]}
        block_k = _tuned_value("flash_decode", shape, q.dtype, "block_k", block_k,
                               q.device.type)
    if not use_kernel:
        return decode_attention(q, k_cache, v_cache, lengths, sm_scale=sm_scale)
    scale = float(sm_scale) if sm_scale is not None else 1.0 / (q.shape[2] ** 0.5)
    return flash_decode(q, k_cache, v_cache, lengths, sm_scale=scale, block_k=block_k)


def gather_pages(pool: torch.Tensor, page_tables: torch.Tensor) -> torch.Tensor:
    """Dense per-sequence view of a page pool: (n_pages, Hk, page, d) K/V
    pools give (B, Hk, npp * page, d), (n_pages, page, r) latent pools
    (B, npp * page, r).  Positions past a sequence's fill hold stale pages
    (the scratch page included) and must be masked by the caller through
    ``kv_lens``.  Page ids outside the pool are clamped, as the reference's
    gather clamps them."""
    b, npp = page_tables.shape
    idx = page_tables.long().clamp(0, pool.shape[0] - 1)
    tile = pool[idx]  # (B, npp, ...)
    if pool.dim() == 4:
        return tile.movedim(2, 1).reshape(b, pool.shape[1], npp * pool.shape[2], pool.shape[3])
    if pool.dim() == 3:
        return tile.reshape(b, npp * pool.shape[1], pool.shape[2])
    raise ValueError(f"unsupported pool rank {pool.dim()}")


def paged_prefill_attention(
    q: torch.Tensor,  # (B, Hq, C, d) one prompt chunk of queries
    k_pages: torch.Tensor,  # (n_pages, Hk, page, d) pool incl. this chunk's K
    v_pages: torch.Tensor,  # (n_pages, Hk, page, d)
    kv_lens: torch.Tensor,  # (B,) valid positions incl. this chunk
    page_tables: torch.Tensor,  # (B, pages_per_seq) int32
    *,
    q_offset: int,  # absolute position of the chunk's first query
    sm_scale: Optional[float] = None,
    block_q: int = 16,
    block_k: int = 16,
) -> torch.Tensor:
    """Causal chunked-prefill attention over the paged KV pool: the chunk's
    K/V already scattered into its pages, the whole page-table row gathered
    to a contiguous view, then the flash forward (K3 on the card) with the
    chunk's absolute query offset.  Returns (B, Hq, C, d)."""
    k_full = gather_pages(k_pages, page_tables)
    v_full = gather_pages(v_pages, page_tables)
    return flash_attention(q, k_full, v_full, causal=True, sm_scale=sm_scale,
                           kv_lens=kv_lens, q_offset=q_offset, block_q=block_q,
                           block_k=block_k)


def fold_verify_batch(tokens: torch.Tensor, lengths: torch.Tensor,
                      page_tables: torch.Tensor):
    """Fold a (B, T) verify window (column 0 the pending token, columns 1..
    the drafts) into a decode batch of B * T rows, sequence-major: row
    ``s * T + t`` carries token ``tokens[s, t]`` at position ``lengths[s] +
    t`` with sequence s's page-table row.  A decode step over the fold
    scatters every row's K/V before any row attends, so row t sees the rows
    before it through its length alone.  Returns (tokens (B*T,), lengths
    (B*T,), page_tables (B*T, npp))."""
    b, t = tokens.shape
    toks = tokens.reshape(b * t)
    lens = (lengths[:, None] + torch.arange(t, dtype=lengths.dtype,
                                            device=lengths.device)[None, :]).reshape(b * t)
    return toks, lens, page_tables.repeat_interleave(t, dim=0)


def paged_verify_attention(
    q: torch.Tensor,  # (B, T, Hq, d) the window's queries
    k_pages: torch.Tensor,  # (n_pages, Hk, page, d), the window's K/V already in
    v_pages: torch.Tensor,
    lengths: torch.Tensor,  # (B,) fill before the window: row t attends l + t + 1
    page_tables: torch.Tensor,  # (B, pages_per_seq) int32
    *,
    sm_scale: Optional[float] = None,
    impl: str = "kernel",
    pages_per_program: Optional[int] = None,
) -> torch.Tensor:
    """Decode attention for a window of T positions a sequence in one call
    (K2 on the card), folded as ``fold_verify_batch`` folds it; each row's
    output is the one a decode call at that row's length gives.  Returns
    (B, T, Hq, d)."""
    b, t, hq, d = q.shape
    lens = (lengths.to(torch.int32)[:, None] + 1
            + torch.arange(t, dtype=torch.int32, device=lengths.device)[None, :])
    out = paged_decode_attention(q.reshape(b * t, hq, d), k_pages, v_pages,
                                 lens.reshape(b * t),
                                 page_tables.repeat_interleave(t, dim=0).contiguous(),
                                 sm_scale=sm_scale, impl=impl,
                                 pages_per_program=pages_per_program)
    return out.reshape(b, t, hq, v_pages.shape[3])
