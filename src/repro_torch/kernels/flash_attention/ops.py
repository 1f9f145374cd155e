"""Blocked causal flash attention, forward and backward: the Hopper kernels
(K3, csrc/flash_fwd.cu; K3-bwd, csrc/flash_bwd.cu) for CUDA tensors, the
plain versions (ref.py) for CPU tensors.

``flash_attention`` is the model-facing call, with the signature of
``repro/kernels/flash_attention/ops.py::flash_attention`` (grouped GQA,
``kv_lens``, static ``q_offset``, a value dim that may differ from the key
dim, as MLA's prefill and training need).  When q, k or v requires grad it
runs through ``FlashAttention``, a ``torch.autograd.Function`` whose forward
is K3 with the rows' log-sum-exp and whose backward is K3-bwd, the
counterpart of the reference's ``jax.custom_vjp`` (``ops.py:46``,
``defvjp`` at ``:213``); otherwise it runs the forward alone, as the serve
paths do.

``flash_fwd`` and the backward's passes ``flash_bwd_dq``, ``flash_bwd_dkdv``
and, where dk's and dv's accumulators do not fit one walk (MLA's (192,
128)), ``flash_bwd_dv`` and ``flash_bwd_dk`` are the kernels' wrappers: a
CUDA tensor goes to the kernel or the call raises, nothing falls back to the
plain version, and each wrapper's ``launches`` counts its kernel's launches
and only those.  ``flash_bwd`` runs the dq pass and the key side's pass or
passes (``bwd_key_passes``), or, on CPU tensors, ``flash_bwd_ref``.

``decode_attention`` is the reference's plain one-token decode over a
contiguous cache (``ops.py:245``); it is not a kernel.

On "meta" tensors (the dry-run's analysis, ``repro_torch.launch.dryrun``)
``flash_fwd`` and ``flash_bwd`` return empty outputs of the kernels'
shapes; under the dry-run's counter each records its launches' FLOPs and
bytes (``repro_torch.dist.op_costs.counted``) on every device alike.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from repro_torch.dist.op_costs import counted
from repro_torch.kernels._build import MAX_SMEM_PER_BLOCK, KernelLibrary
from repro_torch.kernels.flash_attention.ref import flash_bwd_ref, flash_fwd_ref

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIBRARY = KernelLibrary(
    Path(__file__).resolve().parent / "csrc" / "flash_fwd.cu", "flash_fwd",
    {"flash_fwd_launch": ([_p] * 6 + [_i] * 10 + [_f, _p], ctypes.c_int),
     "flash_fwd_smem_bytes": ([_i, _i, _i, _i], ctypes.c_int),
     "flash_fwd_tile_probe": ([_p] * 6 + [_i, _i, _p], ctypes.c_int)},
    error_fn="flash_fwd_error_string")
BWD_LIBRARY = KernelLibrary(
    Path(__file__).resolve().parent / "csrc" / "flash_bwd.cu", "flash_bwd",
    {"flash_bwd_launch": ([_p] * 11 + [_i] * 10 + [_f, _p], ctypes.c_int),
     "flash_bwd_smem_bytes": ([_i, _i, _i], ctypes.c_int),
     "flash_bwd_plan": ([_i] * 8 + [_p], ctypes.c_int),
     "flash_bwd_occupancy": ([_i, _i, _i, _p], ctypes.c_int)},
    error_fn="flash_bwd_error_string",
    includes=[Path(__file__).resolve().parents[1] / "csrc" / "hopper.cuh"])

# The kernel's online-softmax steps: whole 16-key chunks of its 64-key tiles.
KERNEL_BLOCK_KS = (16, 32, 64)
MAX_BLOCK_K = max(KERNEL_BLOCK_KS)
NEG_INF = -1e30
# (key dim, value dim) pairs the kernel is built for: equal dims, multiples
# of 16 up to 256, and MLA's prefill, DeepSeek-V2's and its smoke variant's
HEAD_DIMS = tuple((d, d) for d in range(16, 257, 16)) + ((192, 128), (24, 16))
# (key dim, value dim) pairs the backward is built for (flash_bwd.cu:
# FLASH_BWD_DIMS): equal dims, multiples of 16 up to 128, and MLA's
# training, DeepSeek-V2's (192, 128) and its smoke variant's (24, 16)
BWD_HEAD_DIMS = tuple((d, d) for d in range(16, 129, 16)) + ((192, 128), (24, 16))
# K3-bwd's passes (flash_bwd.cu: kPassDq .. kPassDk): the dq pass, then the
# key side as one dk/dv pass or as a dv pass and a dk pass
BWD_DQ, BWD_DKDV, BWD_DV, BWD_DK = 0, 1, 2, 3
# K3-bwd's schedule (flash_bwd.cu: kTile, kSlots, kMaxSplit, kMinChunk): rows
# or keys a tile; the slots the key side's cut aims at (an H100's 132 SMs
# x 2 blocks), the most chunks a key tile's walk is cut into, and the fewest
# steps a chunk is cut down to
BWD_TILE, BWD_SLOTS, BWD_MAX_SPLIT, BWD_MIN_CHUNK = 64, 264, 8, 4


def kernel_block_k(block_k: int, skv: int) -> Optional[int]:
    """The online-softmax step the kernel runs for ``block_k`` over ``skv``
    keys, or None where it refuses ``block_k``: a block_k of Skv or more (up
    to ``MAX_BLOCK_K``) is one step over every key and runs as 64."""
    if not 1 <= block_k <= MAX_BLOCK_K:
        return None
    bk = MAX_BLOCK_K if block_k >= skv else int(block_k)
    return bk if bk in KERNEL_BLOCK_KS else None


def _fwd_cost(q, k, v, *args, causal: bool = True, q_offset: int = 0, **kwargs):
    """K3's launch record (``roofline.flash_attention_cost``, over the pairs
    the mask leaves)."""
    from repro_torch.kernels.tune.roofline import flash_attention_cost

    b, hq, sq, d = q.shape
    return [("flash_fwd", *flash_attention_cost(b, hq, k.shape[1], sq, k.shape[2], d,
                                                v.shape[3], q.element_size(), int(q_offset),
                                                causal))]


@counted(_fwd_cost)
def flash_fwd(
    q: torch.Tensor,  # (B, Hq, Sq, Dk) bfloat16
    k: torch.Tensor,  # (B, Hk, Skv, Dk) bfloat16
    v: torch.Tensor,  # (B, Hk, Skv, Dv) bfloat16
    kv_lens: torch.Tensor,  # (B,) valid key positions
    *,
    causal: bool = True,
    sm_scale: float,
    q_offset: int = 0,
    block_q: int = 16,
    block_k: int = 16,
    return_lse: bool = False,
):
    """Returns (B, Hq, Sq, Dv) in q's dtype, and with ``return_lse`` also
    each row's float32 log-sum-exp (B, Hq, Sq), which the kernel writes
    after the output without changing its bits.  ``block_q`` cuts the plain
    version's query tiles; the kernel's rows are independent of it.  The
    kernel takes ``block_k`` in ``KERNEL_BLOCK_KS``, or any ``block_k`` from
    Skv up to ``MAX_BLOCK_K`` (``kernel_block_k``)."""
    if q.device.type == "cpu":
        return flash_fwd_ref(q, k, v, kv_lens, causal=causal, sm_scale=sm_scale,
                             q_offset=q_offset, block_q=block_q, block_k=block_k,
                             return_lse=return_lse)
    if q.device.type == "meta":
        out = torch.empty((*q.shape[:3], v.shape[3]), dtype=q.dtype, device=q.device)
        if not return_lse:
            return out
        return out, torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cpu, cuda or meta tensors, not {q.device}")
    b, hq, sq, d = q.shape
    if k.dim() != 4 or k.shape[0] != b:
        raise ValueError(f"k has shape {tuple(k.shape)}, q {tuple(q.shape)}")
    _, hk, skv, dk = k.shape
    if v.dim() != 4 or tuple(v.shape[:3]) != tuple(k.shape[:3]) or dk != d:
        raise ValueError(f"v {tuple(v.shape)} and k {tuple(k.shape)} must match but for "
                         f"v's last dim, with q's head dim {d}")
    dv = v.shape[3]
    if hq % hk:
        raise ValueError(f"Hq={hq} not a multiple of Hk={hk}")
    if (d, dv) not in HEAD_DIMS:
        raise ValueError(f"(dk, dv) = ({d}, {dv}): the kernel is built for equal dims, "
                         "multiples of 16 up to 256, and (192, 128) and (24, 16)")
    bk = kernel_block_k(block_k, skv)
    if bk is None:
        raise ValueError(f"block_k={block_k} at Skv={skv}: the kernel takes {KERNEL_BLOCK_KS}, "
                         f"or any block_k from Skv up to {MAX_BLOCK_K}")
    if tuple(kv_lens.shape) != (b,):
        raise ValueError(f"kv_lens has shape {tuple(kv_lens.shape)}, expected ({b},)")
    for name, t in (("q", q), ("k", k), ("v", v), ("kv_lens", kv_lens)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if name != "kv_lens" and t.dtype != torch.bfloat16:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if name != "kv_lens" and t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    g = hq // hk
    lib = LIBRARY.load()
    smem = lib.flash_fwd_smem_bytes(g, d, dv, bk)
    if smem > MAX_SMEM_PER_BLOCK:
        raise ValueError(f"dk={d}, dv={dv} need {smem} bytes of shared memory, more than the "
                         f"{MAX_SMEM_PER_BLOCK} a block may use")
    lens32 = kv_lens.to(torch.int32).contiguous()
    out = torch.empty((b, hq, sq, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if return_lse else None
    if b * hq * sq == 0:
        return (out, lse) if return_lse else out
    with torch.cuda.device(q.device):
        err = lib.flash_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lens32.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, hk, g, sq, skv, d, dv, int(q_offset),
            int(bool(causal)), bk, ctypes.c_float(sm_scale),
            torch.cuda.current_stream().cuda_stream)
    LIBRARY.check(err, "flash_fwd kernel")
    flash_fwd.launches += 1
    return (out, lse) if return_lse else out


flash_fwd.launches = 0


def bwd_key_passes(dk: int, dv: int) -> tuple:
    """The key side's launches at (dk, dv) (``kFusedKeys``): the dk/dv pass
    where dk's and dv's float32 accumulators, 64-column panels of each, hold
    at most 256 columns, as at D 128 (every equal pair and (24, 16)); else
    the dv pass and then the dk pass ((192, 128): dk and dv alone would take
    160 registers a thread)."""
    panels = -(-dk // 64) + -(-dv // 64)
    return (BWD_DKDV,) if panels <= 4 else (BWD_DV, BWD_DK)


def bwd_tiles_seeing(j: int, nq: int, sq: int, q_offset: int, causal: bool) -> int:
    """Query tiles of ``BWD_TILE`` rows that the dk/dv pass walks for key
    tile j: every tile, or (causal) those from the tile of the first row that
    sees the tile's first key; 0 when no row does (``tiles_seeing``)."""
    if not causal:
        return nq
    first = j * BWD_TILE - q_offset
    return 0 if first >= sq else nq - max(first, 0) // BWD_TILE


def bwd_split(b: int, hk: int, g: int, sq: int, skv: int, q_offset: int, causal: bool) -> int:
    """The dk/dv pass's split (``dkdv_split``): the smallest of 1, 2, 4, 8
    chunks a key tile's walk of G x n_j steps is cut into such that the
    longest chunk is no longer than the mean load of a slot (all steps over
    ``BWD_SLOTS``), stopping before chunks fall under ``BWD_MIN_CHUNK``
    steps.  A function of the shapes alone, not of kv_lens or the card."""
    nq, nk = -(-sq // BWD_TILE), -(-skv // BWD_TILE)
    works = [g * bwd_tiles_seeing(j, nq, sq, q_offset, causal) for j in range(nk)]
    total, longest = sum(works) * hk * b, max(works, default=0)
    split = 1
    while (split < BWD_MAX_SPLIT and -(-longest // split) * BWD_SLOTS > total
           and -(-longest // (2 * split)) >= BWD_MIN_CHUNK):
        split *= 2
    return split


def bwd_grid(pass_no: int, b: int, hk: int, g: int, sq: int, skv: int, q_offset: int,
             causal: bool) -> tuple:
    """(grid x, y, z, cluster size) of a pass, as the library's
    ``flash_bwd_plan`` reports it: the dq pass (Hq, ceil(Sq / 64), B), its
    y read from the last query tile down; each pass of the key side (the
    dk/dv pass, or the dv and the dk pass) (split, Hk x B, ceil(Skv / 64))
    in clusters of ``split`` along x."""
    if pass_no == BWD_DQ:
        return hk * g, -(-sq // BWD_TILE), b, 1
    split = bwd_split(b, hk, g, sq, skv, q_offset, causal)
    return split, hk * b, -(-skv // BWD_TILE), split


class BwdUnit(NamedTuple):
    """One block of the dk/dv pass: key tile ``key_tile`` of KV head
    ``kv_head`` in batch row ``batch``, chunk ``chunk`` of its walk, which is
    steps [first, last) of the key tile's G x n_j steps; ``visits`` lists the
    (query head, query tile) of each step it runs, in order."""
    key_tile: int
    kv_head: int
    batch: int
    chunk: int
    first: int
    last: int
    visits: tuple


def bwd_plan(b: int, hk: int, g: int, sq: int, skv: int, kv_lens, q_offset: int,
             causal: bool) -> list:
    """The key side's schedule, the CPU mirror of ``flash_bwd_key_kernel``
    (each of its passes runs it): its blocks in launch order (key tile
    slowest, then batch and KV head, then chunk).  Key tile j's walk is
    step i at query head kv_head * G + i // n_j and query tile (nq - n_j) +
    i % n_j, cut into ``bwd_split`` chunks of ceil(G n_j / split) steps;
    chunk c is the cluster's block of rank c, and the chunks' partials are
    summed in rank order.  A key tile starting at or past its row's kv_len
    runs no step."""
    split = bwd_split(b, hk, g, sq, skv, q_offset, causal)
    nq, nk = -(-sq // BWD_TILE), -(-skv // BWD_TILE)
    lens = [min(max(int(x), 0), skv) for x in kv_lens]
    units = []
    for j in range(nk):
        per_head = bwd_tiles_seeing(j, nq, sq, q_offset, causal)
        work = g * per_head
        span = -(-work // split)
        for batch in range(b):
            for kvh in range(hk):
                for chunk in range(split):
                    first = min(work, chunk * span)
                    last = min(work, first + span) if j * BWD_TILE < lens[batch] else first
                    visits = tuple((kvh * g + i // per_head, nq - per_head + i % per_head)
                                   for i in range(first, last))
                    units.append(BwdUnit(j, kvh, batch, chunk, first, last, visits))
    return units


def _bwd_pass(pass_no: int, q, k, v, lens32, out, lse, dout, delta, grads, sm_scale: float,
              q_offset: int, causal: bool) -> None:
    """Launch one pass of K3-bwd (``BWD_DQ``: delta and dq, ``BWD_DKDV``: dk
    and dv, ``BWD_DV``: dv, ``BWD_DK``: dk) into the tensors of ``grads``
    (dq, dk, dv; a pass writes only its own)."""
    b, hq, sq, d = q.shape
    hk, skv, dv_dim = k.shape[1], k.shape[2], v.shape[3]
    dq, dk, dv = grads
    lib = BWD_LIBRARY.load()
    with torch.cuda.device(q.device):
        err = lib.flash_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lens32.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), pass_no, b, hk, hq // hk, sq, skv, d, dv_dim, int(q_offset),
            int(bool(causal)), ctypes.c_float(sm_scale), torch.cuda.current_stream().cuda_stream)
    BWD_LIBRARY.check(err, f"flash_bwd pass {pass_no} kernel")


def flash_bwd_dq(q, k, v, lens32, out, lse, dout, delta, grads, *, sm_scale: float,
                 q_offset: int, causal: bool) -> None:
    """K3-bwd's dq pass: writes delta = rowsum(dout * out) and dq.  Inputs
    as ``flash_bwd`` checks them."""
    _bwd_pass(BWD_DQ, q, k, v, lens32, out, lse, dout, delta, grads, sm_scale, q_offset, causal)
    flash_bwd_dq.launches += 1


def flash_bwd_dkdv(q, k, v, lens32, out, lse, dout, delta, grads, *, sm_scale: float,
                   q_offset: int, causal: bool) -> None:
    """K3-bwd's dk/dv pass: reads the dq pass's delta, writes dk and dv."""
    _bwd_pass(BWD_DKDV, q, k, v, lens32, out, lse, dout, delta, grads, sm_scale, q_offset,
              causal)
    flash_bwd_dkdv.launches += 1


def flash_bwd_dv(q, k, v, lens32, out, lse, dout, delta, grads, *, sm_scale: float,
                 q_offset: int, causal: bool) -> None:
    """K3-bwd's dv pass, where the key side is two launches: writes dv."""
    _bwd_pass(BWD_DV, q, k, v, lens32, out, lse, dout, delta, grads, sm_scale, q_offset, causal)
    flash_bwd_dv.launches += 1


def flash_bwd_dk(q, k, v, lens32, out, lse, dout, delta, grads, *, sm_scale: float,
                 q_offset: int, causal: bool) -> None:
    """K3-bwd's dk pass, where the key side is two launches: reads the dq
    pass's delta, writes dk."""
    _bwd_pass(BWD_DK, q, k, v, lens32, out, lse, dout, delta, grads, sm_scale, q_offset, causal)
    flash_bwd_dk.launches += 1


flash_bwd_dq.launches = 0
flash_bwd_dkdv.launches = 0
flash_bwd_dv.launches = 0
flash_bwd_dk.launches = 0
# each key-side pass's wrapper
BWD_KEY_WRAPPERS = {BWD_DKDV: flash_bwd_dkdv, BWD_DV: flash_bwd_dv, BWD_DK: flash_bwd_dk}


def _bwd_cost(q, k, v, kv_lens, out, lse, dout, *, causal: bool = True, q_offset: int = 0,
              **kwargs):
    """K3-bwd's launch records: the dq pass, then the key side's pass or
    passes (``roofline.flash_bwd_pass_cost``)."""
    from repro_torch.kernels.tune.roofline import flash_bwd_pass_cost

    b, hq, sq, d = q.shape
    hk, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    return [(name, *flash_bwd_pass_cost(pass_no, b, hq, hk, sq, skv, d, dv, int(q_offset),
                                        bool(causal), q.element_size()))
            for pass_no, name in ((BWD_DQ, "flash_bwd_dq"),
                                  *((p, BWD_KEY_WRAPPERS[p].__name__)
                                    for p in bwd_key_passes(d, dv)))]


@counted(_bwd_cost)
def flash_bwd(
    q: torch.Tensor,  # (B, Hq, Sq, Dk) bfloat16
    k: torch.Tensor,  # (B, Hk, Skv, Dk)
    v: torch.Tensor,  # (B, Hk, Skv, Dv)
    kv_lens: torch.Tensor,  # (B,)
    out: torch.Tensor,  # (B, Hq, Sq, Dv), the forward's output
    lse: torch.Tensor,  # (B, Hq, Sq) float32, the forward's log-sum-exp
    dout: torch.Tensor,  # (B, Hq, Sq, Dv)
    *,
    causal: bool = True,
    sm_scale: float,
    q_offset: int = 0,
    block_q: int = 16,
    block_k: int = 16,
):
    """(dq, dk, dv) of the flash forward, in q's, k's and v's dtypes.  CPU
    tensors run ``flash_bwd_ref`` (at ``block_q`` x ``block_k`` tiles); CUDA
    tensors run K3-bwd's dq pass and the key side's pass or passes
    (``bwd_key_passes``), whose blocking is their own, or raise."""
    if q.device.type == "cpu":
        return flash_bwd_ref(q, k, v, kv_lens, out, lse, dout, causal=causal, sm_scale=sm_scale,
                             q_offset=q_offset, block_q=block_q, block_k=block_k)
    if q.device.type == "meta":
        delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        del delta  # the dq pass's rows, freed at the return as on the card
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd runs on cpu, cuda or meta tensors, not {q.device}")
    b, hq, sq, d = q.shape
    if (k.dim() != 4 or v.dim() != 4 or k.shape[0] != b or k.shape[3] != d
            or tuple(v.shape[:3]) != tuple(k.shape[:3])):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: k must "
                         "match q's batch and key dim, v k's but for its value dim")
    hk, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    if hq % hk:
        raise ValueError(f"Hq={hq} not a multiple of Hk={hk}")
    if (d, dv) not in BWD_HEAD_DIMS:
        raise ValueError(f"(dk, dv) = ({d}, {dv}): the backward is built for equal dims, "
                         "multiples of 16 up to 128, and (192, 128) and (24, 16)")
    o_shape = (b, hq, sq, dv)
    for name, t, shape in (("out", out, o_shape), ("dout", dout, o_shape),
                           ("lse", lse, q.shape[:3]), ("kv_lens", kv_lens, (b,))):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout), ("lse", lse),
                    ("kv_lens", kv_lens)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        want = torch.float32 if name == "lse" else None if name == "kv_lens" else torch.bfloat16
        if want is not None and t.dtype != want:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if name not in ("lse", "kv_lens") and t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    lens32 = kv_lens.to(torch.int32).contiguous()
    grads = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    if b * hq * sq == 0 or skv == 0:
        return tuple(t.zero_() for t in grads)
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    kw = dict(sm_scale=sm_scale, q_offset=q_offset, causal=causal)
    flash_bwd_dq(q, k, v, lens32, out, lse, dout, delta, grads, **kw)
    for pass_no in bwd_key_passes(d, dv):
        BWD_KEY_WRAPPERS[pass_no](q, k, v, lens32, out, lse, dout, delta, grads, **kw)
    return grads


class FlashAttention(torch.autograd.Function):
    """The flash forward with its gradient: forward K3 with the rows'
    log-sum-exp (saved with q, k, v and the output), backward K3-bwd; their
    plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens, causal, sm_scale, q_offset, block_q, block_k):
        out, lse = flash_fwd(q, k, v, kv_lens, causal=causal, sm_scale=sm_scale,
                             q_offset=q_offset, block_q=block_q, block_k=block_k,
                             return_lse=True)
        ctx.save_for_backward(q, k, v, kv_lens, out, lse)
        ctx.options = dict(causal=causal, sm_scale=sm_scale, q_offset=q_offset,
                           block_q=block_q, block_k=block_k)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_lens, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, kv_lens, out, lse, dout.contiguous(), **ctx.options)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,  # (B, Hq, Sq, Dk)
    k: torch.Tensor,  # (B, Hk, Skv, Dk)
    v: torch.Tensor,  # (B, Hk, Skv, Dv)
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    kv_lens: Optional[torch.Tensor] = None,  # (B,)
    q_offset: int = 0,
    block_q: int = 16,
    block_k: int = 16,
) -> torch.Tensor:
    """Memory-efficient attention, the counterpart of the reference's
    ``ops.flash_attention`` (``ops.py:216``): KV is grouped without being
    repeated (query head h reads KV head h // G), blocks clamp to
    ``min(block, max(seq, 16))`` as there.  Differentiable in q, k and v
    (``FlashAttention``) when grad is enabled and one of them requires it."""
    b, hq, sq, d = q.shape
    _, hk, skv, _ = k.shape
    if hq % hk:
        raise ValueError(f"Hq={hq} not a multiple of Hk={hk}")
    scale = float(sm_scale) if sm_scale is not None else 1.0 / (d ** 0.5)
    block_q = min(block_q, max(sq, 16))
    block_k = min(block_k, max(skv, 16))
    if kv_lens is None:
        kv_lens = torch.full((b,), skv, dtype=torch.int32, device=q.device)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, kv_lens, bool(causal), scale, int(q_offset),
                                    int(block_q), int(block_k))
    return flash_fwd(q, k, v, kv_lens, causal=causal, sm_scale=scale,
                     q_offset=int(q_offset), block_q=int(block_q), block_k=int(block_k))


def decode_partials(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                    lengths: torch.Tensor, sm_scale: Optional[float] = None):
    """``decode_attention`` before its division: q (B, Hq, D), the cache
    (B, Hk, S, D), ``lengths`` (B,) the valid positions (<= 0: none).
    Products of the stored values accumulated in float32, masked scores set
    to ``NEG_INF``, p rounded to v's dtype before the PV product.  Returns
    the max and the sum (B, Hk, G, 1) and p V (B, Hk, G, D), float32: a block
    of positions' partial, which ``models.attention.merge_partials`` merges
    over a cache split along its sequence."""
    b, hq, d = q.shape
    _, hk, s, _ = k_cache.shape
    scale = float(sm_scale) if sm_scale is not None else 1.0 / (d ** 0.5)
    qf = q.reshape(b, hk, hq // hk, d)
    scores = torch.einsum("bkgd,bksd->bkgs", qf.float(), k_cache.float()) * scale
    pos = torch.arange(s, device=q.device)
    mask = pos[None, :] < lengths.to(q.device)[:, None]  # (B, S)
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    out = torch.einsum("bkgs,bksd->bkgd", p.to(v_cache.dtype).float(), v_cache.float())
    return m, p.sum(dim=-1, keepdim=True), out


def decode_attention(
    q: torch.Tensor,  # (B, Hq, D) one new token per sequence
    k_cache: torch.Tensor,  # (B, Hk, S, D)
    v_cache: torch.Tensor,  # (B, Hk, S, D)
    lengths: torch.Tensor,  # (B,) number of valid cache positions
    *,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """One-token decode attention with the reference's arithmetic: the
    partial of ``decode_partials``, its sum divided by ``max(l, 1e-30)``.  A
    row of length 0 has every score masked and gets the mean of V, as in the
    reference.  Returns (B, Hq, D) in q's dtype."""
    _, l, out = decode_partials(q, k_cache, v_cache, lengths, sm_scale)
    out = out / torch.clamp(l, min=1e-30)
    return out.reshape(q.shape[0], q.shape[1], v_cache.shape[-1]).to(q.dtype)
