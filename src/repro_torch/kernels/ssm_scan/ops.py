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

Training: when grad is enabled and an input requires it, ``selective_scan``
runs through ``SelectiveScan``, a ``torch.autograd.Function`` whose forward
is K4 from zero state (it allocates its state and writes no caller's), also
storing the state before each tile of 256 positions, and whose backward is
K4-bwd (csrc/selective_scan_bwd.cu), the port's own kernel: the reference
differentiates its chunked associative scan by JAX autodiff, with no Pallas
kernel behind it.  ``selective_scan_bwd`` is K4-bwd's wrapper: a CUDA tensor
goes to the kernel or the call raises, a CPU tensor to its plain version
(``ref.selective_scan_bwd_ref``).  ``selective_scan_bwd.launches`` counts
the launches of its scan pass on the card; the pass's partials go to the
reduction's own wrapper, ``selective_scan_bwd_reduce``, whose ``launches``
counts its launches.

On "meta" tensors (the dry-run's analysis) ``selective_scan`` and
``selective_scan_bwd`` return empty outputs of the kernels' shapes; under
the dry-run's counter each records its launches' FLOPs and bytes on every
device alike (``repro_torch.dist.op_costs.counted``; K4-bwd's reduction is
recorded by ``selective_scan_bwd``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.dist.op_costs import counted
from repro_torch.kernels._build import MAX_SMEM_PER_BLOCK, KernelLibrary
from repro_torch.kernels.ssm_scan.ref import (
    BWD_WARPS,
    SCAN_TILE,
    bwd_cluster,
    bwd_lanes,
    bwd_round,
    selective_scan_bwd_ref,
    selective_scan_ref,
    sum_partials_ref,
)

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_CSRC = Path(__file__).resolve().parent / "csrc"
LIBRARY = KernelLibrary(
    _CSRC / "selective_scan.cu", "selective_scan",
    {"selective_scan_launch": ([_p] * 9 + [_i] * 6 + [_ll] * 4 + [_p], ctypes.c_int),
     "selective_scan_smem_bytes": ([_i, _i], ctypes.c_int)},
    error_fn="selective_scan_error_string", includes=[_CSRC / "scan_tile.cuh"])
BWD_LIBRARY = KernelLibrary(
    _CSRC / "selective_scan_bwd.cu", "selective_scan_bwd",
    {"selective_scan_bwd_launch": ([_p] * 14 + [_i] * 8 + [_ll] * 4 + [_p], ctypes.c_int),
     "selective_scan_bwd_reduce_launch": ([_p] * 8 + [_i] * 6 + [_p], ctypes.c_int),
     "selective_scan_bwd_smem_bytes": ([_i] * 3, ctypes.c_int),
     "selective_scan_bwd_occupancy": ([_i] * 6 + [_p], ctypes.c_int)},
    error_fn="selective_scan_bwd_error_string", includes=[_CSRC / "scan_tile.cuh"])

KERNEL_STATE_SIZES = (4, 8, 16, 32)  # N: the kernel's instantiations
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
KERNEL_D_BLOCKS = (8, 16, 32)  # channels a block of the prefill body (8 warps)
DEFAULT_D_BLOCK = 16  # the serve path's value
DEFAULT_CHUNK = 128  # the reference's default, which the kernel does not use
# K4-bwd: channels a block of its scan pass, a multiple of its round (8
# warps of 2 channels at S <= 128, of 1 above); more channels a block, fewer
# partials of dB and dC (one a cluster of 2 blocks: 512 channels at S <= 128).
# 256 at S <= 128 and 32 above (where the tile's rows leave room for no more
# at two blocks an SM), halved while the grid would have fewer blocks than the
# card has SMs (down to one round).
BWD_D_BLOCK = {16: 256, 32: 32}  # by bwd_lanes(S)
BWD_FILL_BLOCKS = 132  # an H100's SMs


def bwd_smem_bytes(n: int, d_block: int, lanes: int) -> int:
    """csrc/selective_scan_bwd.cu's bwd_smem_bytes: B, C and the tile's dB
    and dC sums [n][ld]; the warps' terms [2 bufs at 16 lanes, 1 at 32][2
    states][8 warps][dB, dC][ld] (a round's x, dt and dy staged over them);
    the adjoint carries and dA's sums [d_block][n]; dD's; ld = 9 lanes
    floats (a half tile's or a tile's staged row)."""
    ld = 8 * lanes + lanes
    rows = 4 * n + (2 if lanes == 16 else 1) * 2 * BWD_WARPS * 2
    return 4 * (rows * ld + 2 * d_block * n + d_block)


def default_bwd_d_block(n: int, bt: int, s: int, dn: int) -> int:
    """K4-bwd's channels a block at (Bt, S, Dn, N): BWD_D_BLOCK at the
    tile's lanes, halved while Bt x ceil(Dn / d_block) < BWD_FILL_BLOCKS and
    d_block exceeds the round.  Its shared memory fits a block at every N."""
    d_block = BWD_D_BLOCK[bwd_lanes(s)]
    while d_block > bwd_round(s) and bt * -(-dn // d_block) < BWD_FILL_BLOCKS:
        d_block //= 2
    assert bwd_smem_bytes(n, d_block, bwd_lanes(s)) <= MAX_SMEM_PER_BLOCK
    return d_block


def scan_d_block(x: torch.Tensor, A: torch.Tensor, d_block: int, tuned: bool) -> int:
    """The channels a block a call runs at: the tuner's cache entry for
    ``{bt, s, dn, n}`` on x's device type when ``tuned``, else ``d_block``."""
    if not tuned:
        return int(d_block)
    from repro_torch.kernels.flash_decode.ops import _tuned_value

    bt, s, dn = x.shape
    shape = {"bt": bt, "s": s, "dn": dn, "n": A.shape[1]}
    return _tuned_value("ssm_scan", shape, x.dtype, "d_block", int(d_block), x.device.type)


def _check_kernel_inputs(what: str, x, dt, A, B, C, D, **more) -> Tuple[int, int, int, int]:
    """The checks both kernels make: shapes, dtypes, one device, B and C
    with a last stride of 1, the rest contiguous.  ``more`` adds tensors
    by name with their expected (shape, dtype).  Returns (Bt, S, Dn, N)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu, cuda or meta tensors, not {x.device}")
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
    expected = {"x": ((bt, s, dn), x.dtype), "dt": ((bt, s, dn), torch.float32),
                "A": ((dn, n), torch.float32), "B": ((bt, s, n), x.dtype),
                "C": ((bt, s, n), x.dtype), "D": ((dn,), torch.float32)}
    tensors = {"x": x, "dt": dt, "A": A, "B": B, "C": C, "D": D}
    for name, (t, shape, dtype) in more.items():
        expected[name] = (tuple(shape), dtype)
        tensors[name] = t
    for name, t in tensors.items():
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
    return bt, s, dn, n


def n_tiles(s: int) -> int:
    """Tiles of ``SCAN_TILE`` positions over S (the tile states' second axis)."""
    return -(-s // SCAN_TILE)


def _scan_cost(x, dt, A, *args, **kwargs):
    """K4's launch record (``roofline.scan_cost``)."""
    from repro_torch.kernels.tune.roofline import scan_cost

    return [("selective_scan", *scan_cost(*x.shape, A.shape[-1], x.element_size()))]


@counted(_scan_cost)
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
    return_tile_states: bool = False,
):
    """Returns (y (Bt, S, Dn) in x's dtype, h_last (Bt, Dn, N) float32).
    When ``h`` is given it is the initial state and is overwritten with
    h_last, which is ``h`` itself; otherwise the scan starts from zeros.
    With ``return_tile_states`` also the state before each tile of
    ``SCAN_TILE`` positions, (Bt, n_tiles(S), Dn, N) float32, which the
    backward restarts from.  When grad is enabled and an input requires it,
    the call is ``SelectiveScan``'s (from zeros: ``h`` must be None)."""
    d_block = scan_d_block(x, A, d_block, tuned)
    if chunk < 1:
        raise ValueError(f"chunk={chunk} must be positive")
    if d_block not in KERNEL_D_BLOCKS:
        raise ValueError(f"d_block={d_block}: the kernel takes {KERNEL_D_BLOCKS} channels a "
                         "block")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, B, C, D)):
        if h is not None or return_tile_states:
            raise ValueError("under autograd the scan starts from zeros and returns y and "
                             "h_last only: pass no state")
        return SelectiveScan.apply(x, dt, A, B, C, D, d_block)
    if x.device.type == "meta":
        bt, s, dn = x.shape
        h_last = (torch.empty((bt, dn, A.shape[-1]), dtype=torch.float32, device=x.device)
                  if h is None else h)
        tiles = (torch.empty((bt, n_tiles(s), dn, A.shape[-1]), dtype=torch.float32,
                             device=x.device) if return_tile_states else None)
        y = torch.empty_like(x)
        return (y, h_last, tiles) if return_tile_states else (y, h_last)
    if x.device.type == "cpu":
        y, h_last, tiles = selective_scan_ref(x, dt, A, B, C, D, h, return_tile_states=True)
        if h is not None:
            h.copy_(h_last)
            h_last = h
        return (y, h_last, tiles) if return_tile_states else (y, h_last)
    state = {} if h is None else {
        "h": (h, (x.shape[0], x.shape[-1], A.shape[-1]), torch.float32)}
    bt, s, dn, n = _check_kernel_inputs("selective_scan", x, dt, A, B, C, D, **state)
    if h is None:
        h = torch.zeros((bt, dn, n), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    tiles = (torch.empty((bt, n_tiles(s), dn, n), dtype=torch.float32, device=x.device)
             if return_tile_states else None)
    if bt * s * dn == 0:
        return (y, h, tiles) if return_tile_states else (y, h)
    lib = LIBRARY.load()
    smem = lib.selective_scan_smem_bytes(n, d_block)
    if smem > MAX_SMEM_PER_BLOCK:
        raise ValueError(f"N={n}, d_block={d_block} need {smem} bytes of shared memory, more "
                         f"than the {MAX_SMEM_PER_BLOCK} a block may use")
    with torch.cuda.device(x.device):
        err = lib.selective_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            D.data_ptr(), h.data_ptr(), y.data_ptr(), None if tiles is None else tiles.data_ptr(),
            bt, s, dn, n, int(x.dtype == torch.bfloat16), d_block, B.stride(0), B.stride(1),
            C.stride(0), C.stride(1), torch.cuda.current_stream().cuda_stream)
    LIBRARY.check(err, "selective_scan kernel")
    selective_scan.launches += 1
    selective_scan.step_launches += int(s == 1 and tiles is None)
    return (y, h, tiles) if return_tile_states else (y, h)


selective_scan.launches = 0
selective_scan.step_launches = 0


def _scan_bwd_cost(x, dt, A, *args, **kwargs):
    """K4-bwd's launch records, its scan pass and its reduction
    (``roofline.scan_bwd_cost``, ``scan_bwd_reduce_cost``)."""
    from repro_torch.kernels.tune.roofline import scan_bwd_cost, scan_bwd_reduce_cost

    bt, s, dn = x.shape
    n, it = A.shape[-1], x.element_size()
    parts = bwd_cluster(dn, default_bwd_d_block(n, bt, s, dn))[1]
    return [("selective_scan_bwd", *scan_bwd_cost(bt, s, dn, n, it)),
            ("selective_scan_bwd_reduce", *scan_bwd_reduce_cost(bt, s, dn, n, parts, it))]


@counted(_scan_bwd_cost)
def selective_scan_bwd(
    x: torch.Tensor,  # (Bt, S, Dn) bf16 or float32
    dt: torch.Tensor,  # (Bt, S, Dn) float32
    A: torch.Tensor,  # (Dn, N) float32
    B: torch.Tensor,  # (Bt, S, N) in x's dtype
    C: torch.Tensor,  # (Bt, S, N) in x's dtype
    D: torch.Tensor,  # (Dn,) float32
    dy: torch.Tensor,  # (Bt, S, Dn) in x's dtype
    h_tiles: Optional[torch.Tensor] = None,  # (Bt, n_tiles(S), Dn, N) float32
) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``selective_scan`` from zero state: (dx, ddt, dA, dB,
    dC, dD), dx in x's dtype, dB and dC in B's (contiguous), the rest
    float32.  On the card ``h_tiles`` is the forward's
    (``return_tile_states``), from which K4-bwd restarts each tile; the
    plain version recomputes the states and ignores it.  K4-bwd's channels a
    block (``default_bwd_d_block``) order the sums of dB and dC in both."""
    bt, s, dn = x.shape
    n = A.shape[-1]
    d_block = default_bwd_d_block(n, bt, s, dn)
    if x.device.type == "cpu":
        return selective_scan_bwd_ref(x, dt, A, B, C, D, dy, d_block=d_block)
    if x.device.type == "meta":
        return (torch.empty_like(x), torch.empty_like(dt), torch.empty_like(A),
                torch.empty((bt, s, n), dtype=B.dtype, device=x.device),
                torch.empty((bt, s, n), dtype=C.dtype, device=x.device), torch.empty_like(D))
    if h_tiles is None:
        raise ValueError("K4-bwd restarts from the forward's tile states: pass h_tiles "
                         "(selective_scan(..., return_tile_states=True))")
    bt, s, dn, n = _check_kernel_inputs(
        "selective_scan_bwd", x, dt, A, B, C, D, dy=(dy, x.shape, x.dtype),
        h_tiles=(h_tiles, (x.shape[0], n_tiles(x.shape[1]), x.shape[2], A.shape[-1]),
                 torch.float32))
    grads = (torch.empty_like(x), torch.empty_like(dt),
             torch.empty((dn, n), dtype=torch.float32, device=x.device),
             torch.empty((bt, s, n), dtype=B.dtype, device=x.device),
             torch.empty((bt, s, n), dtype=C.dtype, device=x.device),
             torch.empty((dn,), dtype=torch.float32, device=x.device))
    if bt * s * dn == 0:
        return tuple(g.zero_() for g in grads)
    dx, ddt, dA, dB, dC, dD = grads
    lib = BWD_LIBRARY.load()
    lanes = bwd_lanes(s)
    cluster, groups = bwd_cluster(dn, d_block)
    part_b = torch.empty((groups, bt, s, n), dtype=torch.float32, device=x.device)
    part_c = torch.empty_like(part_b)
    part_a = torch.empty((bt, dn, n), dtype=torch.float32, device=x.device)
    part_d = torch.empty((bt, dn), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    with torch.cuda.device(x.device):
        err = lib.selective_scan_bwd_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            D.data_ptr(), dy.data_ptr(), h_tiles.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
            part_b.data_ptr(), part_c.data_ptr(), part_a.data_ptr(), part_d.data_ptr(), bt, s,
            dn, n, int(x.dtype == torch.bfloat16), d_block, lanes, cluster, B.stride(0),
            B.stride(1), C.stride(0), C.stride(1), stream)
    BWD_LIBRARY.check(err, "selective_scan_bwd kernel")
    selective_scan_bwd.launches += 1
    selective_scan_bwd_reduce((part_b, part_c, part_a, part_d), (dB, dC, dA, dD))
    return grads


selective_scan_bwd.launches = 0


def bwd_occupancy(n: int, bt: int, s: int, dn: int, dtype: torch.dtype) -> dict:
    """What the card makes of K4-bwd's scan pass at (Bt, S, Dn, N) in
    ``dtype``: its plan (d_block, lanes, blocks a cluster, clusters, shared
    memory a block), the blocks an SM and clusters at once that the
    occupancy calculator gives, and the kernel's registers a thread."""
    d_block, lanes = default_bwd_d_block(n, bt, s, dn), bwd_lanes(s)
    cluster, groups = bwd_cluster(dn, d_block)
    out = (ctypes.c_int * 3)()
    err = BWD_LIBRARY.load().selective_scan_bwd_occupancy(
        int(dtype == torch.bfloat16), n, lanes, d_block, cluster, dn, ctypes.addressof(out))
    BWD_LIBRARY.check(err, "selective_scan_bwd occupancy query")
    return {"d_block": d_block, "lanes": lanes, "cluster": cluster, "clusters": groups,
            "smem_bytes": bwd_smem_bytes(n, d_block, lanes), "blocks_per_sm": out[0],
            "active_clusters": out[1], "registers": out[2]}


def selective_scan_bwd_reduce(parts: Tuple[torch.Tensor, ...],
                              outs: Tuple[torch.Tensor, ...]) -> None:
    """K4-bwd's second launch: writes each of ``outs`` (dB, dC (Bt, S, N) in
    B's dtype, dA (Dn, N), dD (Dn,) float32) as the sum of its partial,
    ``parts`` (float32, (clusters, Bt, S, N) twice, then (Bt, Dn, N) and (Bt,
    Dn)), over the first axis in order, one float32 addition at a time,
    rounded once to the output's dtype.  CPU tensors take the plain version
    (``ref.sum_partials_ref``)."""
    part_b, part_c, part_a, part_d = parts
    dB, dC, dA, dD = outs
    if part_b.device.type == "cpu":
        for part, out in zip(parts, outs):
            out.copy_(sum_partials_ref(part, out.dtype))
        return
    n_parts, bt, s, n = part_b.shape
    dn = part_a.shape[1]
    want = ((part_b, (n_parts, bt, s, n), torch.float32), (part_c, part_b.shape, torch.float32),
            (part_a, (bt, dn, n), torch.float32), (part_d, (bt, dn), torch.float32),
            (dB, (bt, s, n), dB.dtype), (dC, (bt, s, n), dB.dtype),
            (dA, (dn, n), torch.float32), (dD, (dn,), torch.float32))
    for t, shape, dtype in want:
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != part_b.device \
                or not t.is_contiguous():
            raise ValueError(f"selective_scan_bwd_reduce: a {t.dtype} tensor of shape "
                             f"{tuple(t.shape)} on {t.device} where a contiguous {dtype} one "
                             f"of shape {tuple(shape)} on {part_b.device} goes")
    if dB.dtype not in KERNEL_DTYPES:
        raise TypeError(f"dB is {dB.dtype}; the kernel takes bfloat16 or float32")
    lib = BWD_LIBRARY.load()
    with torch.cuda.device(part_b.device):
        err = lib.selective_scan_bwd_reduce_launch(
            part_b.data_ptr(), part_c.data_ptr(), part_a.data_ptr(), part_d.data_ptr(),
            dB.data_ptr(), dC.data_ptr(), dA.data_ptr(), dD.data_ptr(), bt, s, dn, n, n_parts,
            int(dB.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    BWD_LIBRARY.check(err, "selective_scan_bwd reduction")
    selective_scan_bwd_reduce.launches += 1


selective_scan_bwd_reduce.launches = 0


class SelectiveScan(torch.autograd.Function):
    """The selective scan with its gradient, from zero state: forward K4
    (storing the state before each tile), backward K4-bwd; their plain
    versions on CPU tensors.  Returns (y, h_last); h_last carries no
    gradient."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, d_block):
        y, h_last, tiles = selective_scan(x, dt, A, B, C, D, d_block=d_block,
                                          return_tile_states=True)
        ctx.save_for_backward(x, dt, A, B, C, D, tiles)
        ctx.mark_non_differentiable(h_last)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, _dh_last):
        x, dt, A, B, C, D, tiles = ctx.saved_tensors
        grads = selective_scan_bwd(x, dt, A, B, C, D, dy.contiguous(), tiles)
        return (*grads, None)
