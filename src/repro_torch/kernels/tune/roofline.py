"""Roofline models for autotune candidate pruning.

Per (family, shape, candidate config, dtype) this module estimates FLOPs,
device-memory bytes, the shared memory one block of the family's kernel
needs, and the serial steps of a launch on the card, and turns them into a
modeled time ``max(flops/peak, bytes/bw) + STEP_OVERHEAD_S * serial_steps``.
The sweep harness measures only candidates the kernel takes (shared memory
and the kernel's own limits) and whose modeled time is within a slack factor
of the best modeled time.  ``light_speed_s``/``roofline_fraction_us`` give
each cache entry's distance from the roofline (``bench_rows``).

FLOP counts are the reference's (``repro/kernels/tune/roofline.py``): they
depend only on the shape.  Bytes use the reference's formulas with the
itemsize of the dtype measured; the reference's fixed 4 is a TPU staging
fact.  The two decode families are the exception: the sweep feeds them
``ragged_lengths``, and K2 and K5 stop at each row's length, so their bytes
and tiles count the valid positions only (28% of the padded cache at
qwen3-14b's long-run shape), where the TPU grid read every block.  Shared
memory follows each kernel's own layout (the ``smem_bytes`` of its
``csrc/*.cu``), mirrored here so the tuner prunes without building.  A
``flash_decode_paged`` shape with a rope width ``dr`` is K2's MLA latent form
(``flash_decode.ops.latent_shape``): its own shared-memory layout and grid,
and the q_pe term counted in its FLOPs and bytes.  Candidates that differ
only in a key the port's kernel ignores (``IGNORED_KEYS``: K3's rows do not
depend on ``block_q``, the latent kernel's tile not on ``pages_per_program``)
are timed once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels._build import MAX_SMEM_PER_BLOCK
from repro_torch.kernels.flash_attention.ops import kernel_block_k as k3_block_k
from repro_torch.kernels.flash_decode.ops import (LATENT_HEADS, LATENT_SPLIT_POSITIONS,
                                                  LATENT_TILE, LATENT_WIDTHS)
from repro_torch.kernels.sdca.ops import MAX_D as K1_MAX_D
from repro_torch.kernels.sdca.ops import kernel_plan as k1_plan
from repro_torch.kernels.ssm_scan.ops import KERNEL_D_BLOCKS as K4_D_BLOCKS
from repro_torch.kernels.ssm_scan.ops import KERNEL_STATE_SIZES as K4_STATE_SIZES
from repro_torch.kernels.tune.cache import dtype_name

# NVIDIA H100 SXM data sheet, at its 700 W power limit: dense bf16 tensor-core
# rate and HBM3 bandwidth.
PEAK_FLOPS = 989e12  # bf16 FLOP/s per card
HBM_BW = 3.35e12  # bytes/s per card
SMS = 132  # streaming multiprocessors
# Modeled cost of one serial step of a block (one staged tile: a dependent
# round trip to device memory and the block's barriers); a model parameter,
# not a measurement.
STEP_OVERHEAD_S = 1e-6
PRUNE_SLACK = 3.0

_K3_TILE_Q = 128  # query positions per K3 block (two warpgroups of 64 rows)
_K3_TILE_KV = 64  # key positions per staged K3 tile
_STAGES = 2  # staged tiles in flight (K2, K3, K5)
_SPLIT_POSITIONS = 192  # K2's and K5's split-KV: tiles a split fill at most this
_K4_THREADS = 256  # K4's prefill block: 8 warps
_K4_TILE = 256  # positions a warp scans together (32 lanes x 8)
_K4_ROW = _K4_TILE + 4 * (_K4_TILE // 32) + 4  # floats a staged row of a tile
_K4_WARPS = 8
_MAX_BLOCKS_PER_SM = 32

# config keys a kernel takes but does not depend on, by family (the latent
# form of flash_decode_paged by its own name): of candidates that differ only
# there, prune keeps the first
IGNORED_KEYS: Dict[str, Tuple[str, ...]] = {"flash_attention": ("block_q",),
                                            "flash_decode_latent": ("pages_per_program",)}


def ragged_lengths(b: int, capacity: int) -> np.ndarray:
    """Deterministic serving-like fill: longest sequence at half capacity,
    the rest tapering off — the operating point the engine actually runs
    at mid-trace.  The sweep's decode cases use these lengths."""
    return np.asarray([max(1, (capacity * (b - i)) // (2 * b)) for i in range(b)], np.int32)


def light_speed_s(
    flops: float, bytes_moved: float, peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW
) -> float:
    """Roofline lower bound for one kernel invocation."""
    return max(flops / peak_flops, bytes_moved / hbm_bw)


def roofline_fraction_us(measured_us: float, flops: float, bytes_moved: float) -> float:
    """measured / light-speed (>= 1; how far from the roofline we run)."""
    floor = light_speed_s(flops, bytes_moved) * 1e6
    return measured_us / floor if floor > 0 else 0.0


def k3_smem_bytes(g: int, d: int, bk: int, dv: Optional[int] = None) -> int:
    """csrc/flash_fwd.cu's smem_bytes: q's 128 rows and two stages of 64 key
    and value rows, bf16, the key dim d padded to a multiple of 16; value dim
    dv (default d).  The scores, softmax and accumulator live in registers,
    so G and block_k do not enter."""
    dv = d if dv is None else dv
    dkp = -(-d // 16) * 16
    return 2 * (_K3_TILE_Q * dkp + _STAGES * _K3_TILE_KV * (dkp + dv))


def k3_blocks(b: int, hq: int, sq: int) -> int:
    """K3's grid: one block per 128 query positions of one query head."""
    return b * hq * _ceil_div(sq, _K3_TILE_Q)


def decode_smem_bytes(g: int, d: int, bk: int) -> int:
    """flash_decode/csrc/decode_tile.cuh's smem_bytes, the block body of K2
    (bk = pages_per_program * page) and K5 (bk = block_k): q, a ring of
    staged K and V tiles (``decode_ring_stages``), scores, accumulator,
    m / l / alpha."""
    return (g * d * 4 + decode_ring_stages(bk) * 2 * bk * d * 2 + g * bk * 4 + g * d * 4
            + 3 * g * 4)


def decode_ring_stages(bk: int) -> int:
    """decode_tile.cuh's ring_stages: two staged tiles, or one where a split
    is one tile (there is no next tile to stage)."""
    return min(_STAGES, decode_tiles_per_split(bk))


def decode_tiles_per_split(bk: int) -> int:
    """decode_tile.cuh's tiles_per_split: a split is as many tiles of bk
    positions as fit in 192 positions, at least one."""
    return 1 if bk >= _SPLIT_POSITIONS else _SPLIT_POSITIONS // bk


def decode_splits(capacity: int, bk: int) -> int:
    """decode_tile.cuh's n_splits: splits of a row of ``capacity`` positions,
    the first dimension of K2's and K5's grids, (splits, Hk, B)."""
    return _ceil_div(_ceil_div(capacity, bk), decode_tiles_per_split(bk))


def latent_smem_bytes(r: int, dr: int) -> int:
    """flash_decode/csrc/paged_latent_decode.cu's smem_bytes, K2's latent
    form: [q_lat | q_pe] for its 64 heads a block and a ring of two tiles of
    64 [ckv | kpe] rows, bf16, the depth r + dr padded to a multiple of 16;
    then the pool rows of the split's 192 positions (int32).  The scores,
    softmax and accumulator live in registers."""
    dkp = _ceil_div(r + dr, 16) * 16
    return 2 * (LATENT_HEADS + _STAGES * LATENT_TILE) * dkp + 4 * LATENT_SPLIT_POSITIONS


def latent_splits(capacity: int) -> int:
    """paged_latent_decode.cu's n_splits: splits of 192 positions from
    position 0 of a row of ``capacity`` positions, the first dimension of
    the latent kernel's grid, (splits, ceil(H / 64), B)."""
    return _ceil_div(capacity, LATENT_SPLIT_POSITIONS)


def k4_smem_bytes(n: int, d_block: int) -> int:
    """csrc/selective_scan.cu's smem_bytes, its prefill body: B and C of a
    tile of 256 positions, x (then y) and dt of the block's d_block channels
    over the tile, float32 in rows of 292 (a lane's 8 positions skewed 4
    floats every 4 lanes, against bank conflicts), and the channels' carried
    states, two of each."""
    return ((2 * n + 2 * d_block) * _K4_ROW + 2 * d_block * n) * 4


def k1_smem_bytes(d: int) -> int:
    """csrc/sdca.cu's shared memory at width d: the ring of staged rows, and
    v where it does not fit the registers."""
    return k1_plan(d)[2]


def _resident_waves(blocks: int, smem: int) -> int:
    """Waves of ``blocks`` when as many blocks share an SM as its shared
    memory holds (at most 32)."""
    per_sm = max(1, min(_MAX_BLOCKS_PER_SM, MAX_SMEM_PER_BLOCK // max(smem, 1)))
    return _ceil_div(blocks, SMS * per_sm)


# ---------------------------------------------------------------------------
# Each kernel's FLOPs and bytes at any shape: the formulas ``estimate`` uses
# for its family (at the family's shape they are that family's numbers), and
# the records the kernels' entries make under the dry-run's counter
# (``repro_torch.dist.op_costs``).  The entries count by shape only: every
# position of a decode cache (the dry-run's program has no lengths to read),
# the (query, key) pairs K3's causal mask leaves (``causal_pairs``).
# ---------------------------------------------------------------------------
def flash_attention_cost(b: int, hq: int, hk: int, sq: int, skv: int, dk: int, dv: int,
                         itemsize: int, q_offset: int = 0,
                         causal: bool = False) -> Tuple[float, float]:
    """K3: 2 DK + 2 DV FLOPs a (query, key) pair (q k^T and p v), over the
    whole Sq x Skv square, or with ``causal`` the pairs each row sees (as
    ``flash_bwd_pass_cost`` counts them); q, k and v read once, the output
    written once."""
    flops = 2.0 * b * hq * causal_pairs(sq, skv, q_offset, causal) * (dk + dv)
    nbytes = 1.0 * (b * hq * sq * (dk + dv) + b * hk * skv * (dk + dv)) * itemsize
    return flops, nbytes


def decode_cost(b: int, hq: int, hk: int, s: int, d: int, valid: int,
                itemsize: int) -> Tuple[float, float]:
    """K2 and K5: one query a (row, head) against a cache of ``s`` positions,
    4 D FLOPs a position; the K and V of the ``valid`` positions (summed over
    the rows) read once."""
    return 4.0 * b * hq * s * d, 2.0 * hk * valid * d * itemsize


def latent_decode_cost(b: int, h: int, s: int, r: int, dr: int, valid: int,
                       itemsize: int) -> Tuple[float, float]:
    """K2's latent form: q . k and p . v over r, q_pe . kpe over dr; one pool
    is the keys and the values, so each valid position's rows are read
    once."""
    return 2.0 * b * h * s * (2 * r + dr), 1.0 * valid * (r + dr) * itemsize


def scan_cost(bt: int, s: int, dn: int, n: int, itemsize: int) -> Tuple[float, float]:
    """K4: 8 FLOPs a (row, position, channel, state); x, B, C read and y
    written once."""
    return 8.0 * bt * s * dn * n, 3.0 * bt * s * (dn + 2 * n) * itemsize


def sdca_cost(m: int, nl: int, h: int, d: int, itemsize: int) -> Tuple[float, float]:
    """K1: each of the m workers' h steps two length-d products; X, y and the
    worker's vectors read once."""
    return 4.0 * m * h * d, 1.0 * m * (nl * d + 2 * nl + 2 * d) * itemsize


def local_sgd_cost(m: int, nl: int, h: int, d: int, itemsize: int) -> Tuple[float, float]:
    """K6 (no tuner family; K1's count): each of the m workers' h steps a
    length-d product and a length-d update; X, y, the start vectors and the
    order read once, the vectors written once."""
    return 4.0 * m * h * d, 1.0 * m * (nl * d + nl + 2 * d + h) * itemsize


def causal_pairs(sq: int, skv: int, q_offset: int = 0, causal: bool = True) -> int:
    """The (query, key) pairs a causal attention row set sees: query row r
    (position q_offset + r) sees min(skv, q_offset + r + 1) keys."""
    if not causal:
        return sq * skv
    t = max(0, min(sq, skv - q_offset))  # the rows that see fewer than skv keys
    return t * q_offset + t * (t + 1) // 2 + (sq - t) * skv


# K3-bwd's launches (``flash_attention.ops``' BWD_DQ, BWD_DKDV, BWD_DV,
# BWD_DK): FLOPs a pair by products (the dq pass: S, dP, dS K; the dk/dv
# pass: S, dP, P^T dO, dS^T Q; the dv pass: S, P^T dO; the dk pass: S, dP,
# dS^T Q), as PERF.md's bounds count them
_BWD_FLOPS = {0: (4, 2), 1: (4, 4), 2: (2, 2), 3: (4, 2)}


def flash_bwd_pass_cost(pass_no: int, b: int, hq: int, hk: int, sq: int, skv: int, dk: int,
                        dv: int, q_offset: int = 0, causal: bool = True,
                        itemsize: int = 2) -> Tuple[float, float]:
    """One K3-bwd launch (no tuner family: PERF.md's bound): its products over
    the causal pairs each row sees; each input read once, each output
    written once (q, dq: B Hq Sq DK; out, dout: B Hq Sq DV; k, dk: B Hk Skv
    DK; v, dv: B Hk Skv DV; lse and delta float32 rows)."""
    pairs = b * hq * causal_pairs(sq, skv, q_offset, causal)
    q_b, o_b = b * hq * sq * dk * itemsize, b * hq * sq * dv * itemsize
    k_b, v_b = b * hk * skv * dk * itemsize, b * hk * skv * dv * itemsize
    rows = b * hq * sq * 4
    a, c = _BWD_FLOPS[pass_no]
    nbytes = {0: 2 * q_b + k_b + v_b + 2 * o_b + 2 * rows,  # q k v out dout lse; dq delta
              1: q_b + 2 * k_b + 2 * v_b + o_b + 2 * rows,  # q k v dout lse delta; dk dv
              2: q_b + k_b + v_b + o_b + rows,  # q k dout lse; dv
              3: q_b + 2 * k_b + v_b + o_b + 2 * rows}[pass_no]  # q k v dout lse delta; dk
    return float((a * dk + c * dv) * pairs), float(nbytes)


def scan_bwd_cost(bt: int, s: int, dn: int, n: int, itemsize: int) -> Tuple[float, float]:
    """K4-bwd's scan pass (no tuner family: PERF.md's bound): 16 float32
    operations a (row, position, channel, state); x, dy and dx in x's
    dtype, dt and ddt float32, B, C, dB and dC in x's dtype, A, D, dA and dD
    float32, each read or written once."""
    nbytes = ((3 * itemsize + 2 * 4) * bt * s * dn + 4 * itemsize * bt * s * n
              + 4 * 2 * (dn * n + dn))
    return 16.0 * bt * s * dn * n, float(nbytes)


def scan_bwd_reduce_cost(bt: int, s: int, dn: int, n: int, n_parts: int,
                         itemsize: int) -> Tuple[float, float]:
    """K4-bwd's reduction: each partial (float32: dB's and dC's ``n_parts``
    of (Bt, S, N), dA's (Bt, Dn, N), dD's (Bt, Dn)) added once and read
    once; dB and dC written in x's dtype, dA and dD in float32."""
    parts = 2 * n_parts * bt * s * n + bt * dn * n + bt * dn
    nbytes = 4 * parts + 2 * itemsize * bt * s * n + 4 * (dn * n + dn)
    return float(parts), float(nbytes)


@dataclasses.dataclass
class CandidateEstimate:
    config: Dict[str, int]
    flops: float
    bytes_moved: float
    smem_bytes: int
    serial_steps: int  # waves of blocks x tiles each block walks, over the launches
    fits: bool  # the kernel takes this candidate (shared memory, its own limits)

    @property
    def t_model_s(self) -> float:
        return light_speed_s(self.flops, self.bytes_moved) + STEP_OVERHEAD_S * self.serial_steps


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _waves(blocks: int) -> int:
    """Blocks run side by side on the card's SMs, not in order as on a TPU's
    grid: a launch's serial depth is modeled as its waves of blocks,
    counting one resident block an SM, times the tiles each block walks in
    order."""
    return _ceil_div(blocks, SMS)


def estimate(family: str, shape: Dict[str, int], config: Dict[str, int],
             dtype="float32") -> CandidateEstimate:
    """FLOPs / bytes / shared memory / serial-step model for one candidate."""
    it = getattr(torch, dtype_name(dtype)).itemsize
    if family == "flash_attention":  # K3 at the tuner's MHA shape (G = 1)
        b, h, s, d = shape["b"], shape["h"], shape["s"], shape["d"]
        bk = k3_block_k(config["block_k"], s)  # None where the wrapper refuses it
        flops, bytes_moved = flash_attention_cost(b, h, h, s, s, d, d, it)
        smem = k3_smem_bytes(1, d, 16)  # block_k does not enter
        # a block walks its last row's key tiles in order, block_k steps each
        steps = _waves(k3_blocks(b, h, s)) * _ceil_div(s, bk or config["block_k"])
        fits = bk is not None and smem <= MAX_SMEM_PER_BLOCK
    elif family == "flash_decode":  # K5 at the tuner's MHA shape (G = 1)
        b, h, s, d = shape["b"], shape["h"], shape["s"], shape["d"]
        bk = min(config["block_k"], s)  # the wrapper's clamp
        lens = ragged_lengths(b, s)
        flops, bytes_moved = decode_cost(b, h, h, s, d, int(lens.sum()), it)
        smem = decode_smem_bytes(1, d, bk)
        # split-KV: each block walks at most one split's tiles
        steps = _waves(b * h * decode_splits(s, bk)) * min(decode_tiles_per_split(bk),
                                                           _ceil_div(int(lens.max()), bk))
        fits = smem <= MAX_SMEM_PER_BLOCK
    elif family == "flash_decode_paged" and "dr" in shape:  # K2's latent form
        b, h, r, dr = shape["b"], shape["g"], shape["d"], shape["dr"]
        s = shape["npp"] * shape["page"]
        lens = ragged_lengths(b, s)
        # the reference's count with the q_pe term: q . k and p . v over r,
        # q_pe . kpe over dr; one pool is the keys and the values, so each
        # valid position's latent and rope rows are read once
        flops, bytes_moved = latent_decode_cost(b, h, s, r, dr, int(lens.sum()), it)
        smem = latent_smem_bytes(r, dr)
        # split-KV: each block (one an SM) walks at most one split's tiles
        steps = (_waves(b * _ceil_div(h, LATENT_HEADS) * latent_splits(s))
                 * min(LATENT_SPLIT_POSITIONS // LATENT_TILE,
                       _ceil_div(int(lens.max()), LATENT_TILE)))
        fits = (r, dr) in LATENT_WIDTHS and smem <= MAX_SMEM_PER_BLOCK
    elif family == "flash_decode_paged":  # K2
        b, hk, g = shape["b"], shape["hk"], shape["g"]
        d, page, npp = shape["d"], shape["page"], shape["npp"]
        ppp = min(config["pages_per_program"], npp)  # the wrapper's clamp
        s = npp * page
        lens = ragged_lengths(b, s)
        flops, bytes_moved = decode_cost(b, hk * g, hk, s, d, int(lens.sum()), it)
        blk = ppp * page
        smem = decode_smem_bytes(g, d, blk)
        steps = _waves(b * hk * decode_splits(s, blk)) * min(decode_tiles_per_split(blk),
                                                             _ceil_div(int(lens.max()), blk))
        fits = smem <= MAX_SMEM_PER_BLOCK
    elif family == "prefill_chunk":  # K3 once per chunk, at block_k 16
        p, hk, g = shape["p"], shape["hk"], shape["g"]
        d, page, npp = shape["d"], shape["page"], shape["npp"]
        c = config["chunk"]
        s = npp * page
        n_chunks = _ceil_div(p, c)
        # every chunk re-gathers the full page row (the chunked-prefill
        # bytes tax) and attends c queries against s keys
        flops = 4.0 * hk * g * p * s * d
        bytes_moved = (2.0 * n_chunks * hk * s * d + 2.0 * hk * g * p * d) * it
        smem = k3_smem_bytes(g, d, 16)
        steps = n_chunks * _waves(k3_blocks(1, hk * g, c)) * _ceil_div(s, 16)
        fits = smem <= MAX_SMEM_PER_BLOCK
    elif family == "ssm_scan":  # K4
        bt, s, dn, n = shape["bt"], shape["s"], shape["dn"], shape["n"]
        d_block = config["d_block"]
        flops, bytes_moved = scan_cost(bt, s, dn, n, it)
        if s == 1:  # the decode body: a thread a (sequence, channel), no staging
            smem = 0
            steps = _waves(_ceil_div(bt * dn, _K4_THREADS))
        else:  # a warp walks its channels' tiles in order
            smem = k4_smem_bytes(n, d_block)
            steps = (_resident_waves(bt * _ceil_div(dn, d_block), smem) * _ceil_div(s, _K4_TILE)
                     * _ceil_div(d_block, _K4_WARPS))
        fits = (n in K4_STATE_SIZES and d_block in K4_D_BLOCKS
                and smem <= MAX_SMEM_PER_BLOCK)
    elif family == "sdca":  # K1 (use_pallas 1) or its plain version (0)
        m, nl, d = shape["m"], shape["nl"], shape["d"]
        h = shape.get("h", nl)
        flops, bytes_moved = sdca_cost(m, nl, h, d, it)
        fits = d <= K1_MAX_D or not config.get("use_pallas")
        smem = k1_smem_bytes(d) if config.get("use_pallas") and fits else 0
        # H dependent steps in each worker's warp, as many workers an SM as
        # their rings fit
        steps = _resident_waves(m, smem) * h
    else:
        raise ValueError(f"unknown kernel family {family!r}")
    return CandidateEstimate(
        config=config,
        flops=flops,
        bytes_moved=bytes_moved,
        smem_bytes=int(smem),
        serial_steps=int(steps),
        fits=bool(fits),
    )


def prune(
    family: str,
    shape: Dict[str, int],
    candidates: Sequence[Dict[str, int]],
    dtype="float32",
    slack: float = PRUNE_SLACK,
) -> Tuple[List[CandidateEstimate], int]:
    """Drop candidates the kernel would refuse, those that repeat an earlier
    one but for ``IGNORED_KEYS``, and those whose modeled time exceeds
    ``slack`` x the best modeled time.  Returns (survivors, n_pruned); raises
    if the kernel takes no candidate."""
    ests = [estimate(family, shape, c, dtype) for c in candidates]
    fits = [e for e in ests if e.fits]
    if not fits:
        raise ValueError(f"{family} at {shape}: the kernel takes none of {list(candidates)}")
    latent = family == "flash_decode_paged" and "dr" in shape
    ignored = IGNORED_KEYS.get("flash_decode_latent" if latent else family, ())
    distinct = {}
    for e in fits:
        distinct.setdefault(tuple(sorted((k, v) for k, v in e.config.items()
                                         if k not in ignored)), e)
    t_best = min(e.t_model_s for e in distinct.values())
    kept = [e for e in distinct.values() if e.t_model_s <= slack * t_best]
    return kept, len(ests) - len(kept)
