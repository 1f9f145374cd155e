"""Plain PyTorch version of the selective scan (K4), the Mamba-1 recurrence

    h_t = exp(dt_t A) * h_{t-1} + (dt_t x_t) B_t
    y_t = sum_n C_t[n] h_t[:, n] + D x_t

as a sequential loop over t in float32: the counterpart of
``repro/kernels/ssm_scan/ref.py::selective_scan_ref`` with the initial state
of ``ops.py::selective_scan`` (``h0``).  At S = 1 it is
``ops.py::selective_scan_step``, the decode step.

Each step runs the reference's operations in its order, one rounding each:
``decay = exp(dt A)``, ``h = decay h + (dt x) B``, ``y = sum_n h C + D x``.
The sum over n halves the state axis repeatedly (n with n + N/2, then
N/4, ...).  This serial loop is the reference-order oracle the card holds
the kernel against: the kernel scans time as an associative scan in fixed
tiles and sums over n in order, so the two differ by a few float32
roundings a step (``tests/test_torch_block_scan.py`` models the kernel's
grouping).

``selective_scan_bwd_ref`` is the plain version of K4-bwd, the gradient of
the same recurrence from zero state: the serial forward again, then the
adjoint g_t = a_{t+1} g_{t+1} + dy_t C_t serially in reverse, and its sums in
float32 in the order K4-bwd takes them (over n in order; over the channels
as ``_channel_sum`` says: at S <= 128 the two channels of a warp, then a
round's 8 warps in order, then a block's rounds, then the blocks of a
cluster in rank order, then the clusters; over time a lane's 8 positions,
the lanes halving, the tiles from the last, then the sequences).  The
kernel fuses some products into its sums and scans time as a tree, so the
two differ by a few float32 roundings.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

SCAN_TILE = 256  # positions of K4's and K4-bwd's tiles (scan_tile.cuh's kTile)
LANES, LANE_ITEMS = 32, 8  # a tile's lanes and each lane's positions
BWD_WARPS = 8  # K4-bwd's warps a block
# K4-bwd's blocks a cluster at most: an H100 holds 132 clusters of 2 blocks at
# once at two blocks an SM, all 264 slots, but only 62 of 4 and 30 of 8 (its
# occupancy query), so larger clusters leave a wave part-empty
BWD_MAX_CLUSTER = 2


def lane_sum(p: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by halving it while its length is even, then
    in one sum over what remains (1 for a power of two)."""
    while p.shape[-1] > 1 and p.shape[-1] % 2 == 0:
        half = p.shape[-1] // 2
        p = p[..., :half] + p[..., half:]
    return p.sum(-1) if p.shape[-1] > 1 else p[..., 0]


def selective_scan_ref(
    x: torch.Tensor,  # (Bt, S, Dn)
    dt: torch.Tensor,  # (Bt, S, Dn), positive (softplus applied)
    A: torch.Tensor,  # (Dn, N), negative
    B: torch.Tensor,  # (Bt, S, N)
    C: torch.Tensor,  # (Bt, S, N)
    D: torch.Tensor,  # (Dn,)
    h: Optional[torch.Tensor] = None,  # (Bt, Dn, N) initial state
    *,
    return_tile_states: bool = False,
):
    """Returns (y (Bt, S, Dn) in x's dtype, h_last (Bt, Dn, N) float32),
    with ``return_tile_states`` also the state before each tile of
    ``SCAN_TILE`` positions, (Bt, ceil(S / SCAN_TILE), Dn, N).  ``h`` is
    read, not written."""
    bt, s, dn = x.shape
    n = A.shape[1]
    xf, dtf = x.float(), dt.float()
    af, bf, cf, df = A.float(), B.float(), C.float(), D.float()
    state = (torch.zeros((bt, dn, n), dtype=torch.float32, device=x.device) if h is None
             else h.float().clone())
    y = torch.empty((bt, s, dn), dtype=torch.float32, device=x.device)
    tiles = []
    for t in range(s):
        if t % SCAN_TILE == 0:
            tiles.append(state)
        dtt, xt = dtf[:, t], xf[:, t]  # (Bt, Dn)
        decay = torch.exp(dtt[..., None] * af)  # (Bt, Dn, N)
        bx = (dtt * xt)[..., None] * bf[:, t, None, :]
        state = decay * state + bx
        y[:, t] = lane_sum(state * cf[:, t, None, :]) + df * xt
    if not return_tile_states:
        return y.to(x.dtype), state
    tile_states = (torch.stack(tiles, dim=1) if tiles
                   else torch.zeros((bt, 0, dn, n), dtype=torch.float32, device=x.device))
    return y.to(x.dtype), state, tile_states


def _sum_in_order(terms: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` one term at a time, in order."""
    total = terms.select(dim, 0)
    for i in range(1, terms.shape[dim]):
        total = total + terms.select(dim, i)
    return total


def sum_partials_ref(part: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """K4-bwd's reduction: ``part``'s sum over its first axis, one float32
    addition at a time in order, rounded once to ``dtype``."""
    return _sum_in_order(part.float(), 0).to(dtype)


def bwd_lanes(s: int) -> int:
    """Lanes K4-bwd scans a channel's tile with: 16 (a half-warp a channel,
    a half tile of 128 positions) when S <= 128, else 32."""
    return LANES // 2 if s <= SCAN_TILE // 2 else LANES


def bwd_round(s: int) -> int:
    """K4-bwd's channels a round: 8 warps of 32 / bwd_lanes(S) channels."""
    return BWD_WARPS * LANES // bwd_lanes(s)


def bwd_cluster(dn: int, d_block: int) -> Tuple[int, int]:
    """(blocks a cluster, clusters) of K4-bwd's channel blocks over Dn: as
    few clusters of at most BWD_MAX_CLUSTER as cover the blocks, each as
    small as that allows."""
    blocks = -(-dn // d_block)
    groups = -(-blocks // BWD_MAX_CLUSTER)
    return -(-blocks // groups), groups


def _channel_partials(terms: torch.Tensor, d_block: int, lanes: int) -> torch.Tensor:
    """K4-bwd's partials of a sum of (..., Dn, N) over Dn, one a cluster,
    (clusters, ..., N): at 16 lanes the two channels of a warp added, then
    a round's 8 warps in order, a block's rounds in order, and the blocks of
    a cluster in rank order (channels past the last block are zeros)."""
    dn, n = terms.shape[-2:]
    pair = LANES // lanes
    cluster, groups = bwd_cluster(dn, d_block)
    pad = groups * cluster * d_block - dn
    if pad:
        terms = torch.cat([terms, terms.new_zeros(terms.shape[:-2] + (pad, n))], dim=-2)
    terms = terms.reshape(terms.shape[:-2] + (groups, cluster, d_block // (BWD_WARPS * pair),
                                              BWD_WARPS, pair, n))
    per_warp = terms[..., 0, :] + terms[..., 1, :] if pair == 2 else terms[..., 0, :]
    per_round = _sum_in_order(per_warp, -2)
    per_block = _sum_in_order(per_round, -2)
    return _sum_in_order(per_block, -2).movedim(-2, 0)


def _channel_sum(terms: torch.Tensor, d_block: int, lanes: int) -> torch.Tensor:
    """Sum (..., Dn, N) over Dn in K4-bwd's order: its partials
    (``_channel_partials``), then the clusters in order."""
    return _sum_in_order(_channel_partials(terms, d_block, lanes), 0)


def _time_sum(terms: torch.Tensor) -> torch.Tensor:
    """Sum (Bt, S, ...) over the sequences and time in K4-bwd's order: per
    tile a lane's 8 positions in order, the 32 lanes by halving (the xor
    butterfly's value), the tiles from the last to the first, then the
    sequences in order (positions past S are zeros)."""
    bt, s = terms.shape[:2]
    tiles = -(-s // SCAN_TILE)
    pad = tiles * SCAN_TILE - s
    if pad:
        terms = torch.cat([terms, terms.new_zeros((bt, pad) + terms.shape[2:])], dim=1)
    terms = terms.reshape((bt, tiles, LANES, LANE_ITEMS) + terms.shape[2:])
    per_lane = _sum_in_order(terms, 3)  # (Bt, tiles, 32, ...)
    per_tile = lane_sum(per_lane.movedim(2, -1))  # (Bt, tiles, ...)
    return _sum_in_order(_sum_in_order(per_tile.flip(1), 1), 0)


def selective_scan_bwd_ref(
    x: torch.Tensor,  # (Bt, S, Dn)
    dt: torch.Tensor,  # (Bt, S, Dn)
    A: torch.Tensor,  # (Dn, N)
    B: torch.Tensor,  # (Bt, S, N)
    C: torch.Tensor,  # (Bt, S, N)
    D: torch.Tensor,  # (Dn,)
    dy: torch.Tensor,  # (Bt, S, Dn)
    *,
    d_block: int,
) -> Tuple[torch.Tensor, ...]:
    """The exact gradient of ``selective_scan_ref`` from zero state with
    respect to (x, dt, A, B, C, D), given dy: (dx in x's dtype, ddt float32,
    dA float32, dB and dC in B's and C's dtypes, dD float32).  With a_t =
    exp(dt_t A) and the adjoint g_t = a_{t+1} g_{t+1} + dy_t C_t:
    dx_t = D dy_t + dt_t sum_n g_t B_t, ddt_t = sum_n g_t A a_t h_{t-1} +
    x_t sum_n g_t B_t, dA = sum_{b,t} dt_t g_t a_t h_{t-1}, dB_t = sum_d g_t
    dt_t x_t, dC_t = sum_d dy_t h_t, dD = sum_{b,t} dy_t x_t.  ``d_block`` is
    K4-bwd's channels a block (``ops.default_bwd_d_block(N)``), which orders
    dB's and dC's sums."""
    bt, s, dn = x.shape
    n = A.shape[1]
    xf, dtf, dyf = x.float(), dt.float(), dy.float()
    af, bf, cf, df = A.float(), B.float(), C.float(), D.float()
    states = torch.zeros((bt, s + 1, dn, n), dtype=torch.float32, device=x.device)
    decays = torch.ones((bt, s + 1, dn, n), dtype=torch.float32, device=x.device)
    dtx = dtf * xf
    for t in range(s):  # states[:, t + 1] is h_t, states[:, t] h_{t-1}
        decays[:, t] = torch.exp(dtf[:, t, :, None] * af)
        states[:, t + 1] = decays[:, t] * states[:, t] + dtx[:, t, :, None] * bf[:, t, None, :]
    g = torch.empty((bt, s, dn, n), dtype=torch.float32, device=x.device)
    after = torch.zeros((bt, dn, n), dtype=torch.float32, device=x.device)  # a_{t+1} g_{t+1}
    for t in reversed(range(s)):
        g[:, t] = after + dyf[:, t, :, None] * cf[:, t, None, :]
        after = decays[:, t] * g[:, t]
    q = g * decays[:, :s] * states[:, :s]  # g_t a_t h_{t-1}
    s1 = torch.zeros((bt, s, dn), dtype=torch.float32, device=x.device)
    s2 = torch.zeros_like(s1)
    for i in range(n):  # over n in order
        s1 = s1 + g[..., i] * bf[:, :, None, i]
        s2 = s2 + af[:, i] * q[..., i]
    dx = dtf * s1 + df * dyf
    ddt = xf * s1 + s2
    dA = _time_sum(dtf[..., None] * q)
    dD = _time_sum(dyf * xf)
    lanes = bwd_lanes(s)
    dB = _channel_sum(g * dtx[..., None], d_block, lanes)
    dC = _channel_sum(dyf[..., None] * states[:, 1:], d_block, lanes)
    return dx.to(x.dtype), ddt, dA, dB.to(B.dtype), dC.to(C.dtype), dD
