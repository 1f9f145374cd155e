"""The selective scan's gradient on the CPU: the plain version of K4-bwd
(``repro_torch/kernels/ssm_scan/ref.py::selective_scan_bwd_ref``) and
``SelectiveScan``'s CPU path against ``jax.grad`` of the JAX package's
model-facing scan (``repro/kernels/ssm_scan/ops.py::selective_scan``, the
chunked associative scan that the reference trains through) and against
autograd through the port's serial ``selective_scan_ref``, in float32; a
plain model of K4-bwd's reverse adjoint scan (tiles of 256 positions walked
from the last, lanes of 8 positions, the lanes' suffixes by shuffles, the
carry a_t0 g_t0 from the tile after) against the serial adjoint; a model of
its lane scans at 16 lanes a channel (a half-warp's half tile, S <= 128)
against the 32-lane one, bit for bit; and a model of its sums of dB and dC
over the channels (a warp's two channels, its 8 warps, rounds, a cluster's
ranks, the clusters) against the plain version's order.

Tolerances: every gradient within 1e-4 of its largest magnitude (as
``tests/test_torch_train.py``'s gradient leaves): the same float32
arithmetic summed in other orders and, against JAX, a chunked scan's tree in
place of the serial loop; measured about 1e-6.  The model's adjoint within
1e-5 of its largest magnitude (a few float32 roundings a step, which decay
with the state).  Bitwise: a pad to whole tiles (dt = x = 0, dy = 0) leaves
the gradients of the real positions as they are in the model, and every
padded position's gradients are exactly 0; the 16-lane scans give the
32-lane scans' states and adjoint (up to the sign of a zero); the channel
order's model gives the plain version's sums.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ops import selective_scan as jax_selective_scan
from repro_torch.kernels.ssm_scan import ops
from repro_torch.kernels.ssm_scan.ref import (
    BWD_WARPS,
    SCAN_TILE,
    _channel_partials,
    _channel_sum,
    bwd_cluster,
    bwd_lanes,
    bwd_round,
    selective_scan_bwd_ref,
    selective_scan_ref,
    sum_partials_ref,
)

RTOL_OF_MAX = 1e-4
MODEL_RTOL_OF_MAX = 1e-5
NAMES = ("x", "dt", "A", "B", "C", "D")
LANES, ITEMS = 32, 8


def _inputs(seed, bt, s, dn, n):
    rng = np.random.RandomState(seed)
    x = rng.randn(bt, s, dn).astype(np.float32)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), (bt, s, dn))).astype(np.float32)
    A = -np.tile(np.arange(1, n + 1, dtype=np.float32), (dn, 1)) * rng.uniform(
        0.5, 1.5, (dn, n)).astype(np.float32)
    B = rng.randn(bt, s, n).astype(np.float32)
    C = rng.randn(bt, s, n).astype(np.float32)
    D = rng.randn(dn).astype(np.float32)
    dy = rng.randn(bt, s, dn).astype(np.float32)
    return [x, dt, A, B, C, D], dy


def _pad(args, dy, to):
    """The inputs and dy padded with zeros to ``to`` positions (A, D as they are)."""
    def pad(a):
        return np.pad(a, [(0, 0), (0, to - a.shape[1])] + [(0, 0)] * (a.ndim - 2))

    x, dt, A, B, C, D = args
    return [pad(x), pad(dt), A, pad(B), pad(C), D], pad(dy)


def _jax_grads(args, dy):
    def loss(*a):
        y, _ = jax_selective_scan(*a, chunk=128)
        return jnp.sum(y * dy)

    return [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(6)))(
        *[jnp.asarray(a) for a in args])]


def _autograd_grads(args, dy):
    ins = [torch.from_numpy(a).requires_grad_() for a in args]
    y, _ = selective_scan_ref(*ins)
    y.backward(torch.from_numpy(dy))
    return [t.grad.numpy() for t in ins]


def _close(got, want, what, rtol=RTOL_OF_MAX):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), (what, err, float(np.abs(want).max()))


@pytest.mark.parametrize("s", [300, 130, 128], ids=["two-tiles", "one-tile", "half-tile"])
@pytest.mark.parametrize("n", [4, 16])
@pytest.mark.parametrize("padded", [False, True], ids=["as-is", "padded-to-tiles"])
def test_bwd_ref_matches_jax_grad(s, n, padded):
    """At 300 and 130 positions K4-bwd's tiles of 32 lanes (rounds of 8
    channels), at 128 its half tiles of 16 lanes (rounds of 16); d_block 16
    over 40 channels, three blocks in one cluster, the last ragged."""
    args, dy = _inputs(s + n, 2, s, 40, n)
    want = _jax_grads(args, dy)
    t_args, t_dy = (_pad(args, dy, -(-s // SCAN_TILE) * SCAN_TILE) if padded else (args, dy))
    got = selective_scan_bwd_ref(*(torch.from_numpy(a) for a in t_args),
                                 torch.from_numpy(t_dy), d_block=16)
    for name, g, w in zip(NAMES, got, want):
        g = g.numpy()
        if padded and name in ("x", "dt", "B", "C"):
            assert not np.any(g[:, s:]), f"{name} at a padded position"
            g = g[:, :s]
        _close(g, w, name)


@pytest.mark.parametrize("n", [4, 16])
def test_bwd_ref_matches_autograd_of_the_serial_scan(n):
    args, dy = _inputs(n, 3, 270, 20, n)
    want = _autograd_grads(args, dy)
    for d_block in (8, 16, 64):
        got = selective_scan_bwd_ref(*(torch.from_numpy(a) for a in args),
                                     torch.from_numpy(dy), d_block=d_block)
        for name, g, w in zip(NAMES, got, want):
            assert g.dtype == torch.float32
            _close(g.numpy(), w, name)


def test_selective_scan_under_autograd_on_the_cpu():
    """``selective_scan`` with grad runs ``SelectiveScan``: y and h_last as
    without grad, the gradients those of the plain backward, bit for bit,
    and within the tolerance of autograd through the serial scan and of
    jax.grad; no kernel launch on CPU tensors, and a caller's state
    refused."""
    args, dy = _inputs(7, 2, 300, 16, 8)
    ins = [torch.from_numpy(a).requires_grad_() for a in args]
    launches = (ops.selective_scan.launches, ops.selective_scan_bwd.launches,
                ops.selective_scan_bwd_reduce.launches)
    y, h_last = ops.selective_scan(*ins)
    with torch.no_grad():
        want_y, want_h = ops.selective_scan(*(torch.from_numpy(a) for a in args))
    assert torch.equal(y.detach(), want_y) and torch.equal(h_last, want_h)
    assert not h_last.requires_grad
    y.backward(torch.from_numpy(dy))
    plain = selective_scan_bwd_ref(*(torch.from_numpy(a) for a in args), torch.from_numpy(dy),
                                   d_block=ops.default_bwd_d_block(8, 2, 300, 16))
    for t, g in zip(ins, plain):
        assert torch.equal(t.grad, g)
    for name, t, w in zip(NAMES, ins, _autograd_grads(args, dy)):
        _close(t.grad.numpy(), w, name)
    for name, t, w in zip(NAMES, ins, _jax_grads(args, dy)):
        _close(t.grad.numpy(), w, name)
    assert (ops.selective_scan.launches, ops.selective_scan_bwd.launches,
            ops.selective_scan_bwd_reduce.launches) == launches
    with pytest.raises(ValueError, match="state"):
        ops.selective_scan(*ins, torch.zeros(2, 16, 8))


def test_bwd_d_block_is_the_most_that_fits():
    """K4-bwd's channels a block: 256 at S <= 128 (half tiles, rounds of 16
    channels) and 32 above (rounds of 8), halved while the grid has fewer
    blocks than the card's 132 SMs, down to a round; at falcon-mamba-7b's
    training shape (B 8, S 128, Dn 8192, N 16) 256, whose shared memory,
    107,520 bytes, lets two blocks share an SM (each at most 115,712 of its
    233,472); at B 1, S 1000 32 (256 blocks, 114,816 bytes: two an SM).
    Every plan's shared memory fits a block at every N."""
    assert ops.default_bwd_d_block(16, 8, 128, 8192) == 256
    assert ops.bwd_smem_bytes(16, 256, 16) == 107_520 <= 115_712
    assert ops.default_bwd_d_block(16, 1, 1000, 8192) == 32
    assert ops.bwd_smem_bytes(16, 32, 32) == 114_816 <= 115_712
    assert ops.default_bwd_d_block(16, 1, 128, 8192) == 32  # 64 blocks of 128: too few
    assert ops.default_bwd_d_block(16, 2, 45, 100) == 16  # a round, however few blocks
    assert ops.default_bwd_d_block(4, 1, 300, 136) == 8
    assert ops.default_bwd_d_block(32, 4, 129, 8192) == 32
    for n in ops.KERNEL_STATE_SIZES:
        for bt, s, dn in ((8, 128, 8192), (1, 1000, 8192), (1, 1, 64), (3, 45, 100)):
            d_block = ops.default_bwd_d_block(n, bt, s, dn)
            assert d_block % bwd_round(s) == 0
            assert ops.bwd_smem_bytes(n, d_block, bwd_lanes(s)) <= ops.MAX_SMEM_PER_BLOCK


def kernel_channel_partials(terms, d_block, lanes):
    """K4-bwd's partials of a sum over Dn of (..., Dn, N) terms, modelled by
    its loops: for each cluster, its ranks' blocks in order; in a block the
    rounds in order (the first written, the rest added); in a round the 8
    warps in order, each warp's value at 16 lanes the sum of its two
    channels (the lower half-warp's plus the upper's).  Channels past Dn
    add zeros."""
    dn = terms.shape[-2]
    pair = 32 // lanes
    cluster, groups = bwd_cluster(dn, d_block)

    def term(d):
        return terms[..., d, :] if d < dn else torch.zeros_like(terms[..., 0, :])

    parts = []
    for g in range(groups):
        total = None
        for rank in range(cluster):
            d0 = (g * cluster + rank) * d_block
            block = None
            for r in range(d_block // (BWD_WARPS * pair)):
                acc = None
                for w in range(BWD_WARPS):
                    c = d0 + (r * BWD_WARPS + w) * pair
                    v = term(c) + term(c + 1) if pair == 2 else term(c)
                    acc = v if acc is None else acc + v
                block = acc if block is None else block + acc
            total = block if total is None else total + block
        parts.append(total)
    return torch.stack(parts)


@pytest.mark.parametrize("dn, d_block, lanes", [
    (8192, 256, 16),  # the training shape's plan: 32 blocks, 16 clusters of 2
    (8192, 32, 32),   # B 1, S 1000's plan: 256 blocks, 128 clusters of 2
    (136, 16, 16),    # 9 blocks: 5 clusters, the last block and a half past Dn
    (100, 48, 16),    # 3 blocks of 3 rounds: 2 clusters, the last block alone
    (40, 8, 32),      # 5 blocks of one round, 3 clusters
])
def test_channel_order_matches_the_kernels_loops(dn, d_block, lanes):
    """The plain version's order of dB's and dC's sums over the channels
    (``_channel_partials``, ``_channel_sum``) is the kernel's, bit for bit:
    per cluster the loops above, then the clusters in order (the
    reduction's ``sum_partials_ref``)."""
    rng = np.random.RandomState(dn + d_block)
    terms = torch.from_numpy(rng.randn(2, 3, dn, 4).astype(np.float32))
    want = kernel_channel_partials(terms, d_block, lanes)
    cluster, groups = bwd_cluster(dn, d_block)
    assert want.shape == (groups, 2, 3, 4)
    assert torch.equal(_channel_partials(terms, d_block, lanes), want)
    assert torch.equal(_channel_sum(terms, d_block, lanes), sum_partials_ref(want, torch.float32))


def test_bwd_cluster_plan():
    """Clusters of at most 2 consecutive channel blocks of a sequence (an
    H100 runs 132 of them at once, every slot of two blocks an SM), as few
    as cover the blocks; at the training shape 16 clusters of 2 blocks of
    256 channels, whose partials of dB and dC (written and read again) are
    4.19 MB, an eighth of the 33.55 MB that one partial a block of 64
    channels took."""
    assert bwd_cluster(8192, 256) == (2, 16)
    assert bwd_cluster(8192, 32) == (2, 128)
    assert bwd_cluster(136, 16) == (2, 5)
    assert bwd_cluster(100, 48) == (2, 2)
    assert bwd_cluster(64, 64) == (1, 1)
    assert bwd_lanes(128) == 16 and bwd_lanes(129) == 32 and bwd_lanes(1) == 16
    bt, s, n = 8, 128, 16
    partials = 2 * 2 * 4 * bwd_cluster(8192, 256)[1] * bt * s * n
    assert partials == 4_194_304 and 8 * partials == 2 * 2 * 4 * (8192 // 64) * bt * s * n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reduction_cpu_path_adds_blocks_in_the_plain_backwards_order(dtype):
    """``selective_scan_bwd_reduce`` on CPU tensors (its plain version, no
    launch): the kernel's per-cluster partials of dB's terms (the loops of
    ``kernel_channel_partials``: five clusters, a ragged last block) summed
    by it give the plain backward's channel sum bit for bit, at 16 lanes and
    at 32; dA's and dD's partials over the sequences their sums in order."""
    rng = np.random.RandomState(11)
    bt, s, dn, n, d_block = 2, 5, 136, 4, 16
    terms = torch.from_numpy(rng.randn(bt, s, dn, n).astype(np.float32))
    part_a = torch.from_numpy(rng.randn(bt, dn, n).astype(np.float32))
    part_d = torch.from_numpy(rng.randn(bt, dn).astype(np.float32))
    for lanes in (16, 32):
        part_b = kernel_channel_partials(terms, d_block, lanes)
        part_c = kernel_channel_partials(terms.flip(1), d_block, lanes)
        assert part_b.shape[0] == 5
        outs = (torch.empty(bt, s, n, dtype=dtype), torch.empty(bt, s, n, dtype=dtype),
                torch.empty(dn, n), torch.empty(dn))
        launches = ops.selective_scan_bwd_reduce.launches
        ops.selective_scan_bwd_reduce((part_b, part_c, part_a, part_d), outs)
        assert ops.selective_scan_bwd_reduce.launches == launches
        assert torch.equal(outs[0], _channel_sum(terms, d_block, lanes).to(dtype))
        assert torch.equal(outs[1], _channel_sum(terms.flip(1), d_block, lanes).to(dtype))
        assert torch.equal(outs[2], part_a[0] + part_a[1])
        assert torch.equal(outs[3], part_d[0] + part_d[1])


def test_tile_states_are_the_states_before_each_tile():
    args, _ = _inputs(3, 2, 600, 8, 4)
    t_args = [torch.from_numpy(a) for a in args]
    y, h, tiles = ops.selective_scan(*t_args, return_tile_states=True)
    assert tiles.shape == (2, 3, 8, 4) and not tiles[:, 0].any()
    for k in (1, 2):
        cut = [a[:, :k * SCAN_TILE] if a.dim() == 3 else a for a in t_args]
        _, h_k = selective_scan_ref(*cut)
        assert torch.equal(tiles[:, k], h_k)
    assert torch.equal(ops.selective_scan(*t_args)[0], y)


def _fma(a, b, c):
    """a * b + c rounded once to float32 (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def adjoint_model(a, beta):
    """K4-bwd's adjoint g_t = a_{t+1} g_{t+1} + beta_t over (Bt, S, ...)
    float32, as the kernel takes it: tiles of 256 positions from the last;
    in a tile lane l holds positions 8 l .. 8 l + 7 with alpha_i = a of the
    position after (lane l + 1's first for the lane's last, 1 at lane 31,
    whose carry has it); the lane's pairs combined from its last down, the
    lanes' suffixes by a Hillis-Steele scan (offsets 1 .. 16, lanes past 31
    the identity), g at the lane's first position fma(ra, carry, rb), then
    the lane's positions down from the next lane's first (lane 31: the
    carry); the tile's carry out a_t0 g_t0.  Positions past S: a = 1,
    beta = 0."""
    bt, s = a.shape[:2]
    tiles = -(-s // SCAN_TILE)
    pad = tiles * SCAN_TILE - s
    rest = a.shape[2:]
    a = torch.cat([a, torch.ones((bt, pad) + rest)], 1)
    beta = torch.cat([beta, torch.zeros((bt, pad) + rest)], 1)
    g = torch.empty_like(a)
    carry = torch.zeros((bt,) + rest)
    lanes = torch.arange(LANES)
    for tile in reversed(range(tiles)):
        rows = slice(tile * SCAN_TILE, (tile + 1) * SCAN_TILE)
        av = a[:, rows].reshape((bt, LANES, ITEMS) + rest)
        bv = beta[:, rows].reshape((bt, LANES, ITEMS) + rest)
        a_next = av[:, (lanes + 1).clamp(max=LANES - 1), 0]
        alpha_last = torch.where((lanes == LANES - 1).view((1, LANES) + (1,) * len(rest)),
                                 torch.ones_like(a_next), a_next)
        ra, rb = alpha_last, bv[:, :, ITEMS - 1]
        for i in range(ITEMS - 2, -1, -1):
            rb = _fma(av[:, :, i + 1], rb, bv[:, :, i])
            ra = ra * av[:, :, i + 1]
        for off in (1, 2, 4, 8, 16):
            src = (lanes + off).clamp(max=LANES - 1)
            take = (lanes + off < LANES).view((1, LANES) + (1,) * len(rest))
            qa, qb = ra[:, src], rb[:, src]
            ra, rb = torch.where(take, ra * qa, ra), torch.where(take, _fma(ra, qb, rb), rb)
        g_first = _fma(ra, carry[:, None], rb)
        g_next = torch.cat([g_first[:, 1:], carry[:, None]], 1)
        gv = torch.empty_like(av)
        for i in range(ITEMS - 1, -1, -1):
            alpha = alpha_last if i == ITEMS - 1 else av[:, :, i + 1]
            gv[:, :, i] = _fma(alpha, g_next, bv[:, :, i])
            g_next = gv[:, :, i]
        carry = av[:, 0, 0] * gv[:, 0, 0]
        g[:, rows] = gv.reshape((bt, SCAN_TILE) + rest)
    return g[:, :s]


def serial_adjoint(a, beta):
    g = torch.empty_like(a)
    after = torch.zeros_like(a[:, 0])
    for t in reversed(range(a.shape[1])):
        g[:, t] = after + beta[:, t]
        after = a[:, t] * g[:, t]
    return g


@pytest.mark.parametrize("s, slow", [(1088, True), (300, False), (257, True), (256, False),
                                     (40, True)])
def test_adjoint_model_matches_the_serial_adjoint(s, slow):
    """The kernel's reverse scan across tile boundaries (1088: five tiles,
    the last ragged; 257: one position into the second tile; 256: a tile
    exactly), with slow and fast decay; the model padded to whole tiles
    with (1, 0) pairs gives the same bits on the real positions."""
    rng = np.random.RandomState(s)
    dt = rng.uniform(1e-3, 1e-2 if slow else 0.5, (2, s, 6, 4))
    a = torch.from_numpy(np.exp(-dt).astype(np.float32))
    beta = torch.from_numpy(rng.randn(2, s, 6, 4).astype(np.float32))
    got = adjoint_model(a, beta)
    _close(got, serial_adjoint(a, beta), "g", MODEL_RTOL_OF_MAX)
    to = -(-s // SCAN_TILE) * SCAN_TILE + SCAN_TILE  # a whole padding tile more
    padded = adjoint_model(torch.cat([a, torch.ones(2, to - s, 6, 4)], 1),
                           torch.cat([beta, torch.zeros(2, to - s, 6, 4)], 1))
    assert torch.equal(padded[:, :s], got) and not padded[:, s:].any()


def _lanes(v, lanes):
    """(Bt, 8 lanes, ...) positions as (Bt, lanes, 8, ...): lane l's 8."""
    return v.reshape((v.shape[0], lanes, ITEMS) + v.shape[2:])


def lane_scans_model(a, b, beta, lanes):
    """K4-bwd's two lane scans of a (Bt, S, ...) float32 sequence at
    ``lanes`` lanes of 8 positions a tile (16: the half tile of S <= 128),
    as the kernel runs them (csrc/selective_scan_bwd.cu with
    scan_tile.cuh::state_before_lane): the identity (1, 0) combined where a
    lane has no partner, the operations of the kernel in its order.  The
    forward from zero state: per tile the lanes' products, their inclusive
    scan with shuffles up, the state after the lane before; the adjoint
    g_t = a_{t+1} g_{t+1} + beta_t: per tile from the last, the lanes'
    suffixes by shuffles down, the carry a_t0 g_t0 into the tile before.
    Positions past S: a = 1, b = beta = 0.  Returns (h after each position,
    g), (Bt, S, ...)."""
    bt, s = a.shape[:2]
    tile = ITEMS * lanes
    tiles = -(-s // tile)
    pad = tiles * tile - s
    rest = a.shape[2:]
    a = torch.cat([a, torch.ones((bt, pad) + rest)], 1)
    b = torch.cat([b, torch.zeros((bt, pad) + rest)], 1)
    beta = torch.cat([beta, torch.zeros((bt, pad) + rest)], 1)
    ln = torch.arange(lanes).view((1, lanes) + (1,) * len(rest))
    one, zero = torch.ones(()), torch.zeros(())
    h = torch.empty_like(a)
    g = torch.empty_like(a)
    carry = torch.zeros((bt,) + rest)
    for t in range(tiles):  # the states, as K4 and the backward's recomputation
        rows = slice(t * tile, (t + 1) * tile)
        av, bv = _lanes(a[:, rows], lanes), _lanes(b[:, rows], lanes)
        pa, pb = av[:, :, 0], bv[:, :, 0]
        for i in range(1, ITEMS):
            pb = _fma(av[:, :, i], pb, bv[:, :, i])
            pa = pa * av[:, :, i]
        off = 1
        while off < lanes:
            src = (torch.arange(lanes) - off).clamp(min=0)
            qa = torch.where(ln >= off, pa[:, src], one)
            qb = torch.where(ln >= off, pb[:, src], zero)
            pb, pa = _fma(pa, qb, pb), qa * pa
            off *= 2
        after = _fma(pa, carry[:, None], pb)
        hv = torch.cat([carry[:, None], after[:, :-1]], 1)  # the state before each lane
        hs = torch.empty_like(av)
        for i in range(ITEMS):
            hv = _fma(av[:, :, i], hv, bv[:, :, i])
            hs[:, :, i] = hv
        h[:, rows] = hs.reshape(h[:, rows].shape)
        carry = hs[:, -1, -1]
    carry = torch.zeros((bt,) + rest)
    for t in reversed(range(tiles)):
        rows = slice(t * tile, (t + 1) * tile)
        av, bv = _lanes(a[:, rows], lanes), _lanes(beta[:, rows], lanes)
        last = ln == lanes - 1
        a_next = av[:, (torch.arange(lanes) + 1).clamp(max=lanes - 1), 0]
        alpha_last = torch.where(last, one, a_next)
        ra, rb = alpha_last, bv[:, :, ITEMS - 1]
        for i in range(ITEMS - 2, -1, -1):
            rb = _fma(av[:, :, i + 1], rb, bv[:, :, i])
            ra = ra * av[:, :, i + 1]
        off = 1
        while off < lanes:
            src = (torch.arange(lanes) + off).clamp(max=lanes - 1)
            qa = torch.where(ln + off < lanes, ra[:, src], one)
            qb = torch.where(ln + off < lanes, rb[:, src], zero)
            rb, ra = _fma(ra, qb, rb), ra * qa
            off *= 2
        g_first = _fma(ra, carry[:, None], rb)
        g_next = torch.cat([g_first[:, 1:], carry[:, None]], 1)
        gv = torch.empty_like(av)
        for i in range(ITEMS - 1, -1, -1):
            alpha = alpha_last if i == ITEMS - 1 else av[:, :, i + 1]
            gv[:, :, i] = _fma(alpha, g_next, bv[:, :, i])
            g_next = gv[:, :, i]
        carry = av[:, 0, 0] * gv[:, 0, 0]
        g[:, rows] = gv.reshape(g[:, rows].shape)
    return h[:, :s], g[:, :s]


def serial_states(a, b):
    h = torch.empty_like(a)
    state = torch.zeros_like(a[:, 0])
    for t in range(a.shape[1]):
        state = a[:, t] * state + b[:, t]
        h[:, t] = state
    return h


@pytest.mark.parametrize("s", [128, 100, 64, 1])
def test_half_warp_lane_scans_give_the_32_lane_bits(s):
    """At S <= 128 the kernel scans a channel's tile with a half-warp (16
    lanes, 4 shuffle stages, offsets within the half): its states and
    adjoint are the 32-lane scans' on the real positions, bit for bit (up to
    the sign of a zero), where lanes 16-31 hold the padding pairs (1, 0) and
    combine with lanes 0-15 as the identity; and both are within the
    tolerance of the serial recurrences."""
    rng = np.random.RandomState(s)
    shape = (2, s, 5, 4)
    a = torch.from_numpy(np.exp(-rng.uniform(1e-3, 0.5, shape)).astype(np.float32))
    b = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    beta = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    h16, g16 = lane_scans_model(a, b, beta, 16)
    h32, g32 = lane_scans_model(a, b, beta, 32)
    assert torch.equal(h16, h32) and torch.equal(g16, g32)
    _close(h16, serial_states(a, b), "h", MODEL_RTOL_OF_MAX)
    _close(g16, serial_adjoint(a, beta), "g", MODEL_RTOL_OF_MAX)


@pytest.mark.parametrize("s", [300, 256, 1088])
def test_32_lane_scans_are_the_adjoint_model_above_128(s):
    """Above 128 positions the kernel keeps its 32 lanes: the lane scans'
    model gives ``adjoint_model``'s adjoint bit for bit (up to the sign of a
    zero) across tile boundaries, and states within the tolerance of the
    serial recurrence."""
    rng = np.random.RandomState(s)
    shape = (2, s, 3, 4)
    a = torch.from_numpy(np.exp(-rng.uniform(1e-3, 0.5, shape)).astype(np.float32))
    b = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    beta = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    h, g = lane_scans_model(a, b, beta, 32)
    assert torch.equal(g, adjoint_model(a, beta))
    _close(h, serial_states(a, b), "h", MODEL_RTOL_OF_MAX)
