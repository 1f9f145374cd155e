"""The selective scan's gradient on the CPU: the plain version of K4-bwd
(``repro_torch/kernels/ssm_scan/ref.py::selective_scan_bwd_ref``) and
``SelectiveScan``'s CPU path against ``jax.grad`` of the JAX package's
model-facing scan (``repro/kernels/ssm_scan/ops.py::selective_scan``, the
chunked associative scan that the reference trains through) and against
autograd through the port's serial ``selective_scan_ref``, in float32; and a
plain model of K4-bwd's reverse adjoint scan (tiles of 256 positions walked
from the last, lanes of 8 positions, the lanes' suffixes by shuffles, the
carry a_t0 g_t0 from the tile after) against the serial adjoint.

Tolerances: every gradient within 1e-4 of its largest magnitude (as
``tests/test_torch_train.py``'s gradient leaves): the same float32
arithmetic summed in other orders and, against JAX, a chunked scan's tree in
place of the serial loop; measured about 1e-6.  The model's adjoint within
1e-5 of its largest magnitude (a few float32 roundings a step, which decay
with the state).  Bitwise: a pad to whole tiles (dt = x = 0, dy = 0) leaves
the gradients of the real positions as they are in the model, and every
padded position's gradients are exactly 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ops import selective_scan as jax_selective_scan
from repro_torch.kernels.ssm_scan import ops
from repro_torch.kernels.ssm_scan.ref import (
    CHANNEL_ROUND,
    SCAN_TILE,
    _channel_sum,
    selective_scan_bwd_ref,
    selective_scan_ref,
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


@pytest.mark.parametrize("s", [300, 130], ids=["two-tiles", "one-tile"])
@pytest.mark.parametrize("n", [4, 16])
@pytest.mark.parametrize("padded", [False, True], ids=["as-is", "padded-to-tiles"])
def test_bwd_ref_matches_jax_grad(s, n, padded):
    args, dy = _inputs(s + n, 2, s, 12, n)
    want = _jax_grads(args, dy)
    t_args, t_dy = (_pad(args, dy, -(-s // SCAN_TILE) * SCAN_TILE) if padded else (args, dy))
    got = selective_scan_bwd_ref(*(torch.from_numpy(a) for a in t_args),
                                 torch.from_numpy(t_dy), d_block=8)
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
                                   d_block=ops.default_bwd_d_block(8))
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
    """K4-bwd's channels a block, from the mirror of its shared memory: 64
    at N 4-16, 32 at N 32 (64 would need 239,744 bytes, more than a block
    may use)."""
    assert [ops.default_bwd_d_block(n) for n in ops.KERNEL_STATE_SIZES] == [64, 64, 64, 32]
    assert ops.bwd_smem_bytes(32, 64) == 239_744 > ops.MAX_SMEM_PER_BLOCK


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reduction_cpu_path_adds_blocks_in_the_plain_backwards_order(dtype):
    """``selective_scan_bwd_reduce`` on CPU tensors (its plain version, no
    launch): per-block partials of dB's terms (each block's rounds of 8
    channels summed in order, a ragged last block) summed by it give the
    plain backward's channel sum bit for bit; dA's and dD's partials over
    the sequences their sums in order."""
    rng = np.random.RandomState(11)
    bt, s, dn, n, d_block = 2, 5, 40, 4, 16
    terms = torch.from_numpy(rng.randn(bt, s, dn, n).astype(np.float32))
    blocks = -(-dn // d_block)
    padded = torch.cat([terms, terms.new_zeros(bt, s, blocks * d_block - dn, n)], dim=2)
    rounds = padded.reshape(bt, s, blocks, d_block // CHANNEL_ROUND, CHANNEL_ROUND, n)
    per_round = rounds[..., 0, :]
    for i in range(1, CHANNEL_ROUND):
        per_round = per_round + rounds[..., i, :]
    per_block = per_round[:, :, :, 0]
    for i in range(1, d_block // CHANNEL_ROUND):
        per_block = per_block + per_round[:, :, :, i]
    part_b = per_block.movedim(2, 0).contiguous()
    part_a = torch.from_numpy(rng.randn(bt, dn, n).astype(np.float32))
    part_d = torch.from_numpy(rng.randn(bt, dn).astype(np.float32))
    parts = (part_b, part_b.flip(2).contiguous(), part_a, part_d)
    outs = (torch.empty(bt, s, n, dtype=dtype), torch.empty(bt, s, n, dtype=dtype),
            torch.empty(dn, n), torch.empty(dn))
    launches = ops.selective_scan_bwd_reduce.launches
    ops.selective_scan_bwd_reduce(parts, outs)
    assert ops.selective_scan_bwd_reduce.launches == launches
    assert torch.equal(outs[0], _channel_sum(terms, d_block).to(dtype))
    assert torch.equal(outs[1], _channel_sum(terms.flip(1), d_block).to(dtype))
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
