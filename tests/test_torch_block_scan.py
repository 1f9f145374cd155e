"""K4's grouping of the selective scan, modelled on the CPU.

K4 (``repro_torch/kernels/ssm_scan/csrc/selective_scan.cu``) runs a prefill
as an associative scan over the pairs (a_t, b_t) = (exp(dt_t A), (dt_t x_t)
B_t): tiles of 256 positions from position 0; in a tile, lane l of a warp
takes positions 8 l .. 8 l + 7, combines its 8 pairs in order, the 32 lanes'
products are scanned with shuffles (Hillis-Steele, offsets 1, 2, 4, 8, 16),
the state after lane l - 1 is a_scan * carry + b_scan, and lane l steps
h = a_i h + b_i from it, summing C_i[n] h_i over n in order into y_i; lane
31's last state is carried to the next tile.  Positions past S are the pair
(1, 0).  The decode body (S = 1) runs one position's steps over n in order.
``block_scan_model`` and ``decode_step_model`` are plain models of that
arithmetic (a fused multiply-add as a float64 product and sum rounded once
to float32; the exponential torch's exp2 where the card's is ex2.approx),
held here against the port's plain version (``ssm_scan/ref.py``, the serial
loop) and the JAX package's ``ref.selective_scan_ref`` and
``ops.selective_scan`` (its chunked associative scan).

Tolerance: 1e-5 of the largest magnitude of the value compared.  The
groupings differ by a few float32 roundings a step, which decay with the
state (measured up to 5e-7 of the largest magnitude here); a fault of
grouping shows as errors of the order of the values.  Bitwise: the identity and the padded pair
(1, +-0) leave every value they meet as it is, so the state after position
n - 1 does not depend on the padded length; and the decode body repeats the
tile body's operations at S = 1.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ops import selective_scan as jax_selective_scan
from repro.kernels.ssm_scan.ref import selective_scan_ref as jax_selective_scan_ref
from repro_torch.kernels.ssm_scan.ref import selective_scan_ref

RTOL_OF_MAX = 1e-5
LANES, ITEMS = 32, 8
TILE = LANES * ITEMS
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to float32 (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def block_scan_model(x, dt, A, B, C, D, h0):
    """K4's prefill body in float32: returns (y (Bt, S, Dn), h (Bt, Dn, N))."""
    bt, s, dn = x.shape
    n = A.shape[1]
    n_tiles = -(-s // TILE)
    pad = n_tiles * TILE - s

    def padded(t):
        return torch.nn.functional.pad(t.float(), (0, 0, 0, pad))

    xf, dtf, bf, cf = padded(x), padded(dt), padded(B), padded(C)
    a2 = A.float() * LOG2E  # (Dn, N)
    h = h0.float().clone()
    y = torch.empty((bt, n_tiles * TILE, dn))
    lanes = torch.arange(LANES)
    for tile in range(n_tiles):
        rows = slice(tile * TILE, (tile + 1) * TILE)
        # position 8 l + i at [l, i]
        dtt = dtf[:, rows].reshape(bt, LANES, ITEMS, dn)
        xt = xf[:, rows].reshape(bt, LANES, ITEMS, dn)
        bt_ = bf[:, rows].reshape(bt, LANES, ITEMS, 1, n)
        ct = cf[:, rows].reshape(bt, LANES, ITEMS, 1, n)
        av = torch.exp2(dtt[..., None] * a2)  # (Bt, 32, 8, Dn, N)
        bv = (dtt * xt)[..., None] * bt_
        pa, pb = av[:, :, 0], bv[:, :, 0]
        for i in range(1, ITEMS):
            pb = _fma(av[:, :, i], pb, bv[:, :, i])
            pa = pa * av[:, :, i]
        for off in (1, 2, 4, 8, 16):
            src = (lanes - off).clamp(min=0)
            qa, qb = pa[:, src], pb[:, src]
            take = (lanes >= off).view(1, LANES, 1, 1)
            pa, pb = torch.where(take, qa * pa, pa), torch.where(take, _fma(pa, qb, pb), pb)
        end = _fma(pa, h[:, None], pb)  # the state after each lane
        hv = torch.cat([h[:, None], end[:, :-1]], dim=1)
        acc = torch.zeros((bt, LANES, ITEMS, dn))
        for i in range(ITEMS):
            hv = _fma(av[:, :, i], hv, bv[:, :, i])
            for k in range(n):
                acc[:, :, i] = _fma(ct[:, :, i, :, k], hv[..., k], acc[:, :, i])
        h = hv[:, LANES - 1]
        y[:, rows] = (acc + D.float() * xt).reshape(bt, TILE, dn)
    return y[:, :s].to(x.dtype), h


def decode_step_model(x, dt, A, B, C, D, h0):
    """K4's decode body (S = 1) in float32: each state's step, y summed over
    n in order."""
    xv, dtv = x[:, 0].float(), dt[:, 0].float()  # (Bt, Dn)
    dtx = dtv * xv
    h = h0.float().clone()
    acc = torch.zeros_like(xv)
    for k in range(A.shape[1]):
        av = torch.exp2(dtv * (A[:, k].float() * LOG2E))
        h[..., k] = _fma(av, h[..., k], dtx * B[:, 0, None, k].float())
        acc = _fma(C[:, 0, None, k].float(), h[..., k], acc)
    return (acc + D.float() * xv)[:, None].to(x.dtype), h


def _inputs(seed, bt, s, dn, n, dt_shift, n_valid=None):
    rng = np.random.RandomState(seed)
    x = rng.randn(bt, s, dn).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(bt, s, dn) - dt_shift)).astype(np.float32)
    if n_valid is not None:  # the engine's padding
        x[:, n_valid:] = 0
        dt[:, n_valid:] = 0
    A = (-np.abs(rng.randn(dn, n)) - 0.1).astype(np.float32)
    B = rng.randn(bt, s, n).astype(np.float32)
    C = rng.randn(bt, s, n).astype(np.float32)
    D = rng.randn(dn).astype(np.float32)
    h0 = (0.5 * rng.randn(bt, dn, n)).astype(np.float32)
    return x, dt, A, B, C, D, h0


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    assert err <= RTOL_OF_MAX * float(np.abs(want).max()), (what, err)


@pytest.mark.parametrize("bt, s, dn, n, dt_shift, n_valid", [
    (2, 1088, 8, 16, 4.0, 1000),   # two tiles and a padded tail; slow decay
    (1, 300, 12, 4, 0.0, None),    # S not a multiple of the tile; fast decay
    (1, 257, 6, 32, 4.0, None),    # one position into the second tile
    (3, 40, 5, 8, 2.0, 33),        # one short tile
])
def test_block_scan_model_matches_the_references(bt, s, dn, n, dt_shift, n_valid):
    args = _inputs(bt + s + n, bt, s, dn, n, dt_shift, n_valid)
    y, h = block_scan_model(*(torch.from_numpy(a) for a in args))
    want_y, want_h = selective_scan_ref(*(torch.from_numpy(a) for a in args))
    _close(y, want_y, "port plain y")
    _close(h, want_h, "port plain h")
    jargs = [jnp.asarray(a) for a in args]
    ref_y, ref_h = jax_selective_scan_ref(*jargs)
    _close(y, ref_y, "reference ref y")
    _close(h, ref_h, "reference ref h")
    ops_y, ops_h = jax_selective_scan(*jargs, chunk=128)
    _close(y, ops_y, "reference ops y")
    _close(h, ops_h, "reference ops h")


def test_identity_padding_holds_the_state_bitwise():
    """The state after position n - 1 and the outputs before it have the same
    bits at every padded length (positions n .. S - 1 with dt = x = 0, as the
    engine pads), across tile boundaries, and as at S = n."""
    n_valid = 1000
    x, dt, A, B, C, D, h0 = (torch.from_numpy(a) for a in
                             _inputs(7, 1, 2048, 4, 16, 4.0, n_valid))
    y_cut, h_cut = block_scan_model(x[:, :n_valid], dt[:, :n_valid], A, B[:, :n_valid],
                                    C[:, :n_valid], D, h0)
    for s in (1024, 1088, 2048):
        y, h = block_scan_model(x[:, :s], dt[:, :s], A, B[:, :s], C[:, :s], D, h0)
        assert torch.equal(h, h_cut), s
        assert torch.equal(y[:, :n_valid], y_cut), s


def test_decode_body_repeats_the_tile_body_at_one_position():
    for n in (4, 8, 16, 32):
        args = [torch.from_numpy(a) for a in _inputs(n, 8, 1, 24, n, 2.0)]
        y_tile, h_tile = block_scan_model(*args)
        y_step, h_step = decode_step_model(*args)
        assert torch.equal(h_tile, h_step) and torch.equal(y_tile, y_step), n
        _close(h_step, selective_scan_ref(*args)[1], "decode h")
