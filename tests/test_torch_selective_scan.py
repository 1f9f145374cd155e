"""Port parity: the selective scan's plain version (K4's, ``repro_torch/
kernels/ssm_scan/ref.py``) and its wrapper on CPU tensors against the JAX
package's scans, on the same inputs made from a seed with numpy.

Tolerances, as a share of the largest magnitude of the value compared:
* against ``selective_scan_ref`` and ``selective_scan_step``, which run the
  same operations in the same order, 1e-5: the sums over n are taken in
  another order and the two libraries' ``exp`` may differ in the last bit,
  so the results differ by a few float32 epsilons (measured up to 4e-7);
* against ``ops.selective_scan`` at the engine's ``scan_chunk`` of 32, whose
  associative scan within a chunk reorders the products, the same 1e-5
  (measured up to 5e-7);
* against ``selective_scan_pallas`` in interpret mode, as
  ``tests/test_kernels.py`` runs it, the same 1e-5.
The two cases draw dt as softplus(normal) (large steps, fast decay) and as
softplus(normal - 4) (the small steps of a Mamba model, slow decay, long
memory).
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.kernel import selective_scan_pallas
from repro.kernels.ssm_scan.ops import selective_scan as jax_selective_scan
from repro.kernels.ssm_scan.ops import selective_scan_step as jax_selective_scan_step
from repro.kernels.ssm_scan.ref import selective_scan_ref as jax_selective_scan_ref
from repro_torch.kernels.ssm_scan import ops
from repro_torch.kernels.ssm_scan.ref import lane_sum, selective_scan_ref

RTOL_OF_MAX = 1e-5


def _inputs(seed, bt, s, dn, n, dt_shift):
    rng = np.random.RandomState(seed)
    x = rng.randn(bt, s, dn).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(bt, s, dn) - dt_shift)).astype(np.float32)
    A = (-np.abs(rng.randn(dn, n)) - 0.1).astype(np.float32)
    B = rng.randn(bt, s, n).astype(np.float32)
    C = rng.randn(bt, s, n).astype(np.float32)
    D = np.full(dn, 0.4, np.float32)
    h0 = rng.randn(bt, dn, n).astype(np.float32)
    return x, dt, A, B, C, D, h0


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= RTOL_OF_MAX * scale, (np.abs(got - want).max(), scale)


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


CASES = [(2, 70, 16, 4, 0.0), (2, 70, 16, 4, 4.0), (1, 33, 8, 16, 4.0)]


@pytest.mark.parametrize("bt, s, dn, n, dt_shift", CASES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_plain_matches_reference_scan(bt, s, dn, n, dt_shift, with_h0):
    x, dt, A, B, C, D, h0 = _inputs(s + n, bt, s, dn, n, dt_shift)
    h = h0 if with_h0 else None
    want_y, want_h = jax_selective_scan_ref(*_jax(x, dt, A, B, C, D),
                                            None if h is None else jnp.asarray(h))
    y, h_last = selective_scan_ref(*_torch(x, dt, A, B, C, D),
                                   None if h is None else torch.from_numpy(h))
    assert y.dtype == torch.float32 and h_last.dtype == torch.float32
    _close(y.numpy(), want_y)
    _close(h_last.numpy(), want_h)


@pytest.mark.parametrize("bt, s, dn, n, dt_shift", CASES)
def test_plain_matches_chunked_scan_at_the_engine_chunk(bt, s, dn, n, dt_shift):
    x, dt, A, B, C, D, h0 = _inputs(7, bt, s, dn, n, dt_shift)
    want_y, want_h = jax_selective_scan(*_jax(x, dt, A, B, C, D, h0), chunk=32)
    y, h_last = selective_scan_ref(*_torch(x, dt, A, B, C, D, h0))
    _close(y.numpy(), want_y)
    _close(h_last.numpy(), want_h)


@pytest.mark.parametrize("dt_shift", [0.0, 4.0])
def test_plain_matches_pallas_kernel_in_interpret_mode(dt_shift):
    x, dt, A, B, C, D, _ = _inputs(7, 2, 70, 16, 4, dt_shift)
    want = selective_scan_pallas(*_jax(x, dt, A, B, C, D), chunk=16, d_block=8,
                                 interpret=True)
    y, _ = selective_scan_ref(*_torch(x, dt, A, B, C, D))
    _close(y.numpy(), want)


@pytest.mark.parametrize("n", [3, 4, 16])
def test_one_step_is_the_decode_step(n):
    x, dt, A, B, C, D, h0 = _inputs(9, 3, 1, 8, n, 4.0)
    want_y, want_h = jax_selective_scan_step(
        *_jax(x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], D, h0))
    y, h_last = selective_scan_ref(*_torch(x, dt, A, B, C, D, h0))
    _close(y.numpy()[:, 0], want_y)
    _close(h_last.numpy(), want_h)


def test_padded_positions_with_zero_dt_hold_the_state_bitwise():
    """The engine pads prompts and zeroes dt and x there: the state after
    the padding is bit for bit the state after the last real position, and
    the real positions' outputs are unchanged."""
    x, dt, A, B, C, D, h0 = _inputs(3, 2, 20, 8, 16, 4.0)
    pad = 12
    xp = np.concatenate([x, np.zeros((2, pad, 8), np.float32)], axis=1)
    dtp = np.concatenate([dt, np.zeros((2, pad, 8), np.float32)], axis=1)
    rng = np.random.RandomState(4)
    Bp = np.concatenate([B, rng.randn(2, pad, 16).astype(np.float32)], axis=1)
    Cp = np.concatenate([C, rng.randn(2, pad, 16).astype(np.float32)], axis=1)
    y, h = selective_scan_ref(*_torch(x, dt, A, B, C, D, h0))
    yp, hp = selective_scan_ref(*_torch(xp, dtp, A, Bp, Cp, D, h0))
    assert torch.equal(hp, h)
    assert torch.equal(yp[:, :20], y)


def test_lane_sum_halves_the_state_axis():
    p = torch.arange(16, dtype=torch.float32) * 0.1 + 1.0
    want = (((p[0] + p[8]) + (p[4] + p[12])) + ((p[2] + p[10]) + (p[6] + p[14]))) + \
        (((p[1] + p[9]) + (p[5] + p[13])) + ((p[3] + p[11]) + (p[7] + p[15])))
    assert torch.equal(lane_sum(p), want)
    q = torch.arange(6, dtype=torch.float32)
    assert torch.equal(lane_sum(q), (q[:3] + q[3:]).sum())


def test_wrapper_on_cpu_takes_the_plain_version_and_updates_the_state_in_place():
    """bf16 x with B and C as strided views of one (Bt, S, R + 2N) tensor,
    as the model passes them; the state is overwritten in place and the
    kernel's launch count does not move."""
    bt, s, dn, n, r = 2, 9, 8, 16, 5
    x, dt, A, _, _, D, h0 = _inputs(5, bt, s, dn, n, 4.0)
    xdb = torch.from_numpy(np.random.RandomState(6).randn(bt, s, r + 2 * n).astype(np.float32))
    xdb = xdb.to(torch.bfloat16)
    _, B, C = xdb.split([r, n, n], dim=-1)
    assert not B.is_contiguous()
    xb = torch.from_numpy(x).to(torch.bfloat16)
    h = torch.from_numpy(h0.copy())
    before = ops.selective_scan.launches
    y, h_out = ops.selective_scan(xb, torch.from_numpy(dt), torch.from_numpy(A), B, C,
                                  torch.from_numpy(D), h)
    assert ops.selective_scan.launches == before
    assert h_out is h and y.dtype == torch.bfloat16
    want_y, want_h = selective_scan_ref(xb, torch.from_numpy(dt), torch.from_numpy(A),
                                        B.contiguous(), C.contiguous(), torch.from_numpy(D),
                                        torch.from_numpy(h0))
    assert torch.equal(h, want_h) and torch.equal(y, want_y)
    y0, h_new = ops.selective_scan(xb, torch.from_numpy(dt), torch.from_numpy(A), B, C,
                                   torch.from_numpy(D))
    assert h_new.shape == (bt, dn, n) and y0.shape == (bt, s, dn)
