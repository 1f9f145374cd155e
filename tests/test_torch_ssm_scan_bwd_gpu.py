"""Training's kernels on the card: K4-bwd (the selective scan's backward,
``repro_torch/kernels/ssm_scan/csrc/selective_scan_bwd.cu``) against its
plain version (``ref.selective_scan_bwd_ref``) at falcon-mamba-7b's
training shape and across tiles, and its reduction alone; K4's tile states;
``SelectiveScan`` on the
card; and the MoE's training step, whose gradient has the same bits run to
run.

Marked ``gpu``: without a CUDA device each test skips from inside itself, so
every worker collects the same tests.  Run on the card with
``PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_ssm_scan_bwd_gpu.py``
(that machine has no JAX).

Tolerance: the kernel recomputes the states with K4's tile scan (ex2.approx,
a tree over the lanes) and scans the adjoint as a tree too, where the plain
version runs both serially with the true exp; their sums over n, channels,
time and sequences are in the same order, but the kernel fuses a product
into each.  So, as for K4's forward (``test_torch_selective_scan_gpu.py``:
a few float32 roundings a step that decay with the state, up to sqrt(1000)
epsilons over a slow channel), each gradient within 2^-12 (2.4e-4) of its
largest magnitude, twice the forward's limit for the two scans it takes,
and a bf16 gradient within that plus one bf16 ulp (one rounding of a value
that moved).  A fault (a wrong tile, lane or carry) shows as errors of the
order of the values.  Bitwise: two launches, every K4 d_block's tile
states, and the forward's y and h with and without its tile states.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import assert_within_bf16_ulp
from repro_torch.configs import get_smoke_config
from repro_torch.convert import tree_from_lm
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.kernels.ssm_scan import ops
from repro_torch.kernels.ssm_scan.ref import (
    selective_scan_bwd_ref,
    selective_scan_ref,
    sum_partials_ref,
)
from repro_torch.models.model import LM
from repro_torch.models.runtime import Runtime
from repro_torch.training.tree import tree_leaves

pytestmark = pytest.mark.gpu
RTOL_OF_MAX = 2.0 ** -12
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def scan_inputs(gen, bt, s, dn, n, dtype, dtr=8):
    """Inputs as the model makes them (dt log-uniform in [1e-3, 1e-1], A =
    -(1..N), B and C strided views of one x_proj output) and dy."""
    dev = gen.device
    x = torch.randn((bt, s, dn), generator=gen, device=dev).to(dtype)
    u = torch.rand((bt, s, dn), generator=gen, device=dev)
    dt = torch.exp(u * (np.log(0.1) - np.log(1e-3)) + np.log(1e-3))
    A = -torch.arange(1, n + 1, dtype=torch.float32, device=dev).expand(dn, n).contiguous()
    xdb = torch.randn((bt, s, dtr + 2 * n), generator=gen, device=dev).to(dtype)
    _, B, C = xdb.split([dtr, n, n], dim=-1)
    D = torch.randn(dn, generator=gen, device=dev)
    dy = torch.randn((bt, s, dn), generator=gen, device=dev).to(dtype)
    return (x, dt, A, B, C, D), dy


def bwd_launches():
    """K4-bwd's launches so far: its scan pass's and its reduction's."""
    return ops.selective_scan_bwd.launches, ops.selective_scan_bwd_reduce.launches


def kernel_grads(args, dy):
    _, _, tiles = ops.selective_scan(*args, return_tile_states=True)
    before = bwd_launches()
    grads = ops.selective_scan_bwd(*args, dy, tiles)
    torch.cuda.synchronize()
    assert bwd_launches() == (before[0] + 1, before[1] + 1)
    return grads


def check_against_plain(args, dy):
    got = kernel_grads(args, dy)
    bt, s, dn = args[0].shape
    want = selective_scan_bwd_ref(*args, dy,
                                  d_block=ops.default_bwd_d_block(args[2].shape[1], bt, s, dn))
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.isfinite(g.float()).all(), name
        atol = RTOL_OF_MAX * float(w.float().abs().max())
        if g.dtype == torch.bfloat16:
            assert_within_bf16_ulp(g.float().cpu().numpy(), w.float().cpu().numpy(), atol=atol)
        else:
            assert float((g - w).abs().max()) <= atol, (name, float((g - w).abs().max()), atol)
    return got


@pytest.mark.parametrize("bt, s, dn, n, dtype", [
    (8, 128, 8192, 16, torch.bfloat16),   # falcon-mamba-7b's training shape: half tiles
    (1, 1000, 8192, 16, torch.bfloat16),  # four tiles, the last ragged
    (2, 257, 96, 4, torch.bfloat16),      # one position into the second tile
    (2, 256, 64, 8, torch.float32),       # a tile exactly
    (3, 45, 100, 8, torch.float32),       # ragged channel rounds, 7 blocks, 4 clusters
    (1, 600, 64, 32, torch.bfloat16),     # three tiles at N 32
    (2, 1, 128, 16, torch.bfloat16),      # one position
    (2, 64, 200, 4, torch.float32),       # half tiles at N 4
    (4, 129, 520, 16, torch.float32),     # one position past a half tile: 32 lanes
    (3, 100, 136, 16, torch.bfloat16),    # 9 blocks in 5 clusters, a block and a half past Dn
    (2, 128, 1000, 32, torch.float32),    # half tiles at N 32
    (1, 1088, 264, 8, torch.bfloat16),    # five tiles, the last ragged; Dn ragged
])
def test_bwd_kernel_matches_plain(card, bt, s, dn, n, dtype):
    gen = torch.Generator(device=card).manual_seed(bt + s + dn + n)
    check_against_plain(*scan_inputs(gen, bt, s, dn, n, dtype))


@pytest.mark.parametrize("n", ops.KERNEL_STATE_SIZES)
def test_bwd_two_launches_bitwise(card, n):
    """Every state size across a tile boundary and in a half tile, with a
    ragged channel block and clusters: within the tolerance, and two
    launches the same bits."""
    gen = torch.Generator(device=card).manual_seed(n)
    for s in (300, 100):
        args, dy = scan_inputs(gen, 2, s, 136, n, torch.bfloat16)
        got = check_against_plain(args, dy)
        again = kernel_grads(args, dy)
        assert all(torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.parametrize("n_blocks, bt, s, dn, n, dtype", [
    (16, 8, 128, 8192, 16, torch.bfloat16),  # falcon-mamba-7b's training shape: 16 clusters
    (3, 2, 45, 100, 8, torch.float32),        # ragged, float32 outputs
    (11, 1, 7, 99, 4, torch.bfloat16),        # dD one output a thread (Dn not a multiple of 4)
])
def test_reduction_matches_plain_bitwise(card, n_blocks, bt, s, dn, n, dtype):
    """K4-bwd's second launch alone: each output its partials' sum over the
    first axis in order, rounded once, the plain version's bits (four
    outputs a thread where the count allows, else one)."""
    gen = torch.Generator(device=card).manual_seed(n_blocks)
    parts = tuple(torch.randn(shape, generator=gen, device=card) for shape in (
        (n_blocks, bt, s, n), (n_blocks, bt, s, n), (bt, dn, n), (bt, dn)))
    outs = (torch.empty((bt, s, n), dtype=dtype, device=card),
            torch.empty((bt, s, n), dtype=dtype, device=card),
            torch.empty((dn, n), device=card), torch.empty(dn, device=card))
    before = bwd_launches()
    ops.selective_scan_bwd_reduce(parts, outs)
    torch.cuda.synchronize()
    assert bwd_launches() == (before[0], before[1] + 1)
    for part, out in zip(parts, outs):
        assert torch.equal(out, sum_partials_ref(part, out.dtype))


def test_tile_states_and_forward_bits(card):
    """K4 with tile states: y and h the same bits as without, the states the
    same at every d_block, the first zero, each within the forward's
    tolerance of the plain version's."""
    gen = torch.Generator(device=card).manual_seed(3)
    args, _ = scan_inputs(gen, 2, 700, 200, 16, torch.bfloat16)
    y0, h0 = ops.selective_scan(*args)
    want = None
    for d_block in ops.KERNEL_D_BLOCKS:
        y, h, tiles = ops.selective_scan(*args, d_block=d_block, return_tile_states=True)
        assert torch.equal(y, y0) and torch.equal(h, h0) and not tiles[:, 0].any()
        want = tiles if want is None else want
        assert torch.equal(tiles, want), d_block
    _, _, plain = selective_scan_ref(*args, return_tile_states=True)
    assert float((want - plain).abs().max()) <= 2.0 ** -13 * float(plain.abs().max())


def test_selective_scan_autograd_on_the_card(card):
    gen = torch.Generator(device=card).manual_seed(4)
    args, dy = scan_inputs(gen, 2, 300, 64, 16, torch.bfloat16)
    ins = [t.detach().clone().requires_grad_() for t in args]
    before = (ops.selective_scan.launches, *bwd_launches())
    y, h_last = ops.selective_scan(*ins)
    y.backward(dy)
    assert (ops.selective_scan.launches, *bwd_launches()) == \
        (before[0] + 1, before[1] + 1, before[2] + 1)
    with torch.no_grad():
        assert torch.equal(y, ops.selective_scan(*args)[0])
    want = kernel_grads(args, dy)
    for t, w in zip(ins, want):
        assert torch.equal(t.grad, w.to(t.grad.dtype))


def test_shared_memory_mirror(card):
    """The library's shared memory a block at every (N, d_block, lanes)
    equals the CPU mirror, which the wrapper's plan checks."""
    lib = ops.BWD_LIBRARY.load()
    for n in ops.KERNEL_STATE_SIZES:
        for d_block in (8, 16, 32, 64):
            for lanes in (16, 32):
                assert lib.selective_scan_bwd_smem_bytes(n, d_block, lanes) == \
                    ops.bwd_smem_bytes(n, d_block, lanes)


def test_occupancy_at_the_training_shape(card):
    """At falcon-mamba-7b's training shape (B 8, S 128, Dn 8192, N 16, bf16)
    the scan pass runs two blocks of 8 warps an SM (the card's occupancy
    query), at most 128 registers a thread, and the card holds every
    cluster of 2 at once (132); at B 1, S 1000 (32 lanes) too."""
    for bt, s in ((8, 128), (1, 1000)):
        occ = ops.bwd_occupancy(16, bt, s, 8192, torch.bfloat16)
        assert occ["blocks_per_sm"] >= 2 and occ["active_clusters"] >= 128, occ
        assert occ["registers"] <= 128 and occ["cluster"] == 2, occ


def test_bwd_refuses_what_it_does_not_take(card):
    gen = torch.Generator(device=card).manual_seed(5)
    args, dy = scan_inputs(gen, 1, 40, 64, 16, torch.bfloat16)
    _, _, tiles = ops.selective_scan(*args, return_tile_states=True)
    before = bwd_launches()
    with pytest.raises(ValueError, match="h_tiles"):
        ops.selective_scan_bwd(*args, dy)
    with pytest.raises(TypeError):
        ops.selective_scan_bwd(*args, dy.float(), tiles)
    with pytest.raises(ValueError):
        ops.selective_scan_bwd(*args, dy, tiles[:, :, :32].contiguous())
    assert bwd_launches() == before


def _moe_grads(card, seed):
    cfg = get_smoke_config("deepseek-moe-16b")
    lm = LM(cfg, card).init_params(torch.Generator(device=card).manual_seed(seed)).trainable()
    batch = SyntheticTokens(cfg.vocab_size, 32, 4, seed=seed).next_batch()
    loss, extra = lm.loss_fn({k: torch.as_tensor(v) for k, v in batch.items()},
                             Runtime(block_q=64, block_k=64))
    loss.backward()
    return loss.detach(), extra["aux"].detach(), tree_leaves(tree_from_lm(lm, grads=True))


def test_moe_training_step_has_fixed_bits(card):
    """The smoke deepseek-moe (a dense head layer, a MoE layer at the
    training capacity) on the card: the loss, the aux and every gradient
    the same bits in two runs from the same seed; the aux positive."""
    loss, aux, grads = _moe_grads(card, 0)
    loss2, aux2, grads2 = _moe_grads(card, 0)
    assert float(aux) > 0 and torch.equal(loss, loss2) and torch.equal(aux, aux2)
    assert all(torch.equal(g, h) for g, h in zip(grads, grads2))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_mamba_training_step_on_the_card(card):
    """The smoke falcon-mamba cut to 2 layers, in float32: its training step
    runs K4 twice a layer under full remat and K4-bwd's two launches once a
    layer, and its
    loss and gradients match the CPU's (the plain versions): the loss within
    1e-5 relative, each gradient leaf within 2^-11 of its largest magnitude
    (K4-bwd's own limit against its plain version, doubled for the float32
    arithmetic around it, which the card sums in other orders)."""
    cfg = dataclasses.replace(get_smoke_config("falcon-mamba-7b"), n_layers=2, dtype="float32")
    batch = SyntheticTokens(cfg.vocab_size, 32, 4, seed=1).next_batch()
    results = {}
    for dev in (card, torch.device("cpu")):
        lm = LM(cfg, "cpu").init_params(torch.Generator().manual_seed(2)).to(dev).trainable()
        before = (ops.selective_scan.launches, *bwd_launches())
        loss, _ = lm.loss_fn({k: torch.as_tensor(v) for k, v in batch.items()},
                             Runtime(remat="full"))
        loss.backward()
        if dev.type == "cuda":
            after = (ops.selective_scan.launches, *bwd_launches())
            assert tuple(a - b for a, b in zip(after, before)) == (4, 2, 2)
        results[dev.type] = (float(loss.detach()),
                             [g.cpu() for g in tree_leaves(tree_from_lm(lm, grads=True))])
    assert abs(results["cuda"][0] - results["cpu"][0]) <= 1e-5 * abs(results["cpu"][0])
    for g, w in zip(results["cuda"][1], results["cpu"][1]):
        assert float((g - w).abs().max()) <= 2.0 ** -11 * float(w.abs().max()) + 1e-12
