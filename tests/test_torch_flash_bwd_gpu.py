"""K3's log-sum-exp and K3-bwd (the flash backward's dq pass and its key
side: one dk/dv pass, or at MLA's (192, 128) a dv and a dk pass) on the
card, against their plain versions (``flash_fwd_ref(..., return_lse=True)``,
``flash_bwd_ref``) on the same bf16 inputs.

Marked ``gpu``: without a CUDA device each test skips from inside itself.
Run on the card with
``PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_flash_bwd_gpu.py``.

Tolerances.  lse: the kernel sums p = 2^(x - m) by ex2.approx in its own
order; within 1e-5 (1 + |lse|).  Gradients: the plain version runs float32
arithmetic on the bf16 inputs and rounds dq, dk, dv to bf16 once; the
kernel multiplies on the tensor cores (exact bf16 products, float32 sums in
another order) with p and ds carried as hi + lo bf16 pairs (within 2^-17 of
each) and rounds once.  The float32 difference can move the rounding by one
bf16 step, and is itself about sqrt(n) float32 epsilons of the n summands'
magnitude, which for an element near 0 by cancellation is several of its
ulps; so one bf16 ulp of the element plus 2^-12 of the tensor's max |value|
(chip_smoke.py states the same limit).  A fault (a wrong mask, tile or
fragment) shows as errors of the order of the values.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import pytest
import torch

from _torch_parity import assert_within_bf16_ulp
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_bwd_ref, flash_fwd_ref

pytestmark = pytest.mark.gpu
GRAD_ATOL = 2.0 ** -12  # of max |value|


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(dev, seed, b, hq, hk, sq, skv, d, dv=None):
    gen = torch.Generator(device=dev).manual_seed(seed)
    draw = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    dv = d if dv is None else dv
    return draw(b, hq, sq, d), draw(b, hk, skv, d), draw(b, hk, skv, dv), draw(b, hq, sq, dv)


def _pass_launches():
    return (fa_ops.flash_bwd_dq.launches,
            *(fa_ops.BWD_KEY_WRAPPERS[p].launches for p in sorted(fa_ops.BWD_KEY_WRAPPERS)))


CASES = [  # b, hq, hk, sq, skv, d, dv, kv_lens, q_offset
    (2, 4, 4, 33, 33, 16, 16, None, 0),           # MHA, S not a multiple of the tile
    (2, 4, 2, 70, 70, 64, 64, [70, 9], 0),        # G = 2, ragged kv_lens
    (1, 8, 2, 130, 130, 32, 32, None, 0),         # G = 4
    (1, 10, 2, 200, 200, 128, 128, [200], 0),     # G = 5, D 128
    (2, 10, 2, 21, 153, 64, 64, [150, 87], 129),  # q_offset > 0, kv_lens < Skv
    (1, 4, 4, 128, 128, 48, 48, [0], 0),          # a row of no keys
    (8, 32, 32, 128, 128, 64, 64, None, 0),       # stablelm-1.6b's attention
    # the Hopper design's edges: the key side's cut (split 1, 2, 4, 8),
    # tiles of 64 rows, the K tile zeroed past kv_len
    (2, 4, 2, 10, 10, 32, 32, [10, 7], 0),        # S below one tile
    (1, 16, 2, 256, 256, 64, 64, None, 0),        # G 8, an even number of key tiles (split 4)
    (1, 8, 1, 512, 512, 96, 96, None, 0),         # G 8, one KV head (split 8)
    (1, 10, 2, 192, 192, 112, 112, None, 0),      # G 5, an odd number of key tiles (split 4)
    (2, 40, 8, 1024, 1024, 128, 128, [1024, 611], 0),  # qwen3-14b ragged (split 2)
    (2, 10, 2, 100, 300, 80, 80, [260, 300], 200),  # q_offset > 0, kv_len < Skv, D 80
    (3, 6, 3, 150, 150, 64, 64, [0, 1, 150], 0),  # kv_len 0 and 1 in one batch
    (8, 32, 32, 128, 128, 64, 64, [128, 100, 77, 64, 63, 17, 1, 128], 0),  # B 8 ragged
    (8, 24, 24, 192, 192, 64, 64, None, 0),       # musicgen-medium's training: 64 frames + 128
    (8, 24, 24, 192, 192, 64, 64, [192, 150, 129, 128, 65, 64, 1, 192], 0),  # ragged
    # unequal key and value dims: MLA's (192, 128), the dv and the dk pass,
    # and the smoke deepseek-v2's (24, 16), one dk/dv pass
    (8, 128, 128, 128, 128, 192, 128, None, 0),   # deepseek-v2-236b's training shape
    (8, 128, 128, 128, 128, 192, 128, [128, 100, 77, 64, 63, 17, 1, 128], 0),
    (1, 4, 4, 2048, 2048, 192, 128, None, 0),     # the key side cut (split 4) at DK 192
    (2, 10, 2, 100, 300, 192, 128, [260, 300], 200),  # q_offset > 0, GQA
    (2, 4, 2, 70, 70, 24, 16, [70, 9], 0),        # the smoke pair, G 2, ragged
    (1, 8, 1, 512, 512, 24, 16, None, 0),         # split 8 at (24, 16)
    (3, 6, 3, 150, 150, 24, 16, [0, 1, 150], 0),  # kv_len 0 and 1
]


@pytest.mark.parametrize("b, hq, hk, sq, skv, d, dv, lens, q_offset", CASES)
def test_bwd_kernel_matches_plain(card, b, hq, hk, sq, skv, d, dv, lens, q_offset):
    q, k, v, do = _inputs(card, 0, b, hq, hk, sq, skv, d, dv)
    kv_lens = torch.tensor(lens if lens else [skv] * b, dtype=torch.int32, device=card)
    kw = dict(causal=True, sm_scale=d ** -0.5, q_offset=q_offset)
    out, lse = fa_ops.flash_fwd(q, k, v, kv_lens, block_k=64, return_lse=True, **kw)
    assert torch.equal(out, fa_ops.flash_fwd(q, k, v, kv_lens, block_k=64, **kw))
    want_out, want_lse = flash_fwd_ref(q, k, v, kv_lens, block_q=64, block_k=64,
                                       return_lse=True, **kw)
    assert torch.allclose(lse, want_lse, rtol=1e-5, atol=1e-5), float((lse - want_lse).abs().max())
    launches = _pass_launches()
    got = fa_ops.flash_bwd(q, k, v, kv_lens, out, lse, do, **kw)
    key = fa_ops.bwd_key_passes(d, dv)
    assert _pass_launches() == tuple(
        n + (p == fa_ops.BWD_DQ or p in key) for p, n in enumerate(launches))
    want = flash_bwd_ref(q, k, v, kv_lens, out, lse, do, block_q=64, block_k=64, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        w = w.float().cpu().numpy()
        assert_within_bf16_ulp(g.float().cpu().numpy(), w,
                               atol=GRAD_ATOL * float(abs(w).max() + 1e-30))
    again = fa_ops.flash_bwd(q, k, v, kv_lens, out, lse, do, **kw)
    for g, a in zip(got, again):
        assert torch.equal(g, a)  # the sum order is fixed: the same bits


@pytest.mark.parametrize("d, dv", fa_ops.BWD_HEAD_DIMS)
def test_bwd_every_head_dim(card, d, dv):
    """Every (key dim, value dim) pair the backward is built for (one panel
    of 64 columns up to 64, two past it, three at DK 192), G 2 with a ragged
    batch, two runs the same bits."""
    test_bwd_kernel_matches_plain(card, 2, 4, 2, 100, 100, d, dv, [100, 70], 0)


@pytest.mark.parametrize("d, dv", fa_ops.BWD_HEAD_DIMS)
def test_library_builds_the_mirrors_passes(card, d, dv):
    """The library has a kernel for the dq pass and for each of the key
    side's passes ``ops.bwd_key_passes`` names at (d, dv), and none for the
    others (``flash_bwd_smem_bytes`` 0); each fits a block's shared memory
    and the card holds at least one block of it an SM."""
    import ctypes

    lib = fa_ops.BWD_LIBRARY.load()
    runs = (fa_ops.BWD_DQ,) + fa_ops.bwd_key_passes(d, dv)
    for pass_no in (fa_ops.BWD_DQ, fa_ops.BWD_DKDV, fa_ops.BWD_DV, fa_ops.BWD_DK):
        smem = lib.flash_bwd_smem_bytes(pass_no, d, dv)
        assert (smem > 0) == (pass_no in runs), (pass_no, smem)
        if pass_no in runs:
            blocks = ctypes.c_int()
            assert lib.flash_bwd_occupancy(pass_no, d, dv, ctypes.byref(blocks)) == 0
            assert blocks.value >= 1 and smem <= fa_ops.MAX_SMEM_PER_BLOCK
    assert lib.flash_bwd_smem_bytes(fa_ops.BWD_DQ, 192, 192) == 0


@pytest.mark.parametrize("b, hq, hk, sq, skv, d, dv, lens, q_offset", CASES)
def test_library_plan_matches_mirror(card, b, hq, hk, sq, skv, d, dv, lens, q_offset):
    """The library's grid and cluster for each pass (``flash_bwd_plan``) are
    ``ops.bwd_grid``'s, the CPU mirror the plan tests hold."""
    import ctypes

    lib = fa_ops.BWD_LIBRARY.load()
    for pass_no in (fa_ops.BWD_DQ,) + fa_ops.bwd_key_passes(d, dv):
        out = (ctypes.c_int * 4)()
        assert lib.flash_bwd_plan(pass_no, b, hk, hq // hk, sq, skv, q_offset, 1, out) == 0
        assert tuple(out) == fa_ops.bwd_grid(pass_no, b, hk, hq // hk, sq, skv, q_offset, True)


@pytest.mark.parametrize("b, hq, hk, s, lens, nan_from", [
    (2, 4, 2, 96, [96, 40], 40),         # the tile that straddles kv_len is the first
    (2, 10, 2, 600, [600, 450], 450),    # G 5, the dk/dv pass cut in chunks, tile 7 straddles
])
def test_bwd_ignores_nan_in_the_straddling_tile(card, b, hq, hk, s, lens, nan_from):
    """K and V hold NaN from kv_len on, inside the tile that straddles it: dq
    and the keys below kv_len are unchanged bit for bit in both passes, and
    dk and dv past kv_len are 0."""
    q, k, v, do = _inputs(card, 4, b, hq, hk, s, s, 64)
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=card)
    kw = dict(causal=True, sm_scale=0.125, q_offset=0)
    out, lse = fa_ops.flash_fwd(q, k, v, kv_lens, block_k=64, return_lse=True, **kw)
    clean = fa_ops.flash_bwd(q, k, v, kv_lens, out, lse, do, **kw)
    k2, v2 = k.clone(), v.clone()
    k2[-1, :, nan_from:] = float("nan")
    v2[-1, :, nan_from:] = float("nan")
    dirty = fa_ops.flash_bwd(q, k2, v2, kv_lens, out, lse, do, **kw)
    assert torch.equal(clean[0], dirty[0])
    assert torch.equal(clean[1][..., :nan_from, :], dirty[1][..., :nan_from, :])
    assert torch.equal(clean[2][..., :nan_from, :], dirty[2][..., :nan_from, :])
    assert not bool(dirty[1][-1, :, nan_from:].any()) and not bool(dirty[2][-1, :, nan_from:].any())


def test_bwd_ignores_nan_past_kv_len(card):
    q, k, v, do = _inputs(card, 1, 2, 4, 2, 96, 96, 64)
    kv_lens = torch.tensor([96, 40], dtype=torch.int32, device=card)
    kw = dict(causal=True, sm_scale=0.125, q_offset=0)
    out, lse = fa_ops.flash_fwd(q, k, v, kv_lens, block_k=64, return_lse=True, **kw)
    clean = fa_ops.flash_bwd(q, k, v, kv_lens, out, lse, do, **kw)
    k2, v2 = k.clone(), v.clone()
    k2[1, :, 40:] = float("nan")
    v2[1, :, 40:] = float("nan")
    dirty = fa_ops.flash_bwd(q, k2, v2, kv_lens, out, lse, do, **kw)
    assert torch.equal(clean[0], dirty[0])
    assert torch.equal(clean[1][:, :, :40], dirty[1][:, :, :40])
    assert torch.equal(clean[2][:, :, :40], dirty[2][:, :, :40])
    assert not bool(clean[1][1, :, 40:].any()) and not bool(dirty[2][1, :, 40:].any())


@pytest.mark.parametrize("d, dv", [(64, 64), (192, 128)])
def test_autograd_runs_both_kernels(card, d, dv):
    """Autograd runs K3 and K3-bwd: the dq pass and the key side's pass or
    passes, once each; the gradients are ``flash_bwd``'s bits."""
    q, k, v, do = _inputs(card, 2, 2, 8, 2, 64, 64, d, dv)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = (fa_ops.flash_fwd.launches, *_pass_launches())
    out = fa_ops.flash_attention(q, k, v, block_q=64, block_k=64)
    out.backward(do)
    after = (fa_ops.flash_fwd.launches, *_pass_launches())
    key = fa_ops.bwd_key_passes(d, dv)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1) + tuple(
        int(p in key) for p in sorted(fa_ops.BWD_KEY_WRAPPERS))
    with torch.no_grad():
        lens = torch.full((2,), 64, dtype=torch.int32, device=card)
        o, lse = fa_ops.flash_fwd(q, k, v, lens, sm_scale=d ** -0.5, block_k=64, return_lse=True)
        want = fa_ops.flash_bwd(q, k, v, lens, o, lse, do, sm_scale=d ** -0.5)
    for g, w in zip((q.grad, k.grad, v.grad), want):
        assert torch.equal(g, w)


def test_bwd_runs_mla_dims(card):
    """MLA's (192, 128), which the backward refused before it was built for
    it: 128 heads at S 128, within the tolerance of the plain version, dk
    and dv from the dv and the dk pass, one launch each."""
    test_bwd_kernel_matches_plain(card, 2, 128, 128, 128, 128, 192, 128, [128, 50], 0)


@pytest.mark.parametrize("d, dv", [(192, 192), (128, 64), (256, 256), (40, 40)])
def test_bwd_refuses_dims_outside_the_table(card, d, dv):
    q = torch.zeros(1, 2, 16, d, dtype=torch.bfloat16, device=card)
    v = torch.zeros(1, 2, 16, dv, dtype=torch.bfloat16, device=card)
    lens = torch.full((1,), 16, dtype=torch.int32, device=card)
    lse = torch.zeros(1, 2, 16, device=card)
    with pytest.raises(ValueError, match="the backward is built for"):
        fa_ops.flash_bwd(q, q.clone(), v, lens, torch.zeros_like(v), lse, torch.zeros_like(v),
                         sm_scale=0.1)
