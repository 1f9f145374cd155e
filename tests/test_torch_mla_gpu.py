"""The deepseek-v2 slice's kernels on the card: K2's MLA latent form
(paged_latent_decode; at lengths 0, 1, full, at its 192-position split
boundaries and one past them, over one and two 64-head groups) and K3 with a
value dim other than its key dim (flash_fwd at (192, 128) and (24, 16), at
block_k 16 and 64, with NaN past kv_len) against their plain versions; the
latent form's rows bit for bit alone and in a batch of 8, unchanged by NaN
past the lengths and in unused pages, and the same over two launches; the
roofline's shared-memory mirrors equal to the kernels' own at every
candidate it keeps, and the latent kernel taking every pages_per_program the
roofline keeps, with the same bits (its tile does not follow it); the MoE's row stability on the card; and the smoke
deepseek-v2 engine through the kernels.

Marked ``gpu``: without a CUDA device each test skips from inside itself, so
every worker collects the same tests.  Run on the card with
``PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_mla_gpu.py``
(that machine has no JAX).

Tolerance, kernels against their plain versions: both run float32
arithmetic on bf16 inputs, summed in another order, and round the output to
bf16 once, so one bf16 ulp of the output plus 2^-14 of max|v| (v is the
latent pool for K2's latent form; chip_smoke.py states the reason).  The
MoE's row stability is bitwise.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import assert_within_bf16_ulp, check_prefix_reuse_across_row_blocks
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_fwd_ref
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.tune import candidates_for, ragged_lengths
from repro_torch.kernels.tune.roofline import prune
from repro_torch.kernels.tune import roofline
from repro_torch.launch import serve as serve_cli
from repro_torch.models import moe
from repro_torch.models.model import LM

pytestmark = pytest.mark.gpu
V_ATOL = 2.0 ** -14  # of max|v|
ARCH = "deepseek-v2-236b"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bf16(gen, *shape):
    return torch.randn(shape, generator=gen, device=gen.device).to(torch.bfloat16)


LATENT_CASES = [  # b, h, r, dr, page, npp, lengths (None: ragged_lengths), ppp
    (8, 128, 512, 64, 16, 68, None, 4),          # deepseek-v2's decode shape
    (8, 128, 512, 64, 16, 68, None, 8),          # the plain version's 128-position groups
    (4, 128, 512, 64, 16, 68, [0, 1, 1088, 1000], 4),   # empty, one, full, not x 64
    (3, 20, 512, 64, 16, 9, [144, 77, 1], 2),    # heads not a multiple of 8
    (2, 4, 16, 8, 16, 6, [96, 21], 4),           # the smoke widths
    # at split boundaries (192 positions from position 0) and one past them
    (8, 128, 512, 64, 16, 68, [192, 193, 384, 385, 576, 577, 191, 1088], 4),
    (8, 128, 512, 64, 16, 68, [192, 193, 384, 385, 576, 577, 191, 1088], 3),
    (4, 70, 16, 8, 16, 30, [192, 193, 384, 385], 1),   # two head groups, the smoke widths
    # pages of 32 and of 8 positions at the default pages_per_program (4):
    # the serve CLI's --page-size 32, and tiles that cut pages or span eight
    (8, 128, 512, 64, 32, 34, None, fd_ops.DEFAULT_PAGES_PER_PROGRAM),
    (4, 128, 512, 64, 8, 136, [1088, 577, 64, 9], fd_ops.DEFAULT_PAGES_PER_PROGRAM),
    (2, 4, 16, 8, 32, 4, [128, 33], fd_ops.DEFAULT_PAGES_PER_PROGRAM),
]


def _latent_inputs(card, b, h, r, dr, page, npp, lengths, seed):
    """bf16 q_lat, q_pe and pools (page 0 the scratch page), shuffled page
    tables and int32 lengths (``ragged_lengths`` where None)."""
    gen = torch.Generator(device=card).manual_seed(seed)
    n_pages = 1 + b * npp
    q_lat, q_pe = _bf16(gen, b, h, r), _bf16(gen, b, h, dr)
    ckv, kpe = _bf16(gen, n_pages, page, r), _bf16(gen, n_pages, page, dr)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(0)) + 1
    tables = perm[: b * npp].reshape(b, npp).to(torch.int32).to(card)
    lens = torch.tensor(ragged_lengths(b, npp * page) if lengths is None else lengths,
                        dtype=torch.int32, device=card)
    return q_lat, q_pe, ckv, kpe, lens, tables


@pytest.mark.parametrize("b, h, r, dr, page, npp, lengths, ppp", LATENT_CASES)
def test_latent_decode_kernel_matches_plain(card, b, h, r, dr, page, npp, lengths, ppp):
    q_lat, q_pe, ckv, kpe, lens, tables = _latent_inputs(card, b, h, r, dr, page, npp,
                                                         lengths, b * h + ppp)
    scale = 192 ** -0.5
    fd_ops.paged_latent_decode.launches = 0
    got = fd_ops.paged_latent_decode(q_lat, q_pe, ckv, kpe, lens, tables, scale=scale,
                                     pages_per_program=ppp)
    torch.cuda.synchronize()
    assert fd_ops.paged_latent_decode.launches == 1
    want = fd_ops.paged_latent_decode_attention(q_lat, q_pe, ckv, kpe, lens, tables,
                                                sm_scale=scale, impl="stream",
                                                pages_per_program=ppp)
    assert got.shape == (b, h, r) and torch.isfinite(got.float()).all()
    assert_within_bf16_ulp(got.float().cpu().numpy(), want.float().cpu().numpy(),
                           atol=V_ATOL * float(ckv.float().abs().max()))
    for i, n in enumerate(lens.tolist()):
        if n == 0:
            assert not got[i].float().abs().any()


@pytest.mark.parametrize("dk, dv, h, s, lens", [
    (192, 128, 128, 1024, [1000]),   # deepseek-v2's prefill heads at one block
    (192, 128, 4, 77, [77, 40]),
    (24, 16, 4, 40, [40, 13]),        # the smoke widths
])
def test_flash_fwd_value_dim_matches_plain(card, dk, dv, h, s, lens):
    gen = torch.Generator(device=card).manual_seed(dk + s)
    b = len(lens)
    q, k, v = _bf16(gen, b, h, s, dk), _bf16(gen, b, h, s, dk), _bf16(gen, b, h, s, dv)
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=card)
    got = fa_ops.flash_fwd(q, k, v, kv_lens, sm_scale=dk ** -0.5)
    torch.cuda.synchronize()
    want = flash_fwd_ref(q, k, v, kv_lens, causal=True, sm_scale=dk ** -0.5, q_offset=0,
                         block_q=16, block_k=16)
    assert got.shape == (b, h, s, dv)
    assert_within_bf16_ulp(got.float().cpu().numpy(), want.float().cpu().numpy(),
                           atol=V_ATOL * float(v.float().abs().max()))


@pytest.mark.parametrize("block_k", [16, 64])
@pytest.mark.parametrize("dk, dv, h, g", [(192, 128, 4, 1), (24, 16, 2, 2)])
def test_flash_fwd_value_dim_past_kv_len(card, dk, dv, h, g, block_k):
    """K3 at deepseek-v2's pair and its smoke pair (DK 24 padded to 32 in
    the kernel), at both online-softmax steps, with q_offset > 0, kv_lens <
    Skv and NaN in K and V at and past each kv_len."""
    gen = torch.Generator(device=card).manual_seed(dk + block_k)
    b, sq, skv, q_offset, lens = 2, 140, 260, 110, [250, 133]
    q, k = _bf16(gen, b, h * g, sq, dk), _bf16(gen, b, h, skv, dk)
    v = _bf16(gen, b, h, skv, dv)
    want = flash_fwd_ref(q, k, v, torch.tensor(lens), causal=True, sm_scale=dk ** -0.5,
                         q_offset=q_offset, block_q=16, block_k=block_k)
    for i, n in enumerate(lens):
        k[i, :, n:] = float("nan")
        v[i, :, n:] = float("nan")
    got = fa_ops.flash_fwd(q, k, v, torch.tensor(lens, dtype=torch.int32, device=card),
                           sm_scale=dk ** -0.5, q_offset=q_offset, block_k=block_k)
    torch.cuda.synchronize()
    assert got.shape == (b, h * g, sq, dv) and torch.isfinite(got.float()).all()
    assert_within_bf16_ulp(got.float().cpu().numpy(), want.float().cpu().numpy(),
                           atol=V_ATOL * float(v.float().nan_to_num(0.0).abs().max()))


def test_shared_memory_mirrors_and_refusals(card):
    """The roofline's formulas (shared memory, the latent form's splits)
    equal the kernels' exports; at deepseek-v2's decode shape the roofline
    keeps every pages_per_program, and the latent wrapper takes each and
    gives the same bits (its tile is 64 positions whatever the value)."""
    lat = fd_ops.LATENT_LIBRARY.load()
    k3 = fa_ops.LIBRARY.load()
    for r, dr in fd_ops.LATENT_WIDTHS:
        assert lat.paged_latent_decode_smem_bytes(r, dr) == roofline.latent_smem_bytes(r, dr)
    for capacity in (1, 64, 192, 193, 1088, 4096):
        assert lat.paged_latent_decode_splits(capacity) == roofline.latent_splits(capacity)
    for dk, dv in ((192, 128), (24, 16), (128, 128)):
        for bk in (16, 64):
            assert k3.flash_fwd_smem_bytes(1, dk, dv, bk) == roofline.k3_smem_bytes(1, dk, bk, dv)
    shape = fd_ops.latent_shape(2, 128, 512, 64, 16, 68)
    gen = torch.Generator(device=card).manual_seed(3)
    n_pages = 1 + 2 * 68
    args = (_bf16(gen, 2, 128, 512), _bf16(gen, 2, 128, 64), _bf16(gen, n_pages, 16, 512),
            _bf16(gen, n_pages, 16, 64), torch.tensor([300, 1088], dtype=torch.int32,
                                                      device=card),
            (torch.arange(2 * 68, dtype=torch.int32, device=card) + 1).reshape(2, 68))
    first = None
    for config in candidates_for("flash_decode_paged", shape):
        assert roofline.estimate("flash_decode_paged", shape, config, "bfloat16").fits
        got = fd_ops.paged_latent_decode(*args, scale=0.1, **config)
        first = got if first is None else first
        assert torch.equal(got, first), config
    torch.cuda.synchronize()


@pytest.mark.parametrize("r, dr, npp", [(512, 64, 68), (16, 8, 6), (16, 8, 30)])
def test_latent_smem_mirror_for_every_kept_candidate(card, r, dr, npp):
    """For every pages_per_program the roofline keeps at a latent shape, the
    kernel's shared memory equals the roofline's mirror, and the kernel
    runs there against the plain version."""
    shape = fd_ops.latent_shape(2, 128, r, dr, 16, npp)
    kept, _ = prune("flash_decode_paged", shape, candidates_for("flash_decode_paged", shape),
                    "bfloat16")
    lib = fd_ops.LATENT_LIBRARY.load()
    args = _latent_inputs(card, 2, 128, r, dr, 16, npp, [npp * 16, npp * 8 + 3], r + npp)
    for est in kept:
        ppp = est.config["pages_per_program"]
        assert lib.paged_latent_decode_smem_bytes(r, dr) == est.smem_bytes == \
            roofline.latent_smem_bytes(r, dr)
        got = fd_ops.paged_latent_decode(*args, scale=0.1, pages_per_program=ppp)
        want = fd_ops.paged_latent_decode_attention(*args, sm_scale=0.1, impl="stream",
                                                    pages_per_program=ppp)
        assert_within_bf16_ulp(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=V_ATOL * float(args[2].float().abs().max()))


@pytest.mark.parametrize("r, dr", [(512, 64), (16, 8)])
def test_latent_decode_row_alone_equals_in_batch(card, r, dr):
    """A row's bits depend on its own length and the blocking only: each row
    alone (B 1) equals its row in a batch of 8, bit for bit."""
    args = _latent_inputs(card, 8, 128, r, dr, 16, 68, [1088, 500, 193, 7, 1000, 0, 384, 66], 5)
    full = fd_ops.paged_latent_decode(*args, scale=0.07, pages_per_program=4)
    for i in range(8):
        one = fd_ops.paged_latent_decode(*(x[i:i + 1] if x.shape[0] == 8 else x for x in args),
                                         scale=0.07, pages_per_program=4)
        assert torch.equal(one[0], full[i]), f"row {i}"


@pytest.mark.parametrize("r, dr, ppp", [(512, 64, 4), (512, 64, 3), (16, 8, 1)])
def test_latent_decode_ignores_nan_past_lengths_and_repeats_bitwise(card, r, dr, ppp):
    """NaN in every pool position past each row's length, in the unused
    pages and in the scratch page leaves the output unchanged bit for bit
    (nothing is read there); two launches give the same bits."""
    b, npp, page = 6, 40, 16
    lengths = [0, 1, 192, 193, 450, 640]
    q_lat, q_pe, ckv, kpe, lens, tables = _latent_inputs(card, b, 128, r, dr, page, npp,
                                                         lengths, 11 + ppp)
    first = fd_ops.paged_latent_decode(q_lat, q_pe, ckv, kpe, lens, tables, scale=0.07,
                                       pages_per_program=ppp)
    again = fd_ops.paged_latent_decode(q_lat, q_pe, ckv, kpe, lens, tables, scale=0.07,
                                       pages_per_program=ppp)
    assert torch.equal(first, again)
    live = torch.zeros(ckv.shape[:2], dtype=torch.bool, device=card)
    for i, n in enumerate(lengths):
        pos = torch.arange(n, device=card)
        live[tables[i, pos // page].long(), pos % page] = True
    ckv[~live] = float("nan")
    kpe[~live] = float("nan")
    assert not live[0].any() and bool(torch.isnan(ckv[0]).all())
    got = fd_ops.paged_latent_decode(q_lat, q_pe, ckv, kpe, lens, tables, scale=0.07,
                                     pages_per_program=ppp)
    torch.cuda.synchronize()
    assert torch.equal(got, first)
    assert not got[0].float().abs().any()


def test_moe_rows_do_not_depend_on_the_other_tokens_on_the_card(card):
    """bf16, full-width experts cut to 8: tokens 10..14 of a 64-token
    dispatch give the same bits whatever the other tokens are."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), d_model=512,
                              moe=dataclasses.replace(get_smoke_config(ARCH).moe,
                                                      n_routed_experts=8, top_k=6,
                                                      expert_d_ff=256))
    gen = torch.Generator(device=card).manual_seed(4)
    p = {name: (torch.randn(shape, generator=gen, device=card) * scale).to(
        torch.float32 if name in moe.FLOAT32_PARAMS else torch.bfloat16)
        for name, (shape, _, scale) in moe.moe_shapes(cfg).items()}
    x, other = _bf16(gen, 1, 64, 512), _bf16(gen, 1, 64, 512)
    keep = slice(10, 15)
    want = moe.apply_moe(p, x, cfg)[:, keep]
    mixed = other.clone()
    mixed[:, keep] = x[:, keep]
    assert torch.equal(moe.apply_moe(p, mixed, cfg)[:, keep], want)


def test_smoke_engine_on_the_card(card, capsys):
    fa_ops.flash_fwd.launches = fd_ops.paged_latent_decode.launches = 0
    fd_ops.paged_decode.launches = 0
    result = serve_cli.main(["--arch", ARCH, "--smoke", "--continuous"])
    assert "bit_identical=yes" in capsys.readouterr().out
    assert result["served"] == 8
    n_layers = get_smoke_config(ARCH).n_layers
    stats = [e.stats() for e in result["engines"]]
    assert fa_ops.flash_fwd.launches == n_layers * sum(s["prefills_run"] for s in stats)
    assert fd_ops.paged_latent_decode.launches == \
        n_layers * sum(s["decode_steps"] for s in stats)
    assert fd_ops.paged_decode.launches == 0
    assert np.isfinite(result["planner"].step_time(4))


def test_smoke_engine_prefix_reuse_across_row_blocks_on_the_card(card):
    lm = LM(get_smoke_config(ARCH), device=card).init_params(
        torch.Generator(device=card).manual_seed(0))
    check_prefix_reuse_across_row_blocks(lm)
