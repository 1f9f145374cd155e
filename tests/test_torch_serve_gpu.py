"""The serve slice's kernels on the card: K3 (flash_fwd) and K2
(paged_decode) against their plain versions, and the smoke engine through
them.  K3 runs on the tensor cores (wgmma): one 64 x 64 tile of each of its
products is held against torch.matmul first, then the kernel at the engine's
block_k 16 and at 64, with NaN in K and V past kv_len, and its rows bit for bit
across Sq.  K2 is split-KV: lengths 0, 1, one split exactly and a full
1088-position row, a row's bits alone and in a batch of 8, and NaN past a
row's length.

Marked ``gpu``: without a CUDA device each test skips from inside itself, so
every worker collects the same tests.  Run on the card with
``PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_serve_gpu.py``
(that machine has no JAX).

Tolerance: the plain versions run float32 arithmetic on bf16 inputs; K2
does the same in another order, and K3 multiplies on the tensor cores (exact
bf16 products, float32 sums) with p carried as two bf16 values within 2^-17 of
it.  Both round the output to bf16 once.  The float32 difference can move
that rounding by one step, and is itself an absolute error of about sqrt(n)
float32 epsilons of max|v| over n keys, several ulps of an output that is
near 0 by cancellation; so one bf16 ulp of the output plus 2^-14 of max|v|
(chip_smoke.py states the same limit).  The tile probe: S against
torch.matmul within 2 DK 2^-24 of the largest sum of |q||k| (two float32 sums
of DK products, each within DK float32 epsilons of it); P V within 2^-16 of
max|v| times the largest row sum of p (the split's 2^-17 and the float32
sums).
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import numpy as np
import pytest
import torch

from _torch_parity import assert_within_bf16_ulp, check_prefix_reuse_across_row_blocks
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_fwd_ref
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode.ref import paged_decode_stream
from repro_torch.launch import serve as serve_cli
from repro_torch.models.model import LM

pytestmark = pytest.mark.gpu
V_ATOL = 2.0 ** -14  # of max|v|


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bf16(gen, *shape):
    return torch.randn(shape, generator=gen, device=gen.device).to(torch.bfloat16)


@pytest.mark.parametrize("b, hk, g, sq, skv, d, lens, q_offset", [
    (2, 2, 2, 33, 33, 16, None, 0),          # the smoke config's heads
    (1, 8, 5, 17, 17, 128, None, 0),         # qwen3-14b's heads
    (2, 2, 5, 21, 53, 64, [50, 37], 29),     # q_offset > 0, kv_lens < Skv
    (1, 1, 1, 1, 1, 256, None, 0),
    (8, 24, 1, 192, 192, 64, None, 0),       # musicgen-medium's training rows: 64 + 128
    (1, 8, 8, 1024, 1024, 128, [290], 0),    # internvl2-76b's prefill block: 256 + 34
])
def test_flash_fwd_kernel_matches_plain(card, b, hk, g, sq, skv, d, lens, q_offset):
    gen = torch.Generator(device=card).manual_seed(sq * d)
    q, k, v = _bf16(gen, b, hk * g, sq, d), _bf16(gen, b, hk, skv, d), _bf16(gen, b, hk, skv, d)
    kv_lens = torch.tensor(lens or [skv] * b, dtype=torch.int32, device=card)
    before = fa_ops.flash_fwd.launches
    got = fa_ops.flash_fwd(q, k, v, kv_lens, sm_scale=d ** -0.5, q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa_ops.flash_fwd.launches == before + 1
    want = flash_fwd_ref(q, k, v, kv_lens, causal=True, sm_scale=d ** -0.5,
                         q_offset=q_offset, block_q=16, block_k=16)
    assert_within_bf16_ulp(got.float().cpu().numpy(), want.float().cpu().numpy(),
                           atol=V_ATOL * float(v.float().abs().max()))


def test_flash_fwd_rows_do_not_depend_on_sq(card):
    """Sq from 1 to 200 spans one to four 64-row warpgroup tiles and two
    128-row blocks; a row's bits stay the same."""
    gen = torch.Generator(device=card).manual_seed(0)
    q, k, v = _bf16(gen, 1, 10, 200, 128), _bf16(gen, 1, 2, 200, 128), _bf16(gen, 1, 2, 200, 128)
    full = fa_ops.flash_attention(q, k, v)
    for sq in (1, 37, 41, 96):
        part = fa_ops.flash_attention(q[:, :, :sq].contiguous(), k[:, :, :sq].contiguous(),
                                      v[:, :, :sq].contiguous())
        assert torch.equal(part, full[:, :, :sq])


def test_wgmma_tile_matches_matmul(card):
    """One 64 x 64 tile of each of K3's products through the kernel's own
    staging, shared-memory descriptors and wgmma calls (flash_fwd_tile_probe):
    S = Q K^T against torch.matmul in float32, and P V with p split into
    bf16 hi + lo against the float64 product."""
    lib = fa_ops.LIBRARY.load()
    gen = torch.Generator(device=card).manual_seed(3)
    for dk, dv in ((128, 128), (192, 128), (24, 16)):
        q, k, v = _bf16(gen, 64, dk), _bf16(gen, 64, dk), _bf16(gen, 64, dv)
        p = torch.rand((64, 64), generator=gen, device=card)
        s_out = torch.full((64, 64), float("nan"), device=card)
        o_out = torch.full((64, dv), float("nan"), device=card)
        err = lib.flash_fwd_tile_probe(q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
                                       s_out.data_ptr(), o_out.data_ptr(), dk, dv,
                                       torch.cuda.current_stream().cuda_stream)
        fa_ops.LIBRARY.check(err, "flash_fwd tile probe")
        torch.cuda.synchronize()
        want_s = torch.matmul(q.float(), k.float().T)
        scale_s = float((q.float().abs() @ k.float().abs().T).max())
        assert float((s_out - want_s).abs().max()) <= 2 * dk * 2.0 ** -24 * scale_s
        want_o = p.double() @ v.double()
        assert float((o_out.double() - want_o).abs().max()) <= \
            2.0 ** -16 * float(v.float().abs().max()) * float(p.sum(1).max())


@pytest.mark.parametrize("block_k", [16, 64])
def test_flash_fwd_kernel_matches_plain_past_kv_len(card, block_k):
    """qwen3-14b's heads (G 5, d 128) at both online-softmax steps, with
    q_offset > 0, kv_lens < Skv and NaN in K and V at and past each kv_len."""
    gen = torch.Generator(device=card).manual_seed(block_k)
    b, hk, g, sq, skv, d, q_offset, lens = 2, 2, 5, 150, 300, 128, 140, [290, 171]
    q, k, v = _bf16(gen, b, hk * g, sq, d), _bf16(gen, b, hk, skv, d), _bf16(gen, b, hk, skv, d)
    want = flash_fwd_ref(q, k, v, torch.tensor(lens), causal=True, sm_scale=d ** -0.5,
                         q_offset=q_offset, block_q=16, block_k=block_k)
    for i, n in enumerate(lens):
        k[i, :, n:] = float("nan")
        v[i, :, n:] = float("nan")
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=card)
    got = fa_ops.flash_fwd(q, k, v, kv_lens, sm_scale=d ** -0.5, q_offset=q_offset,
                           block_k=block_k)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert_within_bf16_ulp(got.float().cpu().numpy(), want.float().cpu().numpy(),
                           atol=V_ATOL * float(v.float().nan_to_num(0.0).abs().max()))


def test_paged_decode_kernel_matches_plain(card):
    gen = torch.Generator(device=card).manual_seed(1)
    b, hk, g, d, page, n_pages, npp = 5, 8, 5, 128, 16, 64, 9
    q = _bf16(gen, b, hk, g, d)
    kp, vp = _bf16(gen, n_pages, hk, page, d), _bf16(gen, n_pages, hk, page, d)
    lengths = torch.tensor([1, 17, 64, 130, 144], dtype=torch.int32, device=card)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(0)) + 1
    tables = perm[: b * npp].reshape(b, npp).to(torch.int32).to(card)
    tables[0] = 0  # a scratch row, as an idle slot
    before = fd_ops.paged_decode.launches
    got = fd_ops.paged_decode(q, kp, vp, lengths, tables, scale=d ** -0.5, pages_per_program=4)
    torch.cuda.synchronize()
    assert fd_ops.paged_decode.launches == before + 1
    want = paged_decode_stream(q, kp, vp, lengths, tables, scale=d ** -0.5,
                               pages_per_program=4)
    assert torch.isfinite(got.float()).all()
    assert_within_bf16_ulp(got.float().cpu().numpy(), want.float().cpu().numpy(),
                           atol=V_ATOL * float(vp.float().abs().max()))


def _paged_case(gen, card, b, npp, lengths, hk=8, g=5, d=128, page=16):
    n_pages = 1 + b * npp
    q = _bf16(gen, b, hk, g, d)
    kp, vp = _bf16(gen, n_pages, hk, page, d), _bf16(gen, n_pages, hk, page, d)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(b)) + 1
    tables = perm[: b * npp].reshape(b, npp).to(torch.int32).to(card)
    return q, kp, vp, torch.tensor(lengths, dtype=torch.int32, device=card), tables


# lengths 0 and 1, one split exactly (3 groups of 4 pages of 16: 192
# positions), one more, a full 1088-position row, and ragged ones
SPLIT_LENGTHS = [0, 1, 192, 193, 1088, 700, 64, 1000]


@pytest.mark.parametrize("ppp", [4, 1, 8])
def test_paged_decode_split_kv_matches_plain(card, ppp):
    gen = torch.Generator(device=card).manual_seed(10 + ppp)
    q, kp, vp, lens, tables = _paged_case(gen, card, 8, 68, SPLIT_LENGTHS)
    fd_ops.paged_decode.launches = 0
    got = fd_ops.paged_decode(q, kp, vp, lens, tables, scale=128 ** -0.5, pages_per_program=ppp)
    torch.cuda.synchronize()
    assert fd_ops.paged_decode.launches == 1  # the split and combine kernels: one call
    want = paged_decode_stream(q, kp, vp, lens, tables, scale=128 ** -0.5, pages_per_program=ppp)
    assert torch.isfinite(got.float()).all() and not got[0].float().abs().any()
    assert_within_bf16_ulp(got.float().cpu().numpy(), want.float().cpu().numpy(),
                           atol=V_ATOL * float(vp.float().abs().max()))


@pytest.mark.parametrize("hk, g, d", [(8, 8, 128), (24, 1, 64)])
def test_paged_decode_at_the_frontend_archs_heads(card, hk, g, d):
    """K2 at internvl2-76b's 64 query heads over 8 KV heads (G 8, D 128)
    and musicgen-medium's 24 heads of MHA (D 64), every split length."""
    gen = torch.Generator(device=card).manual_seed(hk * g)
    q, kp, vp, lens, tables = _paged_case(gen, card, 8, 68, SPLIT_LENGTHS, hk=hk, g=g, d=d)
    fd_ops.paged_decode.launches = 0
    got = fd_ops.paged_decode(q, kp, vp, lens, tables, scale=d ** -0.5, pages_per_program=4)
    torch.cuda.synchronize()
    assert fd_ops.paged_decode.launches == 1
    want = paged_decode_stream(q, kp, vp, lens, tables, scale=d ** -0.5, pages_per_program=4)
    assert torch.isfinite(got.float()).all() and not got[0].float().abs().any()
    assert_within_bf16_ulp(got.float().cpu().numpy(), want.float().cpu().numpy(),
                           atol=V_ATOL * float(vp.float().abs().max()))


def test_paged_decode_row_is_the_same_alone_and_in_a_batch(card):
    gen = torch.Generator(device=card).manual_seed(11)
    q, kp, vp, lens, tables = _paged_case(gen, card, 8, 68, SPLIT_LENGTHS)
    full = fd_ops.paged_decode(q, kp, vp, lens, tables, scale=128 ** -0.5, pages_per_program=4)
    for i in (1, 3, 4, 7):
        one = fd_ops.paged_decode(q[i:i + 1].contiguous(), kp, vp, lens[i:i + 1].contiguous(),
                                  tables[i:i + 1].contiguous(), scale=128 ** -0.5,
                                  pages_per_program=4)
        assert torch.equal(one[0], full[i])


def test_paged_decode_never_reads_past_a_rows_length(card):
    """NaN in every pool position past each row's length, the rest of the
    last page included: the output is finite and the same bits."""
    gen = torch.Generator(device=card).manual_seed(12)
    q, kp, vp, lens, tables = _paged_case(gen, card, 8, 68, SPLIT_LENGTHS)
    want = fd_ops.paged_decode(q, kp, vp, lens, tables, scale=128 ** -0.5, pages_per_program=4)
    live = torch.zeros(kp.shape[0], kp.shape[2], dtype=torch.bool, device=card)
    for i, n in enumerate(lens.tolist()):
        pos = torch.arange(n, device=card)
        live[tables[i].long()[pos // 16], pos % 16] = True
    kp = kp.masked_fill(~live[:, None, :, None], float("nan"))
    vp = vp.masked_fill(~live[:, None, :, None], float("nan"))
    got = fd_ops.paged_decode(q, kp, vp, lens, tables, scale=128 ** -0.5, pages_per_program=4)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all() and torch.equal(got, want)


def test_kernels_reject_what_they_do_not_take(card):
    gen = torch.Generator(device=card).manual_seed(2)
    q, k = _bf16(gen, 1, 2, 8, 16), _bf16(gen, 1, 2, 8, 16)
    lens = torch.tensor([8], dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        fa_ops.flash_fwd(q.float(), k.float(), k.float(), lens, sm_scale=0.25)
    with pytest.raises(ValueError):
        fa_ops.flash_fwd(q, k, k, lens, sm_scale=0.25, block_k=128)
    q48, k48 = _bf16(gen, 1, 2, 100, 16), _bf16(gen, 1, 2, 100, 16)
    with pytest.raises(ValueError, match="block_k"):  # not 16, 32 or 64, and < Skv
        fa_ops.flash_fwd(q48, k48, k48, lens, sm_scale=0.25, block_k=48)
    with pytest.raises(ValueError):  # not contiguous
        fa_ops.flash_fwd(_bf16(gen, 1, 2, 8, 32)[..., :16], k, k, lens, sm_scale=0.25)
    pool = _bf16(gen, 4, 2, 16, 16)
    tables = torch.zeros((1, 2), dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        fd_ops.paged_decode(q[:, :, :1].contiguous(), pool, pool, lens, tables.long(),
                            scale=0.25)
    with pytest.raises(ValueError):
        fd_ops.paged_decode(q[:, :, :1].contiguous(), pool, pool, lens.cpu(), tables,
                            scale=0.25)


def test_smoke_engine_on_the_card(card, capsys):
    fa_ops.flash_fwd.launches = fd_ops.paged_decode.launches = 0
    result = serve_cli.main(["--arch", "qwen3-14b", "--smoke", "--continuous"])
    assert "bit_identical=yes" in capsys.readouterr().out
    assert result["served"] == 8
    n_layers = get_smoke_config("qwen3-14b").n_layers
    stats = [e.stats() for e in result["engines"]]
    assert fa_ops.flash_fwd.launches == n_layers * sum(s["prefills_run"] for s in stats)
    assert fd_ops.paged_decode.launches == n_layers * sum(s["decode_steps"] for s in stats)
    assert np.isfinite(result["planner"].step_time(4))


def test_smoke_engine_prefix_reuse_across_row_blocks_on_the_card(card):
    lm = LM(get_smoke_config("qwen3-14b"), device=card).init_params(
        torch.Generator(device=card).manual_seed(0))
    check_prefix_reuse_across_row_blocks(lm)


def test_smoke_router_and_handoff_on_the_card(card, capsys, tmp_path):
    """The serve CLI's routed fleet with a mid-run handoff and tracing on the
    card: its tokens the single engine's, the kernels launched once a layer
    for every prefill and decode step of every engine the CLI built (the
    handoff's source and destination both), and the spans reconciled with
    the step times."""
    fa_ops.flash_fwd.launches = fd_ops.paged_decode.launches = 0
    result = serve_cli.main(["--arch", "qwen3-14b", "--smoke", "--router", "--replicas", "2",
                             "--migrate-at", "3", "--trace", str(tmp_path / "t.json")])
    out = capsys.readouterr().out
    assert "routed fleet vs single engine: bit_identical=yes" in out
    routed = result["routed"]
    assert routed["bit_identical"] and routed["migration"]["in_flight"] > 0
    engines = [*result["engines"], *routed["router"].engines, *routed["replaced"]]
    assert len({id(e) for e in engines}) == 5
    n_layers = get_smoke_config("qwen3-14b").n_layers
    stats = [e.stats() for e in engines]
    assert fa_ops.flash_fwd.launches == n_layers * sum(s["prefills_run"] for s in stats)
    assert fd_ops.paged_decode.launches == n_layers * sum(s["decode_steps"] for s in stats)
    assert result["trace"]["spans"] > 0 and result["trace"]["reconcile"] <= 0.05


def test_smoke_tp2_on_the_card(card):
    """``--tp 2`` on the card: two ranks sharing it over gloo (or a card
    each over nccl), every engine 2-way; the routed fleet the single TP
    engine's tokens, the ranks' streams the same, and on each rank K3 once a
    layer a prefill and K2 once a layer a decode step at the rank's heads,
    no other kernel."""
    summary = serve_cli.main(["--arch", "qwen3-14b", "--smoke", "--router", "--replicas", "2",
                              "--tp", "2"])
    assert summary["routed_bit_identical"] is True and summary["ranks_same"] is True
    reports = summary["reports"]
    assert [rep["rank"] for rep in reports] == [0, 1]
    assert reports[0]["tokens"] == reports[1]["tokens"]
    assert all(np.array_equal(a, b) for a, b in zip(reports[0]["logits"], reports[1]["logits"]))
    for rep in reports:
        n = rep["n_layers"]
        launches = {k: v for k, v in rep["launches"].items() if v}
        assert launches == {"flash_fwd": n * rep["prefills"],
                            "paged_decode": n * rep["decode_steps"]}, launches
        assert rep["device"].startswith("cuda")
