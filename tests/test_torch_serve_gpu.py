"""The serve slice's kernels on the card: K3 (flash_fwd) and K2
(paged_decode) against their plain versions, and the smoke engine through
them.

Marked ``gpu``: without a CUDA device each test skips from inside itself, so
every worker collects the same tests.  Run on the card with
``PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_serve_gpu.py``
(that machine has no JAX).

Tolerance: kernel and plain version run the same float32 arithmetic on
bf16 inputs, summed in another order, and round the output to bf16 once.
The float32 difference can move that rounding by one step, and is itself an
absolute error of about sqrt(n) float32 epsilons of max|v| over n keys,
several ulps of an output that is near 0 by cancellation; so one bf16 ulp of
the output plus 2^-14 of max|v| (chip_smoke.py states the same limit).
"""
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
    gen = torch.Generator(device=card).manual_seed(0)
    q, k, v = _bf16(gen, 1, 10, 96, 128), _bf16(gen, 1, 2, 96, 128), _bf16(gen, 1, 2, 96, 128)
    full = fa_ops.flash_attention(q, k, v)
    for sq in (1, 37, 41):
        part = fa_ops.flash_attention(q[:, :, :sq].contiguous(), k[:, :, :sq].contiguous(),
                                      v[:, :, :sq].contiguous())
        assert torch.equal(part, full[:, :, :sq])


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


def test_kernels_reject_what_they_do_not_take(card):
    gen = torch.Generator(device=card).manual_seed(2)
    q, k = _bf16(gen, 1, 2, 8, 16), _bf16(gen, 1, 2, 8, 16)
    lens = torch.tensor([8], dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        fa_ops.flash_fwd(q.float(), k.float(), k.float(), lens, sm_scale=0.25)
    with pytest.raises(ValueError):
        fa_ops.flash_fwd(q, k, k, lens, sm_scale=0.25, block_k=128)
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
