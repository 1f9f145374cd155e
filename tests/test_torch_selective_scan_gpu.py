"""The Mamba slice's kernel on the card: K4 (selective_scan) against its
plain version at falcon-mamba-7b's prefill and decode shapes, in place, with
B and C as strided views; what it refuses; and the smoke falcon-mamba engine
through it.

Marked ``gpu``: without a CUDA device each test skips from inside itself, so
every worker collects the same tests.  Run on the card with
``PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_selective_scan_gpu.py``
(that machine has no JAX).

Tolerance: the kernel scans time as an associative scan in fixed tiles of
256 positions (``tests/test_torch_block_scan.py`` models its grouping),
with ex2.approx for the exponential, where the plain version is the serial
loop with the true exp.  The association differs by a few float32 rounding
errors a step, and each enters the state once and decays with it, so over a
channel whose decay is close to 1 (dt |A| of 1e-3 remembers about 1000
steps) they add up like a random walk, to about sqrt(1000) float32
epsilons, 4e-6 of the state's magnitude (the CPU model measures up to 5e-7).
So the state within 2^-13 (1.2e-4) of its largest magnitude, thirty times
that; bf16 outputs within one bf16 ulp (one rounding of a float32 value that
moved) plus 2^-13 of the largest output, float32 outputs within 2^-13 of
the largest (chip_smoke.py states the same limits).  A fault of the kernel
shows as errors of the order of the values.  Bitwise: a padded position
(dt = 0) and a position past S hold every value they meet, so the state
after position n - 1 has the same bits at every padded length; every
d_block (the tuner's knob) gives the same bits.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import numpy as np
import pytest
import torch

from _torch_parity import assert_within_bf16_ulp
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.ssm_scan import ops
from repro_torch.kernels.ssm_scan.ref import selective_scan_ref
from repro_torch.launch import serve as serve_cli
from repro_torch.serve import ServeEngine

pytestmark = pytest.mark.gpu
RTOL_OF_MAX = 2.0 ** -13


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def scan_inputs(gen, bt, s, dn, n, dtype, dtr=8, n_valid=None):
    """Inputs as the model makes them: dt log-uniform in [1e-3, 1e-1] (the
    range dt's bias is drawn from), A = -(1..N), B and C strided views of
    one (Bt, S, dtr + 2N) tensor, a nonzero initial state; dt and x zero
    from ``n_valid`` on, as the engine pads."""
    dev = gen.device
    x = torch.randn((bt, s, dn), generator=gen, device=dev).to(dtype)
    u = torch.rand((bt, s, dn), generator=gen, device=dev)
    dt = torch.exp(u * (np.log(0.1) - np.log(1e-3)) + np.log(1e-3))
    if n_valid is not None:
        x[:, n_valid:] = 0
        dt[:, n_valid:] = 0
    A = -torch.arange(1, n + 1, dtype=torch.float32, device=dev).expand(dn, n).contiguous()
    xdb = torch.randn((bt, s, dtr + 2 * n), generator=gen, device=dev).to(dtype)
    _, B, C = xdb.split([dtr, n, n], dim=-1)
    D = torch.ones(dn, device=dev)
    h0 = 0.1 * torch.randn((bt, dn, n), generator=gen, device=dev)
    return x, dt, A, B, C, D, h0


def check_against_plain(x, dt, A, B, C, D, h0, d_block=ops.DEFAULT_D_BLOCK):
    h = h0.clone()
    before = ops.selective_scan.launches
    y, h_out = ops.selective_scan(x, dt, A, B, C, D, h, d_block=d_block)
    torch.cuda.synchronize()
    assert ops.selective_scan.launches == before + 1
    assert h_out is h
    want_y, want_h = selective_scan_ref(x, dt, A, B, C, D, h0)
    assert torch.isfinite(y.float()).all() and torch.isfinite(h).all()
    h_err = float((h - want_h).abs().max())
    assert h_err <= RTOL_OF_MAX * float(want_h.abs().max()), h_err
    atol = RTOL_OF_MAX * float(want_y.float().abs().max())
    if x.dtype == torch.bfloat16:
        assert_within_bf16_ulp(y.float().cpu().numpy(), want_y.float().cpu().numpy(), atol=atol)
    else:
        assert float((y - want_y).abs().max()) <= atol


@pytest.mark.parametrize("bt, s, dn, n, dtype, n_valid", [
    (1, 1024, 8192, 16, torch.bfloat16, 1000),  # falcon-mamba-7b's prefill, padded tail
    (8, 1, 8192, 16, torch.bfloat16, None),     # its decode step, all slots
    (2, 77, 128, 4, torch.bfloat16, 70),        # the smoke config's state size
    (3, 45, 100, 8, torch.float32, None),       # ragged channel block, float32
    (1, 33, 64, 32, torch.float32, None),
    (1, 1088, 8192, 16, torch.bfloat16, 1000),  # the long run's max_seq: two tiles
    (1, 2048, 1024, 16, torch.bfloat16, 1000),  # eight tiles, the last four padding
    (2, 300, 512, 16, torch.bfloat16, None),    # S not a multiple of the tile
    (1, 96, 8192, 16, torch.bfloat16, 80),      # the serve CLI's max_seq
    (2, 257, 96, 4, torch.bfloat16, None),      # one position past a tile boundary
    (2, 256, 96, 8, torch.bfloat16, None),      # a tile exactly
    (1, 512, 64, 32, torch.bfloat16, 500),      # two tiles at N 32
    (1, 1, 8192, 16, torch.bfloat16, None),     # the decode body, one sequence
    (8, 1, 100, 32, torch.float32, None),       # the decode body, ragged Dn, N 32
])
def test_selective_scan_kernel_matches_plain(card, bt, s, dn, n, dtype, n_valid):
    gen = torch.Generator(device=card).manual_seed(s + dn + n)
    check_against_plain(*scan_inputs(gen, bt, s, dn, n, dtype, n_valid=n_valid))


def test_padding_holds_the_state_bitwise_on_the_card(card):
    """The state after position n - 1 has the same bits whether the prompt
    ends there or is padded (dt = x = 0) to S, within a tile and across tile
    boundaries (1024, 1088 and 2048 positions for n = 1000)."""
    gen = torch.Generator(device=card).manual_seed(0)
    for n_valid, lengths in ((60, (96,)), (1000, (1024, 1088, 2048))):
        x, dt, A, B, C, D, h0 = scan_inputs(gen, 1, max(lengths), 256, 16, torch.bfloat16,
                                            n_valid=n_valid)
        y_cut, h_cut = ops.selective_scan(x[:, :n_valid].contiguous(),
                                          dt[:, :n_valid].contiguous(), A, B[:, :n_valid],
                                          C[:, :n_valid], D, h0.clone())
        for s in lengths:
            y_pad, h_pad = ops.selective_scan(x[:, :s].contiguous(), dt[:, :s].contiguous(), A,
                                              B[:, :s], C[:, :s], D, h0.clone())
            assert torch.equal(h_pad, h_cut), (n_valid, s)
            assert torch.equal(y_pad[:, :n_valid], y_cut), (n_valid, s)


@pytest.mark.parametrize("n", ops.KERNEL_STATE_SIZES)
def test_every_d_block_and_chunk_gives_the_same_bits(card, n):
    """The tuner's candidates (channels a block) and the reference's chunk
    argument leave every bit as it is, at a ragged channel count and across a
    tile boundary, and each agrees with the plain version."""
    gen = torch.Generator(device=card).manual_seed(n)
    x, dt, A, B, C, D, h0 = scan_inputs(gen, 2, 300, 100, n, torch.bfloat16, n_valid=290)
    want = None
    for d_block in ops.KERNEL_D_BLOCKS:
        for chunk in (1, 32, 128):
            h = h0.clone()
            y, _ = ops.selective_scan(x, dt, A, B, C, D, h, chunk=chunk, d_block=d_block)
            torch.cuda.synchronize()
            if want is None:
                want = (y, h)
                check_against_plain(x, dt, A, B, C, D, h0, d_block=d_block)
            assert torch.equal(y, want[0]) and torch.equal(h, want[1]), (d_block, chunk)


def test_selective_scan_kernel_rejects_what_it_does_not_take(card):
    gen = torch.Generator(device=card).manual_seed(1)
    x, dt, A, B, C, D, h0 = scan_inputs(gen, 2, 8, 64, 16, torch.bfloat16)
    before = ops.selective_scan.launches
    bad = [
        (TypeError, dict(dt=dt.to(torch.bfloat16))),              # dt in bf16
        (TypeError, dict(x=x.half(), B=B.half(), C=C.half())),     # fp16
        (TypeError, dict(B=B.float())),                            # B not in x's dtype
        (ValueError, dict(A=A[:, :3].contiguous())),               # N = 3
        (ValueError, dict(x=x.transpose(0, 1).contiguous().transpose(0, 1))),  # strided x
        (ValueError, dict(B=B.transpose(1, 2).contiguous().transpose(1, 2))),  # last stride
        (ValueError, dict(D=D.cpu())),                             # another device
        (ValueError, dict(h=h0[:1])),                              # state of another batch
        (ValueError, dict(d_block=12)),                            # not a compiled blocking
    ]
    base = dict(x=x, dt=dt, A=A, B=B, C=C, D=D, h=h0)
    for error, change in bad:
        with pytest.raises(error):
            ops.selective_scan(**{**base, **change})
    assert ops.selective_scan.launches == before


def test_smoke_mamba_engine_on_the_card(card, capsys):
    ops.selective_scan.launches = 0
    result = serve_cli.main(["--arch", "falcon-mamba-7b", "--smoke", "--continuous"])
    assert "bit_identical=yes" in capsys.readouterr().out
    assert result["served"] == 8
    n_layers = get_smoke_config("falcon-mamba-7b").n_layers
    stats = [e.stats() for e in result["engines"]]
    assert ops.selective_scan.launches == n_layers * sum(
        s["prefills_run"] + s["decode_steps"] for s in stats)


def test_smoke_mamba_full_prompt_reuse_on_the_card(card):
    prompt = np.random.RandomState(5).randint(0, 256, 16).astype(np.int32)
    eng = ServeEngine("falcon-mamba-7b", collect_logits=True, max_batch=2, page_size=8,
                      max_seq=64)
    r1 = eng.submit(prompt, max_new_tokens=4)
    eng.run()
    r2 = eng.submit(prompt, max_new_tokens=4)
    eng.run()
    assert r2.prefill_skipped and r1.generated == r2.generated
    for got, want in zip(r2.logits_trace, r1.logits_trace):
        np.testing.assert_array_equal(got, want)
