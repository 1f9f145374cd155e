"""The tuner slice's kernels on the card: K5 (flash_decode) against its plain
version, with grouped KV, ragged and edge lengths; K4 bit-identical across
every chunk it takes; every K2, K3 and K5 candidate the roofline keeps, at
the tuner's shapes and called as the sweep calls it, against its plain
version; the roofline's shared-memory and split-count mirrors equal to the
kernels' own; and a smoke sweep of every family on the card.

Marked ``gpu``: without a CUDA device each test skips from inside itself, so
every worker collects the same tests.  Run on the card with
``PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_flash_decode_gpu.py``
(that machine has no JAX).

Tolerance, K2, K3 and K5 against their plain versions: float32 sums of
bf16 inputs in another order (K3's on the tensor cores, with p as a bf16
pair within 2^-17 of it), the output rounded to bf16 once, so the limit is
one bf16 ulp of the output plus 2^-14 of max|v| (chip_smoke.py states the
reason).  K4 across d_block and chunk: bit for bit, since its grouping in
time is fixed (tiles of 256 positions from position 0) and the chunk is the
reference's argument, which it does not use.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import pytest
import torch

from _torch_parity import assert_within_bf16_ulp
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_fwd_ref
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode.ref import flash_decode_ref
from repro_torch.kernels.sdca import build as sdca_build
from repro_torch.kernels.sdca import ops as sdca_ops
from repro_torch.kernels.ssm_scan import ops as ss_ops
from repro_torch.kernels.tune import (
    FAMILIES,
    SWEEP_SHAPES,
    ConfigCache,
    candidates_for,
    measured_call,
    ragged_lengths,
    sweep_all,
)
from repro_torch.kernels.tune import roofline

pytestmark = pytest.mark.gpu
V_ATOL_OF_MAX = 2.0 ** -14


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bf16(gen, *shape):
    return torch.randn(shape, generator=gen, device=gen.device).to(torch.bfloat16)


CASES = [  # b, hq, hk, s, d, lengths (None: ragged_lengths), block_k
    (8, 40, 8, 1088, 128, None, 128),   # qwen3-14b's decode shape, G = 5
    (8, 40, 8, 1088, 128, None, 256),   # a tile past the split's 192 positions
    (4, 8, 8, 100, 64, [0, 1, 100, 37], 16),   # G = 1; S not a multiple of 16
    (4, 8, 2, 100, 64, [0, 1, 100, 99], 64),   # G = 4
    (2, 4, 1, 33, 16, [33, 5], 512),           # block_k clamped to S
]


@pytest.mark.parametrize("b, hq, hk, s, d, lengths, block_k", CASES)
def test_flash_decode_kernel_matches_plain(card, b, hq, hk, s, d, lengths, block_k):
    gen = torch.Generator(device=card).manual_seed(0)
    q, k, v = _bf16(gen, b, hq, d), _bf16(gen, b, hk, s, d), _bf16(gen, b, hk, s, d)
    lens = torch.tensor(ragged_lengths(b, s) if lengths is None else lengths,
                        dtype=torch.int32, device=card)
    fd_ops.flash_decode.launches = 0
    got = fd_ops.flash_decode(q, k, v, lens, sm_scale=d ** -0.5, block_k=block_k)
    torch.cuda.synchronize()
    assert fd_ops.flash_decode.launches == 1
    want = flash_decode_ref(q, k, v, lens, sm_scale=d ** -0.5, block_k=block_k)
    assert torch.isfinite(got.float()).all()
    assert_within_bf16_ulp(got.float().cpu().numpy(), want.float().cpu().numpy(),
                           atol=V_ATOL_OF_MAX * float(v.float().abs().max()))
    for i, n in enumerate(lens.tolist()):
        if n == 0:  # an empty row gives zeros, as the Pallas kernel does
            assert not got[i].float().abs().any()
    auto = fd_ops.decode_attention_auto(q, k, v, lens, use_kernel=True, block_k=block_k,
                                        sm_scale=d ** -0.5)
    assert torch.equal(auto, got)


def test_flash_decode_refuses(card):
    gen = torch.Generator(device=card).manual_seed(1)
    q, k, v = _bf16(gen, 2, 8, 128), _bf16(gen, 2, 8, 1024, 128), _bf16(gen, 2, 8, 1024, 128)
    lens = torch.tensor([1024, 7], dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="shared memory"):
        fd_ops.flash_decode(q, k, v, lens, sm_scale=0.1, block_k=1024)
    with pytest.raises(TypeError, match="bfloat16"):
        fd_ops.flash_decode(q.float(), k.float(), v.float(), lens, sm_scale=0.1)
    with pytest.raises(TypeError, match="int32"):
        fd_ops.flash_decode(q, k, v, lens.long(), sm_scale=0.1)


def test_roofline_smem_mirrors_the_kernels(card):
    lib2 = fd_ops.LIBRARY.load()
    lib5 = fd_ops.DECODE_LIBRARY.load()
    lib3 = fa_ops.LIBRARY.load()
    lib4 = ss_ops.LIBRARY.load()
    for g in (1, 2, 5, 8):
        for d in (16, 64, 128, 256):
            for bk in (16, 64, 100, 256, 1024):
                want = roofline.decode_smem_bytes(g, d, bk)
                assert want == lib2.paged_decode_smem_bytes(g, d, bk)
                assert want == lib5.flash_decode_smem_bytes(g, d, bk)
                assert roofline.k3_smem_bytes(g, d, bk) == lib3.flash_fwd_smem_bytes(g, d, d, bk)
    for cap in (1, 96, 1088, 4096):
        for bk in (16, 48, 64, 128, 256, 1024):
            want = roofline.decode_splits(cap, bk)
            assert want == lib2.paged_decode_splits(cap, bk) == lib5.flash_decode_splits(cap, bk)
    for n in ss_ops.KERNEL_STATE_SIZES:
        for d_block in ss_ops.KERNEL_D_BLOCKS:
            assert roofline.k4_smem_bytes(n, d_block) == lib4.selective_scan_smem_bytes(n, d_block)
    lib1 = sdca_build.load()
    for d in (1, 4, 33, 100, 784, 800, 2047, 2048, 2049, 4096, 12224, sdca_ops.MAX_D):
        e, ring, smem = sdca_ops.kernel_plan(d)
        assert roofline.k1_smem_bytes(d) == smem == lib1.sdca_smem_bytes(d), d
        assert (e, ring) == (lib1.sdca_register_entries(d), lib1.sdca_ring_rows(d)), d


def _kept(family, shape):
    kept, _ = roofline.prune(family, shape, candidates_for(family, shape), "bfloat16")
    return [e.config for e in kept]


def _plain(family, config, args):
    """The plain version of the call measured_call gives, on its tensors."""
    if family == "flash_attention":
        q, k, v = args
        lens = torch.full((q.shape[0],), k.shape[2], dtype=torch.int32, device=q.device)
        return flash_fwd_ref(q, k, v, lens, causal=True, sm_scale=1.0 / (q.shape[3] ** 0.5),
                             q_offset=0, block_q=16, block_k=config["block_k"])
    if family == "flash_decode":
        q, k, v, lens = args
        return flash_decode_ref(q, k, v, lens, sm_scale=1.0 / (q.shape[2] ** 0.5),
                                block_k=config["block_k"])
    return fd_ops.paged_decode_attention(*args, impl="stream",
                                         pages_per_program=config["pages_per_program"])


def _check_every_kept_candidate(card, family, shape):
    """Each candidate the roofline keeps, called as the sweep calls it,
    against its plain version on the same tensors."""
    configs = _kept(family, shape)
    assert configs
    for config in configs:
        fn, args = measured_call(family, shape, "bfloat16", card, config)
        got = fn(*args)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all(), config
        want = _plain(family, config, args)
        assert_within_bf16_ulp(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=V_ATOL_OF_MAX * float(args[2].float().abs().max()))


@pytest.mark.parametrize("shape", [SWEEP_SHAPES["smoke"]["flash_attention"],
                                   SWEEP_SHAPES["full"]["flash_attention"],
                                   {"b": 1, "h": 40, "s": 1024, "d": 128}])
def test_every_kept_flash_attention_candidate_launches(card, shape):
    _check_every_kept_candidate(card, "flash_attention", shape)


# the tuner's decode shapes: its presets', and qwen3-14b's that chip_smoke.py
# asks ensure for (K5 with one KV head a query head, as the tuner runs it)
DECODE_ASKS = [
    ("flash_decode", SWEEP_SHAPES["smoke"]["flash_decode"]),
    ("flash_decode", SWEEP_SHAPES["full"]["flash_decode"]),
    ("flash_decode", {"b": 8, "h": 40, "s": 1088, "d": 128}),
    ("flash_decode_paged", SWEEP_SHAPES["smoke"]["flash_decode_paged"]),
    ("flash_decode_paged", {"b": 4, "hk": 8, "g": 5, "d": 128, "page": 16, "npp": 6}),
    ("flash_decode_paged", {"b": 8, "hk": 8, "g": 5, "d": 128, "page": 16, "npp": 68}),
]


@pytest.mark.parametrize("family, shape", DECODE_ASKS)
def test_every_kept_decode_candidate_launches(card, family, shape):
    _check_every_kept_candidate(card, family, shape)


@pytest.mark.parametrize("dtype, n", [(torch.bfloat16, 16), (torch.float32, 16),
                                      (torch.bfloat16, 4)])
def test_selective_scan_bit_identical_across_chunks(card, dtype, n):
    gen = torch.Generator(device=card).manual_seed(4)
    bt, s, dn = 2, 300, 512
    x = torch.randn((bt, s, dn), generator=gen, device=card).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((bt, s, dn), generator=gen, device=card))
    A = -torch.arange(1, n + 1, dtype=torch.float32, device=card).expand(dn, n).contiguous()
    B = torch.randn((bt, s, n), generator=gen, device=card).to(dtype)
    C = torch.randn((bt, s, n), generator=gen, device=card).to(dtype)
    D = torch.ones(dn, device=card)
    h0 = 0.1 * torch.randn((bt, dn, n), generator=gen, device=card)
    ref_y, ref_h = None, None
    for d_block in ss_ops.KERNEL_D_BLOCKS:
        for chunk in (1, 7, 16, 32, 64, 128, 256, 4096):
            h = h0.clone()
            y, _ = ss_ops.selective_scan(x, dt, A, B, C, D, h, chunk=chunk, d_block=d_block)
            torch.cuda.synchronize()
            if ref_y is None:
                ref_y, ref_h = y, h
            assert torch.equal(y, ref_y) and torch.equal(h, ref_h), (d_block, chunk)
    for d_block in (4, 12, 64):
        with pytest.raises(ValueError, match="d_block"):
            ss_ops.selective_scan(x, dt, A, B, C, D, h0.clone(), d_block=d_block)


def test_smoke_sweep_every_family_on_the_card(card, tmp_path):
    cache = ConfigCache(str(tmp_path / "tune.json"))
    entries = sweep_all("smoke", device=card, cache=cache, iters=2)
    assert [e["family"] for e in entries] == list(FAMILIES)
    for e in entries:
        assert e["backend"] == "cuda" and e["us_per_call"] > 0
        assert e["config"] in candidates_for(e["family"], e["shape"])
    by_family = {e["family"]: e for e in entries}
    assert by_family["sdca"]["dtype"] == "float32"
    assert by_family["flash_decode"]["dtype"] == "bfloat16"
    assert by_family["sdca"]["config"] == {"use_pallas": 1}
    with pytest.raises(ValueError, match="takes"):
        sweep_all("smoke", families=["sdca"], dtype="bfloat16", device=card,
                  cache=ConfigCache(None), iters=1)
