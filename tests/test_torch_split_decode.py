"""K2's split-KV and K3's p split, modelled on the CPU at smoke size.

K2 (``flash_decode/csrc/paged_decode.cu`` on ``decode_tile.cuh``) cuts each
row's positions into groups of ``pages_per_program`` pages from position 0
and the groups into splits of ``decode_tiles_per_split`` groups; each split
keeps its own online softmax, and a row longer than one split is merged from
its splits' partials in split order.  ``split_decode_model`` is a plain model
of that arithmetic, held here against the port's ``paged_decode_stream`` and
the JAX package's ``paged_decode_attention`` (its jnp ``stream`` path; the
Pallas K2 does not run on this jax, ROADMAP.md).  The kernel itself is held
against ``paged_decode_stream`` on the card (``tests/test_torch_serve_gpu.py``).

K3 (``flash_attention/csrc/flash_fwd.cu``) multiplies p by v on the tensor
cores with p carried as two bf16 values, p_hi = bf16(p) and
p_lo = bf16(p - p_hi); the model here shows the pair reproduces float32
p v within 2^-16 max|v| where a single bf16 p does not.

Also the roofline's mirrors of the two kernels' shared memory, split count
and grids (``repro_torch.kernels.tune.roofline``), which the card's tests
hold equal to the kernels' own exports.

Tolerances: float32 atol 1e-5 against the stream plain version and the
reference, the same blocked online softmax summed in another order (the
split's merge adds one rescale per split); the p split's error is bounded by
2^-17 of each p (two bf16 roundings), so 2^-16 max|v| of a softmax-weighted
output.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode.ops import paged_decode_attention as jax_paged_decode
from repro_torch.kernels.flash_attention.ops import KERNEL_BLOCK_KS
from repro_torch.kernels.flash_decode.ref import paged_decode_stream
from repro_torch.kernels.tune import roofline

ATOL_F32 = 1e-5
NEG_INF = -1e30


def split_decode_model(q, k_pages, v_pages, lengths, page_tables, *, scale: float,
                       pages_per_program: int) -> torch.Tensor:
    """K2's arithmetic in float32, one split at a time: q (B, Hk, G, d),
    pools (n_pages, Hk, page, d); returns (B, Hk, G, d) float32."""
    b, hk, g, d = q.shape
    n_pages, _, page, _ = k_pages.shape
    npp = page_tables.shape[1]
    ppp = max(1, min(int(pages_per_program), npp))
    bk = ppp * page
    per = roofline.decode_tiles_per_split(bk)
    capacity = npp * page
    out = torch.zeros((b, hk, g, d), dtype=torch.float32)
    for i in range(b):
        n = min(max(int(lengths[i]), 0), capacity)
        n_tiles = -(-n // bk)
        parts = []
        for split in range(max(1, -(-n_tiles // per))):
            acc = torch.zeros((hk, g, d))
            m = torch.full((hk, g), NEG_INF)
            l = torch.zeros((hk, g))
            for t in range(split * per, min(split * per + per, n_tiles)):
                pos = t * bk + torch.arange(bk)
                valid = pos < n
                pids = page_tables[i, (pos // page).clamp(max=npp - 1)].long().clamp(0, n_pages - 1)
                kt = k_pages[pids, :, pos % page].float().transpose(0, 1)  # (Hk, bk, d)
                vt = v_pages[pids, :, pos % page].float().transpose(0, 1)
                s = torch.einsum("hgd,hpd->hgp", q[i].float(), kt) * scale
                s = torch.where(valid, s, NEG_INF)
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum("hgp,hpd->hgd", p, vt)
                m = m_new
            parts.append((acc, m, l))
        if len(parts) == 1:
            acc, _, l = parts[0]
            out[i] = acc / l.clamp(min=1e-30)[..., None]
            continue
        mx = torch.stack([m for _, m, _ in parts]).amax(0)
        o = torch.zeros((hk, g, d))
        total = torch.zeros((hk, g))
        for acc, m, l in parts:  # in split order
            w = torch.exp(m - mx)
            total = total + l * w
            o = o + acc * w[..., None]
        out[i] = o / total.clamp(min=1e-30)[..., None]
    return out


def _case(seed, b, hk, g, d, page, npp, lengths):
    """Random pools and per-row page tables drawn without repeats from pages
    1.. (page 0 is the scratch page), out of order."""
    rng = np.random.RandomState(seed)
    n_pages = 1 + b * npp
    q = rng.randn(b, hk, g, d).astype(np.float32)
    kp = rng.randn(n_pages, hk, page, d).astype(np.float32)
    vp = rng.randn(n_pages, hk, page, d).astype(np.float32)
    tables = (rng.permutation(np.arange(1, n_pages))[: b * npp].reshape(b, npp)
              .astype(np.int32))
    return q, kp, vp, np.asarray(lengths, np.int32), tables


# lengths 0 and 1, one split exactly (192 positions at pages_per_program 4 of
# 16: three groups of 64), one position more, a full row, and ragged ones
SPLIT_CASES = [  # seed, b, hk, g, d, page, npp, lengths, ppp
    (0, 6, 2, 5, 16, 16, 20, [0, 1, 192, 193, 320, 77], 4),
    (1, 4, 2, 2, 32, 16, 20, [320, 150, 300, 16], 1),
    (2, 4, 1, 4, 16, 16, 20, [256, 129, 9, 200], 8),
    (3, 3, 2, 3, 16, 8, 40, [320, 191, 33], 3),
]


@pytest.mark.parametrize("seed, b, hk, g, d, page, npp, lengths, ppp", SPLIT_CASES)
def test_split_model_matches_stream_and_reference(seed, b, hk, g, d, page, npp, lengths, ppp):
    q, kp, vp, lens, tables = _case(seed, b, hk, g, d, page, npp, lengths)
    scale = d ** -0.5
    t = [torch.from_numpy(x) for x in (q, kp, vp, lens, tables)]
    got = split_decode_model(*t, scale=scale, pages_per_program=ppp).numpy()
    stream = paged_decode_stream(*t, scale=scale, pages_per_program=ppp).numpy()
    np.testing.assert_allclose(got, stream, atol=ATOL_F32, rtol=0)
    ref = np.asarray(jax_paged_decode(
        jnp.asarray(q.reshape(b, hk * g, d)), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(lens), jnp.asarray(tables), impl="stream", pages_per_program=ppp))
    np.testing.assert_allclose(got, ref.reshape(b, hk, g, d), atol=ATOL_F32, rtol=0)
    bk = min(ppp, npp) * page
    assert any(n > roofline.decode_tiles_per_split(bk) * bk for n in lengths)  # a merge ran
    for i, n in enumerate(lengths):
        if n == 0:
            assert not got[i].any()


def test_split_count_depends_on_the_blocking_only():
    """The split is a fixed number of groups from position 0, so the grid's
    splits per (row, KV head) follow from the table's capacity and the
    group, whatever B or the longest row; at qwen3-14b's long run (1088
    positions, groups of 4 pages of 16) the grid fills more than two waves
    of 132 SMs."""
    shape = {"hk": 8, "g": 5, "d": 128, "page": 16, "npp": 68}
    assert roofline.decode_tiles_per_split(64) == 3
    assert roofline.decode_splits(1088, 64) == 6
    assert 6 * 8 * 8 > 2 * roofline.SMS
    for ppp in (1, 2, 4, 8):
        bk = 16 * ppp
        splits = roofline.decode_splits(68 * 16, bk)
        assert roofline.decode_tiles_per_split(bk) * bk <= 192 or bk > 192
        for b in (1, 4, 8):
            est = roofline.estimate("flash_decode_paged", dict(shape, b=b),
                                    {"pages_per_program": ppp}, "bfloat16")
            assert est.serial_steps == roofline._waves(b * 8 * splits) * min(
                roofline.decode_tiles_per_split(bk),
                -(-int(roofline.ragged_lengths(b, 1088).max()) // bk))
    # a row's result in the model is the same bits alone and in a batch
    q, kp, vp, lens, tables = _case(4, 8, 2, 5, 16, 16, 20, [320, 1, 200, 0, 77, 193, 320, 5])
    t = [torch.from_numpy(x) for x in (q, kp, vp, lens, tables)]
    full = split_decode_model(*t, scale=0.25, pages_per_program=4)
    one = split_decode_model(t[0][2:3], t[1], t[2], t[3][2:3], t[4][2:3], scale=0.25,
                             pages_per_program=4)
    assert torch.equal(one[0], full[2])


def test_p_split_reproduces_float32_pv():
    """Softmax weights of a 64-key tile (each at most 1, the row's largest
    exactly 1) times bf16 values: p_hi + p_lo, two bf16 products summed in
    float32, stays within 2^-16 max|v| of float32 p v after the division by
    l; one bf16 p does not."""
    rng = np.random.RandomState(0)
    s = rng.randn(64, 64).astype(np.float32) * 3
    p = torch.from_numpy(np.exp(s - s.max(axis=1, keepdims=True)))
    l = p.sum(1, keepdim=True)
    v = torch.from_numpy(rng.randn(64, 128).astype(np.float32)).to(torch.bfloat16).float()
    want = (p.double() @ v.double()) / l.double()
    hi = p.to(torch.bfloat16)
    lo = (p - hi.float()).to(torch.bfloat16)
    assert float((hi.float() + lo.float() - p).abs().max()) <= 2.0 ** -17
    got = (hi.float() @ v + lo.float() @ v) / l
    limit = 2.0 ** -16 * float(v.abs().max())
    assert float((got.double() - want).abs().max()) <= limit
    single = (hi.float() @ v) / l
    assert float((single.double() - want).abs().max()) > limit


def test_roofline_mirrors_the_new_shared_memory_and_grids():
    """K3: q's 128 rows and two stages of 64 key and value rows in bf16 (DK
    padded to 16), nothing that depends on G or block_k; a block per 128
    query positions of one query head.  K2 and K5: q, acc and scores in
    float32 and a ring of two unpadded K/V tiles, 72 KB at qwen3-14b's decode
    (G 5, d 128, 64 positions), so three blocks share an SM's 228 KB; where
    a split is one tile (bk > 96) the ring is one stage, so a 128-position
    tile fits three blocks an SM as well and a 256-position one still fits."""
    assert roofline.k3_smem_bytes(5, 128, 16) == 2 * (128 * 128 + 2 * 64 * 256) == 98304
    assert roofline.k3_smem_bytes(1, 128, 64) == 98304
    assert roofline.k3_smem_bytes(1, 192, 16, 128) == 131072
    assert roofline.k3_smem_bytes(1, 24, 16, 16) == 2 * (128 * 32 + 2 * 64 * 48)
    assert roofline.k3_smem_bytes(1, 256, 16) <= roofline.MAX_SMEM_PER_BLOCK
    assert roofline.k3_blocks(1, 40, 2048) == 16 * 40
    smem = roofline.decode_smem_bytes(5, 128, 64)
    assert smem == 5 * 128 * 4 * 2 + 2 * 2 * 64 * 128 * 2 + 5 * 64 * 4 + 3 * 5 * 4
    assert 3 * (smem + 1024) <= 228 * 1024
    assert [roofline.decode_ring_stages(bk) for bk in (16, 64, 96, 97, 128, 256)] == \
        [2, 2, 2, 1, 1, 1]
    smem = roofline.decode_smem_bytes(5, 128, 128)
    assert smem == 5 * 128 * 4 * 2 + 1 * 2 * 128 * 128 * 2 + 5 * 128 * 4 + 3 * 5 * 4
    assert 3 * (smem + 1024) <= 228 * 1024
    assert roofline.decode_smem_bytes(5, 128, 256) <= roofline.MAX_SMEM_PER_BLOCK
    est = roofline.estimate("flash_attention", {"b": 1, "h": 40, "s": 2048, "d": 128},
                            {"block_q": 16, "block_k": 16}, "bfloat16")
    assert est.serial_steps == roofline._waves(640) * 2048 // 16 and est.fits
    est = roofline.estimate("prefill_chunk", {"p": 256, "hk": 8, "g": 5, "d": 128, "page": 16,
                                              "npp": 16}, {"chunk": 128}, "bfloat16")
    assert est.serial_steps == 2 * roofline._waves(roofline.k3_blocks(1, 40, 128)) * 256 // 16


@pytest.mark.parametrize("block_k, s, fits", [(16, 1024, True), (32, 1024, True),
                                              (64, 1024, True), (128, 1024, False),
                                              (32, 16, True), (64, 40, True),
                                              (48, 40, True), (48, 1024, False),
                                              (128, 40, False)])
def test_roofline_keeps_the_block_k_the_kernel_takes(block_k, s, fits):
    """K3 takes block_k 16, 32 or 64, or any block_k from Skv up to 64 (one
    online-softmax step over every key); the roofline refuses the rest, as
    the wrapper does."""
    assert set(KERNEL_BLOCK_KS) == {16, 32, 64}
    est = roofline.estimate("flash_attention", {"b": 1, "h": 2, "s": s, "d": 64},
                            {"block_q": 16, "block_k": block_k}, "bfloat16")
    assert est.fits == fits
