"""K2's MLA latent form on the tensor cores, modelled on the CPU at smoke size.

The kernel (``flash_decode/csrc/paged_latent_decode.cu``) holds 64 query
heads of one row a block (wgmma's M rows; fewer heads are padded with zero
queries), cuts the row's positions into tiles of 64 positions from position
0 (one online-softmax step each), whatever the page size and
``pages_per_program``, and the tiles into splits of 192 positions from
position 0.  Each split keeps its own online
softmax with the scores in log2 units (s * scale * log2(e), then exp2),
multiplies p into the latent rows as the bf16 pair p_hi = bf16(p),
p_lo = bf16(p - p_hi), and a row longer than one split is merged from its
splits' partials (m, l, acc) in split order.  ``latent_split_model`` is a
plain model of that arithmetic in float32, held here against the port's
``paged_latent_decode_attention(impl="stream")`` and the JAX package's
``paged_latent_decode_attention`` (its jnp ``stream`` path; the Pallas K2
does not run on this jax, ROADMAP.md).  The kernel itself is held against
the stream plain version on the card (``tests/test_torch_mla_gpu.py``).

Also: the split count follows from the row's length, not from B; a single bf16 p misses the tolerance the card holds the kernel to,
where the pair holds it; and the roofline's mirrors of the kernel's shared
memory and grid (``repro_torch.kernels.tune.roofline``), which the card's
tests hold equal to the kernel's own export.

Tolerances.  Model against the plain versions, in float32 on bf16-valued
inputs: the q . k products are exact either way and only the order of the
float32 sums differs; the pair p_hi + p_lo is within 2^-17 of p (two bf16
roundings), so the softmax-weighted output moves by at most 2^-17 max|v|
from it, and the splits' merge adds one rescale per split.  So 2^-16 max|v|
(v the latent pool), twice that.  The single-p check uses the card's
tolerance on bf16 outputs: one bf16 ulp of the output beyond 2^-14 max|v|.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode.ops import paged_latent_decode_attention as jax_latent_decode
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.tune import roofline

SPLIT = fd_ops.LATENT_SPLIT_POSITIONS  # positions a split, from position 0
TILE = fd_ops.LATENT_TILE  # positions a tile, from position 0
HEADS = fd_ops.LATENT_HEADS
NEG_INF = -1e30
LOG2E = 1.4426950408889634
ATOL_OF_MAX = 2.0 ** -16  # model vs plain versions, float32, of max|v|
CARD_ATOL_OF_MAX = 2.0 ** -14  # the card's tolerance beyond one bf16 ulp


def latent_split_model(q_lat, q_pe, ckv_pages, kpe_pages, lengths, page_tables, *,
                       scale: float, p_pair: bool = True):
    """The latent kernel's arithmetic in float32: q_lat (B, H, r), q_pe (B, H,
    dr), pools (n_pages, page, r) and (n_pages, page, dr), lengths (B,),
    page_tables (B, npp).  ``p_pair=False`` multiplies a single bf16 p.
    Returns (B, H, r) float32."""
    b, h, r = q_lat.shape
    n_pages, page, _ = ckv_pages.shape
    npp = page_tables.shape[1]
    capacity = npp * page
    groups = -(-h // HEADS)
    q = torch.zeros((b, groups * HEADS, q_lat.shape[2] + q_pe.shape[2]))
    q[:, :h] = torch.cat([q_lat, q_pe], dim=-1).float()
    out = torch.zeros((b, h, r))
    for i in range(b):
        n = min(max(int(lengths[i]), 0), capacity)
        pos = torch.arange(capacity)
        pids = page_tables[i, pos // page].long().clamp(0, n_pages - 1)
        keys = torch.cat([ckv_pages[pids, pos % page], kpe_pages[pids, pos % page]],
                         dim=-1).float()  # (capacity, r + dr): K; its first r columns V
        # positions past the capacity are staged as zeros, and masked
        keys = torch.nn.functional.pad(keys, (0, 0, 0, -capacity % SPLIT))
        for grp in range(groups):
            qg = q[i, grp * HEADS:(grp + 1) * HEADS]  # 64 heads, zero-padded
            parts = []
            for start in range(0, max(n, 1), SPLIT):  # splits from position 0
                acc = torch.zeros((HEADS, r))
                m = torch.full((HEADS,), NEG_INF)
                l = torch.zeros(HEADS)
                for t0 in range(start, min(start + SPLIT, n), TILE):  # from position 0
                    kt = keys[t0:t0 + TILE]
                    valid = torch.arange(t0, t0 + TILE) < n
                    x = torch.where(valid, (qg @ kt.T) * scale * LOG2E, NEG_INF)
                    mx = torch.maximum(m, x.amax(-1))
                    alpha = torch.where(mx == m, torch.ones(()), torch.exp2(m - mx))
                    p = torch.where(valid, torch.exp2(x - mx[:, None]), 0.0)
                    l = l * alpha + p.sum(-1)
                    hi = p.to(torch.bfloat16).float()
                    pv = hi @ kt[:, :r]
                    if p_pair:
                        pv = pv + (p - hi).to(torch.bfloat16).float() @ kt[:, :r]
                    acc = acc * alpha[:, None] + pv
                    m = mx
                parts.append((acc, m, l))
            if len(parts) == 1:
                acc, _, l = parts[0]
                res = acc / l.clamp(min=1e-30)[:, None]
            else:
                big = torch.stack([m for _, m, _ in parts]).amax(0)
                o = torch.zeros((HEADS, r))
                total = torch.zeros(HEADS)
                for acc, m, l in parts:  # in split order
                    w = torch.exp2(m - big)
                    total = total + l * w
                    o = o + acc * w[:, None]
                res = o / total.clamp(min=1e-30)[:, None]
            keep = min(HEADS, h - grp * HEADS)
            out[i, grp * HEADS:grp * HEADS + keep] = res[:keep]
    return out


def _case(seed, b, h, r, dr, page, npp, lengths):
    """bf16-valued float32 inputs; per-row page tables drawn without repeats
    from pages 1.. (page 0 is the scratch page), out of order."""
    rng = np.random.RandomState(seed)
    n_pages = 1 + b * npp

    def bf16(*shape):
        x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        return x.to(torch.bfloat16).float().numpy()

    tables = (rng.permutation(np.arange(1, n_pages))[: b * npp].reshape(b, npp)
              .astype(np.int32))
    return (bf16(b, h, r), bf16(b, h, dr), bf16(n_pages, page, r), bf16(n_pages, page, dr),
            np.asarray(lengths, np.int32), tables)


# lengths 0 and 1, one split exactly, one position more, two splits exactly
# and beyond; heads fewer than 64, not a multiple of 8, and over 64 (a second,
# padded head group); pages of 8 and 32 positions, whose plain versions
# group 32 and 128 positions where the kernel's tile is 64; ppp is the plain
# versions' page group
LATENT_CASES = [  # seed, b, h, r, dr, page, npp, lengths, ppp
    (0, 6, 4, 16, 8, 16, 30, [0, 1, 192, 193, 384, 480], 4),
    (1, 3, 20, 16, 8, 16, 30, [300, 77, 385], 2),
    (2, 2, 70, 16, 8, 16, 30, [450, 191], 1),
    (3, 3, 4, 16, 8, 16, 30, [480, 200, 48], 3),
    (4, 2, 8, 512, 64, 16, 26, [416, 150], 4),
    (5, 3, 4, 16, 8, 8, 60, [320, 65, 193], 4),
    (6, 2, 20, 16, 8, 32, 15, [420, 97], 4),
]


@pytest.mark.parametrize("seed, b, h, r, dr, page, npp, lengths, ppp", LATENT_CASES)
def test_latent_model_matches_stream_and_reference(seed, b, h, r, dr, page, npp, lengths, ppp):
    args = _case(seed, b, h, r, dr, page, npp, lengths)
    t = [torch.from_numpy(x) for x in args]
    scale = (r + dr) ** -0.5
    got = latent_split_model(*t, scale=scale).numpy()
    atol = ATOL_OF_MAX * float(np.abs(args[2]).max())
    stream = fd_ops.paged_latent_decode_attention(*t, sm_scale=scale, impl="stream",
                                                  pages_per_program=ppp).numpy()
    np.testing.assert_allclose(got, stream, atol=atol, rtol=0)
    ref = np.asarray(jax_latent_decode(*(jnp.asarray(x) for x in args), sm_scale=scale,
                                       impl="stream", pages_per_program=ppp))
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)
    for i, n in enumerate(lengths):
        if n == 0:
            assert not got[i].any()


def test_split_count_depends_on_length_and_blocking_only():
    """Splits are 192 positions from position 0, so a row takes ceil(len /
    192) of them whatever B or the other rows, and the grid's split axis
    follows from the table's capacity alone; a row's result in the model is
    the same bits alone and in a batch of 8."""
    assert [roofline.latent_splits(c) for c in (96, 192, 193, 1088, 1024 + 64)] == \
        [1, 1, 2, 6, 6]
    assert SPLIT % TILE == 0  # a split is a whole number of tiles
    args = _case(5, 8, 4, 16, 8, 16, 30, [480, 1, 193, 0, 77, 384, 192, 5])
    t = [torch.from_numpy(x) for x in args]
    full = latent_split_model(*t, scale=0.3)
    for row in (0, 2, 5):
        one = latent_split_model(t[0][row:row + 1], t[1][row:row + 1], t[2], t[3],
                                 t[4][row:row + 1], t[5][row:row + 1], scale=0.3)
        assert torch.equal(one[0], full[row])


def _ulps_beyond(got: np.ndarray, want: np.ndarray, atol: float) -> float:
    """Largest difference beyond ``atol`` in bf16 ulps of the larger
    magnitude, 2 ** (floor(log2 |x|) - 7); both bf16 values in float32."""
    got, want = got.astype(np.float64), want.astype(np.float64)
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), np.finfo(np.float32).tiny)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    return float((np.maximum(np.abs(got - want) - atol, 0.0) / ulp).max())


def test_single_bf16_p_misses_the_tolerance_the_pair_holds():
    """At deepseek-v2's widths (r 512, dr 64) with a sharp softmax (scores
    of a few units, as the absorbed queries give), the model's bf16 output
    with p as the pair stays within one bf16 ulp beyond 2^-14 max|v| of the
    plain version's, and with a single bf16 p (2^-9 of each p) it does
    not."""
    args = _case(6, 2, 8, 512, 64, 16, 26, [400, 137])
    t = [torch.from_numpy(x) for x in args]
    scale = 0.12
    want = fd_ops.paged_latent_decode_attention(*t, sm_scale=scale, impl="stream",
                                                pages_per_program=4)
    want = want.to(torch.bfloat16).float().numpy()
    atol = CARD_ATOL_OF_MAX * float(np.abs(args[2]).max())

    def ulps(p_pair):
        got = latent_split_model(*t, scale=scale, p_pair=p_pair)
        return _ulps_beyond(got.to(torch.bfloat16).float().numpy(), want, atol)

    assert ulps(True) <= 1.0
    assert ulps(False) > 1.0


def test_roofline_mirrors_the_latent_layout_grid_and_tiles():
    """Shared memory: [q_lat | q_pe] for 64 heads and two staged tiles of 64
    positions of [ckv | kpe], bf16 at the depth padded to 16, then the pool
    rows of a split's 192 positions (int32): 216.75 KB at deepseek-v2's
    widths, one block an SM.  The grid at phase 22's shape of chip_smoke.py
    (B 8, 128 heads, 68 pages of 16, ragged lengths 544 .. 68): 6 splits x 2
    head groups x 8 rows, 34 of whose blocks hold positions; at full rows
    all 96, one wave of 132 SMs.  The tile does not follow pages_per_program
    or the page size, so the roofline keeps every pages_per_program with the
    same estimate and every page size."""
    tail = 4 * 192
    assert roofline.latent_smem_bytes(512, 64) == 2 * (64 * 576 + 2 * 64 * 576) + tail
    assert roofline.latent_smem_bytes(512, 64) == 221952 <= roofline.MAX_SMEM_PER_BLOCK
    assert roofline.latent_smem_bytes(16, 8) == 2 * (64 * 32 + 2 * 64 * 32) + tail
    lens = roofline.ragged_lengths(8, 1088)
    assert lens.tolist() == [544, 476, 408, 340, 272, 204, 136, 68]
    splits = roofline.latent_splits(1088)
    assert splits == 6 and splits * 2 * 8 == 96 <= roofline.SMS
    assert sum(roofline.latent_splits(int(n)) for n in lens) * 2 == 34
    shape = fd_ops.latent_shape(8, 128, 512, 64, 16, 68)
    ests = [roofline.estimate("flash_decode_paged", shape, {"pages_per_program": ppp},
                              "bfloat16") for ppp in (1, 2, 3, 4, 8, 16)]
    assert all(e.fits for e in ests)
    # one wave of blocks, each walking at most a split's three tiles (the
    # longest row's 544 positions hold more than a split)
    assert {(e.serial_steps, e.smem_bytes, e.t_model_s) for e in ests} == \
        {(3, 221952, ests[0].t_model_s)}
    smoke = fd_ops.latent_shape(2, 4, 16, 8, 16, 6)
    for page, npp in ((16, 6), (32, 3), (4, 8), (8, 12), (24, 4)):
        assert roofline.estimate("flash_decode_paged", dict(smoke, page=page, npp=npp),
                                 {"pages_per_program": 4}, "bfloat16").fits
