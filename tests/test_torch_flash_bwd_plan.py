"""K3-bwd's schedule on the CPU: ``ops.bwd_plan``, the mirror of the key
side's blocks (``flash_bwd_key_kernel``: a key tile's walk over its G query
heads and the query tiles that see it, cut into ``bwd_split`` chunks, one a
block of a cluster, their float32 partials summed in rank order), and a
float32 model of the dk/dv sums taken in that order.  The key side is one
dk/dv pass, or at MLA's (192, 128) a dv pass and a dk pass, each on the
same schedule (``ops.bwd_key_passes``).

Proved over a grid of shapes: every visible (key tile, query head, query
tile) is visited exactly once; no key tile has two owners (one cluster whose
chunks cover its walk in order); the order is fixed (a function of the
shapes, the same whatever kv_lens); the work per block is balanced (below).
The library's own plan is checked against this mirror on the card
(``chip_smoke.py`` phase 23b).

Tolerance of the model: float32 throughout, the same blocked arithmetic as
``flash_bwd_ref`` summed in another order (a chunk's steps, then the chunks);
within ``ATOL_VJP`` (2e-5, as ``tests/test_torch_flash_bwd.py`` states for
gradients of magnitude up to about 6) of both ``flash_bwd_ref`` and the JAX
package's custom VJP (``_flash_bwd``).
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import heapq

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import flash_bwd_ref, flash_fwd_ref

ATOL_VJP = 2e-5
TILE = ops.BWD_TILE

SHAPES = [  # b, hk, g, sq, skv, kv_lens, q_offset, causal
    (1, 8, 5, 2048, 2048, None, 0, True),           # qwen3-14b's training shape
    (2, 8, 5, 1024, 1024, (1024, 611), 0, True),    # qwen3 ragged
    (8, 32, 1, 128, 128, None, 0, True),            # stablelm-1.6b's
    (8, 32, 1, 128, 128, (128, 100, 77, 64, 63, 17, 1, 128), 0, True),
    (1, 1, 8, 512, 512, None, 0, True),             # split 8
    (1, 2, 4, 130, 130, None, 0, True),             # S not a multiple of the tile
    (2, 2, 5, 33, 33, (33, 0), 0, True),            # one tile, a row of no keys
    (2, 1, 3, 21, 153, (150, 87), 129, True),       # q_offset > 0, kv_lens < Skv
    (1, 2, 2, 40, 300, (1, 300), 260, True),        # kv_len 1
    (1, 4, 2, 192, 192, None, 0, True),             # an odd number of key tiles
    (1, 4, 2, 256, 256, None, 0, True),             # an even number
    (2, 2, 3, 200, 150, None, 0, False),            # not causal
    (8, 128, 1, 128, 128, None, 0, True),           # deepseek-v2-236b's (MLA, 128 heads)
    (8, 128, 1, 128, 128, (128, 100, 77, 64, 63, 17, 1, 128), 0, True),
    (1, 4, 1, 2048, 2048, None, 0, True),           # MLA heads cut in 4 at S 2048
]


def _visible(b, hk, g, sq, skv, kv_lens, q_offset, causal) -> set:
    """Every (key tile, KV head, batch, query head, query tile) with a pair
    some row of the query tile sees, from the masks' definition."""
    out = set()
    rows, keys = np.arange(sq), np.arange(skv)
    for batch in range(b):
        seen = keys[None, :] < min(kv_lens[batch], skv)
        if causal:
            seen = seen & (keys[None, :] <= q_offset + rows[:, None])
        else:
            seen = np.broadcast_to(seen, (sq, skv))
        for j in range(-(-skv // TILE)):
            for qt in range(-(-sq // TILE)):
                if seen[qt * TILE:(qt + 1) * TILE, j * TILE:(j + 1) * TILE].any():
                    out.update((j, kvh, batch, kvh * g + h, qt)
                               for kvh in range(hk) for h in range(g))
    return out


def _lens(b, skv, kv_lens):
    return list(kv_lens) if kv_lens is not None else [skv] * b


@pytest.mark.parametrize("b, hk, g, sq, skv, lens, q_offset, causal", SHAPES)
def test_every_visible_tile_visited_once(b, hk, g, sq, skv, lens, q_offset, causal):
    lens = _lens(b, skv, lens)
    units = ops.bwd_plan(b, hk, g, sq, skv, lens, q_offset, causal)
    visits = [(u.key_tile, u.kv_head, u.batch, h, qt) for u in units for h, qt in u.visits]
    assert len(visits) == len(set(visits))
    assert set(visits) == _visible(b, hk, g, sq, skv, lens, q_offset, causal)
    assert all(u.kv_head * g <= h < (u.kv_head + 1) * g for u in units for h, _ in u.visits)


@pytest.mark.parametrize("b, hk, g, sq, skv, lens, q_offset, causal", SHAPES)
def test_each_key_tile_has_one_owner(b, hk, g, sq, skv, lens, q_offset, causal):
    """The blocks of a (key tile, KV head, batch) are one cluster of
    ``split`` neighbours in launch order, ranks 0.. in order, whose chunks
    cut the walk [0, G n_j) into consecutive pieces."""
    units = ops.bwd_plan(b, hk, g, sq, skv, _lens(b, skv, lens), q_offset, causal)
    split = ops.bwd_split(b, hk, g, sq, skv, q_offset, causal)
    nq = -(-sq // TILE)
    assert split in (1, 2, 4, 8) and len(units) % split == 0
    owners = set()
    for at in range(0, len(units), split):
        cluster = units[at:at + split]
        owner = {(u.key_tile, u.kv_head, u.batch) for u in cluster}
        assert len(owner) == 1 and not owner & owners
        owners |= owner
        assert [u.chunk for u in cluster] == list(range(split))
        work = g * ops.bwd_tiles_seeing(cluster[0].key_tile, nq, sq, q_offset, causal)
        bounds = [min(work, c * -(-work // split)) for c in range(split)] + [work]
        assert [u.first for u in cluster] == bounds[:-1]
        assert all(u.last in (u.first, bounds[u.chunk + 1]) for u in cluster)
    assert len(owners) == b * hk * -(-skv // TILE)


@pytest.mark.parametrize("b, hk, g, sq, skv, lens, q_offset, causal", SHAPES)
def test_order_is_fixed_by_the_shapes(b, hk, g, sq, skv, lens, q_offset, causal):
    """Launch order: key tiles from the first (the most rows) on, then batch
    and KV head, then rank; a block's steps in walk order (query head, then
    query tile); the cut the same for any kv_lens, and the library's grid as
    ``bwd_grid`` states it."""
    lens = _lens(b, skv, lens)
    units = ops.bwd_plan(b, hk, g, sq, skv, lens, q_offset, causal)
    assert units == ops.bwd_plan(b, hk, g, sq, skv, lens, q_offset, causal)
    keys = [(u.key_tile, u.batch, u.kv_head, u.chunk) for u in units]
    assert keys == sorted(keys)
    for u in units:
        assert list(u.visits) == sorted(u.visits)
    full = ops.bwd_plan(b, hk, g, sq, skv, [skv] * b, q_offset, causal)
    assert [(u.first, u.chunk) for u in units] == [(u.first, u.chunk) for u in full]
    x, y, z, cluster = ops.bwd_grid(1, b, hk, g, sq, skv, q_offset, causal)
    assert x * y * z == len(units) and cluster == x == units[-1].chunk + 1
    assert ops.bwd_grid(0, b, hk, g, sq, skv, q_offset, causal) == (hk * g, -(-sq // TILE), b, 1)


def _makespan(works) -> int:
    """Steps until the last block ends when blocks take the first free of
    ``BWD_SLOTS`` slots in launch order, a step a unit of time."""
    slots = [0] * ops.BWD_SLOTS
    for w in works:
        heapq.heappush(slots, heapq.heappop(slots) + w)
    return max(slots)


BALANCED = [  # b, hk, g, s: full-length causal shapes of a training step
    (1, 8, 5, 2048), (1, 8, 5, 4096), (2, 8, 5, 2048), (4, 8, 5, 4096),  # qwen3-14b
    (1, 8, 4, 2048), (1, 8, 8, 4096), (1, 4, 8, 8192),                  # G 4 and 8
    (8, 32, 1, 128), (8, 32, 1, 512), (2, 32, 1, 2048), (8, 32, 1, 2048),  # MHA
]


@pytest.mark.parametrize("b, hk, g, s", BALANCED)
def test_work_per_block_is_balanced(b, hk, g, s):
    """Stated factor: blocks taking the first free of the 264 slots in
    launch order end within 1.1 x the mean load of a slot, plus one step.
    Where the cut stopped below 8 chunks, no block is longer than that mean
    (rounded up).  The PR-22 schedule (one block a key tile, the whole
    walk) is no better than its longest walk, G x S / 64 steps."""
    units = ops.bwd_plan(b, hk, g, s, s, [s] * b, 0, True)
    works = [len(u.visits) for u in units]
    mean = sum(works) / ops.BWD_SLOTS
    assert _makespan(works) <= 1.1 * mean + 1
    if ops.bwd_split(b, hk, g, s, s, 0, True) < ops.BWD_MAX_SPLIT:
        assert max(works) <= np.ceil(mean) or max(works) < 2 * ops.BWD_MIN_CHUNK
    unsplit = [g * ops.bwd_tiles_seeing(j, -(-s // TILE), s, 0, True)
               for j in range(-(-s // TILE)) for _ in range(b * hk)]
    assert _makespan(unsplit) >= g * -(-s // TILE)


def test_qwen3_cut_halves_the_longest_block():
    """qwen3-14b's training shape: split 2, the longest block 80 steps
    against PR 22's 160, the makespan at the slots' mean load."""
    assert ops.bwd_split(1, 8, 5, 2048, 2048, 0, True) == 2
    works = [len(u.visits) for u in ops.bwd_plan(1, 8, 5, 2048, 2048, [2048], 0, True)]
    assert max(works) == 80 and sum(works) == 21120
    assert _makespan(works) <= 81


# ---------------------------------------------------------------- the float32 model


def dkdv_by_plan(q, k, v, kv_lens, out, lse, dout, *, sm_scale, q_offset, causal):
    """dk and dv summed as the key side sums them, in float32: each block
    of ``bwd_plan`` accumulates P^T dO and dS^T Q over its steps in order
    (64 x 64 tiles, p = exp(s - lse) masked to 0, ds = p (dP - delta)), and
    a key tile's partials are summed in rank order; dk scaled once.  Where
    the key side is a dv and a dk pass, each runs this schedule and these
    sums for its own gradient."""
    b, hq, sq, d = q.shape
    _, hk, skv, _ = k.shape
    d_v = v.shape[3]
    g = hq // hk
    qf, kf, vf, dof = (x.double().float() for x in (q, k, v, dout))
    delta = (dout.float() * out.float()).sum(-1)
    dk = torch.zeros(b, hk, skv, d)
    dv = torch.zeros(b, hk, skv, d_v)
    partial = {}
    for u in ops.bwd_plan(b, hk, g, sq, skv, kv_lens.tolist(), q_offset, causal):
        k0 = u.key_tile * TILE
        keys = torch.arange(k0, min(k0 + TILE, skv))
        acc_k = torch.zeros(len(keys), d)
        acc_v = torch.zeros(len(keys), d_v)
        for head, qt in u.visits:
            rows = torch.arange(qt * TILE, min(qt * TILE + TILE, sq))
            s = (kf[u.batch, u.kv_head, keys] @ qf[u.batch, head, rows].T) * sm_scale
            seen = keys[:, None] < int(kv_lens[u.batch])
            if causal:
                seen = seen & (keys[:, None] <= q_offset + rows[None, :])
            p = torch.where(seen, torch.exp(s - lse[u.batch, head, rows][None, :]), 0.0)
            dp = vf[u.batch, u.kv_head, keys] @ dof[u.batch, head, rows].T
            ds = p * (dp - delta[u.batch, head, rows][None, :])
            acc_v = acc_v + p @ dof[u.batch, head, rows]
            acc_k = acc_k + ds @ qf[u.batch, head, rows]
        key = (u.key_tile, u.kv_head, u.batch)
        if key in partial:  # rank order: the earlier chunks' sum plus this one
            acc_k, acc_v = partial[key][0] + acc_k, partial[key][1] + acc_v
        partial[key] = (acc_k, acc_v)
        dk[u.batch, u.kv_head, keys] = acc_k * sm_scale
        dv[u.batch, u.kv_head, keys] = acc_v
    return dk, dv


MODEL_CASES = [  # b, hq, hk, sq, skv, d or (dk, dv), kv_lens, q_offset
    (1, 8, 1, 512, 512, 16, None, 0),        # split 8
    (1, 10, 2, 200, 200, 16, None, 0),       # split 4, S not a multiple of the tile
    (2, 8, 2, 260, 260, 16, [260, 140], 0),  # split 4, ragged
    (2, 6, 2, 21, 153, 16, [150, 87], 129),  # q_offset > 0, kv_lens < Skv
    (1, 2, 2, 512, 512, (192, 128), [512], 0),  # MLA's dims, split 2: the dv and the dk pass
    (1, 8, 1, 512, 512, (24, 16), [400], 0),     # the smoke deepseek-v2's, split 8, ragged
]


@pytest.mark.parametrize("b, hq, hk, sq, skv, d, lens, q_offset", MODEL_CASES)
def test_chunked_sum_matches_plain_and_reference(b, hq, hk, sq, skv, d, lens, q_offset):
    d, dv = (d, d) if isinstance(d, int) else d
    rng = np.random.RandomState(3)
    q, k, v, do = (rng.randn(*shape).astype(np.float32) for shape in
                   ((b, hq, sq, d), (b, hk, skv, d), (b, hk, skv, dv), (b, hq, sq, dv)))
    kl = np.full(b, skv, np.int32) if lens is None else np.asarray(lens, np.int32)
    assert ops.bwd_split(b, hk, hq // hk, sq, skv, q_offset, True) > 1 or q_offset
    t = [torch.from_numpy(x) for x in (q, k, v)]
    lens_t = torch.from_numpy(kl)
    kw = dict(causal=True, sm_scale=d ** -0.5, q_offset=q_offset)
    out, lse = flash_fwd_ref(*t, lens_t, block_q=TILE, block_k=TILE, return_lse=True, **kw)
    got_k, got_v = dkdv_by_plan(*t, lens_t, out, lse, torch.from_numpy(do), **kw)
    _, plain_k, plain_v = flash_bwd_ref(*t, lens_t, out, lse, torch.from_numpy(do),
                                        block_q=TILE, block_k=TILE, **kw)
    _, ref_k, ref_v = jax.jit(jax.grad(
        lambda q, k, v: jnp.sum(jax_flash_attention(
            q, k, v, kv_lens=jnp.asarray(kl, jnp.float32), causal=True, q_offset=q_offset,
            block_q=TILE, block_k=TILE) * do), argnums=(0, 1, 2)))(q, k, v)
    for got, plain, ref in ((got_k, plain_k, ref_k), (got_v, plain_v, ref_v)):
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=ATOL_VJP)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL_VJP)


@pytest.mark.parametrize("d, dv", ops.BWD_HEAD_DIMS)
def test_key_passes_by_pair(d, dv):
    """The key side's launches at each pair the backward is built for: the
    dk/dv pass where dk's and dv's 64-column panels are at most 4, as at D
    128 (every equal pair, (24, 16)); the dv and then the dk pass at MLA's
    (192, 128).  Each of them runs the one schedule, ``bwd_grid`` the same
    for every key pass."""
    passes = ops.bwd_key_passes(d, dv)
    if (d, dv) == (192, 128):
        assert passes == (ops.BWD_DV, ops.BWD_DK)
    else:
        assert passes == (ops.BWD_DKDV,) and -(-d // 64) + -(-dv // 64) <= 4
    for shape in ((8, 128, 1, 128, 128, 0, True), (1, 4, 1, 2048, 2048, 0, True),
                  (2, 2, 5, 33, 33, 0, True)):
        grids = {ops.bwd_grid(p, *shape) for p in (ops.BWD_DKDV, ops.BWD_DV, ops.BWD_DK)}
        assert len(grids) == 1
        assert ops.bwd_grid(ops.BWD_DQ, *shape)[:3] == (shape[1] * shape[2],
                                                        -(-shape[3] // TILE), shape[0])
    assert ops.bwd_split(1, 4, 1, 2048, 2048, 0, True) == 4  # the card's cut case at DK 192
