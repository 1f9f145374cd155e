"""Shared helpers of the parity tests between ``repro`` (JAX) and
``repro_torch``: the reference's coordinate orders, recomputed from its keys,
and a comparison to one bf16 ulp.  JAX is imported where it is used, so the
card's tests, which run without JAX, can import this module.
"""
import functools

import numpy as np


def reference_round_indices(sub, m: int, nl: int, h: int) -> np.ndarray:
    """The (m, H) coordinates that ``repro.optim.cocoa.cocoa_outer_step``
    draws from the round key ``sub`` (cocoa.py:85-89)."""
    import jax

    keys = jax.random.split(sub, m)
    if h <= nl:
        idx = jax.vmap(lambda k: jax.random.permutation(k, nl)[:h])(keys)
    else:
        idx = jax.vmap(lambda k: jax.random.randint(k, (h,), 0, nl))(keys)
    return np.array(idx)


def reference_index_source(seed: int, m: int, nl: int, h: int, rounds: int):
    """The per-round orders of ``repro.optim.cocoa.run_cocoa`` with
    ``seed``, as an index source for ``repro_torch.optim.cocoa.run_cocoa``."""
    import jax

    key = jax.random.PRNGKey(seed)
    per_round = []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        per_round.append(reference_round_indices(sub, m, nl, h))
    return lambda it: per_round[it]


def reference_minibatch_source(seed: int, m: int, nl: int, b: int, rounds: int):
    """The per-round (m, B) minibatches of ``repro.optim.sgd.run_minibatch_sgd``
    with ``seed`` (a round key split from the run's key, split over the
    workers, ``randint`` each: sgd.py:35-41, :66-69), as an index source for
    ``repro_torch.optim.sgd.run_minibatch_sgd``."""
    import jax

    key = jax.random.PRNGKey(seed)
    per_round = []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, m)
        per_round.append(np.array(jax.vmap(lambda k: jax.random.randint(k, (b,), 0, nl))(keys)))
    return lambda it: per_round[it]


def reference_ssp_indices(seed: int, t: int, m: int, h: int, nl: int) -> np.ndarray:
    """The (m, h) rows ``repro.optim.simcluster.SSPLocalSGD`` draws in outer
    step t (``fold_in(PRNGKey(seed), t)`` split over the workers, ``randint``
    each: simcluster.py:55-60, :155)."""
    return np.array(_ssp_draw(seed, m, h, nl)(t))


@functools.lru_cache(maxsize=None)
def _ssp_draw(seed: int, m: int, h: int, nl: int):
    """``reference_ssp_indices`` at one (seed, m, h, nl), jitted over t (a
    loop of the fleet's or the chaos loop's outer steps calls it once a
    step)."""
    import jax

    def draw(t):
        keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), t), m)
        return jax.vmap(lambda k: jax.random.randint(k, (h,), 0, nl))(keys)

    return jax.jit(draw)


def randomize_qkv_bias(params, seed: int = 0):
    """A reference param tree (numpy leaves, mutable dicts) with qwen1.5's
    QKV biases ``bq``/``bk``/``bv``, zeros at init, drawn from N(0, 0.1^2)
    in place, so that a parity test exercises them.  Returns the tree."""
    rng = np.random.RandomState(seed)

    def walk(node):
        if isinstance(node, dict):
            for key, value in node.items():
                if key in ("bq", "bk", "bv"):
                    node[key] = (0.1 * rng.randn(*np.shape(value))).astype(np.float32)
                else:
                    walk(value)
        elif isinstance(node, (tuple, list)):
            for item in node:
                walk(item)

    walk(params)
    return params


def assert_within_bf16_ulp(got: np.ndarray, want: np.ndarray, atol: float = 0.0) -> None:
    """Each element of ``got`` within ``atol`` plus one bf16 ulp of ``want``:
    the spacing of bf16 values (7 stored significand bits) at the larger
    magnitude of the two, 2 ** (floor(log2 |x|) - 7).  Both are bf16 values
    carried in float32."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), np.finfo(np.float32).tiny)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7) + atol
    err = np.abs(got - want)
    worst = np.unravel_index(np.argmax(err - ulp), err.shape)
    assert np.all(err <= ulp), (
        f"{int(np.sum(err > ulp))} elements differ by more than one bf16 ulp (+ {atol}); worst at "
        f"{worst}: {got[worst]} vs {want[worst]}")


def check_prefix_reuse_across_row_blocks(lm) -> None:
    """Serve engines on ``lm`` at a max_seq of one prefill row block
    (``PREFILL_ROWS``) and 64 positions more: a short prompt is padded to
    one block, not to max_seq, and a two-block prompt that reuses a
    one-block prompt's pages gets a cold engine's logits bit for bit (a
    Mamba model recomputes the shared head's state in its own prefill)."""
    from repro_torch.models.runtime import PREFILL_ROWS
    from repro_torch.serve import ServeEngine

    rows, vocab = PREFILL_ROWS, lm.cfg.vocab_size
    kw = dict(max_batch=2, page_size=16, max_seq=rows + 64, collect_logits=True, lm=lm)
    rng = np.random.RandomState(0)
    head = rng.randint(0, vocab, 32)
    prompt_a = np.concatenate([head, rng.randint(0, vocab, 5)])
    prompt_b = np.concatenate([head, rng.randint(0, vocab, rows + 12)])
    warm = ServeEngine("", **kw)
    assert warm.rt.prefill_rows == rows
    if lm.layers[0].spec.mixer == "attn":  # K/V (B, Hk, S, hd) or MLA's latents (B, S, r)
        name, axis = ("ckv", 1) if lm.cfg.mla is not None else ("k", 2)
        assert warm._prefill(prompt_a)[1][0][name].shape[axis] == rows
        assert warm._prefill(prompt_b)[1][0][name].shape[axis] == 2 * rows
    warm.submit(prompt_a, 4)
    warm.run()
    r_warm = warm.submit(prompt_b, 4)
    warm.run()
    cold = ServeEngine("", **kw)
    r_cold = cold.submit(prompt_b, 4)
    cold.run()
    assert r_warm.n_shared_pages == 2 and r_cold.n_shared_pages == 0
    assert len(r_warm.logits_trace) == len(r_cold.logits_trace) == 4
    assert all(np.array_equal(a, b) for a, b in zip(r_warm.logits_trace, r_cold.logits_trace))
