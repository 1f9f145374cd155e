"""Shared helpers of the parity tests between ``repro`` (JAX) and
``repro_torch``: the reference's coordinate orders, recomputed from its keys.
"""
import jax
import numpy as np


def reference_round_indices(sub, m: int, nl: int, h: int) -> np.ndarray:
    """The (m, H) coordinates that ``repro.optim.cocoa.cocoa_outer_step``
    draws from the round key ``sub`` (cocoa.py:85-89)."""
    keys = jax.random.split(sub, m)
    if h <= nl:
        idx = jax.vmap(lambda k: jax.random.permutation(k, nl)[:h])(keys)
    else:
        idx = jax.vmap(lambda k: jax.random.randint(k, (h,), 0, nl))(keys)
    return np.array(idx)


def reference_index_source(seed: int, m: int, nl: int, h: int, rounds: int):
    """The per-round orders of ``repro.optim.cocoa.run_cocoa`` with
    ``seed``, as an index source for ``repro_torch.optim.cocoa.run_cocoa``."""
    key = jax.random.PRNGKey(seed)
    per_round = []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        per_round.append(reference_round_indices(sub, m, nl, h))
    return lambda it: per_round[it]
