"""Port parity: the Mamba-1 mixer (``repro_torch/models/mamba.py``) and the
smoke falcon-mamba LM (1 layer, d_model 64, d_inner 128, d_state 4,
dt_rank 8, d_conv 4) with the reference's weights, converted through numpy,
against ``repro.models.mamba`` and ``repro.models.model.LM``.

Tolerances.  float32: the same arithmetic, with the products and the sums
over the state taken in another order and the reference's prefill scan an
associative one (``scan_chunk`` 32, as its engine runs it), so outputs and
logits within 1e-4 of the largest magnitude, and the float32 state within
1e-5 of its largest magnitude.  bf16: both sides round activations to bf16
at places the two frameworks choose differently (the gate ``y * silu(z)``,
the projections' outputs), so single activations differ by bf16 steps that
the residual stream carries on; logits within 3% of the largest logit's
magnitude, their mean difference within 0.5% (as tests/test_torch_lm.py).

The reference cannot serve a prompt shorter than ``d_conv - 1`` = 3 tokens
(see ``test_short_prompts_prefill_state_is_the_token_by_token_decode``), so
the comparisons with it use longer prompts.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import mamba as ref_mamba
from repro.models.model import LM as RefLM
from repro.models.param import split_tree
from repro.models.runtime import Runtime as RefRuntime
from repro.serve.cache import init_paged_cache as ref_init_paged_cache
from repro.serve.cache import write_prefill as ref_write_prefill
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.models import mamba
from repro_torch.models.model import LM
from repro_torch.models.runtime import Runtime
from repro_torch.serve.cache import init_paged_cache, write_prefill

ARCH = "falcon-mamba-7b"
PAGE, N_PAGES = 16, 12
TABLES = np.array([[3, 7, 1, 10], [5, 2, 11, 8]], np.int32)
PROMPT_LENS = (13, 21)
STEPS = 8
RT = Runtime(page_size=PAGE, paged_impl="stream")
TOL = {"float32": (1e-4, None), "bfloat16": (3e-2, 5e-3)}  # (max, mean) of |d| / max|logit|
STATE_RTOL = 1e-5


def _cfgs(dtype):
    return (dataclasses.replace(ref_smoke_config(ARCH), dtype=dtype),
            dataclasses.replace(get_smoke_config(ARCH), dtype=dtype))


def _close(got, want, dtype="float32"):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want)
    max_tol, mean_tol = TOL[dtype]
    assert err.max() <= max_tol * scale, (err.max(), scale)
    if mean_tol is not None:
        assert err.mean() <= mean_tol * scale, (err.mean(), scale)


def _state_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= STATE_RTOL * np.abs(want).max()


def _f32(t):
    return np.asarray(jnp.asarray(t, jnp.float32))


def test_mixer_prefill_and_decode_match_reference():
    """One mixer, float32: a 13-position prefill, then 6 decode steps from
    its state, outputs and states against the reference's."""
    ref_cfg, cfg = _cfgs("float32")
    ref_p, _ = split_tree(ref_mamba.init_mamba(jax.random.PRNGKey(3), ref_cfg))
    p = {k: torch.from_numpy(np.array(v)) for k, v in ref_p.items()}
    rng = np.random.RandomState(0)
    x = rng.randn(2, 13, cfg.d_model).astype(np.float32)
    want, ref_state = ref_mamba.apply_mamba(ref_p, jnp.asarray(x), ref_cfg, mode="prefill",
                                            scan_chunk=32)
    got, state = mamba.apply_mamba(p, torch.from_numpy(x), cfg, RT)
    _close(got.numpy(), want)
    _state_close(state["h"].numpy(), ref_state["h"])
    np.testing.assert_array_equal(state["conv"].numpy(), np.asarray(ref_state["conv"]))
    for step in range(6):
        xt = rng.randn(2, 1, cfg.d_model).astype(np.float32)
        want, ref_state = ref_mamba.apply_mamba_decode(ref_p, jnp.asarray(xt), ref_cfg,
                                                       ref_state)
        got = mamba.apply_mamba_decode(p, torch.from_numpy(xt), cfg, state)
        _close(got.numpy(), want)
        _state_close(state["h"].numpy(), ref_state["h"])
        np.testing.assert_array_equal(state["conv"].numpy(), np.asarray(ref_state["conv"]))


def _setup(dtype):
    ref_cfg, cfg = _cfgs(dtype)
    ref_lm = RefLM(ref_cfg, RefRuntime(remat="none", scan_chunk=32, page_size=PAGE,
                                       paged_impl="stream"))
    params, _ = ref_lm.init(jax.random.PRNGKey(0))
    port = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params), device="cpu")
    return ref_lm, params, port


def test_converted_weights_keep_the_reference_leaves():
    _, params, port = _setup("bfloat16")
    layer = port.layers[0]
    assert layer.ln2 is None and layer.ffn is None
    ref_mixer = params["periods"]["pos0"]["mixer"]
    assert set(layer.mixer) == set(ref_mixer)
    for name, t in layer.mixer.items():
        want_dtype = torch.float32 if name in mamba.FLOAT32_PARAMS else torch.bfloat16
        assert t.dtype == want_dtype, name
        if want_dtype == torch.float32:
            np.testing.assert_array_equal(t.numpy(), np.asarray(ref_mixer[name][0]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_prefill_and_paged_decode_match_reference(dtype):
    ref_lm, params, port = _setup(dtype)
    rng = np.random.RandomState(0)
    vocab = port.cfg.vocab_size
    prompts = [rng.randint(0, vocab, n).astype(np.int32) for n in PROMPT_LENS]
    forced = rng.randint(0, vocab, (STEPS, 2)).astype(np.int32)

    ref_cache = ref_init_paged_cache(ref_lm, num_pages=N_PAGES, page_size=PAGE, max_batch=2)
    cache = init_paged_cache(port, num_pages=N_PAGES, page_size=PAGE, max_batch=2)
    assert set(cache[0]) == {"h", "conv"} and cache[0]["h"].shape == (2, 128, 4)
    axes = ref_lm.cache_axes()
    for slot, prompt in enumerate(prompts):
        pages = -(-len(prompt) // PAGE)
        want, ref_pre = jax.jit(ref_lm.prefill)(params, jnp.asarray(prompt)[None])
        got, pre = port.prefill(torch.from_numpy(prompt.astype(np.int64))[None], rt=RT)
        _close(got.float().numpy(), _f32(want), dtype)
        ref_cache = ref_write_prefill(ref_cache, ref_pre, axes, slot=slot,
                                      page_ids=list(TABLES[slot, :pages]), page_size=PAGE)
        write_prefill(cache, pre, slot=slot, page_ids=list(TABLES[slot, :pages]),
                      page_size=PAGE)
    if dtype == "float32":
        _state_close(cache[0]["h"].numpy(), ref_cache["periods"]["pos0"]["h"][0])

    ref_decode = jax.jit(ref_lm.decode_step_paged)
    lengths = np.array(PROMPT_LENS, np.int32)
    for step in range(STEPS):
        want, ref_cache = ref_decode(params, jnp.asarray(forced[step]), jnp.asarray(lengths),
                                     ref_cache, jnp.asarray(TABLES))
        got, cache = port.decode_step_paged(torch.from_numpy(forced[step].astype(np.int64)),
                                            torch.from_numpy(lengths), cache,
                                            torch.from_numpy(TABLES), rt=RT)
        _close(got.float().numpy(), _f32(want), dtype)
        lengths = lengths + 1


def _float32_lm(seed=0):
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    return LM(cfg, device="cpu").init_params(torch.Generator().manual_seed(seed))


def _decode_from_zero(lm, tokens):
    """The port's decode step run over ``tokens`` one at a time from the
    zero state (slot 0 of a one-slot cache); returns (last logits, cache)."""
    cache = init_paged_cache(lm, num_pages=2, page_size=PAGE, max_batch=1)
    tables = torch.zeros((1, 1), dtype=torch.int32)
    for i, tok in enumerate(tokens):
        logits, cache = lm.decode_step_paged(torch.tensor([int(tok)]),
                                             torch.tensor([i], dtype=torch.int32), cache,
                                             tables, rt=RT)
    return logits, cache


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_short_prompts_prefill_state_is_the_token_by_token_decode(n):
    """A fault of the reference, not repeated here: ``repro/models/mamba.py:122``
    keeps the conv tail as ``x_in[:, -(d_conv - 1):]``, so a 2-token prompt
    raises (``Incompatible shapes for broadcasting: (1, 128, 2) and requested
    shape (1, 128, 3)``) and a 1-token prompt repeats its one position in all
    three taps, where the causal conv's zero padding gives ``[0, 0, x0]``.
    The port's prefill keeps zeros before position 0, so its logits and
    state equal its own one-token-at-a-time decode from the zero state
    (float32, the products over n rows against one row summed in another
    order)."""
    lm = _float32_lm()
    tokens = np.random.RandomState(n).randint(0, lm.cfg.vocab_size, n)
    logits, pre = lm.prefill(torch.from_numpy(tokens)[None], rt=RT)
    want_logits, cache = _decode_from_zero(lm, tokens)
    _close(logits.numpy(), want_logits.numpy())
    _state_close(pre[0]["h"].numpy(), cache[0]["h"].numpy())
    np.testing.assert_allclose(pre[0]["conv"].numpy(), cache[0]["conv"].numpy(),
                               rtol=0, atol=1e-6 * float(cache[0]["conv"].abs().max()))
    if n < 3:
        assert torch.all(pre[0]["conv"][..., : 3 - n] == 0)


def test_prefill_padding_holds_the_state_of_the_last_real_position():
    """A 37-token prompt padded to 64 positions with ``n_valid`` 37: logits
    and state as without padding (float32, products over 64 rows summed in
    another order), and bit for bit the same whatever the padding holds,
    which the engine's prefix reuse rests on."""
    lm = _float32_lm()
    tokens = torch.from_numpy(np.random.RandomState(1).randint(0, lm.cfg.vocab_size, (1, 37)))
    want, want_state = lm.prefill(tokens, rt=RT)
    outs = []
    for fill in (5, 200):
        padded = torch.nn.functional.pad(tokens, (0, 27), value=fill)
        got, state = lm.prefill(padded, n_valid=37, rt=RT)
        _close(got.numpy(), want.numpy())
        _state_close(state[0]["h"].numpy(), want_state[0]["h"].numpy())
        _close(state[0]["conv"].numpy(), want_state[0]["conv"].numpy())
        outs.append((got, state))
    (a, sa), (b, sb) = outs
    assert torch.equal(a, b)
    assert all(torch.equal(sa[0][k], sb[0][k]) for k in ("h", "conv"))


def test_prefill_over_row_blocks_is_the_same_function():
    """Row blocks of 8 positions (the last one ragged) against one block of
    the whole prompt, float32: the products summed in another order; the
    conv and the scan span the whole sequence either way."""
    lm = _float32_lm()
    tokens = torch.from_numpy(np.random.RandomState(0).randint(0, lm.cfg.vocab_size, (1, 37)))
    whole, whole_state = lm.prefill(tokens, rt=RT)
    before = scan_ops.selective_scan.launches
    blocks, blocks_state = lm.prefill(tokens, rt=dataclasses.replace(RT, prefill_rows=8))
    assert scan_ops.selective_scan.launches == before  # CPU tensors: the plain version
    _close(blocks.numpy(), whole.numpy())
    _state_close(blocks_state[0]["h"].numpy(), whole_state[0]["h"].numpy())
