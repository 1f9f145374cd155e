"""Port parity: the contiguous cache's decode, ``LM.init_cache`` and
``LM.decode_step``, against the JAX package's ``repro.models.model.LM`` for
every arch of the catalog (smoke configs), the reference's weights converted
through numpy; MLA's decode in both of its forms (``Runtime.mla_absorb``)
and ``paged_impl="legacy"``, the reference's gather of the latent pages.

A frontend arch's F positions are teacher-forced first through
``decode_step(..., frontend_embed=)``, then the tokens, as the reference's
``tests/test_archs_smoke.py::test_decode_matches_prefill_logits`` feeds
them.  qwen1.5's QKV biases, zeros at init, are drawn at random here so
that they count.

Tolerances.  Against the reference, float32: the same arithmetic summed in
another order, so every step's logits within 1e-4 of the largest logit's
magnitude (tests/test_torch_lm.py's bound), and the cache after the last
step within 1e-4 of each leaf's largest magnitude.  Teacher-forced decode
against the port's own prefill, in the configs' bf16: the reference test's
``atol=0.1, rtol=0.05`` (decode and prefill round at other places, and the
bf16 differences ride the residual stream), with the MoE at the reference
test's ``capacity_factor=100``.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import randomize_qkv_bias
from repro.configs import ARCH_IDS
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models.model import LM as RefLM
from repro.models.runtime import Runtime as RefRuntime
from repro.serve.cache import init_paged_cache as ref_init_paged_cache
from repro.serve.cache import write_prefill as ref_write_prefill
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models.model import LM
from repro_torch.models.runtime import Runtime
from repro_torch.serve.cache import init_paged_cache, write_prefill

B, TOKENS = 2, 8
TOL = 1e-4  # of the largest |logit| (or |cache leaf|), float32


def _models(arch, dtype="float32", absorb=False, paged_impl="stream"):
    ref_cfg = dataclasses.replace(ref_smoke_config(arch), dtype=dtype)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    ref = RefLM(ref_cfg, RefRuntime(remat="none", block_q=16, block_k=16, mla_absorb=absorb,
                                    page_size=16, paged_impl=paged_impl))
    params, _ = ref.init(jax.random.PRNGKey(1))
    params = randomize_qkv_bias(jax.tree.map(np.array, params))
    port = lm_params_from_numpy(cfg, params, device="cpu")
    return ref, params, port


def _inputs(cfg, seed=2):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, cfg.vocab_size, (B, TOKENS)).astype(np.int32)
    f = cfg.n_frontend_tokens
    fe = (0.02 * rng.randn(B, f, cfg.d_model)).astype(np.float32) if f else None
    return tokens, fe


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max()
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= tol * scale + 1e-12, (err, scale)


def _ref_layer_caches(cfg, cache):
    """The reference's contiguous cache as the port's per-layer list."""
    k, period = cfg.first_k_dense, len(cfg.period)
    out = list(cache["head"])
    for i in range(cfg.n_layers - k):
        stacked = cache["periods"][f"pos{i % period}"]
        out.append({name: leaf[i // period] for name, leaf in stacked.items()})
    return out


def _decode_both(arch, absorb=False):
    ref, params, port = _models(arch, absorb=absorb)
    cfg = port.cfg
    tokens, fe = _inputs(cfg)
    f = cfg.n_frontend_tokens
    max_seq = f + TOKENS + 1
    ref_cache, cache = ref.init_cache(B, max_seq), port.init_cache(B, max_seq)
    for ours, theirs in zip(cache, _ref_layer_caches(cfg, ref_cache)):
        assert ours.keys() == theirs.keys()
        for name in ours:
            assert tuple(ours[name].shape) == tuple(theirs[name].shape), name
            assert not ours[name].any()
    ref_dec = jax.jit(ref.decode_step)
    rt = Runtime(mla_absorb=absorb)
    lengths = np.zeros(B, np.int32)
    for t in range(f + TOKENS):
        tok = tokens[:, max(t - f, 0)]
        front = fe[:, t] if t < f else None
        want, ref_cache = ref_dec(params, jnp.asarray(tok), jnp.asarray(lengths), ref_cache,
                                  None if front is None else jnp.asarray(front))
        got, cache = port.decode_step(torch.from_numpy(tok.astype(np.int64)),
                                      torch.from_numpy(lengths), cache,
                                      None if front is None else torch.from_numpy(front), rt=rt)
        _close(got.numpy(), want)
        lengths += 1
    for ours, theirs in zip(cache, _ref_layer_caches(cfg, ref_cache)):
        for name in ours:
            _close(ours[name].float().numpy(), theirs[name])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_step_matches_reference_in_float32(arch):
    _decode_both(arch)


def test_mla_absorbed_decode_step_matches_reference_in_float32():
    """``mla_absorb=True``: attention in the latent space against the
    reference's absorbed form (the default, False, is the parametrised
    case above)."""
    _decode_both("deepseek-v2-236b", absorb=True)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_teacher_forced_decode_reproduces_prefill(arch):
    """The port of the reference's ``test_decode_matches_prefill_logits``:
    bf16, the frontend's positions first, then 8 tokens, from a zero cache,
    against one prefill of the whole row."""
    cfg = get_smoke_config(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=100.0))
    lm = LM(cfg, device="cpu").init_params(torch.Generator().manual_seed(1))
    tokens, fe = _inputs(cfg, seed=3)
    tokens = torch.from_numpy(tokens.astype(np.int64))
    fe = None if fe is None else torch.from_numpy(fe)
    want, _ = lm.prefill(tokens, fe)
    f = cfg.n_frontend_tokens
    cache = lm.init_cache(B, f + TOKENS + 1)
    lengths = torch.zeros(B, dtype=torch.int32)
    dummy = torch.zeros(B, dtype=torch.int64)
    for t in range(f):
        got, cache = lm.decode_step(dummy, lengths, cache, frontend_embed=fe[:, t])
        lengths += 1
    for t in range(TOKENS):
        got, cache = lm.decode_step(tokens[:, t], lengths, cache)
        lengths += 1
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=0.1, rtol=0.05)


@pytest.mark.parametrize("absorb", [False, True])
def test_mla_legacy_paged_decode_matches_reference(absorb):
    """``paged_impl="legacy"``: each row's latent pages gathered into a
    contiguous row, then ``_mla_decode_attn`` (absorbed or naive), against
    the reference's legacy path, float32, two prompts prefilled into
    out-of-order pages then 6 teacher-forced steps."""
    ref, params, port = _models("deepseek-v2-236b", absorb=absorb, paged_impl="legacy")
    rt = Runtime(page_size=16, paged_impl="legacy", mla_absorb=absorb)
    tables = np.array([[3, 7, 1], [5, 2, 6]], np.int32)
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, 256, n).astype(np.int32) for n in (13, 21)]
    forced = rng.randint(0, 256, (6, B)).astype(np.int32)
    ref_cache = ref_init_paged_cache(ref, num_pages=8, page_size=16, max_batch=B)
    cache = init_paged_cache(port, num_pages=8, page_size=16, max_batch=B)
    for slot, prompt in enumerate(prompts):
        pages = list(tables[slot, :-(-len(prompt) // 16)])
        _, ref_pre = jax.jit(ref.prefill)(params, jnp.asarray(prompt)[None])
        _, pre = port.prefill(torch.from_numpy(prompt.astype(np.int64))[None], rt=rt)
        ref_cache = ref_write_prefill(ref_cache, ref_pre, ref.cache_axes(), slot=slot,
                                      page_ids=pages, page_size=16)
        write_prefill(cache, pre, slot=slot, page_ids=pages, page_size=16)
    ref_dec = jax.jit(ref.decode_step_paged)
    lengths = np.array([13, 21], np.int32)
    for step in range(6):
        want, ref_cache = ref_dec(params, jnp.asarray(forced[step]), jnp.asarray(lengths),
                                  ref_cache, jnp.asarray(tables))
        got, cache = port.decode_step_paged(torch.from_numpy(forced[step].astype(np.int64)),
                                            torch.from_numpy(lengths), cache,
                                            torch.from_numpy(tables), rt=rt)
        _close(got.numpy(), want)
        lengths += 1


def test_legacy_is_mla_only():
    """The GQA paged decode takes the pool implementations only, as the
    reference's ``paged_decode_attention`` refuses "legacy"."""
    lm = LM(dataclasses.replace(get_smoke_config("qwen3-14b"), dtype="float32"),
            device="cpu").init_params(torch.Generator().manual_seed(0))
    cache = init_paged_cache(lm, num_pages=4, page_size=16, max_batch=1)
    with pytest.raises(ValueError, match="legacy"):
        lm.decode_step_paged(torch.zeros(1, dtype=torch.int64), torch.zeros(1, dtype=torch.int32),
                             cache, torch.tensor([[1, 2]], dtype=torch.int32),
                             rt=Runtime(paged_impl="legacy"))
