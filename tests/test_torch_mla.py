"""Port parity: MLA, DeepSeek-V2's attention (``repro_torch/models/mla.py``),
and the smoke deepseek-v2 LM (a dense head layer and one MoE layer, d_model
64, 4 heads, q_lora 32, kv_lora 16, qk_nope 16, qk_rope 8, v 16, 8 experts
top-2 and one shared) with the reference's weights, converted through numpy,
against ``repro.models.mla`` and ``repro.models.model.LM``.

Tolerances.  float32: the same arithmetic with the products summed in
another order, so outputs and logits within 1e-4 of the largest magnitude,
and the latents (one projection and a norm) within 1e-5 of theirs.  bf16:
both sides round activations to bf16 at places the two frameworks choose
differently, so logits within 3% of the largest logit's magnitude and their
mean difference within 0.5% (as tests/test_torch_lm.py).
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import mla as ref_mla
from repro.models.model import LM as RefLM
from repro.models.param import split_tree
from repro.models.runtime import Runtime as RefRuntime
from repro.serve.cache import init_paged_cache as ref_init_paged_cache
from repro.serve.cache import write_prefill as ref_write_prefill
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.models import mla
from repro_torch.models.model import LM
from repro_torch.models.runtime import Runtime
from repro_torch.serve.cache import init_paged_cache, write_prefill

ARCH = "deepseek-v2-236b"
PAGE, N_PAGES = 16, 12
TABLES = np.array([[3, 7, 1, 10], [5, 2, 11, 8]], np.int32)  # out of order
PROMPT_LENS = (13, 21)
STEPS = 8
RT = Runtime(page_size=PAGE, paged_impl="stream")
TOL = {"float32": (1e-4, None), "bfloat16": (3e-2, 5e-3)}  # (max, mean) of |d| / max|logit|
LATENT_RTOL = 1e-5


def _cfgs(dtype):
    return (dataclasses.replace(ref_smoke_config(ARCH), dtype=dtype),
            dataclasses.replace(get_smoke_config(ARCH), dtype=dtype))


def _close(got, want, dtype="float32", rtol=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want)
    max_tol, mean_tol = TOL[dtype]
    assert err.max() <= (rtol or max_tol) * scale, (err.max(), scale)
    if mean_tol is not None:
        assert err.mean() <= mean_tol * scale, (err.mean(), scale)


def _mixer(seed):
    ref_cfg, cfg = _cfgs("float32")
    ref_p, _ = split_tree(ref_mla.init_mla(jax.random.PRNGKey(seed), ref_cfg))
    p = {k: torch.from_numpy(np.array(v)) for k, v in ref_p.items()}
    return ref_cfg, cfg, ref_p, p


@pytest.mark.parametrize("kv_lens", [None, [13, 9]])
def test_mla_prefill_matches_reference(kv_lens):
    """Prefill of 2 rows of 13 positions, float32, with and without
    ``kv_lens``: K3's plain version at (dk 24, dv 16) under the port."""
    ref_cfg, cfg, ref_p, p = _mixer(1)
    x = np.random.RandomState(0).randn(2, 13, cfg.d_model).astype(np.float32)
    lens = None if kv_lens is None else np.asarray(kv_lens, np.int32)
    want, ref_cache = ref_mla.apply_mla(
        ref_p, jnp.asarray(x), ref_cfg, mode="prefill", block_q=16, block_k=16,
        kv_lens=None if lens is None else jnp.asarray(lens))
    got, cache = mla.apply_mla(p, torch.from_numpy(x), cfg, RT,
                               kv_lens=None if lens is None else torch.from_numpy(lens))
    _close(got.numpy(), want)
    for name in ("ckv", "kpe"):
        _close(cache[name].numpy(), ref_cache[name], rtol=LATENT_RTOL)
    assert fa_ops.flash_fwd.launches == 0


def test_mla_prefill_over_row_blocks_is_the_same_function():
    _, cfg, _, p = _mixer(2)
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 37, cfg.d_model).astype(np.float32))
    whole, whole_cache = mla.apply_mla(p, x, cfg, RT)
    blocks, blocks_cache = mla.apply_mla(p, x, cfg, dataclasses.replace(RT, prefill_rows=8))
    _close(blocks.numpy(), whole.numpy())
    for name in ("ckv", "kpe"):
        _close(blocks_cache[name].numpy(), whole_cache[name].numpy(), rtol=LATENT_RTOL)


def test_mla_paged_decode_matches_reference():
    """Absorbed paged decode, float32: 2 rows whose prompts' latents fill
    shuffled pages, then 6 steps, each writing its latents into the pool;
    outputs and the pools against the reference's."""
    ref_cfg, cfg, ref_p, p = _mixer(3)
    m = cfg.mla
    rng = np.random.RandomState(2)
    ckv = np.zeros((N_PAGES, PAGE, m.kv_lora_rank), np.float32)
    kpe = np.zeros((N_PAGES, PAGE, m.qk_rope_head_dim), np.float32)
    lengths = np.array(PROMPT_LENS, np.int32)
    for row, n in enumerate(PROMPT_LENS):
        for pos in range(n):
            pid, off = TABLES[row, pos // PAGE], pos % PAGE
            ckv[pid, off] = rng.randn(m.kv_lora_rank)
            kpe[pid, off] = rng.randn(m.qk_rope_head_dim)
    ref_cache = {"ckv": jnp.asarray(ckv), "kpe": jnp.asarray(kpe)}
    cache = {"ckv": torch.from_numpy(ckv.copy()), "kpe": torch.from_numpy(kpe.copy())}
    fd_ops.paged_latent_decode.launches = 0
    for step in range(6):
        x = rng.randn(2, 1, cfg.d_model).astype(np.float32)
        want, ref_cache = ref_mla.apply_mla_decode_paged(
            ref_p, jnp.asarray(x), ref_cfg, ref_cache, jnp.asarray(lengths),
            jnp.asarray(TABLES), page_size=PAGE, paged_impl="stream", pages_per_program=2)
        got = mla.apply_mla_decode_paged(
            p, torch.from_numpy(x), cfg, dataclasses.replace(RT, paged_impl="kernel",
                                                             pages_per_program=2),
            cache, torch.from_numpy(lengths), torch.from_numpy(TABLES))
        _close(got.numpy(), want)
        for name in ("ckv", "kpe"):
            _close(cache[name].numpy(), ref_cache[name], rtol=LATENT_RTOL)
        lengths = lengths + 1
    assert fd_ops.paged_latent_decode.launches == 0  # CPU tensors take the plain version


@functools.lru_cache(maxsize=None)
def _setup(dtype):
    """The reference LM, its parameters and the port's LM holding them (the
    tests read both and write neither)."""
    ref_cfg, cfg = _cfgs(dtype)
    ref_lm = RefLM(ref_cfg, RefRuntime(remat="none", block_q=16, block_k=16, page_size=PAGE,
                                       paged_impl="stream"))
    params, _ = ref_lm.init(jax.random.PRNGKey(0))
    port = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params), device="cpu")
    return ref_lm, params, port


def test_converted_layers_hold_the_reference_leaves():
    """Layer 0 is the dense head layer (``head_layers[0]``), layer 1 the first
    period's MoE layer; the router and the latent norms are float32."""
    ref_lm, params, port = _setup("bfloat16")
    head, body = port.layers
    assert head.spec.ffn == "dense" and body.spec.ffn == "moe"
    np.testing.assert_array_equal(
        head.mixer["wq_a"].float().numpy(),
        np.asarray(jnp.asarray(params["head_layers"][0]["mixer"]["wq_a"], jnp.bfloat16)
                   .astype(jnp.float32)))
    np.testing.assert_array_equal(body.ffn["router"].numpy(),
                                  np.asarray(params["periods"]["pos0"]["ffn"]["router"][0]))
    for t in (body.ffn["router"], body.mixer["q_a_norm"], body.mixer["kv_a_norm"]):
        assert t.dtype == torch.float32
    assert body.ffn["w_gate"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_prefill_and_paged_decode_match_reference(dtype):
    """The smoke deepseek-v2 LM: prefill logits of two prompts, their latents
    written into shuffled pages, then 8 teacher-forced decode steps."""
    ref_lm, params, port = _setup(dtype)
    rng = np.random.RandomState(0)
    vocab = port.cfg.vocab_size
    prompts = [rng.randint(0, vocab, n).astype(np.int32) for n in PROMPT_LENS]
    forced = rng.randint(0, vocab, (STEPS, 2)).astype(np.int32)
    ref_cache = ref_init_paged_cache(ref_lm, num_pages=N_PAGES, page_size=PAGE, max_batch=2)
    cache = init_paged_cache(port, num_pages=N_PAGES, page_size=PAGE, max_batch=2)
    axes = ref_lm.cache_axes()
    for slot, prompt in enumerate(prompts):
        pages = -(-len(prompt) // PAGE)
        want, ref_pre = jax.jit(ref_lm.prefill)(params, jnp.asarray(prompt)[None])
        got, pre = port.prefill(torch.from_numpy(prompt.astype(np.int64))[None], rt=RT)
        _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), dtype)
        ref_cache = ref_write_prefill(ref_cache, ref_pre, axes, slot=slot,
                                      page_ids=list(TABLES[slot, :pages]), page_size=PAGE)
        write_prefill(cache, pre, slot=slot, page_ids=list(TABLES[slot, :pages]),
                      page_size=PAGE)
    assert tuple(cache[1]["ckv"].shape) == (N_PAGES, PAGE, port.cfg.mla.kv_lora_rank)
    ref_decode = jax.jit(ref_lm.decode_step_paged)
    lengths = np.array(PROMPT_LENS, np.int32)
    for step in range(STEPS):
        want, ref_cache = ref_decode(params, jnp.asarray(forced[step]), jnp.asarray(lengths),
                                     ref_cache, jnp.asarray(TABLES))
        got, cache = port.decode_step_paged(torch.from_numpy(forced[step].astype(np.int64)),
                                            torch.from_numpy(lengths), cache,
                                            torch.from_numpy(TABLES), rt=RT)
        _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), dtype)
        lengths = lengths + 1


def test_prefill_padding_is_inert():
    """A 21-token prompt padded to 48 positions with ``n_valid`` 21: the last
    real position's logits and the real positions' latents as without
    padding (float32; the MoE dispatch there spans the padding too, which
    its dropless capacity keeps out of the real tokens' outputs)."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    lm = LM(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.RandomState(1).randint(0, cfg.vocab_size, (1, 21)))
    want, want_cache = lm.prefill(tokens, rt=RT)
    got, got_cache = lm.prefill(torch.nn.functional.pad(tokens, (0, 27), value=5), n_valid=21,
                                rt=RT)
    _close(got.numpy(), want.numpy())
    for g, w in zip(got_cache, want_cache):
        for name in ("ckv", "kpe"):
            _close(g[name][:, :21].numpy(), w[name].numpy(), rtol=LATENT_RTOL)
