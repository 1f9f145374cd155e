"""Port parity: the LM (qwen3-14b smoke: 2 layers, d_model 64, 4 query heads
over 2 KV heads, head_dim 16; stablelm-1.6b smoke: 1 layer, the same widths,
25% partial rotary, no qk-norm) with the reference's weights, converted
through numpy, against ``repro.models.model.LM``: prefill logits, then 8
teacher-forced ``decode_step_paged`` steps over ragged rows in the paged
pools (both sides fed the same tokens).

Tolerances.  float32 (``dtype="float32"``): the same arithmetic summed in
another order, so logits within 1e-4 of the largest logit's magnitude.
bf16: both sides round every activation to bf16, at places the two
frameworks choose differently (fused SwiGLU, where products round), so
single activations differ by bf16 steps (2^-8 relative) that the residual
stream carries on; logits within 3% of the largest logit's magnitude,
and their mean difference within 0.5%.

The rest of the catalog under the same bounds: qwen1.5-110b (QKV bias,
drawn at random here: it is zeros at init), qwen3-32b (qk-norm, 64 heads
over 8 at full width) in both dtypes, jamba (its smoke period of 8: Mamba layers,
attention at position 4, top-2 MoE on the odd layers) in float32.  jamba's
bf16 logits miss the bf16 bounds: its top-2 routing flips at near ties
between the two frameworks' bf16 roundings (ROADMAP.md, queue 3), so in
bf16 it is held to the port's own guarantees instead
(tests/test_torch_serve_engine.py's bitwise prefix reuse,
tests/test_torch_train.py's gradient the same bits twice).  The frontend
archs: tests/test_torch_frontend.py.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import randomize_qkv_bias
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models.model import LM as RefLM
from repro.models.runtime import Runtime as RefRuntime
from repro.serve.cache import init_paged_cache as ref_init_paged_cache
from repro.serve.cache import write_prefill as ref_write_prefill
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models.runtime import Runtime
from repro_torch.serve.cache import init_paged_cache, write_prefill

PAGE, NPP, N_PAGES = 16, 4, 12
TABLES = np.array([[3, 7, 1, 10], [5, 2, 11, 8]], np.int32)  # out of order
PROMPT_LENS = (13, 21)
STEPS = 8
RT = Runtime(page_size=PAGE, paged_impl="stream")
TOL = {"float32": (1e-4, None), "bfloat16": (3e-2, 5e-3)}  # (max, mean) of |d| / max|logit|


def _setup(dtype, arch="qwen3-14b"):
    ref_cfg = dataclasses.replace(ref_smoke_config(arch), dtype=dtype)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    ref_lm = RefLM(ref_cfg, RefRuntime(remat="none", block_q=16, block_k=16, page_size=PAGE,
                                       paged_impl="stream"))
    params, _ = ref_lm.init(jax.random.PRNGKey(0))
    params = randomize_qkv_bias(jax.tree.map(np.array, params))
    port = lm_params_from_numpy(cfg, params, device="cpu")
    return ref_lm, params, port


def _close(got, want, dtype):
    scale = np.abs(want).max()
    err = np.abs(got.astype(np.float64) - want)
    max_tol, mean_tol = TOL[dtype]
    assert err.max() <= max_tol * scale, (err.max(), scale)
    if mean_tol is not None:
        assert err.mean() <= mean_tol * scale, (err.mean(), scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_prefill_and_paged_decode_match_reference(dtype):
    _check_prefill_and_paged_decode(dtype, "qwen3-14b")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stablelm_prefill_and_paged_decode_match_reference(dtype):
    """stablelm-1.6b, the arch the trainer trains, under the same bounds."""
    _check_prefill_and_paged_decode(dtype, "stablelm-1.6b")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deepseek_moe_prefill_and_paged_decode_match_reference(dtype):
    """deepseek-moe-16b (a dense head layer, then MoE FFNs, dropless in
    prefill and decode), which the trainer trains too, under the same
    bounds."""
    _check_prefill_and_paged_decode(dtype, "deepseek-moe-16b")


@pytest.mark.parametrize("arch, dtype", [
    ("qwen1.5-110b", "float32"), ("qwen1.5-110b", "bfloat16"),
    ("qwen3-32b", "float32"), ("qwen3-32b", "bfloat16"),
    ("jamba-1.5-large-398b", "float32")])
def test_catalog_prefill_and_paged_decode_match_reference(arch, dtype):
    """The archs no other parity test above holds, under the same bounds
    (the module docstring on jamba in bf16)."""
    _check_prefill_and_paged_decode(dtype, arch)


def _check_prefill_and_paged_decode(dtype, arch):
    ref_lm, params, port = _setup(dtype, arch)
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


def test_prefill_over_row_blocks_is_the_same_function():
    """Row blocks of 8 positions (the last one ragged) against one block of
    the whole prompt, float32: the same arithmetic, the products summed in
    another order."""
    from repro_torch.models.model import LM

    cfg = dataclasses.replace(get_smoke_config("qwen3-14b"), dtype="float32")
    lm = LM(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab_size, (1, 37)))
    whole, whole_cache = lm.prefill(tokens, rt=RT)
    blocks, blocks_cache = lm.prefill(tokens, rt=dataclasses.replace(RT, prefill_rows=8))
    _close(blocks.numpy(), whole.numpy().astype(np.float64), "float32")
    for got, want in zip(blocks_cache, whole_cache):
        for name in ("k", "v"):
            _close(got[name].numpy(), want[name].numpy().astype(np.float64), "float32")


def test_prefill_padding_is_inert():
    """A 37-token prompt padded to 64 positions, with ``n_valid`` 37: the
    logits of position 36 and the real positions' K/V as without padding
    (float32, the products over 64 rows summed in another order)."""
    from repro_torch.models.model import LM

    cfg = dataclasses.replace(get_smoke_config("qwen3-14b"), dtype="float32")
    lm = LM(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.RandomState(1).randint(0, cfg.vocab_size, (1, 37)))
    want, want_cache = lm.prefill(tokens, rt=RT)
    padded = torch.nn.functional.pad(tokens, (0, 27), value=5)
    got, got_cache = lm.prefill(padded, n_valid=37, rt=RT)
    _close(got.numpy(), want.numpy().astype(np.float64), "float32")
    for g, w in zip(got_cache, want_cache):
        for name in ("k", "v"):
            assert g[name].shape[2] == 64
            _close(g[name][:, :, :37].numpy(), w[name].numpy().astype(np.float64), "float32")
