"""Port parity: the frontend archs, internvl2-76b (a vision stub) and
musicgen-medium (an audio stub), against the JAX package at their smoke
configs (1 layer, d_model 64, 8 frontend positions), the reference's
weights converted through numpy.  A frontend arch's inputs are precomputed
embeddings (F, d) that ``frontend_proj`` projects and that go before the
tokens (``repro/models/model.py:101-112``); the embeddings here are
synthetic, N(0, 0.02^2), as the reference's pipeline and CLI draw them.

Tolerances.  Prefill logits as tests/test_torch_lm.py: float32 within 1e-4
of the largest logit's magnitude; bf16 within 3% of it, the mean difference
within 0.5% (both sides round activations to bf16 at places the two
frameworks choose differently).  ``loss_fn`` as tests/test_torch_train.py:
float32, the loss within 1e-5 of it and every gradient leaf,
``frontend_proj`` included, within 1e-4 of the leaf's max |g|; bf16, the
loss within 2^-7 of it (a bf16 ulp at the loss's magnitude, the logits
being bf16) and each gradient leaf within the logits' bf16 bounds, 3% of
its max |g| and the mean within 0.5% (the same bf16 activations rounded at
other places, through one layer and the head: measured 1.0% and 0.25% at
most).  Token streams in float32, as
tests/test_torch_serve_engine.py: identical, every step's logits within
atol 1e-4, and the smallest top-1/top-2 margin of the reference's above it.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as ref_serve_cli
from repro.configs import get_smoke_config as ref_smoke_config
from repro.launch.serve import _mixed_trace_specs as ref_trace_specs
from repro.models.model import LM as RefLM
from repro.models.runtime import Runtime as RefRuntime
from repro.serve import ServeEngine as RefServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy, tree_from_lm
from repro_torch.launch import serve as port_cli
from repro_torch.models.runtime import Runtime
from repro_torch.serve import ServeEngine
from repro_torch.training.tree import tree_leaves

ARCHS = ["internvl2-76b", "musicgen-medium"]
LOGITS_TOL = {"float32": (1e-4, None), "bfloat16": (3e-2, 5e-3)}  # of max |logit|
GRAD_TOL = {"float32": (1e-4, None), "bfloat16": (3e-2, 5e-3)}  # of the leaf's max |g|
LOSS_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}  # of the loss
ENGINE = dict(max_batch=4, page_size=16, max_seq=96, collect_logits=True)
LOGITS_ATOL = 1e-4


class Float32RefEngine(RefServeEngine):
    @staticmethod
    def config_for(arch, smoke):
        return dataclasses.replace(RefServeEngine.config_for(arch, smoke), dtype="float32")


def _models(arch, dtype):
    ref_cfg = dataclasses.replace(ref_smoke_config(arch), dtype=dtype)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    ref = RefLM(ref_cfg, RefRuntime(remat="none", block_q=16, block_k=16))
    params, _ = ref.init(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    return ref, params, lm_params_from_numpy(cfg, params, device="cpu")


def _embeds(cfg, b, seed):
    return (0.02 * np.random.RandomState(seed).randn(b, cfg.n_frontend_tokens,
                                                     cfg.d_model)).astype(np.float32)


def _within(got, want, tol, what=""):
    max_tol, mean_tol = tol
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max()
    err = np.abs(np.asarray(got, np.float64) - want)
    assert err.max() <= max_tol * scale + 1e-12, (what, err.max(), scale)
    if mean_tol is not None:
        assert err.mean() <= mean_tol * scale + 1e-12, (what, err.mean(), scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_with_embeddings_matches_reference(arch, dtype):
    ref, params, port = _models(arch, dtype)
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, 256, (2, 13)).astype(np.int32)
    fe = _embeds(port.cfg, 2, 2)
    want, ref_cache = jax.jit(ref.prefill)(params, jnp.asarray(tokens), jnp.asarray(fe))
    got, cache = port.prefill(torch.from_numpy(tokens.astype(np.int64)), torch.from_numpy(fe),
                              rt=Runtime())
    _within(got.float().numpy(), np.asarray(want.astype(jnp.float32)), LOGITS_TOL[dtype])
    f = port.cfg.n_frontend_tokens
    assert cache[0]["k"].shape[2] == f + 13  # the frontend's positions come first
    if dtype == "float32":
        _within(cache[0]["k"].numpy(), ref_cache["periods"]["pos0"]["k"][0],
                LOGITS_TOL[dtype])
    # padding after the prompt: the last real position's logits and its
    # frontend-first positions as without it
    padded = np.concatenate([tokens, np.full((2, 11), 7, np.int32)], axis=1)
    pad_got, _ = port.prefill(torch.from_numpy(padded.astype(np.int64)), torch.from_numpy(fe),
                              n_valid=13, rt=Runtime())
    _within(pad_got.float().numpy(), got.float().numpy(), LOGITS_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, dtype):
    """``loss_fn`` over a training batch with ``frontend_embeds`` (the
    pipeline's, 8 frontend positions before 24 tokens), its F positions
    dropped before the head, and every gradient leaf, ``frontend_proj``
    included."""
    from repro.data.pipeline import SyntheticTokens as RefTokens

    ref, params, port = _models(arch, dtype)
    port.trainable()
    cfg = port.cfg
    batch = RefTokens(cfg.vocab_size, 24, 2, seed=0, n_frontend=cfg.n_frontend_tokens,
                      d_model=cfg.d_model).next_batch()
    assert batch["frontend_embeds"].shape == (2, cfg.n_frontend_tokens, cfg.d_model)
    (want_loss, want_aux), want_g = jax.jit(jax.value_and_grad(ref.loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, aux = port.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()},
                             Runtime(block_q=16, block_k=16))
    loss.backward()
    loss = loss.detach()
    assert abs(float(loss) - float(want_loss)) <= LOSS_TOL[dtype] * abs(float(want_loss))
    assert float(aux["tokens"]) == float(want_aux["tokens"]) == 48
    grads = tree_from_lm(port, grads=True)
    assert "frontend_proj" in grads and float(grads["frontend_proj"].abs().max()) > 0
    got = [g.numpy() for g in tree_leaves(grads)]
    want = [np.asarray(w, np.float32) for w in jax.tree.leaves(want_g)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _within(g, w, GRAD_TOL[dtype], g.shape)


def test_train_steps_with_embeddings_match_reference():
    """``make_train_step`` on musicgen-medium's batches with their
    ``frontend_embeds``, 2 microbatches (the embeddings split with the
    tokens), AdamW, 3 steps, against the reference's, float32, under
    tests/test_torch_train.py's bounds: loss within 1e-5 relative,
    grad_norm within 1e-4, and every parameter within 2 lr per step, all
    but 1% of them within 1e-3 lr."""
    from repro.data.pipeline import SyntheticTokens as RefTokens
    from repro.training import optimizers as ref_opt
    from repro.training import trainer as ref_trainer
    from repro_torch.convert import tree_from_numpy, tree_to_numpy
    from repro_torch.training import optimizers as port_opt
    from repro_torch.training import trainer as port_trainer

    ref, params, port = _models("musicgen-medium", "float32")
    port.trainable()
    kw = dict(learning_rate=1e-2, warmup_steps=0, total_steps=10, microbatches=2)
    ref_step = jax.jit(ref_trainer.make_train_step(ref, ref_opt.get_optimizer("adamw"),
                                                   ref_trainer.TrainConfig(**kw)))
    step = port_trainer.make_train_step(port, port_opt.get_optimizer("adamw"),
                                        port_trainer.TrainConfig(**kw),
                                        rt=Runtime(block_q=16, block_k=16))
    data = RefTokens(256, 16, 4, seed=0, n_frontend=8, d_model=64)
    p_ref, s_ref = params, ref_opt.get_optimizer("adamw").init(params)
    p = tree_from_numpy(params, "cpu")
    s = port_opt.get_optimizer("adamw").init(p)
    lr_sum = 0.0
    for i in range(3):
        batch = data.next_batch()
        p_ref, s_ref, want = ref_step(p_ref, s_ref, {k: jnp.asarray(v) for k, v in batch.items()},
                                      jnp.int32(i))
        p, s, got = step(p, s, batch, i)
        assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-5 * abs(float(want["loss"]))
        assert abs(float(got["grad_norm"]) - float(want["grad_norm"])) <= \
            1e-4 * float(want["grad_norm"])
        lr_sum += float(want["lr"])
    got_leaves = tree_leaves(tree_to_numpy(p))
    want_leaves = [np.asarray(x) for x in jax.tree.leaves(p_ref)]
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        err = np.abs(g - w)
        assert err.max() <= 2 * lr_sum + 1e-7, (g.shape, err.max(), lr_sum)
        assert np.mean(err > 1e-3 * lr_sum) <= 0.01, g.shape


def _serve(eng, specs):
    reqs = [eng.submit(p, gen, arrival_step=arr, frontend_embeds=fe) for p, gen, arr, fe in specs]
    eng.run()
    return reqs


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_token_streams_with_embeddings_match_reference_in_float32(arch):
    """The serve CLI's 8-request mixed trace, each request with its 8
    frontend embeddings, through the port's engine and the reference's: the
    same tokens, every step's logits within atol 1e-4; no request shares a
    prefix, none skips its prefill."""
    ref = Float32RefEngine(arch, smoke=True, seed=0, **ENGINE)
    specs = ref_trace_specs(ref.cfg, 16, 8, 0)
    assert all(fe is not None for *_, fe in specs)
    ref_reqs = _serve(ref, specs)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    lm = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, ref.params), device="cpu")
    eng = ServeEngine(arch, lm=lm, paged_impl="stream", **ENGINE)
    reqs = _serve(eng, specs)
    margins = []
    for r_ref, r in zip(ref_reqs, reqs):
        assert r.generated == r_ref.generated, r.rid
        assert len(r.logits_trace) == len(r_ref.logits_trace)
        for got, want in zip(r.logits_trace, r_ref.logits_trace):
            np.testing.assert_allclose(got, want, rtol=0, atol=LOGITS_ATOL)
            top2 = np.sort(np.asarray(want, np.float64))[-2:]
            margins.append(top2[1] - top2[0])
    assert min(margins) > LOGITS_ATOL
    stats = eng.stats()
    assert stats["requests_finished"] == 8 and stats["prefix_hits"] == 0
    assert stats["prefills_run"] == 8 and eng.step_count == ref.step_count


@pytest.mark.parametrize("arch", ARCHS)
def test_server_generate_with_embeddings_matches_reference(arch, monkeypatch):
    """``Server.generate`` with frontend embeddings, the reference's
    ``tests/test_system.py::test_serve_vlm_with_frontend_stub`` pattern, in
    float32 against the reference's ``Server``; then the static CLI, which
    draws the embeddings after the prompts as the reference's does."""
    monkeypatch.setattr(ref_serve_cli, "ServeEngine", Float32RefEngine)
    ref = ref_serve_cli.Server(arch, smoke=True, max_seq=64)
    rng = np.random.RandomState(1)
    prompts = rng.randint(0, ref.cfg.vocab_size, (2, 8)).astype(np.int32)
    fe = _embeds(ref.cfg, 2, 3)
    want = ref.generate(prompts, 4, frontend_embeds=fe)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    lm = lm_params_from_numpy(cfg, ref._engine.params, device="cpu")
    got = port_cli.Server(arch, smoke=True, max_seq=64, lm=lm).generate(prompts, 4, fe)
    assert got["tokens"].shape == (2, 4)
    assert np.array_equal(got["tokens"], want["tokens"])
    res = port_cli.main(["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "8",
                         "--gen", "4", "--device", "cpu"])
    assert res["tokens"].shape == (2, 4)
    assert res["frontend_embeds"].shape == (2, cfg.n_frontend_tokens, cfg.d_model)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_without_embeddings_raises(arch):
    """A frontend arch's prefill refuses tokens alone, as the reference's
    ``_embed_inputs`` asserts; its engine refuses a request without them,
    or with embeddings of the wrong shape, and another arch's engine a
    request with them."""
    _, _, port = _models(arch, "float32")
    with pytest.raises(ValueError, match="needs frontend_embeds"):
        port.prefill(torch.zeros((1, 4), dtype=torch.int64))
    eng = ServeEngine(arch, lm=port, max_seq=32)
    with pytest.raises(ValueError, match="frontend_embeds"):
        eng.submit(np.arange(4), 2)
    with pytest.raises(ValueError, match="frontend_embeds"):
        eng.submit(np.arange(4), 2, frontend_embeds=np.zeros((3, port.cfg.d_model), np.float32))
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(np.arange(20), 8, frontend_embeds=_embeds(port.cfg, 1, 0)[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_cli_stops_at_the_prefix_check(arch, capsys):
    """The serve CLI's ``--continuous`` run on a frontend arch serves the
    trace (each request with its embeddings), then stops at the prefix-reuse
    check, whose prompts carry no embeddings: the reference's CLI stops at
    the same place (its prefill's assert)."""
    with pytest.raises(ValueError, match="prefix-reuse check"):
        port_cli.main(["--arch", arch, "--smoke", "--continuous", "--device", "cpu"])
    assert "served 8/8 requests" in capsys.readouterr().out
