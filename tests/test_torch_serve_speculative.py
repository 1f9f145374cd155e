"""Port parity: chunked prefill and speculative decode in the port's
``ServeEngine`` (the counterpart of ``tests/test_serve_speculative.py``), at
that file's geometry: smoke configs, max_batch 2, page 8, max_seq 64.

Against the JAX package, in float32 (bf16 greedy streams on random weights
have exact top-1 ties, ``tests/test_torch_serve_engine.py``): the port's
engine with ``prefill_chunk=8, speculate=3`` and the reference's, with the
reference's weights converted through numpy, on the reference test's mixed
trace give identical token streams, logits within 1e-4 (the trace's smallest
top-1/top-2 margin exceeding that, so equal streams are a fair demand), and
equal chunk and draft counts; ``LM.prefill_chunk`` gives the reference's
logits chunk by chunk; the folded verify attention gives the reference's
stream implementation's output.

Inside the port, in bf16, bitwise: the chunked + speculative engine against
the plain one-token engine in tokens and logits; the pages and the last
logits after a prompt's last chunk against the monolithic prefill's, with
chunks that straddle a prefill row block; a folded verify row against a
decode-shaped call at its length.  Then the reference file's scheduler and
proposer cases, ported.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode.ops import fold_verify_batch as ref_fold
from repro.kernels.flash_decode.ops import paged_verify_attention as ref_verify
from repro.models.model import LM as RefLM
from repro.models.runtime import Runtime as RefRuntime
from repro.serve import ServeEngine as RefServeEngine
from repro.serve.cache import init_paged_cache as ref_init_paged_cache
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.flash_decode import ops
from repro_torch.models.model import LM
from repro_torch.models.runtime import Runtime
from repro_torch.serve import CapacityPlanner, ServeEngine
from repro_torch.serve.cache import init_paged_cache, write_prefill
from repro_torch.serve.prefix import PrefixCache
from repro_torch.serve.speculate import NgramProposer, find_last_ngram

GEOM = dict(max_batch=2, page_size=8, max_seq=64, seed=0)
KNOBS = dict(prefill_chunk=8, speculate=3)
ARCHS = ["qwen3-14b", "deepseek-v2-236b"]
LOGITS_ATOL = 1e-4


class Float32RefEngine(RefServeEngine):
    @staticmethod
    def config_for(arch, smoke):
        return dataclasses.replace(RefServeEngine.config_for(arch, smoke), dtype="float32")


def _prompt(rng, n):
    return rng.randint(0, 256, n).astype(np.int32)


def _mixed_trace(eng, seed=0, n_requests=8):
    """The reference test's trace: mixed lengths, bursty arrivals, every
    third request sharing a head."""
    rng = np.random.RandomState(seed)
    head = _prompt(rng, 2 * eng.page_size)
    reqs = []
    for i in range(n_requests):
        if i % 3 == 0:
            prompt = np.concatenate([head, _prompt(rng, 3 + rng.randint(0, 8))])
        else:
            prompt = _prompt(rng, int(rng.choice([7, 12, 21, 30])))
        reqs.append(eng.submit(prompt, int(rng.choice([4, 6, 8])), arrival_step=(i // 2) * 2))
    return reqs


def _document_extension(eng):
    """The reference test's speculation workload: a follow-up request
    extends a stored page-aligned document, so drafts from the prefix cache
    are accepted.  Returns (the document's request, the follow-up)."""
    seed = _prompt(np.random.RandomState(3), 16)
    doc_req = eng.submit(seed, 40)
    eng.run()
    doc = np.concatenate([seed, np.asarray(doc_req.generated, np.int32)])
    eng.submit(doc, 1)  # page-aligned: stored whole, a draft source
    eng.run()
    follow = eng.submit(doc[:33].copy(), 20)
    eng.run()
    return [doc_req, follow]


def _workload(eng):
    """The document extension (verify steps with accepted drafts), then the
    mixed trace (chunks; random weights give it few drafts).  In that order:
    the trace's finished prompts would fill the small pool, and admitting
    the follow-up would then evict the stored document."""
    reqs = _document_extension(eng)
    trace = _mixed_trace(eng)
    eng.run()
    return reqs + trace


def _bf16_lm(arch):
    return LM(get_smoke_config(arch), device="cpu").init_params(
        torch.Generator().manual_seed(0))


def _assert_bitwise(reqs_a, reqs_b):
    for ra, rb in zip(reqs_a, reqs_b):
        assert ra.generated == rb.generated, ra.rid
        assert len(ra.logits_trace) == len(rb.logits_trace)
        for la, lb in zip(ra.logits_trace, rb.logits_trace):
            np.testing.assert_array_equal(la, lb)


# ------------------------------------------------------- against the JAX package
@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_speculative_engine_matches_reference_in_float32(arch):
    ref = Float32RefEngine(arch, smoke=True, collect_logits=True, **KNOBS, **GEOM)
    ref_reqs = _workload(ref)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    lm = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, ref.params), device="cpu")
    eng = ServeEngine(arch, lm=lm, collect_logits=True, **KNOBS, **GEOM)
    reqs = _workload(eng)
    margins = []
    for r_ref, r in zip(ref_reqs, reqs):
        assert r.generated == r_ref.generated, r.rid
        assert len(r.logits_trace) == len(r_ref.logits_trace)
        for got, want in zip(r.logits_trace, r_ref.logits_trace):
            np.testing.assert_allclose(got, want, rtol=0, atol=LOGITS_ATOL)
            top2 = np.sort(np.asarray(want, np.float64))[-2:]
            margins.append(top2[1] - top2[0])
    assert min(margins) > LOGITS_ATOL
    got, want = eng.stats(), ref.stats()
    for key in ("requests_finished", "decode_steps", "prefill_chunks", "prefill_chunk_tokens",
                "draft_proposed", "draft_accepted"):
        assert got[key] == want[key], key
    assert got["prefill_chunks"] > 0 and got["draft_accepted"] > 0
    assert eng.step_count == ref.step_count


def _ref_lm_and_port(arch):
    cfg_ref = dataclasses.replace(RefServeEngine.config_for(arch, True), dtype="float32")
    rt = RefRuntime(remat="none", block_q=16, block_k=16, scan_chunk=32, page_size=8,
                    paged_impl="stream")
    ref_lm = RefLM(cfg_ref, rt)
    params, _ = ref_lm.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    lm = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params), device="cpu")
    return ref_lm, params, lm


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_matches_reference_chunk_by_chunk_in_float32(arch):
    """A 30-token prompt in chunks of 8 from s0 = 0 (the last one 6 tokens,
    padded to 8 for the reference): every chunk's last real position's
    logits within 1e-4 of the reference's."""
    ref_lm, params, lm = _ref_lm_and_port(arch)
    page, npp, n_pages = 8, 8, 9
    prompt = _prompt(np.random.RandomState(4), 30)
    table = np.arange(1, npp + 1, dtype=np.int32)[None]
    ref_cache = ref_init_paged_cache(ref_lm, num_pages=n_pages, page_size=page, max_batch=1)
    cache = init_paged_cache(lm, num_pages=n_pages, page_size=page, max_batch=1)
    rt = Runtime(page_size=page, prefill_rows=64)
    chunk = jax.jit(ref_lm.prefill_chunk, static_argnames=("s0",))
    for s0 in range(0, len(prompt), 8):
        n = min(8, len(prompt) - s0)
        tokens = np.zeros(8, np.int32)
        tokens[:n] = prompt[s0:s0 + n]
        want, ref_cache = chunk(params, jnp.asarray(tokens)[None], jnp.int32(n), ref_cache,
                                jnp.asarray(table), s0=s0)
        got, cache = lm.prefill_chunk(torch.from_numpy(tokens)[None], n, cache,
                                      torch.from_numpy(table), s0=s0, rt=rt)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0, n - 1]), rtol=0,
                                   atol=LOGITS_ATOL)


@pytest.mark.parametrize("b,t,ppp", [(3, 4, 4), (2, 2, 3)])
def test_paged_verify_attention_matches_reference(b, t, ppp):
    """The s-major fold and the verify attention against the reference's
    (``impl="stream"``), float32 within 1e-5; each folded row bitwise the
    port's decode call for that row alone at its length."""
    rng = np.random.RandomState(b * 10 + t)
    hk, g, d, page, npp = 2, 2, 16, 8, 6
    n_pages = 1 + b * npp
    q = rng.randn(b, t, hk * g, d).astype(np.float32)
    kp = rng.randn(n_pages, hk, page, d).astype(np.float32)
    vp = rng.randn(n_pages, hk, page, d).astype(np.float32)
    lengths = np.array([5, 17, 30][:b], np.int32)
    tables = (1 + rng.permutation(b * npp)).reshape(b, npp).astype(np.int32)
    toks = rng.randint(0, 256, (b, t)).astype(np.int32)
    folded = ops.fold_verify_batch(torch.from_numpy(toks), torch.from_numpy(lengths),
                                   torch.from_numpy(tables))
    for got, want in zip(folded, ref_fold(jnp.asarray(toks), jnp.asarray(lengths),
                                          jnp.asarray(tables))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    args = [torch.from_numpy(x) for x in (q, kp, vp, lengths, tables)]
    got = ops.paged_verify_attention(*args, pages_per_program=ppp)
    want = ref_verify(*map(jnp.asarray, (q, kp, vp, lengths, tables)), impl="stream",
                      pages_per_program=ppp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    for s in range(b):
        for i in range(t):
            alone = ops.paged_decode_attention(
                args[0][s, i][None], args[1], args[2], args[3][s:s + 1] + 1 + i,
                args[4][s:s + 1], pages_per_program=ppp)
            assert torch.equal(alone[0], got[s, i])


# --------------------------------------------------------- bitwise inside the port
@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_speculative_bit_identical_to_plain_engine_in_bf16(arch):
    """The port of ``test_chunked_speculative_bit_identical_to_baseline``:
    chunks and verify steps change step count, never a token or a logit."""
    lm = _bf16_lm(arch)
    fast = ServeEngine("", lm=lm, collect_logits=True, **KNOBS, **GEOM)
    base = ServeEngine("", lm=lm, collect_logits=True, **GEOM)
    _assert_bitwise(_workload(fast), _workload(base))
    stats = fast.stats()
    assert stats["prefill_chunks"] > 0 and stats["verify_steps"] > 0
    assert stats["draft_accepted"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_pages_after_last_chunk_bitwise_monolithic_prefill_in_bf16(arch):
    """Prefill row blocks of 16 rows and chunks of 6 from s0 = 8 (as after a
    shared page): chunks straddle the block edges at 16, 32 and 48.  After
    the last chunk the prompt's pages and the last position's logits equal
    the monolithic prefill's (pages 0 of the head written by it) bit for
    bit."""
    lm = _bf16_lm(arch)
    page, npp, n_pages, rows, c = 8, 8, 9, 16, 6
    prompt = _prompt(np.random.RandomState(6), 45)
    page_ids = list(range(1, 7))
    table = torch.tensor([page_ids + [0, 0]], dtype=torch.int32)
    rt = Runtime(page_size=page, prefill_rows=rows)
    tokens = np.zeros(48, np.int64)
    tokens[:45] = prompt
    want_logits, pre = lm.prefill(torch.from_numpy(tokens)[None], n_valid=45, rt=rt)
    mono = write_prefill(init_paged_cache(lm, num_pages=n_pages, page_size=page, max_batch=1),
                         pre, slot=0, page_ids=page_ids, page_size=page, n_tokens=45)
    cache = write_prefill(init_paged_cache(lm, num_pages=n_pages, page_size=page, max_batch=1),
                          pre, slot=0, page_ids=page_ids[:1], page_size=page, n_tokens=8)
    for s0 in range(8, 45, c):
        n = min(c, 45 - s0)
        chunk = np.zeros(c, np.int64)
        chunk[:n] = prompt[s0:s0 + n]
        logits, cache = lm.prefill_chunk(torch.from_numpy(chunk)[None], n, cache, table,
                                         s0=s0, rt=rt)
    assert torch.equal(logits, want_logits)
    for layer_got, layer_want in zip(cache, mono):
        for name, pool in layer_got.items():
            got, want = pool[page_ids], layer_want[name][page_ids]
            if name in ("k", "v"):  # (pages, Hk, page, hd): positions < 45
                got = got.transpose(0, 1).reshape(got.shape[1], -1, got.shape[3])[:, :45]
                want = want.transpose(0, 1).reshape(want.shape[1], -1, want.shape[3])[:, :45]
            else:  # (pages, page, width)
                got, want = got.reshape(-1, got.shape[2])[:45], want.reshape(-1, want.shape[2])[:45]
            assert torch.equal(got, want), name


@pytest.mark.parametrize("arch,chunk", [("qwen3-14b", "8"), ("deepseek-v2-236b", "-1")])
def test_cli_chunked_speculative_replay_is_bit_identical(capsys, monkeypatch, tmp_path, arch,
                                                         chunk):
    """The serve CLI with both knobs (``-1``: the tuner's chunk, here an
    empty cache's default): chunk steps, verify steps with accepted drafts,
    and the replay through a plain engine on the same weights token for
    token."""
    from repro_torch.kernels import tune
    from repro_torch.kernels.flash_decode.ops import DEFAULT_PREFILL_CHUNK
    from repro_torch.launch import serve as port_cli

    monkeypatch.setattr(tune, "_default_cache", tune.ConfigCache(str(tmp_path / "tune.json")))

    result = port_cli.main(["--arch", arch, "--smoke", "--continuous", "--device", "cpu",
                            "--prefill-chunk", chunk, "--speculate", "3"])
    out = capsys.readouterr().out
    assert "chunked+speculative vs one-token baseline: bit_identical=yes" in out
    assert "prefix reuse: shared_pages=2 bit_identical=yes" in out
    warm, _ = result["engines"]
    assert result["bit_identical"] is True and result["baseline"].lm is warm.lm
    assert warm.prefill_chunk == (8 if chunk == "8" else DEFAULT_PREFILL_CHUNK)
    stats = warm.stats()
    assert stats["prefill_chunks"] > 0 and stats["verify_steps"] > 0
    assert stats["draft_accepted"] > 0


# ----------------------------------------------------- the reference file's cases
def test_speculation_commits_multiple_tokens_per_step():
    """Document extension: a follow-up prompt extends a stored document, so
    its drafts are accepted and the trace drains in fewer decode steps than
    tokens committed, with the plain engine's tokens."""
    lm = _bf16_lm("qwen3-14b")
    eng = ServeEngine("", lm=lm, speculate=4, **GEOM)
    follow = _document_extension(eng)[1]
    assert follow.generated == _document_extension(ServeEngine("", lm=lm, **GEOM))[1].generated
    s = eng.stats()
    assert s["draft_accepted"] > 0
    assert s["decode_steps"] < s["decode_tokens"]


def test_tiny_chunk_budget_burst_drains_and_bounds_join():
    eng = ServeEngine("qwen3-14b", device="cpu", prefill_chunk=4, **GEOM)
    rng = np.random.RandomState(0)
    reqs = [eng.submit(_prompt(rng, 40), 4, arrival_step=0) for _ in range(4)]
    stats = eng.run()
    assert stats["requests_finished"] == 4
    assert all(r.first_token_step >= 0 for r in reqs)
    assert stats["join_to_first_token_p99"] < 80


def test_admission_backpressure_no_deadlock():
    """Two requests that cannot share the pool are served one after the
    other; one that can never fit raises at submit."""
    eng = ServeEngine("qwen3-14b", device="cpu", prefill_chunk=8, num_pages=6, **GEOM)
    rng = np.random.RandomState(1)
    a = eng.submit(_prompt(rng, 24), 4)  # 4 of the 5 usable pages
    b = eng.submit(_prompt(rng, 24), 4)
    stats = eng.run(max_steps=500)
    assert stats["requests_finished"] == 2
    assert len(a.generated) == len(b.generated) == 4
    with pytest.raises(ValueError, match="never"):
        eng.submit(_prompt(rng, 44), 4)


def test_degenerate_knobs_rejected():
    with pytest.raises(ValueError, match="prefill_chunk"):
        ServeEngine("qwen3-14b", device="cpu", prefill_chunk=0, **GEOM)
    with pytest.raises(ValueError, match="speculate"):
        ServeEngine("qwen3-14b", device="cpu", speculate=-1, **GEOM)
    for kw in (dict(prefill_chunk=8), dict(speculate=2)):
        with pytest.raises(ValueError, match="attention-only"):
            ServeEngine("falcon-mamba-7b", device="cpu", **kw, **GEOM)


def test_find_last_ngram():
    hay = np.array([5, 1, 2, 9, 1, 2, 7], np.int32)
    assert find_last_ngram(hay, np.array([1, 2], np.int32)) == 4
    assert find_last_ngram(hay, np.array([9], np.int32)) == 3
    assert find_last_ngram(hay, np.array([3, 3], np.int32)) == -1
    assert find_last_ngram(hay[:1], np.array([5, 1], np.int32)) == -1


def test_proposer_self_lookup_and_min_n_floor():
    ctx = np.array([7, 3, 9, 4, 7, 3, 9, 4, 7, 3], np.int32)
    np.testing.assert_array_equal(NgramProposer(max_n=3).propose(ctx, 4), [9, 4, 7, 3])
    ctx = np.array([1, 2, 3, 4, 5, 6, 3], np.int32)  # only a 1-gram repeat
    assert len(NgramProposer(max_n=3).propose(ctx, 4)) == 0
    np.testing.assert_array_equal(NgramProposer(max_n=3, min_n=1).propose(ctx, 4),
                                  [4, 5, 6, 3])


def test_proposer_prefix_cache_fallback_and_accounting():
    cache = PrefixCache(page_size=4)

    class _Pool:
        def share(self, pages):
            pass

    cache.register_full(np.arange(100, 116, dtype=np.int32), [1, 2, 3, 4], np.zeros(8), None,
                        _Pool())
    prop = NgramProposer(max_n=3, prefix_cache=cache)
    np.testing.assert_array_equal(prop.propose(np.array([104, 105], np.int32), 4),
                                  [106, 107, 108, 109])
    assert len(prop.propose(np.array([7, 8], np.int32), 4)) == 0
    prop.record(4, 3)
    prop.record(4, 1)
    prop.record(0, 0)
    assert (prop.proposals, prop.proposed_tokens, prop.accepted_tokens) == (2, 8, 4)
    assert prop.accept_rate == 0.5


def test_planner_ingests_the_engines_verify_and_prefill_events():
    """The planner's reading of the rows the reference test feeds it, and of
    a chunked + speculative engine's own ``serve_step`` events: verify rows
    lift the accepted-tokens multiplier, prefill rows give a chunk rate."""
    rows = [
        {"step": 0, "batch": 2, "step_s": 0.010, "kind": "verify", "committed": 6,
         "drafted": 4},
        {"step": 1, "batch": 4, "step_s": 0.012, "kind": "verify", "committed": 12,
         "drafted": 8},
        {"step": 2, "batch": 0, "step_s": 0.004, "kind": "prefill", "prefill_tokens": 16},
    ]
    p = CapacityPlanner()
    p.observe_telemetry(rows)
    assert p.accepted_per_slot_step == pytest.approx(3.0)
    assert p.prefill_tokens_per_s == pytest.approx(16 / 0.004)
    p.fit()
    plain = CapacityPlanner()
    plain.observe_telemetry([{"step": 0, "batch": 2, "step_s": 0.010},
                             {"step": 1, "batch": 4, "step_s": 0.012}])
    plain.fit()
    assert plain.accepted_per_slot_step == 1.0
    assert p.tokens_per_s(4) == pytest.approx(3.0 * plain.tokens_per_s(4))

    eng = ServeEngine("", lm=_bf16_lm("qwen3-14b"), **KNOBS, **GEOM)
    _workload(eng)
    stats = eng.stats()
    planner = CapacityPlanner()
    planner.ingest(eng.events("serve_step"))
    planner.fit()
    assert planner.accepted_per_slot_step == pytest.approx(
        stats["decode_tokens"] / sum(e.batch for e in eng.events("serve_step")))
    assert planner.accepted_per_slot_step > 1.0
    assert planner.prefill_tokens_per_s > 0
