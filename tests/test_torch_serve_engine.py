"""Port parity: the continuous-batching ``ServeEngine`` against the JAX
package's ``repro.serve.ServeEngine`` on the serve CLI's 8-request mixed
trace (qwen3-14b smoke, max_batch 4, page 16, max_seq 96), with the
reference engine's weights converted through numpy.

Token streams are compared in float32, not bf16: in bf16 the reference's
logits along this trace have exact top-1/top-2 ties (smallest margin 0.0),
so any bf16 rounding difference may flip a greedy token, and equal bf16
streams would be an unfair demand.  Both engines get the float32 variant of
the smoke config (the reference's through a subclass that overrides
``config_for``).  In float32 the per-request token streams must be
identical and every step's logits agree to atol 1e-4 (the float32 LM
agrees to about 1e-6, tests/test_torch_lm.py); the test asserts that the
reference trace's smallest top-1/top-2 margin exceeds that tolerance, so
equal streams are a fair demand.

In bf16 the port is held to its own guarantees: prefix-reuse logits bitwise
equal to a cold engine's (the CLI's check, and across prefill row blocks),
``stream`` and ``gather`` giving
bitwise equal streams, a page pool that never hands out the scratch page,
and a capacity planner that fits on the port's ``serve_step`` events.

deepseek-v2 (smoke: a dense head layer and a MoE layer, both MLA) is held as
qwen3-14b is: float32 token streams and logits against the reference engine
(both MoE evals dropless), and in bf16 prefix reuse across prefill row
blocks bitwise.

qwen1.5-110b (its QKV biases drawn at random in the reference engine's
weights: they are zeros at init), qwen3-32b and jamba (its smoke period of
8: 7 Mamba layers, attention at position 4, top-2 MoE on the odd layers)
are held as qwen3-14b is; jamba's bf16 check is the bitwise prefix reuse,
its bf16 routing flipping at near ties against the reference's
(tests/test_torch_lm.py).  The frontend archs: tests/test_torch_frontend.py.

falcon-mamba (smoke: 1 Mamba layer, d_inner 128, d_state 4) is held the
same way: float32 token streams and logits against the reference engine on
the same trace (every prompt there has at least the 3 tokens the
reference's conv tail needs, ``tests/test_torch_mamba.py``), and in bf16
whole-prompt reuse, which restores the recurrent state, bitwise equal to
the first serving of the prompt, as ``tests/test_serve.py`` holds the
reference.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import check_prefix_reuse_across_row_blocks, randomize_qkv_bias
from repro.launch.serve import _mixed_trace_specs as ref_trace_specs
from repro.serve import ServeEngine as RefServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve as port_cli
from repro_torch.models.model import LM
from repro_torch.serve import SCRATCH_PAGE, CapacityPlanner, ServeEngine

ENGINE = dict(max_batch=4, page_size=16, max_seq=96, collect_logits=True)
ARCHS = ["qwen3-14b", "falcon-mamba-7b", "deepseek-v2-236b", "deepseek-moe-16b",
         "qwen1.5-110b", "qwen3-32b", "jamba-1.5-large-398b"]
LOGITS_ATOL = 1e-4


class Float32RefEngine(RefServeEngine):
    @staticmethod
    def config_for(arch, smoke):
        return dataclasses.replace(RefServeEngine.config_for(arch, smoke), dtype="float32")


def _serve(eng, specs):
    reqs = [eng.submit(p, gen, arrival_step=arr) for p, gen, arr, _ in specs]
    eng.run()
    return reqs


def test_trace_copy_is_the_reference_trace():
    cfg = get_smoke_config("qwen3-14b")
    for seed in (0, 1):
        want = ref_trace_specs(cfg, 16, 8, seed)
        got = port_cli._mixed_trace_specs(cfg, 16, 8, seed)
        for (p1, g1, a1, f1), (p2, g2, a2, f2) in zip(got, want):
            assert np.array_equal(p1, p2) and (g1, a1, f1) == (g2, a2, f2)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_token_streams_match_reference_in_float32(arch):
    ref = Float32RefEngine(arch, smoke=True, seed=0, **ENGINE)
    ref.params = jax.tree.map(jnp.asarray, randomize_qkv_bias(jax.tree.map(np.array, ref.params)))
    specs = ref_trace_specs(ref.cfg, 16, 8, 0)
    assert min(len(p) for p, _, _, _ in specs) >= 3
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
    assert eng.stats()["requests_finished"] == ref.stats()["requests_finished"] == 8
    assert eng.step_count == ref.step_count


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_the_trace_and_prefix_reuse_is_bit_identical(capsys, arch):
    result = port_cli.main(["--arch", arch, "--smoke", "--continuous",
                            "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 8/8 requests" in out
    assert "bit_identical=yes" in out
    assert "f(b) step model" in out and "capacity plan: continuous@b" in out
    assert result["served"] == result["requests"] == 8
    warm, cold = result["engines"]
    assert warm.lm is cold.lm  # the cold engine shares the warm engine's weights


def test_cli_without_continuous_is_refused():
    """Without --continuous the CLI runs the static batch (Server.generate,
    tests/test_torch_serve_static.py) and no longer exits, a frontend arch's
    too, its embeddings drawn after the prompts; what is refused is a
    frontend arch's --continuous run at its prefix-reuse check, whose
    prompts carry no embeddings, where the reference's CLI stops too
    (tests/test_torch_frontend.py)."""
    res = port_cli.main(["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "4",
                         "--gen", "2"])
    assert res["tokens"].shape == (2, 2)
    res = port_cli.main(["--arch", "musicgen-medium", "--smoke", "--device", "cpu", "--batch",
                         "2", "--prompt-len", "4", "--gen", "2"])
    assert res["tokens"].shape == (2, 2) and res["frontend_embeds"].shape == (2, 8, 64)
    with pytest.raises(ValueError, match="prefix-reuse check"):
        port_cli.main(["--arch", "musicgen-medium", "--smoke", "--continuous", "--device", "cpu"])


def _recording_engine(lm, paged_impl, handed_out):
    eng = ServeEngine("qwen3-14b", lm=lm, paged_impl=paged_impl, **ENGINE)
    alloc = eng.pool.alloc

    def recording_alloc(n):
        pages = alloc(n)
        handed_out.extend(pages)
        return pages

    eng.pool.alloc = recording_alloc
    return eng


def test_bf16_stream_and_gather_streams_bitwise_and_scratch_never_handed_out():
    cfg = get_smoke_config("qwen3-14b")
    lm = LM(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    specs = port_cli._mixed_trace_specs(cfg, 16, 8, 0)
    handed_out = []
    runs = {}
    for impl in ("stream", "gather"):
        eng = _recording_engine(lm, impl, handed_out)
        runs[impl] = (_serve(eng, specs), eng)
    for r_s, r_g in zip(runs["stream"][0], runs["gather"][0]):
        assert r_s.generated == r_g.generated
        assert all(np.array_equal(a, b) for a, b in zip(r_s.logits_trace, r_g.logits_trace))
    assert handed_out and SCRATCH_PAGE not in handed_out
    eng = runs["stream"][1]
    assert eng.pool.refcount(SCRATCH_PAGE) == 1

    planner = CapacityPlanner()
    assert planner.ingest(eng.events("serve_step")) == eng.stats()["decode_steps"]
    planner.fit()
    assert planner.step_time(4) > 0
    assert planner.plan(target_p50_s=10.0, qps=0.1, gen_tokens=8, batch_grid=[1, 2, 4],
                        m_grid=[1, 2])


def test_unported_engine_options_raise():
    """What the engine refuses: chunked prefill and speculation on an arch
    with recurrent layers (as the reference does), frontend embeddings for
    an arch without a frontend (tests/test_torch_frontend.py holds the
    frontend archs'), and a request past ``max_seq``."""
    for kw in (dict(prefill_chunk=8), dict(speculate=2)):
        with pytest.raises(ValueError, match="attention-only"):
            ServeEngine("falcon-mamba-7b", device="cpu", **kw)
    eng = ServeEngine("qwen3-14b", device="cpu", max_seq=32)
    with pytest.raises(ValueError, match="frontend_embeds"):
        eng.submit(np.arange(8), 4, frontend_embeds=np.zeros((2, eng.cfg.d_model), np.float32))
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(np.arange(30), 4)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefix_reuse_bitwise_across_prefill_row_blocks(arch):
    lm = LM(get_smoke_config(arch), device="cpu").init_params(
        torch.Generator().manual_seed(0))
    check_prefix_reuse_across_row_blocks(lm)


def test_full_prompt_reuse_with_mamba_state():
    """The port of ``tests/test_serve.py::test_full_prompt_reuse_with_mamba_state``
    (bf16, the same geometry): the second serving of a prompt skips its
    prefill and restores the stored state, and its tokens and logits are
    bitwise those of the first."""
    rng = np.random.RandomState(5)
    prompt = rng.randint(0, 256, 16).astype(np.int32)
    eng = ServeEngine("falcon-mamba-7b", device="cpu", collect_logits=True, max_batch=2,
                      page_size=8, max_seq=64, seed=0)
    r1 = eng.submit(prompt, max_new_tokens=4)
    eng.run()
    r2 = eng.submit(prompt, max_new_tokens=4)
    eng.run()
    assert not r1.prefill_skipped and r2.prefill_skipped
    assert r1.generated == r2.generated
    for got, want in zip(r2.logits_trace, r1.logits_trace):
        np.testing.assert_array_equal(got, want)
