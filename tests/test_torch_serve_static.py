"""Port parity: the static serve mode, ``Server.generate`` and the serve
CLI without ``--continuous``, against the JAX package's ``Server`` at the
qwen3-14b smoke config (batch 2, prompts of 8 tokens, 4 generated each),
the reference engine's weights converted through numpy.

Tokens are compared in float32, as in tests/test_torch_serve_engine.py: in
bf16 the reference's greedy logits can tie exactly, and equal bf16 streams
would be an unfair demand; in float32 the LM agrees to about 1e-6
(tests/test_torch_lm.py), so the token streams must be identical.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import repro.launch.serve as ref_serve_cli
from repro.serve import ServeEngine as RefServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve as port_cli


class Float32RefEngine(RefServeEngine):
    @staticmethod
    def config_for(arch, smoke):
        return dataclasses.replace(RefServeEngine.config_for(arch, smoke), dtype="float32")


def test_generate_matches_reference_in_float32(monkeypatch):
    monkeypatch.setattr(ref_serve_cli, "ServeEngine", Float32RefEngine)
    prompts = np.random.RandomState(0).randint(0, 256, (2, 8)).astype(np.int32)
    ref = ref_serve_cli.Server("qwen3-14b", smoke=True, max_seq=32)
    want = ref.generate(prompts, 4)
    cfg = dataclasses.replace(get_smoke_config("qwen3-14b"), dtype="float32")
    lm = lm_params_from_numpy(cfg, ref._engine.params, device="cpu")
    port = port_cli.Server("qwen3-14b", smoke=True, max_seq=32, lm=lm)
    got = port.generate(prompts, 4)
    assert got["tokens"].shape == (2, 4) and got["tokens"].dtype == np.int32
    assert np.array_equal(got["tokens"], want["tokens"])
    assert got["prefill_s"] > 0 and got["decode_s"] > 0 and got["decode_tok_per_s"] > 0
    again = port.generate(prompts, 4)  # the engine is reused across calls
    assert np.array_equal(again["tokens"], want["tokens"])
    one = port.generate(prompts[:1], 4)  # another batch: a new engine, the same weights
    assert port._engine.lm is lm and np.array_equal(one["tokens"], want["tokens"][:1])


def test_static_cli_runs_the_server(capsys):
    res = port_cli.main(["--arch", "qwen3-14b", "--smoke", "--batch", "2", "--prompt-len", "8",
                         "--gen", "4", "--device", "cpu"])
    assert res["tokens"].shape == (2, 4)
    assert "generated (2, 4) tokens; prefill" in capsys.readouterr().out


def test_server_refuses_what_it_cannot_place():
    """A mesh is ported (tests/test_torch_tp.py), MLA over K ranks too
    (tests/test_torch_mla_tp.py), but not MLA heads that do not divide K,
    which the server refuses by name (the smoke deepseek-v2's 4 heads on a
    stand-in mesh of 8 ranks: the plan refuses before it needs a process
    group); rules need a mesh.  Frontend embeddings are ported, for the
    frontend archs (tests/test_torch_frontend.py), and an arch without a
    frontend refuses them."""
    mesh = SimpleNamespace(axis_names=("data", "model"), devices=np.empty((1, 8)))
    with pytest.raises(NotImplementedError, match="4 MLA heads do not divide 8 ranks"):
        port_cli.Server("deepseek-v2-236b", smoke=True, device="cpu", mesh=mesh).generate(
            np.zeros((1, 4), np.int32), 2)
    with pytest.raises(ValueError, match="without a mesh"):
        port_cli.Server("qwen3-14b", rules=object())
    server = port_cli.Server("qwen3-14b", smoke=True, device="cpu")
    with pytest.raises(ValueError, match="frontend_embeds"):
        server.generate(np.zeros((1, 4), np.int32), 2, frontend_embeds=np.zeros((1, 8, 64)))
