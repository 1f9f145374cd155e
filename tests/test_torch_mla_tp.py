"""MLA under tensor parallelism (``repro_torch.models.mla`` over a rank's
heads, ``repro_torch.serve.sharding``), with the MoE FFN on its
expert-parallel path, on the CPU: the smoke deepseek-v2-236b (4 MLA heads,
2 a rank; 8 experts, 4 a rank; one shared expert, half its width a rank)
in float32, two gloo ranks on a (1, 2) mesh.

* Served: the mixed trace of tests/test_torch_serve_engine.py through a
  2-way engine (prefill through K3's plain version over the rank's heads,
  the paged absorbed decode through K2-latent's), and through a 2-way
  engine with ``prefill_chunk=8`` and ``speculate=3`` (chunks, and verify
  steps on the serve CLI's document extension, which drafts from the
  prefix cache), each against the reference's unsharded engine with the same
  knobs: the same token streams, and every step's logits within
  ``LOGITS_RTOL`` = 1e-5 of their largest magnitude (the sums over "model"
  round otherwise).  The reference's own sharded engine raises
  ``ShardingTypeError`` on this host's JAX (ROADMAP.md queue 3), so its
  unsharded engine is the yardstick.  The ranks' tokens and logits are the
  same bits.
* Trained: one forward and backward of the 2-way slice against the port's
  whole model on one rank, on the same batch: the loss within 1e-5
  relative; the replicated down-projections and latent norms (``wq_a``,
  ``wkv_a``, ``q_a_norm``, ``kv_a_norm``) get whole gradients, the same
  bits on both ranks, within 1e-4 of the one rank's largest; every sliced
  leaf's gradient the one rank's gradient's slice within 1e-4 of its
  largest.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_tp_ranks import Spawned
from repro.launch.serve import _mixed_trace_specs as ref_trace_specs
from repro.serve import ServeEngine as RefServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.dist.partitioning import Rules
from repro_torch.launch.serve import _document_extension
from repro_torch.models.runtime import Runtime
from repro_torch.serve.sharding import ShardingPlan

ARCH = "deepseek-v2-236b"
ENGINE = dict(max_batch=4, page_size=16, max_seq=96, collect_logits=True)
KNOBS = dict(prefill_chunk=8, speculate=3)
LOGITS_RTOL, LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-5, 1e-4
SEQ, BATCH = 16, 2
SPAWN_TIMEOUT_S = 240
WHOLE = ("wq_a", "wkv_a", "q_a_norm", "kv_a_norm")


class Float32RefEngine(RefServeEngine):
    @staticmethod
    def config_for(arch, smoke):
        return dataclasses.replace(RefServeEngine.config_for(arch, smoke), dtype="float32")


def _cfg():
    return dataclasses.replace(get_smoke_config(ARCH), dtype="float32")


def _batch():
    rng = np.random.RandomState(4)
    tokens = rng.randint(0, 256, (BATCH, SEQ + 1)).astype(np.int64)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's unsharded engines (plain and with the knobs), then
    the ranks' jobs on its weights, and the one-rank training step computed
    while they run."""
    refs = {}
    for name, knobs in (("plain", {}), ("knobs", KNOBS)):
        ref = Float32RefEngine(ARCH, smoke=True, seed=0, **ENGINE, **knobs)
        specs = ref_trace_specs(ref.cfg, 16, 8, 0)
        reqs = [ref.submit(p, gen, arrival_step=arr) for p, gen, arr, _ in specs]
        ref.run()
        if knobs:  # the CLI's speculation workload: a document to draft from
            reqs += _document_extension(ref, 0)
        refs[name] = (ref, specs, reqs)
    params = jax.tree.map(np.array, refs["plain"][0].params)
    base = {"cfg": _cfg(), "params": params, "specs": refs["plain"][1]}
    jobs = {"plain": dict(base, kind="engine", engine=dict(ENGINE)),
            "knobs": dict(base, kind="engine", engine=dict(ENGINE, **KNOBS), tokens_only=True),
            "train": dict(base, kind="train_grads", batch=_batch())}
    ranks = Spawned(2, jobs, str(tmp_path_factory.mktemp("mla_tp")), SPAWN_TIMEOUT_S)
    whole = lm_params_from_numpy(_cfg(), params, device="cpu").trainable()
    loss, extra = whole.loss_fn({k: torch.from_numpy(v) for k, v in _batch().items()},
                                Runtime(block_q=16, block_k=16))
    loss.backward()
    one = {"loss": float(loss.detach()), "whole": whole}
    return refs, one, ranks.results()


@pytest.mark.parametrize("engine", ["plain", "knobs"])
def test_served_2way_matches_the_reference_unsharded_engine(run, engine):
    refs, _, ranks = run
    ref, _, ref_reqs = refs[engine]
    for r, res in enumerate(ranks):
        got = res[engine]
        for req, tokens, logits in zip(ref_reqs, got["tokens"], got["logits"]):
            assert tokens == req.generated, (r, req.rid)
            want = np.stack(req.logits_trace)
            err = float(np.abs(logits - want).max())
            assert err <= LOGITS_RTOL * float(np.abs(want).max()), (r, req.rid, err)
    if engine == "plain":
        assert ranks[0]["plain"]["local_heads"] == (2, 1)
        assert ranks[0]["plain"]["prefix_reuse_bit_identical"] is True
    else:
        assert ranks[0]["knobs"]["stats"]["prefill_chunks"] > 0
        assert ranks[0]["knobs"]["stats"]["verify_steps"] > 0
    assert ranks[0][engine]["tokens"] == ranks[1][engine]["tokens"]
    for a, b in zip(ranks[0][engine]["logits"], ranks[1][engine]["logits"]):
        np.testing.assert_array_equal(a, b)


def test_trained_2way_matches_one_rank(run):
    _, one, ranks = run
    whole = one["whole"]
    mesh = type("FakeMesh", (), {"axis_names": ("data", "model"),
                                 "devices": np.empty((1, 2))})()
    specs = list(ShardingPlan(mesh, Rules.for_serving(mesh), rank=0).param_specs(whole))
    for r, res in enumerate(ranks):
        got = res["train"]
        assert got["local_heads"] == 2
        assert abs(got["loss"] - one["loss"]) <= LOSS_RTOL * abs(one["loss"])
        plan = ShardingPlan(mesh, Rules.for_serving(mesh), rank=r)
        checked = 0
        for (t, name, _, spec), (got_name, g) in zip(specs, got["grads"]):
            assert got_name == name
            want = plan.slice_param(t.grad, name, spec).numpy()
            assert g.shape == want.shape, name
            err = float(np.abs(g - want).max())
            assert err <= GRAD_RTOL * float(np.abs(want).max()) + 1e-12, (r, name, err)
            if name in WHOLE:
                assert g.shape == tuple(t.shape), name
                checked += 1
        assert checked == len(WHOLE) * whole.cfg.n_layers  # every layer is MLA
    for (name, a), (_, b) in zip(ranks[0]["train"]["grads"], ranks[1]["train"]["grads"]):
        if name in WHOLE:
            np.testing.assert_array_equal(a, b)  # the same bits on both ranks
