"""Tensor-parallel serving in the port (``repro_torch.serve.sharding``,
``repro_torch.dist``, ``repro_torch.launch.mesh``, ``--tp K``) against the
JAX package, on the CPU: two ranks, one process each, over gloo, the
float32 smoke configs of qwen3-14b, qwen1.5-110b (its QKV biases drawn at
random: they are zeros at init) and falcon-mamba-7b.

* Each rank's local tensors equal the slice of the reference's weights that
  the reference's ``Rules.for_serving`` spec names (Mamba's ``in_proj``: the
  rank's slice of each of its x and z halves), in process, no group needed;
  and, in the ranks, ``distribute_tensor``'s shard of the whole tensor with
  the spec's DTensor placements.
* On the serve trace of tests/test_torch_serve_engine.py, the TP2 engine's
  token streams equal the reference's *unsharded* ``ServeEngine``'s and
  every step's logits agree within ``LOGITS_ATOL`` (the reference's own
  sharded engine fails on this host's JAX, so it is the yardstick the
  reference's exactness contract allows: token streams the identity surface
  at world size > 1, logits to float tolerance); the prefix-reuse check is
  bit for bit under TP2; a migration's snapshot holds the whole cache
  (tests/test_torch_migrate.py hands a TP2 replica off).
* A (1, 1) mesh (a one-rank gloo group) gives the port's unsharded engine's
  tokens and logits bit for bit.
* The MoE and MLA archs' 2-way plans place them (E / K experts, n_heads /
  K MLA heads, 1 / K of the shared width; tests/test_torch_mla_tp.py and
  tests/test_torch_moe_ep.py serve and train them), and the refusals by
  name: heads, experts or a shared width that do not divide K, a spec that
  would split a head (KV heads, or the KV pool's ``cache_head_dim``), FSDP
  over "data".
* ``Server(mesh=...)`` and the serve CLI's ``--continuous --tp 2`` and
  ``--router --replicas 2 --tp 2`` (``--device cpu``, as subprocesses).

All of the module's two-rank cases run in one spawned group (a module
fixture), each rank on one thread, its rendezvous file under a temporary
directory, never a fixed port.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import randomize_qkv_bias
from _torch_tp_ranks import spawn_ranks
from repro.dist.partitioning import Rules as RefRules
from repro.launch.serve import _mixed_trace_specs as ref_trace_specs
from repro.serve import ServeEngine as RefServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.dist.partitioning import Rules
from repro_torch.launch.mesh import init_distributed, make_debug_mesh
from repro_torch.launch.serve import Server
from repro_torch.serve import ServeEngine
from repro_torch.serve.sharding import ShardingPlan

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen3-14b", "qwen1.5-110b", "falcon-mamba-7b"]
ENGINE = dict(max_batch=4, page_size=16, max_seq=96, collect_logits=True)
LOGITS_ATOL = 1e-4
SPAWN_TIMEOUT_S = 240


class FakeMesh:
    def __init__(self, shape, names=("data", "model")):
        self.axis_names = names
        self.devices = np.empty(shape)


class Float32RefEngine(RefServeEngine):
    @staticmethod
    def config_for(arch, smoke):
        return dataclasses.replace(RefServeEngine.config_for(arch, smoke), dtype="float32")


def _f32(arch):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


@pytest.fixture(scope="module")
def reference():
    """Per arch: the reference engine's float32 weights (numpy), its trace
    and its requests served unsharded."""
    out = {}
    for arch in ARCHS:
        ref = Float32RefEngine(arch, smoke=True, seed=0, **ENGINE)
        params = randomize_qkv_bias(jax.tree.map(np.array, ref.params))
        ref.params = jax.tree.map(jnp.asarray, params)
        specs = ref_trace_specs(ref.cfg, 16, 8, 0)
        reqs = [ref.submit(p, gen, arrival_step=arr) for p, gen, arr, _ in specs]
        ref.run()
        out[arch] = {"params": params, "specs": specs, "reqs": reqs, "ref": ref}
    return out


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    """Both ranks' results of every two-rank job, from one spawned group."""
    jobs = {arch: {"kind": "engine", "cfg": _f32(arch), "params": reference[arch]["params"],
                   "specs": reference[arch]["specs"],
                   "engine": {k: v for k, v in ENGINE.items()}}
            for arch in ARCHS}
    jobs["server"] = {"kind": "server", "cfg": _f32("qwen3-14b"),
                      "params": reference["qwen3-14b"]["params"],
                      "prompts": np.random.RandomState(5).randint(0, 256, (3, 12)),
                      "gen": 6}
    workdir = tmp_path_factory.mktemp("tp_ranks")
    return spawn_ranks(2, jobs, str(workdir), SPAWN_TIMEOUT_S)


def _ref_slice(plan, a, name, spec):
    """The reference array's slice that ``spec`` names for ``plan``'s rank,
    in numpy (``in_proj``: each half's slice)."""
    t = torch.from_numpy(np.asarray(a, np.float32))
    return plan.slice_param(t, name, spec).numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_each_ranks_tensors_are_the_reference_specs_slices(reference, arch):
    params = reference[arch]["params"]
    whole = lm_params_from_numpy(_f32(arch), params, device="cpu")
    mesh = FakeMesh((1, 2))
    ref_rules = RefRules.for_serving(mesh)
    from repro_torch.convert import param_layout

    for rank in range(2):
        plan = ShardingPlan(mesh, Rules.for_serving(mesh), rank=rank)
        local = plan.shard_params(whole.cfg, source=whole)
        assert local.shard.rank == rank and local.shard.world == 2
        axes = {path: ax for path, _, ax in whole.leaf_axes()}
        checked = 0
        for (path, n, dst) in param_layout(local):
            ax = axes[path]
            leaf = params
            for key in path:
                leaf = leaf[key]
            leaf = np.asarray(leaf if n is None else leaf[n], np.float32)
            spec = tuple(ref_rules.param_pspec(ax, leaf.shape))
            want = _ref_slice(plan, leaf, path[-1], spec)
            if path[-1] == "in_proj" and "model" in spec:
                di = leaf.shape[1] // 2
                half = di // 2
                want_np = np.concatenate([leaf[:, rank * half:(rank + 1) * half],
                                          leaf[:, di + rank * half:di + (rank + 1) * half]], 1)
                np.testing.assert_array_equal(want, want_np)
            elif "model" in spec:
                dim = spec.index("model")
                size = leaf.shape[dim] // 2
                np.testing.assert_array_equal(
                    want, np.take(leaf, np.arange(rank * size, (rank + 1) * size), axis=dim))
            else:
                np.testing.assert_array_equal(want, leaf)
            np.testing.assert_array_equal(dst.numpy(), want)
            checked += 1
        assert checked == sum(1 for _ in param_layout(whole))


@pytest.mark.parametrize("arch", ARCHS)
def test_ranks_drawn_from_a_seed_hold_the_unsharded_models_slices(arch):
    """``shard_params`` from a seed draws each whole matrix as
    ``LM.init_params`` does (the whole model's initialisers and scales) and
    keeps the rank's slice: the unsharded model's weights, sliced, bit for
    bit, in the config's bf16."""
    from repro_torch.models.model import LM

    cfg = get_smoke_config(arch)
    whole = LM(cfg, "cpu").init_params(torch.Generator().manual_seed(3))
    mesh = FakeMesh((1, 2))
    for rank in range(2):
        plan = ShardingPlan(mesh, Rules.for_serving(mesh), rank=rank)
        local = plan.shard_params(cfg, "cpu", seed=3)
        pairs = zip(plan.param_specs(whole), local.init_entries())
        for (t, name, _, spec), (dst, _, _) in pairs:
            assert torch.equal(dst, plan.slice_param(t, name, spec)), name


@pytest.mark.parametrize("arch", ARCHS)
def test_tp2_engine_matches_the_reference_unsharded_engine(reference, ranks, arch):
    ref_reqs = reference[arch]["reqs"]
    cfg = _f32(arch)
    for r, res in enumerate(ranks):
        got = res[arch]
        assert got["dtensor_checked"] > 0
        if cfg.n_heads:
            assert got["local_heads"] == (cfg.n_heads // 2, cfg.n_kv_heads // 2)
        assert got["vocab_rows"] == cfg.vocab_size // 2
        assert got["steps"] == reference[arch]["ref"].step_count
        for req, tokens, logits in zip(ref_reqs, got["tokens"], got["logits"]):
            assert tokens == req.generated, (r, req.rid)
            np.testing.assert_allclose(logits, np.stack(req.logits_trace), rtol=0,
                                       atol=LOGITS_ATOL)
    # the ranks in step: the same tokens and the same logits' bits
    assert ranks[0][arch]["tokens"] == ranks[1][arch]["tokens"]
    for a, b in zip(ranks[0][arch]["logits"], ranks[1][arch]["logits"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp2_prefix_reuse_bitwise_and_the_snapshot_whole(ranks, arch):
    """The snapshot's leaves are whole: the rank's pools and states with
    their split dim (KV heads, Mamba channels) doubled."""
    cfg = _f32(arch)
    for res in ranks:
        assert res[arch]["prefix_reuse_bit_identical"] is True
        for whole, local in zip(res[arch]["snapshot_shapes"], res[arch]["local_shapes"]):
            for name, shape in whole.items():
                dim = 1
                want = list(local[name])
                want[dim] *= 2
                assert shape == tuple(want), (name, shape, local[name])
                assert shape[dim] == (cfg.n_kv_heads if name in ("k", "v") else
                                      cfg.mamba.resolved_d_inner(cfg.d_model))


def test_server_on_a_mesh(reference, ranks):
    """``Server(mesh=...)`` no longer raises: both ranks generate, the same
    tokens, and those of the unsharded ``Server`` on the same weights."""
    whole = lm_params_from_numpy(_f32("qwen3-14b"), reference["qwen3-14b"]["params"],
                                 device="cpu")
    want = Server("", lm=whole, max_seq=48).generate(
        np.random.RandomState(5).randint(0, 256, (3, 12)), 6)["tokens"]
    for res in ranks:
        np.testing.assert_array_equal(res["server"], want)


@pytest.fixture
def one_rank_group(tmp_path):
    """A one-rank gloo group in this process, destroyed after the test."""
    import torch.distributed as dist

    init_distributed(0, 1, str(tmp_path / "rendezvous"), "cpu", verbose=False)
    try:
        yield make_debug_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def test_mesh_1x1_is_bitwise_the_unsharded_engine(reference, one_rank_group):
    for arch in ("qwen3-14b", "falcon-mamba-7b"):
        whole = lm_params_from_numpy(_f32(arch), reference[arch]["params"], device="cpu")
        runs = []
        for mesh in (None, one_rank_group):
            eng = ServeEngine("", lm=whole, mesh=mesh, paged_impl="stream", **ENGINE)
            reqs = [eng.submit(p, gen, arrival_step=arr)
                    for p, gen, arr, _ in reference[arch]["specs"]]
            eng.run()
            runs.append((eng, reqs))
        (plain, plain_reqs), (sharded, sharded_reqs) = runs
        assert sharded.plan is not None and sharded.plan.world == 1 and sharded.lm is whole
        for a, b in zip(plain_reqs, sharded_reqs):
            assert a.generated == b.generated
            for x, y in zip(a.logits_trace, b.logits_trace):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "deepseek-moe-16b",
                                  "jamba-1.5-large-398b"])
def test_mla_and_moe_archs_place_at_world_size_2(arch):
    """The 2-way plan of an MLA or MoE arch: each rank's tensors are its
    slices of the whole model's draws (experts ``r E / 2 ..``, the router's
    and the shared experts' columns, ``sh_down``'s rows, MLA's ``wq_b`` /
    ``wkv_b`` columns and ``wo`` rows; ``wq_a``, ``wkv_a`` and the latent
    norms whole), at the local config's widths; and the refusals of what
    would split a head or an expert group, by name."""
    from repro_torch.models.model import LM

    cfg = get_smoke_config(arch)
    whole = LM(cfg, "cpu").init_params(torch.Generator().manual_seed(3))
    mesh = FakeMesh((1, 2))
    for rank in range(2):
        plan = ShardingPlan(mesh, Rules.for_serving(mesh), rank=rank)
        local = plan.shard_params(cfg, "cpu", seed=3)
        lc = local.cfg
        assert lc.moe.expert_shards == 2 and lc.moe.n_routed_experts == cfg.moe.n_routed_experts
        assert lc.n_heads == cfg.n_heads // 2
        for (t, name, _, spec), (dst, _, _) in zip(plan.param_specs(whole),
                                                   local.init_entries()):
            assert torch.equal(dst, plan.slice_param(t, name, spec)), name
            if name in ("wq_a", "wkv_a", "q_a_norm", "kv_a_norm"):
                assert torch.equal(dst, t), name
        moe = next(blk.ffn for blk in local.layers if blk.spec.ffn == "moe")
        assert moe["w_gate"].shape[0] == moe["w_down"].shape[0] == cfg.moe.n_routed_experts // 2
        assert moe["router"].shape == (cfg.d_model, cfg.moe.n_routed_experts // 2)
        if cfg.moe.n_shared_experts:
            fs = cfg.moe.n_shared_experts * cfg.moe.expert_d_ff
            assert moe["sh_gate"].shape == (cfg.d_model, fs // 2)
            assert moe["sh_down"].shape == (fs // 2, cfg.d_model)
    # what does not divide K is refused by name, never replicated
    odd = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_routed_experts=6))
    mesh4 = FakeMesh((1, 4))
    wide = dataclasses.replace(odd, n_heads=8, n_kv_heads=4) if cfg.mla is None else \
        dataclasses.replace(odd, n_heads=8, n_kv_heads=8)
    with pytest.raises(NotImplementedError, match="6 routed experts are not split over 4"):
        ShardingPlan(mesh4, Rules.for_serving(mesh4), rank=0).check(wide)
    if cfg.mla is not None:
        with pytest.raises(NotImplementedError, match="4 MLA heads do not divide 8 ranks"):
            mesh8 = FakeMesh((1, 8))
            ShardingPlan(mesh8, Rules.for_serving(mesh8), rank=0).check(cfg)
    if cfg.moe.n_shared_experts:
        shared = dataclasses.replace(wide, moe=dataclasses.replace(
            wide.moe, n_routed_experts=8, expert_d_ff=66))
        with pytest.raises(NotImplementedError, match="shared experts' width 66"):
            ShardingPlan(mesh4, Rules.for_serving(mesh4), rank=0).check(shared)
    # a (1, 1) mesh places them whole
    mesh = FakeMesh((1, 1))
    ShardingPlan(mesh, Rules.for_serving(mesh), rank=0).check(cfg)


def test_head_splitting_specs_refused_never_replicated():
    """qwen3-14b's smoke config has 2 KV heads: over 4 ranks ``kv_flat``
    (2 x 16 columns) would shard inside a head, and the KV pool's
    ``cache_head_dim`` takes the model axis; over 2 ranks its 4 heads split
    at head bounds, but not when the rules put only the query heads on
    "model"."""
    cfg = get_smoke_config("qwen3-14b")
    mesh4 = FakeMesh((1, 4))
    with pytest.raises(NotImplementedError, match="split a head"):
        ShardingPlan(mesh4, Rules.for_serving(mesh4), rank=0).check(cfg)
    rules = Rules.for_serving(mesh4)
    assert rules.act_pspec(("cache_batch", "act_kv_heads", "cache_seq", "cache_head_dim"),
                           (33, 2, 16, 16)) == (None, None, None, "model")
    mesh2 = FakeMesh((1, 2))
    only_q = Rules.for_serving(mesh2).override(params={"kv_flat": None})
    with pytest.raises(NotImplementedError, match="without their KV heads"):
        ShardingPlan(mesh2, only_q, rank=0).check(cfg)
    no_pool_heads = Rules.for_serving(mesh2).override(acts={"act_kv_heads": None})
    with pytest.raises(NotImplementedError, match="cache_head_dim"):
        ShardingPlan(mesh2, no_pool_heads, rank=0).check(cfg)
    fsdp = FakeMesh((2, 2))
    with pytest.raises(NotImplementedError, match="FSDP over 'data' is the trainer's"):
        ShardingPlan(fsdp, Rules.default(fsdp), rank=0).check(cfg)


def _cli(*argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
                           "--device", "cpu", *argv], env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=SPAWN_TIMEOUT_S)


@pytest.mark.parametrize("argv, lines", [
    (["--continuous", "--tp", "2"], ["prefix reuse: shared_pages=2 bit_identical=yes"]),
    (["--router", "--replicas", "2", "--tp", "2"],
     ["routed fleet vs single engine: bit_identical=yes",
      "prefix reuse: shared_pages=2 bit_identical=yes"]),
], ids=["continuous", "router"])
def test_serve_cli_tp2_on_the_cpu(argv, lines):
    out = _cli("--arch", "qwen3-14b", *argv)
    assert out.returncode == 0, out.stderr[-3000:]
    text = out.stdout
    assert "tensor parallel: 2-way over mesh {'data': 1, 'model': 2}, backend gloo" in text
    assert "served 8/8 requests" in text
    for line in lines:
        assert line in text
    assert "ranks' token streams: the same on all 2 ranks" in text
    assert text.count("served 8/8") == 1  # rank 0 alone prints
