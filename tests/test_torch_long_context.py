"""The contiguous decode over a cache split along its sequence
(``rules_for_cell``'s long-context branch: ``cache_seq`` over the batch
axes, the tokens replicated; ``repro_torch.models.attention``'s
``split_decode_attention`` and ``write_owned``), on the CPU, float32, gloo
ranks one process each.

* One attention layer (the smoke qwen3-14b's: GQA, qk-norm) on (2, 1) and
  (4, 1) meshes against the reference's ``apply_attention_decode`` and its
  ``decode_attention`` over the whole cache: three rows whose lengths end
  inside the first block (5), inside a middle one and at the cache's last
  position.  y within 1e-5 of its largest magnitude (the ranks' partial
  softmaxes merged at their common max, p rounded against each rank's own
  max); the ranks' blocks put together are the reference's updated cache
  within 1e-6 of its largest (the new token's K/V, written by the rank that
  holds its position, and only there: every other block keeps its bits);
  the ranks' y the same bits.
* The smoke jamba-1.5-large-398b's ``LM.decode_step`` on a (2, 2) mesh
  under those rules, four ranks (the stand-in the card's phase 33e runs):
  its MoE on the 2-D path (experts over "model", their d_model in blocks
  over "data"), its attention heads and Mamba channels over "model", its
  attention cache's positions over "data": two greedy steps from a length
  that ends inside the first block and from one near the end, the logits
  within 1e-5 of their largest of the unsharded port's, the same greedy
  tokens, the ranks' logits the same bits.
* MLA's contiguous decode refuses such a cache by name (no cell gives it
  one).
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_tp_ranks import Spawned
from repro.configs import get_smoke_config as ref_smoke_config
from repro.kernels.flash_attention.ops import decode_attention as ref_decode_attention
from repro.models import attention as ref_attn
from repro.models.param import split_tree
from repro_torch.configs import get_smoke_config
from repro_torch.models.model import LM

SEQ, LENGTHS = 64, np.array([5, 37, 63], np.int32)
Y_RTOL, CACHE_RTOL, LOGITS_RTOL = 1e-5, 1e-6, 1e-5
LONG_SEQ, STARTS, STEPS = 64, (5, 60), 2
SPAWN_TIMEOUT_S = 240
ATTN_ARCH, LM_ARCH = "qwen3-14b", "jamba-1.5-large-398b"


def _f32(get, arch):
    return dataclasses.replace(get(arch), dtype="float32")


def _attention_inputs():
    ref_cfg = _f32(ref_smoke_config, ATTN_ARCH)
    params, _ = split_tree(ref_attn.init_attention(jax.random.PRNGKey(0), ref_cfg))
    params = {k: np.asarray(v, np.float32) for k, v in params.items()}
    rng = np.random.RandomState(1)
    b, hk, hd = len(LENGTHS), ref_cfg.n_kv_heads, ref_cfg.head_dim
    return ref_cfg, {"params": params,
                     "x": (rng.randn(b, 1, ref_cfg.d_model) * 0.5).astype(np.float32),
                     "k": rng.randn(b, hk, SEQ, hd).astype(np.float32),
                     "v": rng.randn(b, hk, SEQ, hd).astype(np.float32),
                     "lengths": LENGTHS}


def _whole_cache(cfg, seed):
    """A random whole contiguous cache for one row (``LM.init_cache``'s
    layout)."""
    gen = torch.Generator().manual_seed(seed)
    cache = LM(cfg, "cpu").init_cache(1, LONG_SEQ)
    for layer in cache:
        for leaf in layer.values():
            leaf.copy_(torch.randn(leaf.shape, generator=gen) * 0.5)
    return cache


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    ref_cfg, attn = _attention_inputs()
    cfg = _f32(get_smoke_config, ATTN_ARCH)
    lm_cfg = _f32(get_smoke_config, LM_ARCH)
    cache = _whole_cache(lm_cfg, 2)
    groups = {}
    for data in (2, 4):
        jobs = {"attn": dict(attn, kind="split_attention", cfg=cfg)}
        groups[f"{data}x1"] = Spawned(data, jobs, str(tmp_path_factory.mktemp(f"seq{data}")),
                                      SPAWN_TIMEOUT_S, data=data)
    jobs = {"lm": {"kind": "long_decode", "cfg": lm_cfg, "seed": 0, "seq": LONG_SEQ,
                   "cache": cache, "starts": STARTS, "steps": STEPS, "token": 7}}
    groups["2x2"] = Spawned(4, jobs, str(tmp_path_factory.mktemp("long2x2")), SPAWN_TIMEOUT_S,
                            data=2)
    # the references, computed while the ranks run
    p = {k: jnp.asarray(v) for k, v in attn["params"].items()}
    y, new = ref_attn.apply_attention_decode(
        p, jnp.asarray(attn["x"]), ref_cfg, {"k": jnp.asarray(attn["k"]),
                                             "v": jnp.asarray(attn["v"])},
        jnp.asarray(LENGTHS))
    ref = {"y": np.asarray(y), "k": np.asarray(new["k"]), "v": np.asarray(new["v"])}
    whole = LM(lm_cfg, "cpu").init_params(torch.Generator().manual_seed(0))
    runs = []
    with torch.no_grad():
        for start in STARTS:
            c = [{k: v.clone() for k, v in layer.items()} for layer in cache]
            tokens, logits = torch.tensor([7]), []
            for step in range(STEPS):
                out, c = whole.decode_step(tokens, torch.tensor([start + step],
                                                                dtype=torch.int32), c)
                logits.append(out.numpy())
                tokens = out.argmax(-1)
            runs.append(logits)
    return attn, ref, runs, {name: g.results() for name, g in groups.items()}


def _close(got, want, rtol, what):
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= rtol * float(np.abs(want).max()), (what, err)


def test_split_softmax_merge_is_the_reference_decode_attention(monkeypatch):
    """``decode_partials`` over four blocks of the cache and
    ``merge_partials`` in rank order (the gather over the group replaced by
    the four partials put together, as every rank of a group of four
    receives them) against the reference's ``decode_attention`` on the whole
    cache, including a row of length 0 (every position masked: the mean of
    V) and one that ends inside the first block."""
    from repro_torch.dist.collectives import VirtualGroup
    from repro_torch.models import attention

    rng = np.random.RandomState(3)
    q = rng.randn(4, 8, 16).astype(np.float32)
    k, v = (rng.randn(4, 2, 64, 16).astype(np.float32) for _ in range(2))
    lengths = np.array([0, 5, 33, 64], np.int32)
    want = np.asarray(ref_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           jnp.asarray(lengths)))
    parts = [attention.decode_partials(torch.from_numpy(q),
                                       torch.from_numpy(k[:, :, 16 * r:16 * (r + 1)].copy()),
                                       torch.from_numpy(v[:, :, 16 * r:16 * (r + 1)].copy()),
                                       torch.from_numpy(lengths - 16 * r))
             for r in range(4)]
    gathered = torch.stack([torch.cat(part, dim=-1) for part in parts])
    monkeypatch.setattr(attention, "gather_dim", lambda x, dim, group: gathered)
    outs = [attention.merge_partials(*parts[r], VirtualGroup("data", 4, r)).reshape(4, 8, 16)
            for r in range(4)]
    for out in outs:
        _close(out.numpy(), want, Y_RTOL, "the merged partials vs decode_attention")
        assert torch.equal(out, outs[0])


@pytest.mark.parametrize("mesh", ["2x1", "4x1"])
def test_split_layer_decode_matches_the_reference(run, mesh):
    attn, ref, _, results = run
    ranks = [r["attn"] for r in results[mesh]]
    data = len(ranks)
    n = SEQ // data
    for res in ranks:
        _close(res["y"], ref["y"], Y_RTOL, "y")
        np.testing.assert_array_equal(res["y"], ranks[0]["y"])
    for name in ("k", "v"):
        got = np.concatenate([res[name] for res in ranks], axis=2)
        _close(got, ref[name], CACHE_RTOL, name)
        for res in ranks:  # only the owner of a row's position writes it
            blk = slice(res["block"] * n, (res["block"] + 1) * n)
            for row, length in enumerate(LENGTHS):
                owned = blk.start <= length < blk.stop
                changed = not np.array_equal(res[name][row], attn[name][row, :, blk])
                assert changed == owned, (name, row, res["block"])


def test_jamba_long_context_decode_on_a_2x2_mesh(run):
    _, _, want_runs, results = run
    ranks = [r["lm"] for r in results["2x2"]]
    for res in ranks:
        assert (res["embed_shards"], res["expert_shards"]) == (2, 2)
        for got_run, want_run in zip(res["runs"], want_runs):
            for got, want in zip(got_run, want_run):
                _close(got, want, LOGITS_RTOL, "logits")
                assert int(got.argmax()) == int(want.argmax())
    for res in ranks[1:]:
        for a, b in zip(res["runs"], ranks[0]["runs"]):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_mla_refuses_a_cache_split_along_its_sequence():
    """No cell splits an MLA arch's ``cache_seq`` (the long-context cell runs
    the Mamba archs), so MLA's contiguous decode refuses a runtime that
    does, by name, before it reads a weight."""
    from repro_torch.models import mla
    from repro_torch.models.runtime import Runtime

    class SplitRuntime(Runtime):
        def seq_group(self):
            return "data"

    cfg = _f32(get_smoke_config, "deepseek-v2-236b")
    with pytest.raises(ValueError, match="MLA's latent cache split along its sequence"):
        mla.apply_mla_decode(None, torch.zeros(1, 1, cfg.d_model), cfg, SplitRuntime(), None,
                             torch.zeros(1, dtype=torch.int32))
