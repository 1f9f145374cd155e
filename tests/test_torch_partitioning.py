"""Port parity: the port's sharding ``Rules`` (``repro_torch.dist.partitioning``)
against the JAX package's, and the port's logical axes
(``repro_torch.models.param``, ``LM.param_axes`` / ``LM.cache_axes``) against
the reference's ``ann(...)`` trees.

* The reference's resolution cases (``tests/test_partitioning.py``, all ten)
  on the port's ``Rules``: a spec is the tuple of a ``PartitionSpec``.
* Every arch of the catalog, smoke and full configs, axes only (the port's
  model on the "meta" device, the reference's through ``jax.eval_shape``):
  the two axes trees equal, the parameter shapes equal.
* Every parameter leaf and every cache leaf, under ``Rules.default`` and
  ``Rules.for_serving``, on the stand-in meshes (1,1), (1,2), (2,2), (1,4),
  (1,16) and the pod mesh (2,16,16): the port's spec equals the reference's
  ``PartitionSpec`` at the leaf's shape.  No processes: Rules read only the
  mesh's axis names and sizes.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.dist.partitioning import Rules as RefRules
from repro.models.model import LM as RefLM
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.dist.partitioning import Rules, placements
from repro_torch.models import param as param_mod
from repro_torch.models.model import LM


class FakeMesh:
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


def rules_2d():
    return Rules.default(FakeMesh((16, 16), ("data", "model")))


def rules_3d():
    return Rules.default(FakeMesh((2, 16, 16), ("pod", "data", "model")))


def test_basic_param_resolution():
    r = rules_2d()
    assert r.param_pspec(("embed", "mlp")) == ("data", "model")
    assert r.param_pspec(("vocab", "embed")) == ("model", "data")
    assert r.param_pspec(("norm",)) == (None,)


def test_pod_axis_joins_fsdp():
    r = rules_3d()
    spec = r.param_pspec(("embed", "mlp"), (8192, 24576))
    assert spec == (("pod", "data"), "model")


def test_dedupe_first_dim_wins():
    r = rules_2d()
    # both dims want 'model' -> second gets None
    spec = r.param_pspec(("mlp", "expert"))
    assert spec == ("model", None)


def test_divisibility_fallback_drops_axis():
    r = rules_2d()
    # kv_heads=8 can't shard over model=16 -> replicated, head_dim claims it
    spec = r.act_pspec(("cache_batch", "act_kv_heads", "cache_seq",
                        "cache_head_dim"), (128, 8, 32768, 128))
    assert spec == ("data", None, None, "model")
    # kv_heads=32 divides -> heads sharded, head_dim replicated
    spec = r.act_pspec(("cache_batch", "act_kv_heads", "cache_seq",
                        "cache_head_dim"), (128, 32, 32768, 128))
    assert spec == ("data", "model", None, None)


def test_partial_axis_tuple_kept():
    r = rules_3d()
    # batch 2 divides pod(2) but not pod*data(32): keep only 'pod'
    spec = r.act_pspec(("batch", "seq"), (2, 4096))
    assert spec == ("pod", None)


def test_override():
    r = rules_2d().override(acts={"cache_seq": "data", "batch": None})
    spec = r.act_pspec(("batch", "cache_seq"), (1, 524288))
    assert spec == (None, "data")


PARAM_AXES = ["embed", "mlp", "vocab", "heads_flat", "kv_flat", "expert",
              "norm", "layers", None]
ACT_AXES = ["batch", "cache_batch", "act_heads", "act_mlp", "seq",
            "cache_seq", "cache_head_dim", "act_embed", None]


def _random_mesh(rng):
    """Random 2d/3d mesh with power-of-two axis sizes."""
    if rng.rand() < 0.5:
        shape = (int(rng.choice([2, 4, 8, 16])), int(rng.choice([2, 4, 8, 16])))
        names = ("data", "model")
    else:
        shape = (2, int(rng.choice([2, 4, 8])), int(rng.choice([2, 4, 8, 16])))
        names = ("pod", "data", "model")
    mesh = FakeMesh(shape, names)
    return Rules.default(mesh), RefRules.default(mesh), dict(zip(names, shape))


def _check_spec(spec, shape, sizes):
    """No mesh axis claimed twice, and a sharded dim always divides the
    product of its axes' sizes."""
    seen = []
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        prod = 1
        for a in axes:
            assert a not in seen, f"axis {a} repeated in {spec}"
            seen.append(a)
            prod *= sizes[a]
        assert shape[dim] % prod == 0, (spec, shape, sizes)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.sampled_from(PARAM_AXES), min_size=1, max_size=4),
       st.integers(0, 2**31 - 1))
def test_param_resolution_properties(logical, seed):
    """The invariants on random shapes and meshes, and the reference's
    spec at each."""
    rng = np.random.RandomState(seed)
    r, ref, sizes = _random_mesh(rng)
    shape = tuple(int(rng.choice([1, 2, 6, 8, 16, 64, 256, 1024])) for _ in logical)
    spec = r.param_pspec(tuple(logical), shape)
    _check_spec(spec, shape, sizes)
    assert spec == tuple(ref.param_pspec(tuple(logical), shape))


@settings(max_examples=60, deadline=None)
@given(st.lists(st.sampled_from(ACT_AXES), min_size=1, max_size=4),
       st.integers(0, 2**31 - 1))
def test_act_resolution_properties(logical, seed):
    rng = np.random.RandomState(seed)
    r, ref, sizes = _random_mesh(rng)
    shape = tuple(int(rng.choice([1, 2, 6, 8, 16, 64, 256, 1024])) for _ in logical)
    spec = r.act_pspec(tuple(logical), shape)
    _check_spec(spec, shape, sizes)
    assert spec == tuple(ref.act_pspec(tuple(logical), shape))


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_resolution_without_shape_never_repeats_axes(seed):
    rng = np.random.RandomState(seed)
    r, ref, _ = _random_mesh(rng)
    names = [PARAM_AXES[i] for i in rng.choice(len(PARAM_AXES), size=rng.randint(1, 5))]
    spec = r.param_pspec(tuple(names))
    flat = []
    for entry in spec:
        if entry is None:
            continue
        flat.extend(entry if isinstance(entry, tuple) else (entry,))
    assert len(flat) == len(set(flat)), spec
    assert spec == tuple(ref.param_pspec(tuple(names)))


def test_batch_axes_and_model_axis():
    r = rules_3d()
    assert r.batch_axes() == ("pod", "data")
    assert r.model_axis() == "model"
    r2 = rules_2d()
    assert r2.batch_axes() == ("data",)
    assert r2.for_serving(r2.mesh).batch_axes() == ()


# ------------------------------------------------- the catalog's axes trees
MESHES = [FakeMesh((1, 1), ("data", "model")), FakeMesh((1, 2), ("data", "model")),
          FakeMesh((2, 2), ("data", "model")), FakeMesh((1, 4), ("data", "model")),
          FakeMesh((1, 16), ("data", "model")), FakeMesh((2, 16, 16), ("pod", "data", "model"))]
CONFIGS = [(arch, smoke) for arch in ARCH_IDS for smoke in (True, False)]


def _configs(arch, smoke):
    if smoke:
        return get_smoke_config(arch), ref_get_smoke_config(arch)
    return get_config(arch), ref_get_config(arch)


def _leaves(axes_tree, shapes_tree):
    """(axes, shape) of every leaf of the reference-layout trees."""
    if hasattr(shapes_tree, "shape"):
        yield axes_tree, tuple(shapes_tree.shape)
    elif isinstance(shapes_tree, dict):
        for k in shapes_tree:
            yield from _leaves(axes_tree[k], shapes_tree[k])
    else:
        for a, s in zip(axes_tree, shapes_tree):
            yield from _leaves(a, s)


def _cache_leaves(cfg):
    """(axes, shape) of each layer kind's cache leaves at the port's paged
    pool shapes: 33 pages of 16 positions, 4 decode slots."""
    out = []
    for spec in dict.fromkeys(cfg.layer_specs()):
        for name, ax in param_mod.layer_cache_axes(cfg, spec).items():
            if name in ("k", "v"):
                shape = (33, cfg.n_kv_heads, 16, cfg.head_dim)
            elif name in ("ckv", "kpe"):
                width = cfg.mla.kv_lora_rank if name == "ckv" else cfg.mla.qk_rope_head_dim
                shape = (33, 16, width)
            else:
                mc = cfg.mamba
                shape = (4, mc.resolved_d_inner(cfg.d_model),
                         mc.d_state if name == "h" else mc.d_conv - 1)
            out.append((ax, shape))
    return out


@pytest.mark.parametrize("arch, smoke", CONFIGS, ids=[f"{a}-{'smoke' if s else 'full'}"
                                                      for a, s in CONFIGS])
def test_axes_trees_and_every_leaf_spec_match_the_reference(arch, smoke):
    cfg, ref_cfg = _configs(arch, smoke)
    lm, ref = LM(cfg, "meta"), RefLM(ref_cfg)
    axes = lm.param_axes()
    assert axes == ref.param_axes()
    assert lm.cache_axes() == ref.cache_axes()
    leaves = list(_leaves(axes, ref.param_shapes()))
    port_shapes = {}
    for path, t, ax in lm.leaf_axes():
        stacked = path[0] == "periods"
        port_shapes.setdefault(path, (("layers",) + ax if stacked else ax,
                                      (cfg.n_periods,) * stacked + tuple(t.shape)))
    assert sorted(port_shapes.values(), key=repr) == sorted(leaves, key=repr)
    cache_leaves = _cache_leaves(cfg)
    for mesh in MESHES:
        for make, ref_make in ((Rules.default, RefRules.default),
                               (Rules.for_serving, RefRules.for_serving)):
            r, rr = make(mesh), ref_make(mesh)
            for ax, shape in leaves:
                assert r.param_pspec(ax, shape) == tuple(rr.param_pspec(ax, shape)), (ax, shape)
            for ax, shape in cache_leaves:
                assert r.act_pspec(ax, shape) == tuple(rr.act_pspec(ax, shape)), (ax, shape)


def test_serving_rules_replicate_pool_and_slots():
    """``tests/test_serve_sharding.py``'s policy check on the port's Rules."""
    rules = Rules.for_serving(FakeMesh((1, 2), ("data", "model")))
    assert rules.acts["batch"] is None and rules.acts["cache_batch"] is None
    assert rules.params["embed"] is None and rules.params["mlp"] == "model"
    assert rules.acts["cache_head_dim"] == "model"
    spec = rules.act_pspec(("cache_batch", "cache_seq", "cache_head_dim"), (32, 8, 16))
    assert spec == tuple(P(None, None, "model"))


def test_placements_follow_the_spec():
    """A spec as DTensor placements: ``Shard(d)`` on each mesh dim a tensor
    dim names, ``Replicate()`` elsewhere; a tuple entry in mesh order."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = FakeMesh((2, 16, 16), ("pod", "data", "model"))
    mesh.mesh_dim_names, mesh.shape = mesh.axis_names, mesh.devices.shape
    assert placements((("pod", "data"), "model"), mesh) == [Shard(0), Shard(0), Shard(1)]
    assert placements((None, "model"), mesh) == [Replicate(), Replicate(), Shard(1)]
    with pytest.raises(ValueError, match="mesh order"):
        placements((("data", "pod"),), mesh)
