"""The dry-run's stand-ins (``repro_torch.launch.inputs``,
``repro_torch.launch.mesh``'s stand-in meshes) against the reference's
``repro/launch/inputs.py``, on the CPU, shapes only.

The reference's functions return global ``ShapeDtypeStruct``s (built here
with no mesh, through ``jax.eval_shape``) and its ``Rules`` name each leaf's
``PartitionSpec`` on a mesh stand-in (``FakeMesh``, as
``tests/test_torch_partitioning.py`` does); a leaf's local shape is its
global shape cut by the spec.  The port's functions return meta tensors at
one rank's local shapes.  For every arch's smoke config (on (4, 1) and
(4, 2): the MoE's experts and MLA's heads over "model" too) and for
stablelm-1.6b and qwen3-14b at full config (on the production meshes (32,
8) and (2, 32, 8)):

* ``text_seq_len``, the batch's and the decode cache's shapes and dtypes
  (jamba's ``long_500k`` cache split along its sequence over "data"),
  the master parameters' and the optimizer state's shapes, and
  ``rules_for_cell`` equal the reference's;
* ``param_count`` and ``model_flops`` equal the reference's for every arch
  and shape, and ``n_params`` every cell of ``tests/fixtures/dryrun_cells.json``;
* every rank of a (4, 2) mesh has rank 0's local shapes, and on every cell
  of the production sweep each split dim divides its mesh axes' size, so
  one rank speaks for the cell.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import itertools
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.configs.base import SHAPES_BY_NAME as REF_SHAPES
from repro.dist.partitioning import Rules as RefRules
from repro.dist.treeutil import map_with_axes as ref_map_with_axes
from repro.launch import inputs as ref_inputs
from repro.models.model import LM as RefLM
from repro.training import optimizers as ref_opt
from repro_torch.configs import ARCH_IDS, applicable_shapes, get_config, get_smoke_config
from repro_torch.configs.base import SHAPES_BY_NAME
from repro_torch.dist.partitioning import Rules, entry_axes
from repro_torch.launch import inputs
from repro_torch.launch.mesh import StandInMesh, make_production_mesh
from repro_torch.models.model import LM
from repro_torch.models.runtime import Runtime
from repro_torch.runtime.elastic import shardings_for
from repro_torch.training import optimizers
from repro_torch.training.trainer import meta_tree, tp_pieces, train_lm
from repro_torch.training.tree import tree_leaves

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "dryrun_cells.json"
AXES = ("data", "model")


class FakeMesh:
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


def _local(spec, shape, sizes):
    """A global shape cut by a spec (a reference ``PartitionSpec``)."""
    out = []
    for entry, n in zip(tuple(spec) + (None,) * (len(shape) - len(spec)), shape):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        parts = int(np.prod([sizes[a] for a in axes])) if axes else 1
        out.append(int(n) // parts)
    return tuple(out)


def _cases():
    cases = []
    for arch in ARCH_IDS:
        cfg = get_smoke_config(arch)
        cases += [(arch, True, m) for m in [(4, 1), (4, 2)]]
    for arch in ("stablelm-1.6b", "qwen3-14b"):
        cases += [(arch, False, (32, 8)), (arch, False, (2, 32, 8))]
    return cases


CASES = _cases()


def _dtype(d) -> str:
    return str(d).replace("torch.", "")


@pytest.mark.parametrize("arch, smoke, mesh_shape", CASES,
                         ids=[f"{a}-{'smoke' if s else 'full'}-{'x'.join(map(str, m))}"
                              for a, s, m in CASES])
def test_inputs_match_the_reference(arch, smoke, mesh_shape):
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    ref_cfg = ref_get_smoke_config(arch) if smoke else ref_get_config(arch)
    names = AXES if len(mesh_shape) == 2 else ("pod",) + AXES
    sizes = dict(zip(names, mesh_shape))
    mesh, fake = StandInMesh(mesh_shape, names), FakeMesh(mesh_shape, names)
    base, ref_base = Rules.default(mesh), RefRules.default(fake)
    ref_lm = RefLM(ref_cfg)
    lm = train_lm(cfg, Runtime(mesh=mesh, rules=base), "meta")

    # the parameters and both optimizers' states
    params, axes = inputs.params_sds(lm, mesh, base)
    ref_params, ref_axes = ref_inputs.params_sds(ref_lm, None, ref_base)
    assert axes == ref_axes

    def ref_local(tree, axes_tree):
        return tree_leaves(ref_map_with_axes(
            lambda s, ax: f"{_local(ref_base.param_pspec(ax, s.shape), s.shape, sizes)} "
                          f"{s.dtype}", tree, axes_tree))

    got = [f"{tuple(t.shape)} {_dtype(t.dtype)}" for t in tree_leaves(params.values)]
    assert got == ref_local(ref_params, ref_axes)
    for name in ("adamw", "adafactor"):
        opt, ref = optimizers.get_optimizer(name), ref_opt.get_optimizer(name)
        state = inputs.opt_state_sds(opt, params, axes, mesh, base, pieces=tp_pieces(cfg))
        ref_state = ref_inputs.opt_state_sds(ref, ref_params, ref_axes, None, ref_base)
        got = [f"{tuple(t.shape)} {_dtype(t.dtype)}" for t in tree_leaves(state.values)]
        assert got == ref_local(ref_state, ref.init_axes(ref_axes)), name

    for shape in applicable_shapes(cfg):
        ref_shape = REF_SHAPES[shape.name]
        assert inputs.text_seq_len(cfg, shape) == ref_inputs.text_seq_len(ref_cfg, ref_shape)
        rules = inputs.rules_for_cell(base, shape, mesh)
        ref_rules = ref_inputs.rules_for_cell(ref_base, ref_shape, fake)
        for table in ("params", "acts"):
            assert dict(getattr(rules, table)) == {
                k: None if v is None else v if isinstance(v, str) else tuple(v)
                for k, v in getattr(ref_rules, table).items()}, (shape.name, table)
        if shape.kind != "decode":
            got = inputs.batch_sds(cfg, shape, mesh, rules).values
            want = ref_inputs.batch_sds(ref_cfg, ref_shape, None, ref_rules)
            act_axes = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
                        "frontend_embeds": ("batch", "frontend_seq", None)}
            assert set(got) == set(want)
            for k, sds in want.items():
                local = _local(ref_rules.act_pspec(act_axes[k], sds.shape), sds.shape, sizes)
                assert (tuple(got[k].shape), _dtype(got[k].dtype)) == (local, str(sds.dtype))
            continue
        split = ref_rules.acts["cache_seq"] is not None
        assert split == (shape.name == "long_500k")  # the cache's positions over "data"
        tokens, lengths, cache = inputs.decode_sds(cfg, shape, mesh, rules, lm)
        ref_tok, ref_len, ref_cache = ref_inputs.decode_sds(ref_cfg, ref_shape, None,
                                                           ref_rules, ref_lm)
        for got, want in ((tokens.values, ref_tok), (lengths.values, ref_len)):
            local = _local(ref_rules.act_pspec(("batch",), want.shape), want.shape, sizes)
            assert (tuple(got.shape), _dtype(got.dtype)) == (local, str(want.dtype))
        cache_axes = ref_lm.cache_axes()
        k, period = cfg.first_k_dense, len(cfg.period)
        for i, layer in enumerate(cache.values):
            if i < k:
                leaves, leaf_axes, at = ref_cache["head"][i], cache_axes["head"][i], None
            else:
                pos = f"pos{(i - k) % period}"
                leaves, leaf_axes = ref_cache["periods"][pos], cache_axes["periods"][pos]
                at = (i - k) // period
            for name, t in layer.items():
                sds, ax = leaves[name], leaf_axes[name]
                local = _local(ref_rules.act_pspec(ax, sds.shape), sds.shape, sizes)
                if at is not None:
                    local = local[1:]
                assert (tuple(t.shape), _dtype(t.dtype)) == (local, str(sds.dtype)), name
                if split and name in inputs.SEQ_DIM:
                    dim = inputs.SEQ_DIM[name]
                    assert t.shape[dim] == sds.shape[dim + (at is not None)] // sizes["data"]


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's dry-run module, imported after this process's JAX
    backend is up, with the device-count flag it sets at import taken back
    (so that nothing started later sees it)."""
    saved = os.environ.get("XLA_FLAGS")
    jax.devices()
    try:
        import repro.launch.dryrun as module
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return module


def test_param_count_and_model_flops_match_the_reference(ref_dryrun):
    from repro_torch.launch.dryrun import model_flops

    for arch in ARCH_IDS:
        for smoke in (True, False):
            cfg = get_smoke_config(arch) if smoke else get_config(arch)
            ref_cfg = ref_get_smoke_config(arch) if smoke else ref_get_config(arch)
            for active in (False, True):
                assert cfg.param_count(active) == ref_cfg.param_count(active)
            for shape in applicable_shapes(cfg):
                assert model_flops(cfg, shape) == ref_dryrun.model_flops(
                    ref_cfg, REF_SHAPES[shape.name])


def test_n_params_matches_every_fixture_cell():
    cells = json.loads(FIXTURE.read_text())["cells"]
    assert len(cells) == 64
    for cell in cells:
        assert get_config(cell["arch"]).param_count() == cell["n_params"], cell["stem"]


def _shapes(placed_tuple):
    return [tuple(t.shape) for p in placed_tuple for t in tree_leaves(p.values)]


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "falcon-mamba-7b"])
def test_every_rank_of_a_4x2_mesh_has_rank_zero_s_local_shapes(arch):
    cfg = get_smoke_config(arch)
    got = []
    for coords in itertools.product(range(4), range(2)):
        mesh = StandInMesh((4, 2), AXES, coords)
        rules = Rules.default(mesh)
        lm = train_lm(cfg, Runtime(mesh=mesh, rules=rules), "meta")
        assert lm.shard.rank == coords[1]
        params, axes = inputs.params_sds(lm, mesh, rules)
        opt = optimizers.get_optimizer("adamw")
        placed = [params, inputs.opt_state_sds(opt, params, axes, mesh, rules,
                                               pieces=tp_pieces(cfg)),
                  inputs.batch_sds(cfg, SHAPES_BY_NAME["train_4k"], mesh, rules),
                  *inputs.decode_sds(cfg, SHAPES_BY_NAME["decode_32k"], mesh, rules, lm)]
        got.append(_shapes(placed))
    assert all(g == got[0] for g in got)


def test_every_cell_cuts_each_leaf_into_equal_blocks():
    """On the production meshes every split dim of every parameter,
    optimizer-state, batch and cache leaf of every cell divides its mesh
    axes' size (the Rules' divisibility fallback), so every rank's block
    has rank 0's shape."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        lm = LM(cfg, "meta")
        whole = meta_tree(lm)
        opt = optimizers.get_optimizer(optimizers.default_optimizer_for(cfg.param_count()))
        for multi in (False, True):
            mesh = make_production_mesh(multi_pod=multi)
            base = Rules.default(mesh)
            trees = [(shardings_for(mesh, base, lm.param_axes(), whole, "meta",
                                    pieces=tp_pieces(cfg)), whole)]
            state = opt.init(whole)
            trees.append((shardings_for(mesh, base, opt.init_axes(lm.param_axes()), state,
                                        "meta", pieces=tp_pieces(cfg)), state))
            for shardings, values in trees:
                for sh, t in zip(tree_leaves(shardings), tree_leaves(values)):
                    for d in sh.split_dims():
                        assert t.shape[d] % (sh.parts(d) * sh.piece_count(d)) == 0
            for shape in applicable_shapes(cfg):
                rules = inputs.rules_for_cell(base, shape, mesh)
                b = shape.global_batch
                for axes, dims in ((("batch", "seq"), (b, shape.seq_len)),
                                   (("cache_batch", "act_kv_heads", "cache_seq",
                                     "cache_head_dim"),
                                    (b, max(cfg.n_kv_heads, 1), shape.seq_len, cfg.head_dim))):
                    spec = rules.act_pspec(axes, dims)
                    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
                    for entry, n in zip(spec, dims):
                        assert n % int(np.prod([sizes[a] for a in entry_axes(entry)])) == 0
