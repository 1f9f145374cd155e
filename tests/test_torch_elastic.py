"""The port's elastic move (``repro_torch.runtime.elastic``), the
optimizers' ``init_axes`` and ``CheckpointManager.restore_sharded`` against
the JAX package, in one process on stand-in meshes (Rules and placement
read only the mesh's axis names, sizes and this rank's coordinates).

* ``init_axes`` of AdamW and Adafactor over the params' axes of
  stablelm-1.6b, falcon-mamba-7b and deepseek-v2-236b: the reference's trees.
* Every param and optimizer-state leaf's spec from ``shardings_for`` under
  ``Rules.default`` on the (2, 1), (4, 2) and (2, 4) meshes, at the full
  configs' shapes (the port's model on the "meta" device, the reference's
  shapes through ``jax.eval_shape``): the reference's ``PartitionSpec`` from
  the spec its ``shardings_for`` puts in each ``NamedSharding``
  (``rules.param_sharding`` = ``NamedSharding(mesh, param_pspec(...))``).
* ``restore_sharded`` of a smoke training state at data 2: each rank's
  leaves the blocks of the saved leaves, bit for bit; a None entry the whole
  leaf; the restore in ``timings``.
* A state placed at data 2 (``rescale_training_state``), its two ranks'
  blocks put back together, and placed again at data 1 and at data 2: the
  same bits each time.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.dist.partitioning import Rules as RefRules
from repro.dist.treeutil import map_with_axes as ref_map_with_axes
from repro.models.model import LM as RefLM
from repro.training import optimizers as ref_opt
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.dist.partitioning import Rules
from repro_torch.models.model import LM
from repro_torch.runtime.elastic import (
    rescale_training_state,
    reshard_tree,
    shardings_for,
)
from repro_torch.training import optimizers as port_opt
from repro_torch.training.trainer import meta_tree
from repro_torch.training.tree import tree_leaves, tree_map

ARCHS = ["stablelm-1.6b", "falcon-mamba-7b", "deepseek-v2-236b"]
OPTIMIZERS = ["adamw", "adafactor"]
MESHES = [(2, 1), (4, 2), (2, 4)]


class FakeMesh:
    """A stand-in mesh: axis names and sizes, and this rank's coordinates."""

    def __init__(self, shape, coords=None, names=("data", "model")):
        self.axis_names = names
        self.devices = np.empty(shape)
        if coords is not None:
            self.coords = coords


class Spec:
    """A reference spec as one leaf (a tuple would be walked into)."""

    def __init__(self, spec):
        self.spec = tuple(spec)


@functools.lru_cache(maxsize=None)
def _models(arch):
    """The port's full model on the "meta" device, its axes and whole
    shapes, and the reference's axes and shapes (each traced once)."""
    lm, ref = LM(get_config(arch), "meta"), RefLM(ref_get_config(arch))
    return lm, lm.param_axes(), meta_tree(lm), ref.param_axes(), ref.param_shapes()


@pytest.mark.parametrize("arch", ARCHS)
def test_init_axes_match_the_reference(arch):
    _, axes, _, ref_axes, _ = _models(arch)
    for name in OPTIMIZERS:
        got = port_opt.get_optimizer(name).init_axes(axes)
        assert got == ref_opt.get_optimizer(name).init_axes(ref_axes)
        assert got["count"] == ()


@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_spec_matches_the_reference(arch):
    _, axes, shapes, ref_axes, ref_shapes = _models(arch)
    checked = 0
    for name in OPTIMIZERS:
        opt, ref_o = port_opt.get_optimizer(name), ref_opt.get_optimizer(name)
        trees = {"params": (axes, shapes, ref_axes, ref_shapes),
                 "opt_state": (opt.init_axes(axes), opt.init(shapes), ref_o.init_axes(ref_axes),
                               jax.eval_shape(ref_o.init, ref_shapes))}
        for shape in MESHES:
            mesh = FakeMesh(shape)
            rules, ref_rules = Rules.default(mesh), RefRules.default(mesh)
            for ax, values, ref_ax, ref_values in trees.values():
                got = [sh.spec for sh in tree_leaves(shardings_for(mesh, rules, ax, values))]
                want = ref_map_with_axes(
                    lambda leaf, a: Spec(ref_rules.param_pspec(a, getattr(leaf, "shape", ()))),
                    ref_values, ref_ax)
                want = [s.spec for s in jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, Spec))]
                assert got == want
                checked += len(got)
    assert checked > 0


def _state(name="adamw"):
    """A smoke stablelm training state (float32 master, the optimizer's
    state after one update), whole leaves on the CPU, and its axes."""
    from repro_torch.convert import tree_from_lm

    cfg = dataclasses.replace(get_smoke_config("stablelm-1.6b"), n_layers=2, dtype="float32")
    lm = LM(cfg, "cpu").init_params(torch.Generator().manual_seed(0))
    params = tree_from_lm(lm)
    opt = port_opt.get_optimizer(name)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=torch.Generator().manual_seed(1)),
                     params)
    params, state = opt.update(grads, opt.init(params), params, torch.tensor(1e-2))
    return {"params": params, "opt_state": state}, lm.param_axes(), opt


def _blocks_put_together(blocks, shardings):
    """The ranks' blocks of each leaf side by side again (the gather's
    layout, by concatenation along the split dims)."""
    def leaf(*args):
        parts, shs = args[:len(blocks)], args[len(blocks):]
        dims = () if shs[0] is None else shs[0].split_dims()
        if not dims:
            assert all(torch.equal(p, parts[0]) for p in parts)
            return parts[0]
        (d,) = dims
        order = sorted(range(len(parts)), key=lambda r: shs[r].index(d))
        return torch.cat([parts[r] for r in order], dim=d)

    return tree_map(leaf, *blocks, *shardings)


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_restore_sharded_places_each_ranks_blocks(name, tmp_path):
    state, axes, opt = _state(name)
    mgr = CheckpointManager(tmp_path / "ckpt")
    mgr.save_async(3, state, metadata={"step": 3}).wait()
    blocks = []
    for r in range(2):
        mesh = FakeMesh((2, 1), coords=(r, 0))
        rules = Rules.default(mesh)
        sh = {"params": shardings_for(mesh, rules, axes, state["params"]),
              "opt_state": shardings_for(mesh, rules, opt.init_axes(axes), state["opt_state"])}
        sh["opt_state"]["count"] = None  # the whole leaf
        placed, meta = mgr.restore_sharded(sh)
        assert meta["step"] == 3 and mgr.last_timing("restore")["step"] == 3
        assert torch.equal(placed["opt_state"]["count"], state["opt_state"]["count"])
        for got, whole, s in zip(tree_leaves(placed), tree_leaves(state), tree_leaves(sh)):
            want = whole if s is None else whole[s.block(whole.shape)]
            assert got.dtype == whole.dtype and torch.equal(got, want)
        blocks.append((placed, sh))
    split = [s for s in tree_leaves(blocks[0][1]) if s is not None and s.split_dims()]
    assert split, "no leaf split at data 2"
    assert all(s.split_dims() == (s.spec.index("data"),) for s in split)
    whole = _blocks_put_together([b[0] for b in blocks], [b[1] for b in blocks])
    assert _equal(whole, state)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_rescale_data_two_to_one_and_back_bit_for_bit(name):
    state, axes, opt = _state(name)
    at_two = []
    for r in range(2):
        mesh = FakeMesh((2, 1), coords=(r, 0))
        rules = Rules.default(mesh)
        placed = rescale_training_state(state, mesh, rules, axes, opt)
        sh = {"params": shardings_for(mesh, rules, axes, state["params"]),
              "opt_state": shardings_for(mesh, rules, opt.init_axes(axes), state["opt_state"])}
        assert _equal(placed, reshard_tree(state, sh))
        at_two.append((placed, sh))
    gathered = _blocks_put_together([p for p, _ in at_two], [s for _, s in at_two])
    assert _equal(gathered, state)
    one = FakeMesh((1, 1), coords=(0, 0))
    assert _equal(rescale_training_state(gathered, one, Rules.default(one), axes, opt), state)
    for r, (placed, _) in enumerate(at_two):
        mesh = FakeMesh((2, 1), coords=(r, 0))
        again = rescale_training_state(gathered, mesh, Rules.default(mesh), axes, opt)
        assert _equal(again, placed)
