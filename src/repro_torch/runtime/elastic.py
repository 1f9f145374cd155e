"""Elastic rescale: move a training state between meshes of different size
(the port of ``repro/runtime/elastic.py``).

The adaptive controller (``repro_torch.core.adaptive``) decides WHEN to
change the data-parallel degree; this module executes the move:

  1. checkpoint (or use host copies),
  2. build the new mesh and its sharding rules,
  3. re-place every leaf with its sharding on the new mesh,
  4. resume: the driver builds the step for the new mesh.

Works across any pair of mesh shapes because checkpoints hold whole leaves
(``CheckpointManager.restore_sharded``).

A port "sharding" is a ``LeafSharding``: the leaf's spec from
``rules.param_pspec`` (the reference's ``NamedSharding`` spec, a tuple) with
the mesh's axis sizes and this rank's coordinates.  A dim whose entry names
mesh axes of product n > 1 is cut into n contiguous equal blocks, the first
axis outermost, and the rank holds block i, i its coordinates in that
order: the layout ``NamedSharding`` gives, so the ranks' blocks put side by
side are the whole leaf, bit for bit.  Placing a leaf slices the rank's
block onto the rank's device; an entry of None is the whole leaf.  The mesh
is a ``DeviceMesh`` (its coordinates from ``get_coordinate``) or a stand-in
with the reference's ``axis_names`` and ``devices.shape`` and, optionally,
``coords`` (this rank's coordinate on each axis, zeros when absent) and
``device``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.dist.partitioning import Rules, Spec, entry_axes, mesh_axes
from repro_torch.dist.treeutil import map_with_axes
from repro_torch.training.tree import tree_map


def mesh_coordinate(mesh) -> Dict[str, int]:
    """{axis name: this rank's coordinate} on a ``DeviceMesh`` or a
    stand-in (its ``coords``, zeros when it has none)."""
    names, _ = mesh_axes(mesh)
    if hasattr(mesh, "get_coordinate"):
        coords = mesh.get_coordinate()
        if coords is None:
            raise RuntimeError("this rank is not on the mesh")
    else:
        coords = getattr(mesh, "coords", (0,) * len(names))
    return dict(zip(names, (int(c) for c in coords)))


def mesh_device(mesh) -> torch.device:
    """The device this rank's blocks live on: a stand-in's ``device`` (the
    CPU when it has none), or the current device of the mesh's type."""
    if not hasattr(mesh, "device_type"):
        return torch.device(getattr(mesh, "device", "cpu"))
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


@dataclasses.dataclass(frozen=True)
class LeafSharding:
    """One leaf's spec on a mesh, seen from one rank."""

    spec: Spec
    axis_sizes: Mapping[str, int]
    coords: Mapping[str, int]
    device: torch.device
    mesh: Any = dataclasses.field(default=None, compare=False, repr=False)

    def parts(self, dim: int) -> int:
        """The number of blocks the leaf is cut into along ``dim``."""
        n = 1
        for axis in entry_axes(self.spec[dim]):
            n *= self.axis_sizes[axis]
        return n

    def index(self, dim: int) -> int:
        """This rank's block along ``dim`` (the entry's first axis outermost)."""
        i = 0
        for axis in entry_axes(self.spec[dim]):
            i = i * self.axis_sizes[axis] + self.coords[axis]
        return i

    def split_dims(self) -> Tuple[int, ...]:
        return tuple(d for d in range(len(self.spec)) if self.parts(d) > 1)

    def n_blocks(self) -> int:
        n = 1
        for d in range(len(self.spec)):
            n *= self.parts(d)
        return n

    def local_shape(self, shape) -> Tuple[int, ...]:
        return tuple(int(n) // self.parts(d) for d, n in enumerate(shape))

    def block(self, shape) -> Tuple[slice, ...]:
        """The rank's block of a whole leaf of ``shape``."""
        out = []
        for d, n in enumerate(shape):
            size = int(n) // self.parts(d)
            out.append(slice(self.index(d) * size, (self.index(d) + 1) * size))
        return tuple(out)

    def place(self, x) -> torch.Tensor:
        """The rank's block of the whole leaf ``x`` (a tensor or numpy
        array), a tensor of its own on ``device``."""
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(x)
        if tuple(x.shape) and len(self.spec) != x.dim():
            raise ValueError(f"spec {self.spec} for a leaf of shape {tuple(x.shape)}")
        local = x[self.block(x.shape)] if x.dim() else x
        return local.to(self.device, copy=True).contiguous()

    def group(self, dim: int):
        """The process group that holds the blocks along ``dim``: the mesh
        axis' group (one axis a dim: the trainer's meshes)."""
        axes = entry_axes(self.spec[dim])
        if len(axes) != 1:
            raise NotImplementedError(f"a dim split over the mesh axes {axes} at once")
        return self.mesh.get_group(axes[0])

    def data_group(self):
        """The group over which the leaf's blocks lie: its one split dim's."""
        dims = self.split_dims()
        if len(dims) != 1:
            raise NotImplementedError(f"a leaf split along the dims {dims}")
        return self.group(dims[0])


def shardings_for(mesh, rules: Rules, axes_tree, value_tree, device=None):
    """A ``LeafSharding`` tree for params or optimizer state (shape-aware:
    each leaf's spec at its whole shape; ``value_tree``'s leaves need only a
    ``shape``: meta tensors do)."""
    _, shape = mesh_axes(mesh)
    sizes = dict(zip(mesh_axes(mesh)[0], shape))
    coords = mesh_coordinate(mesh)
    device = mesh_device(mesh) if device is None else torch.device(device)

    def mk(leaf, ax):
        spec = rules.param_pspec(ax, tuple(getattr(leaf, "shape", ())))
        return LeafSharding(spec, sizes, coords, device, mesh)

    return map_with_axes(mk, value_tree, axes_tree)


def reshard_tree(tree, shardings):
    """Place (host or device) leaves onto their shardings: each the rank's
    block on its device, or the whole leaf where the entry is None."""
    return tree_map(lambda x, sh: sh.place(x) if sh is not None else torch.as_tensor(x),
                    tree, shardings)


def rescale(host_state: Dict[str, Any], new_mesh, rules: Rules,
            axes: Dict[str, Any], device=None) -> Dict[str, Any]:
    """host_state: {'params': tree, 'opt_state': tree} of whole leaves; axes:
    the matching logical-axes trees.  ``rules`` are the new mesh's."""
    out = {}
    for key in host_state:
        sh = shardings_for(new_mesh, rules, axes[key], host_state[key], device)
        out[key] = reshard_tree(host_state[key], sh)
    return out


def rescale_training_state(host_state: Dict[str, Any], new_mesh, rules: Rules, param_axes,
                           opt, device=None) -> Dict[str, Any]:
    """The full elastic move for a checkpointed training state: derive the
    optimizer-state axes from the parameter axes (``Optimizer.init_axes``)
    and re-place both trees on the new mesh.  The resize paths (the LM
    chaos executor) go through this one entry point, so the params /
    opt-state axis pairing is written down once."""
    axes = {"params": param_axes, "opt_state": opt.init_axes(param_axes)}
    return rescale({"params": host_state["params"], "opt_state": host_state["opt_state"]},
                   new_mesh, rules, axes, device)


def gather_leaf(local: torch.Tensor, sh: Optional[LeafSharding]) -> torch.Tensor:
    """The whole leaf from the ranks' blocks (``local`` this rank's), on
    every rank; a leaf split nowhere is ``local`` itself."""
    from repro_torch.dist.collectives import gather_blocks

    if sh is None:
        return local
    for d in sh.split_dims():
        local = gather_blocks(local, d, sh.group(d))
    return local


def gather_tree(tree, shardings, device="cpu"):
    """Every leaf whole on ``device`` (the host by default), one leaf at a
    time; every rank of the mesh takes part."""
    return tree_map(lambda x, sh: gather_leaf(x, sh).to(device, copy=True), tree, shardings)
