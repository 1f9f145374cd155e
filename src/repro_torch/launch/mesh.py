"""Device meshes over the ranks of a process group (the counterpart of
``repro/launch/mesh.py``'s ``make_debug_mesh``).

The reference builds its meshes from the devices one JAX process sees; the
port runs one process a rank and builds a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names ("data", "model") over the initialised process group.  Nothing here
touches the process group or a card at import.

* The rank -> device rule: the card unless the caller names ``"cpu"``; rank
  r on ``cuda:(r % device_count)``.  A rank that asks for a card where there
  is none raises.
* The backend rule: ``nccl`` when every rank has a card of its own
  (world size <= device count), ``gloo`` when ranks share a card or run on
  the CPU.  ``init_distributed`` prints the choice.  Gloo takes only
  ``broadcast`` and ``all_reduce`` for CUDA tensors, which is all the serve
  data plane uses (``repro_torch.dist.collectives``); a collective the
  backend refuses raises.
* Rendezvous through a file (``file://``), never a fixed port, so that
  several groups can start on one host at once; nothing on the machine
  tells a program of a cluster, so the caller passes the rank, the world
  size and the file.

The dry-run's meshes (``make_production_mesh``, ``make_scaled_mesh``, the
counterparts of ``repro/launch/mesh.py:17`` and ``:40``) are stand-ins: no
process group, no card.  A ``StandInMesh`` has the reference's
``axis_names`` and ``devices.shape``, this rank's ``coords`` (rank 0 unless
the caller names another) and ``device="meta"``; its groups are
``VirtualGroup``s of each axis' size (``repro_torch.dist.collectives``), on
which a collective moves nothing and reports its bytes.  Every rank of a
cell has the same local shapes under the Rules' divisibility rules, so one
rank speaks for the cell, as one device's HLO does in the reference.

**The production mesh differs from the reference's in one place.**  The
reference's is a TPU v5e pod, (data 16, model 16), and (pod 2, 16, 16) for
two pods.  At 16 model ranks the port's tensor-parallel plan would have to
split a KV head (qwen3-14b, qwen3-32b, qwen1.5-110b and internvl2-76b have
8 KV heads; musicgen's 24 heads do not divide by 16), and the plan
refuses that by name (``repro_torch.serve.sharding``): it never replicates
or splits a head.  The H100's counterpart of the pod's model ring is the 8
cards of one NVLink node, so the port's production meshes are (data 32,
model 8) = 256 cards and (pod 2, data 32, model 8) = 512 cards: the
reference's card counts per cell and its axis names, and
``make_scaled_mesh(n, model=min(8, n))``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

import torch

MESH_AXES = ("data", "model")
# the production meshes (module docstring): one NVLink node of 8 cards on
# "model"
PRODUCTION_SHAPE = (32, 8)
PRODUCTION_SHAPE_MULTI_POD = (2, 32, 8)
MODEL_RING = 8
# the device init_distributed gave this process's rank
_rank_device: Optional[torch.device] = None


def rank_device(rank: int, device: Optional[str] = None) -> torch.device:
    """The device of rank ``rank``: the CPU when ``device`` is "cpu", else
    ``cuda:(rank % device_count)``, raising when there is no card."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"rank {rank}: no CUDA device is available; pass device='cpu' to "
                           "run the ranks on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def pick_backend(world: int, device: torch.device) -> str:
    """``nccl`` when each of the ``world`` ranks has a card of its own, else
    ``gloo`` (ranks on the CPU, or sharing a card)."""
    if device.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(rank: int, world: int, init_file: str, device: Optional[str] = None,
                     backend: Optional[str] = None, verbose: bool = True
                     ) -> Tuple[torch.device, str]:
    """Initialise the default process group for rank ``rank`` of ``world``
    through the rendezvous file ``init_file`` (the same path for every rank,
    absent before the first starts).  Returns (the rank's device, the
    backend), after making that device the current one."""
    import torch.distributed as dist

    global _rank_device
    dev = rank_device(rank, device)
    backend = backend or pick_backend(world, dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    _rank_device = dev
    if verbose and rank == 0:
        shared = "" if dev.type == "cpu" or backend == "nccl" else " (ranks share a card)"
        print(f"process group: {world} rank(s), backend {backend} on {dev.type}{shared}")
    return dev, backend


def make_debug_mesh(data: int = 1, model: int = 1, device_type: Optional[str] = None):
    """A (data, model) ``DeviceMesh`` over the initialised process group,
    whose world size must be data x model.  ``device_type`` defaults to
    the type of the device ``init_distributed`` gave the rank."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_debug_mesh needs an initialised process group "
                           "(repro_torch.launch.mesh.init_distributed)")
    if dist.get_world_size() != data * model:
        raise RuntimeError(f"need {data * model} ranks, the group has {dist.get_world_size()}")
    if device_type is None:
        if _rank_device is None:
            raise RuntimeError("make_debug_mesh: name the device_type, or initialise the "
                               "group through init_distributed")
        device_type = _rank_device.type
    return init_device_mesh(device_type, (data, model), mesh_dim_names=MESH_AXES)


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or a ``StandInMesh``."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


@dataclasses.dataclass(frozen=True)
class _Devices:
    shape: Tuple[int, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)


class StandInMesh:
    """A mesh of ``shape`` over ``axis_names`` seen from the rank at
    ``coords`` (zeros by default), on ``device`` ("meta": no memory), with
    no process group behind it: its groups are ``VirtualGroup``s."""

    virtual = True

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 coords: Optional[Sequence[int]] = None, device: str = "meta"):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} for axes {tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.devices = _Devices(tuple(int(n) for n in shape))
        self.coords = tuple(int(c) for c in (coords or (0,) * len(shape)))
        if len(self.coords) != len(shape) or any(
                not 0 <= c < n for c, n in zip(self.coords, self.devices.shape)):
            raise ValueError(f"coordinates {self.coords} outside the mesh {tuple(shape)}")
        self.device = device

    def __repr__(self) -> str:
        return (f"StandInMesh({dict(zip(self.axis_names, self.devices.shape))}, "
                f"coords={self.coords}, device={self.device!r})")

    def get_local_rank(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def get_group(self, axis: Union[str, Tuple[str, ...]]):
        """The ``VirtualGroup`` of ``axis`` (a tuple of axes: their product,
        the first outermost) through this rank."""
        from repro_torch.dist.collectives import VirtualGroup

        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        size, rank = 1, 0
        for a in axes:
            i = self.axis_names.index(a)
            size *= self.devices.shape[i]
            rank = rank * self.devices.shape[i] + self.coords[i]
        return VirtualGroup(axis if isinstance(axis, str) else axes, size, rank)


def make_production_mesh(*, multi_pod: bool = False, coords: Optional[Sequence[int]] = None,
                         device: str = "meta") -> StandInMesh:
    """The dry-run's production mesh (module docstring): (data 32, model 8),
    or (pod 2, data 32, model 8) for two pods, seen from rank ``coords``."""
    if multi_pod:
        return StandInMesh(PRODUCTION_SHAPE_MULTI_POD, ("pod",) + MESH_AXES, coords, device)
    return StandInMesh(PRODUCTION_SHAPE, MESH_AXES, coords, device)


def make_scaled_mesh(n_chips: int, model: int = MODEL_RING,
                     coords: Optional[Sequence[int]] = None,
                     device: str = "meta") -> StandInMesh:
    """Meshes of varying size for Ernest f(m) fitting (m = n_chips): the
    model axis fixed at ``min(model, n_chips)`` (TP within a node's ring),
    the data axis scaled (truncating), as capacity is added in production."""
    model = min(model, n_chips)
    return StandInMesh((n_chips // model, model), MESH_AXES, coords, device)
