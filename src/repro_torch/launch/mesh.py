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
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

MESH_AXES = ("data", "model")
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
    """{axis name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))
