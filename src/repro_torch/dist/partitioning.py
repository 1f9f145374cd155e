"""Sharding rules: logical axis names -> a placement spec on a mesh (the
counterpart of ``repro/dist/partitioning.py``).

Model code names every tensor dimension with a *logical* name ("embed",
"mlp", "heads_flat", "cache_batch", ...; ``repro_torch.models.param``); this
module is the one place those names meet the mesh.  ``Rules.default(mesh)``
is the production policy (FSDP over the batch axes, tensor parallelism over
"model"), ``Rules.for_serving(mesh)`` the serve data plane's (pure tensor
parallelism), ``override()`` a variant of either.

A spec is a tuple with one entry per tensor dimension: ``None``
(replicated), one mesh axis name, or a tuple of mesh axis names (sharded
over their product, the first axis outermost).  The reference returns a
``jax.sharding.PartitionSpec``; ``tuple(PartitionSpec(...))`` is this
tuple.

Resolution semantics, unchanged (tests/test_torch_partitioning.py runs the
reference's cases on these Rules):

* **dedupe, first dim wins**: a mesh axis claimed by an earlier tensor
  dimension is unavailable to later ones;
* **divisibility fallback**: a dimension that does not divide the mesh
  axis size stays replicated;
* **partial axis-tuple retention**: of a tuple entry like ("pod", "data")
  the longest prefix that divides (and is unclaimed) is kept;
* **pod joins fsdp**: every non-"model" mesh axis counts as a batch/FSDP
  axis, in mesh order.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (its
``mesh_dim_names`` and ``shape``) or a stand-in with the reference's
``axis_names`` and ``devices.shape``, as the tests use.  ``placements``
turns a spec into DTensor placements on a ``DeviceMesh``; the reference's
``constrain`` has no counterpart, since the port's forward places its
tensors explicitly (``repro_torch.serve.sharding``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

# An entry maps one logical axis to: replicated (None), one mesh axis, or an
# ordered tuple of mesh axes (sharded over their product).
AxisEntry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[AxisEntry, ...]

MODEL_AXIS = "model"

# Sentinel resolved to the mesh's batch/FSDP axes at Rules construction.
_BATCH = "__batch__"

# Parameter logical axes (``partitioning.py:43-58``).  FSDP shards the d_model
# ("embed") dim over the batch axes; all "wide" dims take tensor parallelism
# over "model"; small or scan-carried dims stay replicated.
_PARAM_TABLE: Dict[str, Any] = {
    "embed": _BATCH,
    "vocab": MODEL_AXIS,
    "mlp": MODEL_AXIS,
    "heads_flat": MODEL_AXIS,
    "kv_flat": MODEL_AXIS,
    "expert": MODEL_AXIS,
    "expert_mlp": MODEL_AXIS,
    "mamba_inner": MODEL_AXIS,
    "norm": None,
    "layers": None,
    "lora": None,
    "conv": None,
    "dt_rank": None,
    "ssm_state": None,
}

# Activation / cache logical axes (``partitioning.py:64-78``).  Batch dims
# shard over the batch axes; head/feature dims over "model"; sequence dims
# replicate.
_ACT_TABLE: Dict[str, Any] = {
    "batch": _BATCH,
    "cache_batch": _BATCH,
    "act_heads": MODEL_AXIS,
    "act_kv_heads": MODEL_AXIS,
    "act_mlp": MODEL_AXIS,
    "act_mamba": MODEL_AXIS,
    "act_vocab": MODEL_AXIS,
    "cache_head_dim": MODEL_AXIS,
    "seq": None,
    "frontend_seq": None,
    "act_embed": None,
    "cache_seq": None,
    "cache_latent": None,
}


def _normalize(entry: Any) -> AxisEntry:
    if entry is None or isinstance(entry, str):
        return entry
    return tuple(entry)


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """(axis names, axis sizes) of a ``DeviceMesh`` or of a stand-in with
    ``axis_names`` and ``devices.shape``."""
    if hasattr(mesh, "mesh_dim_names"):
        return tuple(mesh.mesh_dim_names), tuple(int(n) for n in mesh.shape)
    return tuple(mesh.axis_names), tuple(int(n) for n in mesh.devices.shape)


def entry_axes(entry: AxisEntry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, outermost first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class Rules:
    """Immutable logical->physical placement policy for one mesh."""

    mesh: Any                         # DeviceMesh (or a stand-in)
    axis_sizes: Mapping[str, int]     # mesh axis name -> size, in mesh order
    params: Mapping[str, AxisEntry]
    acts: Mapping[str, AxisEntry]

    # ------------------------------------------------------------------
    @classmethod
    def default(cls, mesh) -> "Rules":
        names, shape = mesh_axes(mesh)
        sizes = dict(zip(names, shape))
        batch = tuple(a for a in names if a != MODEL_AXIS)

        def concretize(table: Mapping[str, Any]) -> Dict[str, AxisEntry]:
            return {k: (batch if v is _BATCH else _normalize(v)) for k, v in table.items()}

        return cls(mesh=mesh, axis_sizes=sizes, params=concretize(_PARAM_TABLE),
                   acts=concretize(_ACT_TABLE))

    @classmethod
    def for_serving(cls, mesh) -> "Rules":
        """Placement policy for the serve data plane
        (``partitioning.py:115-144``).

        Pure tensor parallelism: wide parameter and activation feature dims
        shard over "model" exactly as in training, while every batch-like
        axis is replicated: ``batch`` (the decode slots: each rank computes
        all of them), ``cache_batch`` (the paged pool's page axis: any slot
        may reference any page, so the pool is resident everywhere and
        shards along its head dim instead) and ``embed`` (FSDP in training;
        serving keeps full parameter rows resident).

        Exactness: at world size 1 this placement is bitwise the unsharded
        engine.  At world size > 1 the model-axis contractions (the
        attention output, MLP down and Mamba projections) sum partial
        products across ranks, so logits agree to float tolerance and the
        greedy token streams are the identity surface
        (tests/test_torch_tp.py)."""
        return cls.default(mesh).override(params={"embed": None},
                                          acts={"batch": None, "cache_batch": None})

    def override(self, params: Optional[Mapping[str, Any]] = None,
                 acts: Optional[Mapping[str, Any]] = None) -> "Rules":
        """New Rules with some logical-axis entries replaced."""
        new_params = dict(self.params)
        new_acts = dict(self.acts)
        for k, v in (params or {}).items():
            new_params[k] = _normalize(v)
        for k, v in (acts or {}).items():
            new_acts[k] = _normalize(v)
        return dataclasses.replace(self, params=new_params, acts=new_acts)

    # ------------------------------------------------------------------
    def batch_axes(self) -> Tuple[str, ...]:
        """Mesh axes the "batch" activation dim maps to: by default every
        non-"model" axis; ``override(acts={"batch": None})`` empties it."""
        return tuple(a for a in entry_axes(self.acts.get("batch")) if a in self.axis_sizes)

    def model_axis(self) -> Optional[str]:
        return MODEL_AXIS if MODEL_AXIS in self.axis_sizes else None

    # ------------------------------------------------------------------
    def _pick(self, entry: AxisEntry, dim: Optional[int], used: set) -> AxisEntry:
        """Resolve one tensor dim's entry against claimed axes and its size
        (``partitioning.py:178-200``)."""
        if entry is None:
            return None
        # axes absent from this mesh (e.g. "pod" on a single-pod mesh) are
        # skipped so overrides written for the big mesh still apply
        cand = tuple(a for a in entry_axes(entry) if a in self.axis_sizes)
        picked, prod = [], 1
        for a in cand:
            if a in used:
                break
            size = self.axis_sizes[a]
            if dim is not None and dim % (prod * size) != 0:
                break
            picked.append(a)
            prod *= size
        if not picked:
            return None
        used.update(picked)
        return picked[0] if len(picked) == 1 else tuple(picked)

    def _spec(self, lookup, axes: Sequence[Optional[str]],
              shape: Optional[Sequence[int]]) -> Spec:
        if shape is not None and len(shape) != len(axes):
            raise ValueError(f"shape {tuple(shape)} rank != axes {tuple(axes)}")
        used: set = set()
        return tuple(self._pick(lookup(name), None if shape is None else int(shape[i]), used)
                     for i, name in enumerate(axes))

    def _param_entry(self, name: Optional[str]) -> AxisEntry:
        return self.params.get(name) if name else None

    def _act_entry(self, name: Optional[str]) -> AxisEntry:
        """Acts first, then params: cache trees reuse parameter logical names
        (e.g. "mamba_inner") for their feature dims."""
        if not name:
            return None
        if name in self.acts:
            return self.acts[name]
        return self.params.get(name)

    def param_pspec(self, axes: Sequence[Optional[str]],
                    shape: Optional[Sequence[int]] = None) -> Spec:
        return self._spec(self._param_entry, tuple(axes), shape)

    def act_pspec(self, axes: Sequence[Optional[str]],
                  shape: Optional[Sequence[int]] = None) -> Spec:
        return self._spec(self._act_entry, tuple(axes), shape)


def placements(spec: Spec, mesh) -> List[Any]:
    """DTensor placements on ``mesh`` (a ``DeviceMesh``) for ``spec``: one a
    mesh dimension, ``Shard(d)`` where tensor dim d names that mesh axis,
    else ``Replicate()``.  A tuple entry shards its dim over its axes in
    mesh order, which is the entry's own order when it follows the mesh
    (("pod", "data") on a ("pod", "data", "model") mesh)."""
    from torch.distributed.tensor import Replicate, Shard

    names, _ = mesh_axes(mesh)
    owner = {a: d for d, entry in enumerate(spec) for a in entry_axes(entry)}
    for entry in spec:
        order = [names.index(a) for a in entry_axes(entry)]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry} names mesh axes out of mesh order {names}")
    return [Shard(owner[a]) if a in owner else Replicate() for a in names]
