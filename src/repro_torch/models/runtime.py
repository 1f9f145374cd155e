"""Runtime options threaded through the model: kernel geometry, the paged
decode implementation, the row blocks of the row-wise steps, the device mesh
and its sharding rules and, for training, rematerialisation.  The
counterpart of ``repro.models.runtime.Runtime``.

``mesh`` (a ``torch.distributed.device_mesh.DeviceMesh`` with axes ("data",
"model")) and ``rules`` (``repro_torch.dist.partitioning.Rules``; None:
``Rules.for_serving(mesh)``) are the reference's fields
(``runtime.py:19-20``).  The serve engine builds its ``ShardingPlan`` from
them (``repro_torch.serve.sharding``), and the model's forward reads the
"model" axis' process group from ``mesh`` for its collectives
(``model_group``).  The trainer runs on a data mesh (``"model"`` of size
1, ``Rules.default``: FSDP over "data"), and the training forward reads the
"data" group (``data_group``) for its loss shares
(``repro_torch.models.model.LM.loss_fn``).

``remat`` (``runtime.py:25``, ``remat_wrap`` at ``:43-50``) applies to the
training forward, one layer at a time (the reference wraps one period, which
for the dense archs is one layer): ``"none"`` keeps every activation,
``"full"`` keeps only each layer's input and recomputes the layer in the
backward (``torch.utils.checkpoint``), ``"dots"`` keeps the outputs of the
matrix products without batch dimensions (``aten.mm``/``addmm``, as
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` does) and
recomputes the rest (a selective-checkpoint policy).  The serve paths run
under ``no_grad`` and never rematerialise.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import torch

from repro_torch.dist.partitioning import MODEL_AXIS, Rules, mesh_axes

# the paged decode's implementations over the pools (K2 and its two plain
# versions), and the Runtime's, which adds MLA's "legacy" gather
POOL_IMPLS = ("kernel", "stream", "gather")
PAGED_IMPLS = POOL_IMPLS + ("legacy",)
REMAT_MODES = ("none", "full", "dots")
DATA_AXIS = "data"
DEFAULT_PAGES_PER_PROGRAM = 4  # repro/kernels/flash_decode/ops.py:47
# Rows per matrix product in prefill.  Fewer rows waste less on padding
# (the serve engine pads prompts to whole blocks), more rows make fewer
# blocks, and each block costs the host one eager pass over every layer.  On
# an H100 host with eager PyTorch that pass measured 50-90 ms, about the
# device time of a 1000-row block's products: a 32-token prompt took the same
# time unpadded and in one block of 256, 512 or 1024 rows, and a 1024-token
# prompt 153 ms in one block of 1024 against 189-205 ms in two of 512
# (chip_smoke.py's row-block phase; PERF.md).
PREFILL_ROWS = 1024


@dataclasses.dataclass(frozen=True)
class Runtime:
    # Flash-attention blocking.  The reference defaults to 512, a TPU tile;
    # the port's prefill kernel (K3) stages 64-key tiles and takes block_k
    # 16, 32 or 64, so the port defaults to the serve engine's 16.
    block_q: int = 16
    block_k: int = 16
    page_size: int = 16  # paged-KV page length (serving)
    # None: the autotuner's config cache entry for the decode call's shape
    # (repro_torch.kernels.tune), else DEFAULT_PAGES_PER_PROGRAM
    pages_per_program: Optional[int] = None
    # paged decode: "kernel" (K2 for CUDA tensors, its plain version for CPU
    # tensors), "stream" or "gather" (the two plain versions, bit-identical
    # to each other; taken on any device only when named); MLA also takes
    # "legacy", the reference's gather of the latent pages into a
    # contiguous row and its ``_mla_decode_attn`` (``mla.py:214-224``)
    paged_impl: str = "kernel"
    # MLA's contiguous and legacy decode: attend in the latent space with
    # W_uk and W_uv absorbed (True), or re-expand K/V from the latents a
    # chunk at a time (False, the reference's default, ``runtime.py:24``)
    mla_absorb: bool = False
    # prefill runs its row-wise steps (norms, projections, rope, MLP) over
    # blocks of this many rows, each one product of fixed shape; the serve
    # engine pads prompts to whole blocks (repro_torch.serve.engine)
    prefill_rows: int = PREFILL_ROWS
    # a decode-shaped call (one token a row) runs its row-wise steps over
    # blocks of this many rows (None: one block of all rows); the serve
    # engine sets max_batch, so that a speculative verify step, max_batch x
    # (k + 1) rows, runs each of them at the decode step's shape
    decode_rows: Optional[int] = None
    # training only: "none" | "full" | "dots" (the module docstring).  The
    # reference's Runtime defaults to "full" and its LM to "none"; the port's
    # default Runtime plays the LM's part.
    remat: str = "none"
    mesh: Optional[Any] = None
    rules: Optional[Rules] = None

    def __post_init__(self):
        if self.remat not in REMAT_MODES:
            raise ValueError(f"remat={self.remat!r} not in {REMAT_MODES}")
        if self.paged_impl not in PAGED_IMPLS:
            raise ValueError(f"paged_impl={self.paged_impl!r} not in {PAGED_IMPLS}")
        if self.prefill_rows < 1:
            raise ValueError(f"prefill_rows={self.prefill_rows} must be positive")
        if self.decode_rows is not None and self.decode_rows < 1:
            raise ValueError(f"decode_rows={self.decode_rows} must be positive")

    def model_world(self) -> int:
        """The size of the mesh's "model" axis (1 without a mesh)."""
        if self.mesh is None:
            return 1
        names, shape = mesh_axes(self.mesh)
        return dict(zip(names, shape)).get(MODEL_AXIS, 1)

    def model_group(self):
        """The process group of this rank's "model" axis, or None without a
        mesh or at a model axis of size 1 (the collectives are then the
        identity: ``repro_torch.dist.collectives``)."""
        if self.model_world() == 1:
            return None
        return self.mesh.get_group(MODEL_AXIS)

    def data_world(self) -> int:
        """The size of the mesh's "data" axis (1 without a mesh)."""
        if self.mesh is None:
            return 1
        names, shape = mesh_axes(self.mesh)
        return dict(zip(names, shape)).get(DATA_AXIS, 1)

    def data_group(self):
        """The process group of this rank's "data" axis, or None without a
        mesh or at a data axis of size 1 (the training forward then runs
        the unsharded arithmetic)."""
        if self.data_world() == 1:
            return None
        return self.mesh.get_group(DATA_AXIS)

    def remat_call(self, fn: Callable[[torch.Tensor], Any], x: torch.Tensor) -> Any:
        """``fn(x)`` under the ``remat`` policy (a no-op without grad): its
        outputs as ``fn`` returns them, a layer's (x, aux) pair too."""
        if self.remat == "none" or not torch.is_grad_enabled():
            return fn(x)
        from torch.utils import checkpoint as ckpt

        if self.remat == "full":
            return ckpt.checkpoint(fn, x, use_reentrant=False)
        return ckpt.checkpoint(fn, x, use_reentrant=False, context_fn=functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots))


def _save_dots(ctx, op, *args, **kwargs):
    """Selective checkpoint policy of ``remat="dots"``: keep the matrix
    products without batch dimensions, recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE
