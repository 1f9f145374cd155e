"""Runtime options threaded through the model: kernel geometry, the paged
decode implementation and the row blocks of the row-wise steps.  The
counterpart of ``repro.models.runtime.Runtime`` without a mesh, sharding
rules or remat (the port runs on one card and does not train yet).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

PAGED_IMPLS = ("kernel", "stream", "gather")
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
    # to each other; taken on any device only when named)
    paged_impl: str = "kernel"
    # prefill runs its row-wise steps (norms, projections, rope, MLP) over
    # blocks of this many rows, each one product of fixed shape; the serve
    # engine pads prompts to whole blocks (repro_torch.serve.engine)
    prefill_rows: int = PREFILL_ROWS
    # a decode-shaped call (one token a row) runs its row-wise steps over
    # blocks of this many rows (None: one block of all rows); the serve
    # engine sets max_batch, so that a speculative verify step, max_batch x
    # (k + 1) rows, runs each of them at the decode step's shape
    decode_rows: Optional[int] = None

    def __post_init__(self):
        if self.paged_impl not in PAGED_IMPLS:
            raise ValueError(f"paged_impl={self.paged_impl!r} not in {PAGED_IMPLS}")
        if self.prefill_rows < 1:
            raise ValueError(f"prefill_rows={self.prefill_rows} must be positive")
        if self.decode_rows is not None and self.decode_rows < 1:
            raise ValueError(f"decode_rows={self.decode_rows} must be positive")
