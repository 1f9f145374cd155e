"""Configurations of the port: the paper's CoCoA/MNIST workload
(``cocoa_mnist``) and the architecture registry, ``get_config(arch_id)`` /
``get_smoke_config``.

The architecture files are copies of ``repro.configs`` (pure data, no JAX);
arch ids use the assignment's dashed names, e.g. ``qwen3-14b``.  The port's
``LM`` runs every arch of the registry.
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.configs.base import (
    ALL_SHAPES,
    ArchConfig,
    LayerSpec,
    MambaConfig,
    MLAConfig,
    MoEConfig,
    ShapeSpec,
    SHAPES_BY_NAME,
    applicable_shapes,
)
from repro_torch.configs.smoke import (
    SMOKE_DECODE,
    SMOKE_PREFILL,
    SMOKE_TRAIN,
    smoke_variant,
)

from repro_torch.configs import (  # noqa: E402  (module registry)
    deepseek_moe_16b,
    deepseek_v2_236b,
    falcon_mamba_7b,
    internvl2_76b,
    jamba_1_5_large_398b,
    musicgen_medium,
    qwen1_5_110b,
    qwen3_14b,
    qwen3_32b,
    stablelm_1_6b,
)

_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {
    "falcon-mamba-7b": falcon_mamba_7b.config,
    "stablelm-1.6b": stablelm_1_6b.config,
    "qwen3-14b": qwen3_14b.config,
    "qwen1.5-110b": qwen1_5_110b.config,
    "qwen3-32b": qwen3_32b.config,
    "internvl2-76b": internvl2_76b.config,
    "jamba-1.5-large-398b": jamba_1_5_large_398b.config,
    "musicgen-medium": musicgen_medium.config,
    "deepseek-v2-236b": deepseek_v2_236b.config,
    "deepseek-moe-16b": deepseek_moe_16b.config,
}

ARCH_IDS = tuple(_REGISTRY)


def get_config(arch_id: str) -> ArchConfig:
    try:
        return _REGISTRY[arch_id]()
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}") from None


def get_smoke_config(arch_id: str) -> ArchConfig:
    return smoke_variant(get_config(arch_id))


__all__ = [
    "ALL_SHAPES",
    "ARCH_IDS",
    "ArchConfig",
    "LayerSpec",
    "MambaConfig",
    "MLAConfig",
    "MoEConfig",
    "ShapeSpec",
    "SHAPES_BY_NAME",
    "SMOKE_DECODE",
    "SMOKE_PREFILL",
    "SMOKE_TRAIN",
    "applicable_shapes",
    "get_config",
    "get_smoke_config",
    "smoke_variant",
]
