"""internvl2-76b — VLM: InternViT frontend (stub) + InternLM2-style backbone.

[arXiv:2404.16821; unverified] backbone: 80L d_model=8192 64H (GQA kv=8)
d_ff=28672 vocab=128256.  Per the assignment, the vision frontend is a STUB:
``input_specs()`` provides precomputed patch embeddings (n_frontend_tokens per
image, already projected to d_model) which the model prepends to the token
embeddings.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec


def config() -> ArchConfig:
    return ArchConfig(
        name="internvl2-76b",
        family="vlm",
        n_layers=80,
        d_model=8_192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=28_672,
        vocab_size=128_256,
        period=(LayerSpec(mixer="attn", ffn="dense"),),
        frontend="vision_stub",
        n_frontend_tokens=256,
        source="arXiv:2404.16821",
    )
