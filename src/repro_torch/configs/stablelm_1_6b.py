"""stablelm-1.6b — dense transformer, MHA, partial rotary.

[hf:stabilityai/stablelm-2-1_6b; unverified] 24L d_model=2048 32H (kv=32)
d_ff=5632 vocab=100352.  StableLM-2 uses 25% partial rotary embeddings.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec


def config() -> ArchConfig:
    return ArchConfig(
        name="stablelm-1.6b",
        family="dense",
        n_layers=24,
        d_model=2_048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=5_632,
        vocab_size=100_352,
        rotary_pct=0.25,
        period=(LayerSpec(mixer="attn", ffn="dense"),),
        source="hf:stabilityai/stablelm-2-1_6b",
    )
