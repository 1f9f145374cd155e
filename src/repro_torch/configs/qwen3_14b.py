"""qwen3-14b — dense transformer, GQA + qk_norm.

[hf:Qwen/Qwen3-8B family; hf] 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936, head_dim=128, qk-norm.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-14b",
        family="dense",
        n_layers=40,
        d_model=5_120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=17_408,
        vocab_size=151_936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        period=(LayerSpec(mixer="attn", ffn="dense"),),
        source="hf:Qwen/Qwen3-14B",
    )
