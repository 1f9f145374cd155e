"""qwen3-32b — dense transformer, GQA + qk_norm (head_dim 128 > d/H).

[hf:Qwen/Qwen3-32B; hf] 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936, head_dim=128 (q/k/v project to 8192).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-32b",
        family="dense",
        n_layers=64,
        d_model=5_120,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=25_600,
        vocab_size=151_936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        period=(LayerSpec(mixer="attn", ffn="dense"),),
        source="hf:Qwen/Qwen3-32B",
    )
