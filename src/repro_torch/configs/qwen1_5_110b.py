"""qwen1.5-110b — dense transformer, GQA + QKV bias.

[hf:Qwen/Qwen1.5 family; hf] 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064, head_dim=128, QKV bias.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen1.5-110b",
        family="dense",
        n_layers=80,
        d_model=8_192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=49_152,
        vocab_size=152_064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        period=(LayerSpec(mixer="attn", ffn="dense"),),
        source="hf:Qwen/Qwen1.5-110B",
    )
