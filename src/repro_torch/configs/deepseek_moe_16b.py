"""deepseek-moe-16b — fine-grained MoE, 2 shared + 64 routed top-6.

[arXiv:2401.06066; hf] 28L d_model=2048 16H (MHA kv=16) head_dim=128,
vocab=102400, expert d_ff=1408, first layer dense (d_ff=10944).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, MoEConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-moe-16b",
        family="moe",
        n_layers=28,
        d_model=2_048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=10_944,  # dense layers (first_k_dense)
        vocab_size=102_400,
        moe=MoEConfig(
            n_routed_experts=64,
            n_shared_experts=2,
            top_k=6,
            expert_d_ff=1_408,
        ),
        period=(LayerSpec(mixer="attn", ffn="moe"),),
        first_k_dense=1,
        source="arXiv:2401.06066",
    )
