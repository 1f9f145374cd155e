"""deepseek-v2-236b — MoE with Multi-head Latent Attention (MLA).

[arXiv:2405.04434; hf] 60L d_model=5120 128H, MLA kv_lora=512 (q_lora=1536,
qk_nope=128, qk_rope=64, v_head=128), vocab=102400, MoE: 2 shared + 160
routed experts top-6, expert d_ff=1536, first layer dense (d_ff=12288).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, MLAConfig, MoEConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-236b",
        family="moe",
        n_layers=60,
        d_model=5_120,
        n_heads=128,
        n_kv_heads=128,
        head_dim=128,
        d_ff=12_288,  # dense layers (first_k_dense)
        vocab_size=102_400,
        mla=MLAConfig(
            q_lora_rank=1_536,
            kv_lora_rank=512,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
        ),
        moe=MoEConfig(
            n_routed_experts=160,
            n_shared_experts=2,
            top_k=6,
            expert_d_ff=1_536,
        ),
        period=(LayerSpec(mixer="attn", ffn="moe"),),
        first_k_dense=1,
        source="arXiv:2405.04434",
    )
