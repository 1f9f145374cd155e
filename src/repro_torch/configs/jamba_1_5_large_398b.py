"""jamba-1.5-large-398b — hybrid Mamba + attention + MoE.

[arXiv:2403.19887; hf] 72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536,
MoE 16 experts top-2.  Layer layout: period of 8 with attention:mamba = 1:7
(attention at period position 4, as in the Jamba paper) and MoE applied every
other layer (odd positions).  72 = 9 periods of 8.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, MambaConfig, MoEConfig


def _period():
    specs = []
    for j in range(8):
        mixer = "attn" if j == 4 else "mamba"
        ffn = "moe" if j % 2 == 1 else "dense"
        specs.append(LayerSpec(mixer=mixer, ffn=ffn))
    return tuple(specs)


def config() -> ArchConfig:
    return ArchConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        n_layers=72,
        d_model=8_192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=24_576,
        vocab_size=65_536,
        moe=MoEConfig(
            n_routed_experts=16,
            n_shared_experts=0,
            top_k=2,
            expert_d_ff=24_576,
        ),
        mamba=MambaConfig(d_state=16, expand=2, d_conv=4),
        period=_period(),
        source="arXiv:2403.19887",
    )
