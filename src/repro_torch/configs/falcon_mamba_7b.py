"""falcon-mamba-7b — pure Mamba-1 (attention-free) LM.

[arXiv:2410.05355; unverified] 64L d_model=4096 d_ff=0 vocab=65024 ssm_state=16.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, MambaConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="falcon-mamba-7b",
        family="ssm",
        n_layers=64,
        d_model=4_096,
        vocab_size=65_024,
        d_ff=0,
        mamba=MambaConfig(d_state=16, expand=2, d_conv=4),
        period=(LayerSpec(mixer="mamba", ffn="none"),),
        tie_embeddings=False,
        source="arXiv:2410.05355",
    )
