"""musicgen-medium — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284; hf] 48L d_model=1536 24H (kv=24, i.e. MHA) d_ff=6144
vocab=2048.  The audio/text conditioning frontend is a STUB per the
assignment: ``input_specs()`` provides precomputed conditioning frame
embeddings prepended to the EnCodec token stream.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec


def config() -> ArchConfig:
    return ArchConfig(
        name="musicgen-medium",
        family="audio",
        n_layers=48,
        d_model=1_536,
        n_heads=24,
        n_kv_heads=24,
        head_dim=64,
        d_ff=6_144,
        vocab_size=2_048,
        period=(LayerSpec(mixer="attn", ffn="dense"),),
        frontend="audio_stub",
        n_frontend_tokens=64,
        source="arXiv:2306.05284",
    )
