"""Base configuration dataclasses for the repro framework.

Every assigned architecture is expressed as an :class:`ArchConfig`.  The model
code (src/repro/models) is driven entirely by these configs; nothing about a
specific architecture is hard-coded in the model.

Layer layout is described by a *repeating period* so the transformer stack can
be lowered as ``scan(period)`` (cheap to trace/compile even for 80-layer
models):

* pure dense / moe / mamba archs   -> period of length 1
* jamba-style hybrids              -> period of length 8 (1 attn : 7 mamba)
* first-k-dense MoE (deepseek)     -> ``first_k_dense`` layers unrolled, then
                                      scan over the repeating MoE period.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Literal, Optional, Sequence, Tuple

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]
Mixer = Literal["attn", "mamba"]
Ffn = Literal["dense", "moe", "none"]


@dataclass(frozen=True)
class LayerSpec:
    """One layer inside the repeating period."""

    mixer: Mixer = "attn"
    ffn: Ffn = "dense"


@dataclass(frozen=True)
class MoEConfig:
    n_routed_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 1
    expert_d_ff: int = 0
    # capacity factor for the EP all_to_all dispatch path
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.001
    # normalise top-k router weights to sum to one (deepseek-style)
    norm_topk: bool = True
    # a rank's share (the port's local config, repro_torch.serve.sharding):
    # it holds n_routed_experts / expert_shards experts (the router's
    # columns too) and 1 / expert_shards of the shared experts' width, the
    # experts' d_model dim cut in embed_shards blocks (the 2-D path); the
    # routing (softmax, top-k, capacity, aux) stays the whole E's
    expert_shards: int = 1
    embed_shards: int = 1


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    expand: int = 2
    d_conv: int = 4
    dt_rank: int = 0  # 0 => ceil(d_model / 16)
    # 0 => expand * d_model; else a tensor-parallel rank's share of it
    # (repro_torch.serve.sharding.local_config)
    d_inner: int = 0

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank or int(math.ceil(d_model / 16))

    def resolved_d_inner(self, d_model: int) -> int:
        return self.d_inner or self.expand * d_model


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    vocab_size: int
    # --- attention ---
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qk_norm: bool = False
    qkv_bias: bool = False
    rotary_pct: float = 1.0
    rope_theta: float = 10_000.0
    # --- ffn ---
    d_ff: int = 0
    # --- moe / mla / mamba sub-configs ---
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    # --- layer layout ---
    period: Tuple[LayerSpec, ...] = (LayerSpec(),)
    first_k_dense: int = 0  # leading layers forced to (attn|mamba as period[0].mixer, dense ffn)
    # --- frontend stubs (vlm / audio) ---
    frontend: Literal["none", "vision_stub", "audio_stub"] = "none"
    n_frontend_tokens: int = 0
    # --- misc ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    source: str = ""

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.n_layers % len(self.period) and self.n_layers > self.first_k_dense:
            n_scan = self.n_layers - self.first_k_dense
            if n_scan % len(self.period):
                raise ValueError(
                    f"{self.name}: n_layers-first_k_dense={n_scan} not divisible "
                    f"by period length {len(self.period)}"
                )

    # ------------------------------------------------------------------
    @property
    def n_periods(self) -> int:
        return (self.n_layers - self.first_k_dense) // len(self.period)

    @property
    def uses_attention(self) -> bool:
        return any(l.mixer == "attn" for l in self.period) or self.first_k_dense > 0

    @property
    def pure_attention(self) -> bool:
        return all(l.mixer == "attn" for l in self.period)

    @property
    def uses_mamba(self) -> bool:
        return any(l.mixer == "mamba" for l in self.period)

    @property
    def uses_moe(self) -> bool:
        return self.moe is not None and any(l.ffn == "moe" for l in self.period)

    def layer_specs(self) -> Sequence[LayerSpec]:
        """Fully unrolled layer list (for reference / parameter counting)."""
        head = [dataclasses.replace(self.period[0], ffn="dense")] * self.first_k_dense
        body = list(self.period) * self.n_periods
        return head + body

    # ------------------------------------------------------------------
    # Parameter counting (used for MODEL_FLOPS = 6*N*D roofline term).
    # ------------------------------------------------------------------
    def attn_params(self) -> int:
        d = self.d_model
        if self.mla is not None:
            m = self.mla
            q = d * m.q_lora_rank + m.q_lora_rank * self.n_heads * (
                m.qk_nope_head_dim + m.qk_rope_head_dim
            )
            kv = d * (m.kv_lora_rank + m.qk_rope_head_dim) + m.kv_lora_rank * self.n_heads * (
                m.qk_nope_head_dim + m.v_head_dim
            )
            o = self.n_heads * m.v_head_dim * d
            return q + kv + o
        hd = self.head_dim
        q = d * self.n_heads * hd
        k = d * self.n_kv_heads * hd
        v = d * self.n_kv_heads * hd
        o = self.n_heads * hd * d
        bias = (self.n_heads + 2 * self.n_kv_heads) * hd if self.qkv_bias else 0
        return q + k + v + o + bias

    def mamba_params(self) -> int:
        assert self.mamba is not None
        d = self.d_model
        cfg = self.mamba
        d_in = cfg.expand * d
        dt_rank = cfg.resolved_dt_rank(d)
        in_proj = d * 2 * d_in
        conv = d_in * cfg.d_conv + d_in
        x_proj = d_in * (dt_rank + 2 * cfg.d_state)
        dt_proj = dt_rank * d_in + d_in
        a_d = d_in * cfg.d_state + d_in
        out_proj = d_in * d
        return in_proj + conv + x_proj + dt_proj + a_d + out_proj

    def dense_ffn_params(self) -> int:
        # SwiGLU: gate, up, down
        return 3 * self.d_model * self.d_ff

    def moe_ffn_params(self, active_only: bool = False) -> int:
        assert self.moe is not None
        moe = self.moe
        per_expert = 3 * self.d_model * moe.expert_d_ff
        router = self.d_model * moe.n_routed_experts
        shared = moe.n_shared_experts * per_expert
        routed = (moe.top_k if active_only else moe.n_routed_experts) * per_expert
        return router + shared + routed

    def param_count(self, active_only: bool = False) -> int:
        """Total (or active, for MoE) parameter count, embeddings included."""
        total = self.vocab_size * self.d_model  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * self.d_model  # lm head
        for spec in self.layer_specs():
            if spec.mixer == "attn":
                total += self.attn_params()
            else:
                total += self.mamba_params()
            if spec.ffn == "dense":
                total += self.dense_ffn_params()
            elif spec.ffn == "moe":
                total += self.moe_ffn_params(active_only=active_only)
            # 2 rmsnorm scales per layer
            total += 2 * self.d_model
        total += self.d_model  # final norm
        return total


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


TRAIN_4K = ShapeSpec("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")

ALL_SHAPES: Tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def applicable_shapes(cfg: ArchConfig) -> Tuple[ShapeSpec, ...]:
    """long_500k requires sub-quadratic attention: SSM / hybrid only.

    All assigned archs are decoders, so decode shapes apply everywhere.
    """
    shapes = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.uses_mamba:  # ssm & hybrid families
        shapes.append(LONG_500K)
    return tuple(shapes)
