"""Configuration dataclasses (a copy of ``repro/configs/base.py``'s model part).

Every architecture is expressed as a ``ModelConfig``. Configs are plain
frozen dataclasses so they hash, compare, and round-trip to JSON. The
shape/optimizer/sharding/run dataclasses of the JAX package belong to the
training and mesh slices and are not copied yet.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class AttentionConfig:
    """GQA / MQA / MHA / MLA attention configuration."""

    kind: str = "gqa"               # "gqa" | "mla"
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 64
    # Sliding-window attention. None => full attention on every layer.
    sliding_window: Optional[int] = None
    # local:global layer pattern, e.g. 5 => 5 sliding-window layers followed by
    # 1 full-attention layer (gemma3). 0 => all layers full attention.
    local_global_ratio: int = 0
    rope_theta: float = 10000.0
    # Fraction of head_dim that is rotated (stablelm uses 0.25).
    rotary_pct: float = 1.0
    # Multimodal rotary position embedding (qwen2-vl): 3 position streams.
    mrope: bool = False
    mrope_sections: tuple = (16, 24, 24)   # t/h/w split of half-dim
    # --- MLA (deepseek-v2) ---
    kv_lora_rank: int = 0
    q_lora_rank: int = 0            # 0 => no q compression (V2-Lite)
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    @property
    def q_dim(self) -> int:
        if self.kind == "mla":
            return self.num_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
        return self.num_heads * self.head_dim

    @property
    def kv_groups(self) -> int:
        return max(1, self.num_heads // max(1, self.num_kv_heads))


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration (routed + shared experts)."""

    num_experts: int = 64
    top_k: int = 8
    expert_ff: int = 1024
    num_shared: int = 0
    shared_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3
    transport: str = "local"
    first_dense_layers: int = 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-style selective-state-space configuration."""

    state_dim: int = 16
    conv_width: int = 4
    expand: int = 2
    dt_rank: int = 0                # 0 => ceil(d_model/16)


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block stack configuration (mLSTM : sLSTM ratio)."""

    slstm_every: int = 8
    num_heads: int = 4
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 1.333
    conv_width: int = 4
    chunk: int = 256


@dataclass(frozen=True)
class FrontendConfig:
    kind: str = "none"              # "none" | "audio_frames" | "vision_patches"
    feature_dim: int = 0
    num_patch_tokens: int = 0


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"           # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int = 4
    d_model: int = 256
    d_ff: int = 1024                # dense FFN width (0 => no FFN)
    vocab_size: int = 32000
    attention: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    act: str = "silu"               # silu | gelu
    is_encoder: bool = False
    parallel_ssm_attn: bool = False
    mlp_gated: bool = True
    dtype: str = "bfloat16"
    final_logit_softcap: float = 0.0
    remat: str = "full"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), default=str)

