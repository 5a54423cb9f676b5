"""Configuration dataclasses (a copy of ``repro/configs/base.py``'s model part).

Every architecture is expressed as a ``ModelConfig``. Configs are plain
frozen dataclasses so they hash, compare, and round-trip to JSON. The
shapes, the optimizer and the run configuration are copied too; the JAX
package's ``ShardingConfig`` (and ``RunConfig.sharding``) maps tensor axes
onto a mesh, which the port does not have yet (ROADMAP A14). The port's
``RunConfig`` has no default ``checkpoint_dir`` and leaves checkpoint
frequency and retention to ``TrainerConfig``, the fields the Trainer reads.
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



# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


# ---------------------------------------------------------------------------
# Training / runtime config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # int8 gradient compression with error feedback, for the data-parallel
    # reduce (which the port does not have yet: ROADMAP A14)
    compress_grads: bool = False
    accum_steps: int = 1


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    shape: ShapeConfig = field(default_factory=lambda: TRAIN_4K)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    seed: int = 0
    # where the Trainer keeps its checkpoints; no default, so that two runs
    # never share one by accident (the Trainer requires it). How often and
    # how many: TrainerConfig.
    checkpoint_dir: Optional[str] = None
