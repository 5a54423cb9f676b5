"""Configuration dataclasses (a copy of ``repro/configs/base.py``'s model part).

``ModelConfig.param_count`` and ``active_param_count`` are the JAX
package's analytic counts (its approximations included, such as the
mLSTM's block-diagonal qkv), not a sum over the port's parameter tree.

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

    def param_count(self) -> int:
        """Analytic parameter count (total, incl. all experts)."""
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        """Parameters active per token (MoE: shared + top_k experts only)."""
        return _param_count(self, active_only=True)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), default=str)


def _ffn_params(d_model: int, d_ff: int, gated: bool = True) -> int:
    # SwiGLU: gate + up + down; classic MLP: up + down
    return (3 if gated else 2) * d_model * d_ff


def _attn_params(cfg: ModelConfig) -> int:
    a = cfg.attention
    if a is None:
        return 0
    d = cfg.d_model
    if a.kind == "mla":
        qk_head = a.qk_nope_head_dim + a.qk_rope_head_dim
        p = d * a.num_heads * qk_head                      # q proj (no lora in Lite)
        p += d * (a.kv_lora_rank + a.qk_rope_head_dim)     # kv down + shared k_rope
        p += a.kv_lora_rank * a.num_heads * (a.qk_nope_head_dim + a.v_head_dim)
        p += a.num_heads * a.v_head_dim * d                # o proj
        return p
    hd = a.head_dim
    p = d * a.num_heads * hd                               # q
    p += 2 * d * a.num_kv_heads * hd                       # k, v
    p += a.num_heads * hd * d                              # o
    return p


def _layer_params(cfg: ModelConfig, layer_idx: int, active_only: bool) -> int:
    p = 0
    d = cfg.d_model
    if cfg.xlstm is not None:
        # mLSTM block: qkv + i/f gates + out, with up-projection
        inner = int(d * cfg.xlstm.proj_factor_mlstm)
        p += 2 * d * inner          # up/gate proj
        p += 3 * inner * inner // max(1, cfg.xlstm.num_heads)  # qkv (per-head block diag approx)
        p += inner * d              # down proj
        return p + 2 * d            # norms
    p += _attn_params(cfg)
    if cfg.ssm is not None:
        inner = cfg.ssm.expand * d
        p += d * 2 * inner          # in_proj (x, z)
        p += inner * cfg.ssm.conv_width
        dt_rank = cfg.ssm.dt_rank or -(-d // 16)
        p += inner * (dt_rank + 2 * cfg.ssm.state_dim) + dt_rank * inner
        p += inner * d              # out proj
    moe = cfg.moe
    use_moe = moe is not None and layer_idx >= (moe.first_dense_layers if moe else 0)
    if use_moe:
        shared = moe.num_shared * _ffn_params(d, moe.shared_ff or moe.expert_ff)
        routed_each = _ffn_params(d, moe.expert_ff)
        n_routed = moe.top_k if active_only else moe.num_experts
        p += shared + n_routed * routed_each + d * moe.num_experts  # + router
    elif cfg.d_ff > 0:
        p += _ffn_params(d, cfg.d_ff, cfg.mlp_gated)
    p += 2 * d                      # norms
    return p


def _param_count(cfg: ModelConfig, active_only: bool) -> int:
    p = cfg.vocab_size * cfg.d_model  # embed
    if not cfg.tie_embeddings:
        p += cfg.vocab_size * cfg.d_model
    if cfg.frontend.kind != "none":
        p += cfg.frontend.feature_dim * cfg.d_model
    for i in range(cfg.num_layers):
        p += _layer_params(cfg, i, active_only)
    p += cfg.d_model                 # final norm
    return p



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
