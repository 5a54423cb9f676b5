"""stablelm-3b: dense, 32L d_model=2560 32H (MHA kv=32) d_ff=6912 vocab=50304.

Partial rotary embedding (25%). Same numbers as the JAX package's
``configs/stablelm_3b.py`` [hf:stabilityai/stablelm-2-1_6b; unverified].
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

ARCH_ID = "stablelm-3b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=32,
        d_model=2560,
        d_ff=6912,
        vocab_size=50304,
        attention=AttentionConfig(
            kind="gqa", num_heads=32, num_kv_heads=32, head_dim=80,
            rotary_pct=0.25, rope_theta=10000.0,
        ),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        num_layers=2,
        d_model=64,
        d_ff=96,
        vocab_size=256,
        attention=AttentionConfig(
            kind="gqa", num_heads=4, num_kv_heads=4, head_dim=16, rotary_pct=0.25,
        ),
        remat="none",
    )
