"""granite-20b: dense, 52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.

llama-architecture code model. Same numbers as the JAX package's
``configs/granite_20b.py`` [arXiv:2405.04324; hf].
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

ARCH_ID = "granite-20b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=52,
        d_model=6144,
        d_ff=24576,
        vocab_size=49152,
        attention=AttentionConfig(
            kind="gqa", num_heads=48, num_kv_heads=1, head_dim=128,
            rope_theta=10000.0,
        ),
        act="gelu",
        mlp_gated=False,   # GPT-BigCode-style classic 2-matrix MLP
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        d_ff=192,
        vocab_size=256,
        attention=AttentionConfig(kind="gqa", num_heads=4, num_kv_heads=1, head_dim=16),
        act="gelu",
        mlp_gated=False,
        remat="none",
    )
