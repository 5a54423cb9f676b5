"""gemma3-4b: dense, 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.

5:1 local(sliding-window):global attention pattern, 128k context. Same
numbers as the JAX package's ``configs/gemma3_4b.py``
[hf:google/gemma-3-1b-pt; unverified].
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

ARCH_ID = "gemma3-4b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=34,
        d_model=2560,
        d_ff=10240,
        vocab_size=262144,
        attention=AttentionConfig(
            kind="gqa",
            num_heads=8,
            num_kv_heads=4,
            head_dim=256,
            sliding_window=1024,
            local_global_ratio=5,
            rope_theta=1_000_000.0,
        ),
        tie_embeddings=True,
        act="gelu",
        final_logit_softcap=30.0,
    )


def smoke() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        num_layers=6,             # keeps the 5:1 local/global pattern visible
        d_model=64,
        d_ff=128,
        vocab_size=256,
        attention=AttentionConfig(
            kind="gqa", num_heads=4, num_kv_heads=2, head_dim=16,
            sliding_window=8, local_global_ratio=5,
        ),
        tie_embeddings=True,
        act="gelu",
        final_logit_softcap=30.0,
        remat="none",
    )
