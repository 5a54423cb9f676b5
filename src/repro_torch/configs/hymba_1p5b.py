"""hymba-1.5b: hybrid, 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001.

Parallel attention + mamba heads in every block (inner 3200, state 16),
mean-fused; 15 sliding-window (1,024) blocks then one global, twice.
Meta-tokens are omitted. Same numbers as the JAX package's
``configs/hymba_1p5b.py`` [arXiv:2411.13676; hf]. The port serves it on
slots (its default): prefills past the chunking threshold run the flash
attention kernel, every block the selective scan with no valid gate.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, SSMConfig

ARCH_ID = "hymba-1.5b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="hybrid",
        num_layers=32,
        d_model=1600,
        d_ff=5504,
        vocab_size=32001,
        attention=AttentionConfig(
            kind="gqa", num_heads=25, num_kv_heads=5, head_dim=64,
            sliding_window=1024, local_global_ratio=15,
            rope_theta=10000.0,
        ),
        ssm=SSMConfig(state_dim=16, conv_width=4, expand=2),
        parallel_ssm_attn=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="hybrid",
        num_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=256,
        attention=AttentionConfig(
            kind="gqa", num_heads=4, num_kv_heads=2, head_dim=16,
            sliding_window=8, local_global_ratio=1,
        ),
        ssm=SSMConfig(state_dim=4, conv_width=4, expand=2),
        parallel_ssm_attn=True,
        remat="none",
    )
