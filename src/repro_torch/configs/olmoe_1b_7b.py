"""olmoe-1b-7b: MoE, 16L d_model=2048 16H (MHA kv=16) d_ff=1024(expert) vocab=50304.

64 experts, top-8 routing, no shared experts. Same numbers as the JAX
package's ``configs/olmoe_1b_7b.py`` [arXiv:2409.02060; hf]. Each expert is
3 x 2048 x 1024 bf16 weights, 12.6 MB; the port serves it on one card,
where the expert FFN over the capacity buckets is the moe_jam kernel.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

ARCH_ID = "olmoe-1b-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        num_layers=16,
        d_model=2048,
        d_ff=0,
        vocab_size=50304,
        attention=AttentionConfig(
            kind="gqa", num_heads=16, num_kv_heads=16, head_dim=128,
            rope_theta=10000.0,
        ),
        moe=MoEConfig(
            num_experts=64, top_k=8, expert_ff=1024, num_shared=0,
            transport="auto",
        ),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        d_ff=0,
        vocab_size=256,
        attention=AttentionConfig(kind="gqa", num_heads=4, num_kv_heads=4, head_dim=16),
        moe=MoEConfig(num_experts=8, top_k=2, expert_ff=32, transport="auto"),
        remat="none",
    )
