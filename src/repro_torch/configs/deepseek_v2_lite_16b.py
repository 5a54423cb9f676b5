"""deepseek-v2-lite-16b: MoE, 27L d_model=2048 16H d_ff=1408(expert) vocab=102400.

MLA attention (kv_lora_rank 512, no q compression in Lite: q is projected
directly), 64 routed experts top-6 plus 2 shared experts, the first layer
dense (d_ff 10,944). Same numbers as the JAX package's
``configs/deepseek_v2_lite_16b.py`` [arXiv:2405.04434; hf]. About 15.7 B
parameters (31.4 GB in bf16): it fits one H100 at full depth. The MLA cache
holds 512 + 64 values a token and layer; long prefills attend through the
flash kernel with q and k of 192 and v of 128, and the routed experts run
through the moe_jam kernel.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

ARCH_ID = "deepseek-v2-lite-16b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        num_layers=27,
        d_model=2048,
        d_ff=10944,                    # dense FFN width of the first layer
        vocab_size=102400,
        attention=AttentionConfig(
            kind="mla",
            num_heads=16,
            num_kv_heads=16,
            head_dim=192,              # qk_nope + qk_rope
            kv_lora_rank=512,
            q_lora_rank=0,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
            rope_theta=10000.0,
        ),
        moe=MoEConfig(
            num_experts=64,
            top_k=6,
            expert_ff=1408,
            num_shared=2,
            shared_ff=1408,
            first_dense_layers=1,
            transport="local",
        ),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="moe",
        num_layers=3,
        d_model=64,
        d_ff=160,
        vocab_size=256,
        attention=AttentionConfig(
            kind="mla", num_heads=4, num_kv_heads=4, head_dim=24,
            kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16,
        ),
        moe=MoEConfig(
            num_experts=8, top_k=2, expert_ff=32, num_shared=2, shared_ff=32,
            first_dense_layers=1, transport="local",
        ),
        remat="none",
    )
