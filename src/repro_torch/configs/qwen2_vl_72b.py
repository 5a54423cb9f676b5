"""qwen2-vl-72b: VLM backbone, 80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.

M-RoPE (three rotary position streams, t/h/w, over (16, 24, 24) of the 64
frequency slots). Same numbers as the JAX package's
``configs/qwen2_vl_72b.py`` [arXiv:2409.12191; hf]. The vision tower is
not modelled: ``forward`` takes precomputed merged patch embeddings
(batch, patches, 8192) and splices them over the first positions, with
3-D position ids beside them. The port serves it on slots (its default):
prefills past the chunking threshold run the flash attention kernel.
"""
from repro_torch.configs.base import AttentionConfig, FrontendConfig, ModelConfig

ARCH_ID = "qwen2-vl-72b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="vlm",
        num_layers=80,
        d_model=8192,
        d_ff=29568,
        vocab_size=152064,
        attention=AttentionConfig(
            kind="gqa", num_heads=64, num_kv_heads=8, head_dim=128,
            rope_theta=1_000_000.0, mrope=True, mrope_sections=(16, 24, 24),
        ),
        frontend=FrontendConfig(kind="vision_patches", feature_dim=8192,
                                num_patch_tokens=256),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="vlm",
        num_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=256,
        attention=AttentionConfig(
            kind="gqa", num_heads=4, num_kv_heads=2, head_dim=16,
            mrope=True, mrope_sections=(2, 3, 3),
        ),
        frontend=FrontendConfig(kind="vision_patches", feature_dim=64,
                                num_patch_tokens=8),
        remat="none",
    )
