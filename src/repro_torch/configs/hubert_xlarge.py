"""hubert-xlarge: audio encoder-only, 48L d_model=1280 16H (MHA) d_ff=5120 vocab=504.

Same numbers as the JAX package's ``configs/hubert_xlarge.py``
[arXiv:2106.07447]. The conv waveform frontend is not modelled:
``forward`` takes precomputed frame features (batch, frames, 512) and owns
the 512 -> 1280 projection (``frontend_proj``) and the encoder stack. No
rotary positions, no causal mask, no cache and no decode step: its entry
point is the prefill step, which returns logits for every frame; frames
past the chunking threshold run the flash attention kernel without the
causal mask.
"""
from repro_torch.configs.base import AttentionConfig, FrontendConfig, ModelConfig

ARCH_ID = "hubert-xlarge"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="audio",
        num_layers=48,
        d_model=1280,
        d_ff=5120,
        vocab_size=504,
        attention=AttentionConfig(
            kind="gqa", num_heads=16, num_kv_heads=16, head_dim=80,
            rotary_pct=0.0,
        ),
        frontend=FrontendConfig(kind="audio_frames", feature_dim=512),
        is_encoder=True,
        act="gelu",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="audio",
        num_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=64,
        attention=AttentionConfig(
            kind="gqa", num_heads=4, num_kv_heads=4, head_dim=16, rotary_pct=0.0,
        ),
        frontend=FrontendConfig(kind="audio_frames", feature_dim=32),
        is_encoder=True,
        act="gelu",
        remat="none",
    )
