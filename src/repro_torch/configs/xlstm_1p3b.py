"""xlstm-1.3b: ssm, 48L d_model=2048 4H d_ff=0 vocab=50304.

sLSTM + mLSTM blocks (xLSTM[7:1]: one sLSTM block per 8, so 42 mLSTM and
6 sLSTM layers). No separate FFN: an mLSTM block carries its own
up-projection (inner 4096, 4 heads of 1024), an sLSTM block its gated FF.
Same numbers as the JAX package's ``configs/xlstm_1p3b.py``
[arXiv:2405.04517; unverified]. The port serves it on the recurrent
backend (its default) and on slots; neither recurrence has a kernel.
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

ARCH_ID = "xlstm-1.3b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="ssm",
        num_layers=48,
        d_model=2048,
        d_ff=0,
        vocab_size=50304,
        attention=None,
        xlstm=XLSTMConfig(slstm_every=8, num_heads=4, proj_factor_mlstm=2.0),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="ssm",
        num_layers=4,
        d_model=64,
        d_ff=0,
        vocab_size=256,
        attention=None,
        xlstm=XLSTMConfig(slstm_every=2, num_heads=4, proj_factor_mlstm=2.0),
        remat="none",
    )
