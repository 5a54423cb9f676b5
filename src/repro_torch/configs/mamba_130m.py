"""mamba-130m: ssm, 24L d_model=768 vocab=50280.

Pure selective-SSM stack: every layer is a mamba block (inner 1536 =
expand 2, state 16, conv width 4, dt_rank 48), with no attention and no
separate FFN; untied head. Same numbers as the JAX package's
``configs/mamba_130m.py`` [arXiv:2312.00752]. The port serves it on the
recurrent backend, where the selective scan is the ssm_scan kernel.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

ARCH_ID = "mamba-130m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="ssm",
        num_layers=24,
        d_model=768,
        d_ff=0,
        vocab_size=50280,
        attention=None,
        ssm=SSMConfig(state_dim=16, conv_width=4, expand=2),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="ssm",
        num_layers=2,
        d_model=64,
        d_ff=0,
        vocab_size=256,
        attention=None,
        ssm=SSMConfig(state_dim=4, conv_width=4, expand=2),
        remat="none",
    )
