"""Flash attention: the CUDA kernels (forward and backward), their plain
version, and the wrapper."""
from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    BWD_HEAD_DIMS, BWD_LAUNCHES, LAUNCHES, FlashAttentionFn, compare, design, flash_attention,
    flash_attention_bwd_cuda, flash_attention_cuda, flash_attention_lse_cuda, key_tile,
    mha_ref, tile_counts)
