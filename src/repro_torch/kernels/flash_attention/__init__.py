"""Flash attention: the CUDA kernel, its plain version, and the wrapper."""
from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    LAUNCHES, compare, design, flash_attention, flash_attention_cuda, key_tile, mha_ref,
    tile_counts)
