"""Paged attention: the CUDA kernel, its plain version, and the wrapper."""
from repro_torch.kernels.paged_attention.ops import (  # noqa: F401
    KERNEL_KINDS, LAUNCHES, compare_valid, modeled_hbm_bytes, paged_attention,
    paged_attention_cuda, paged_attention_ref, paged_attention_split_ref, resolve_kernel,
    split_plan)
