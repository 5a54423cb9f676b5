"""The moe_jam expert FFN: the CUDA kernel, its plain version, and the wrapper."""
from repro_torch.kernels.moe_jam.ops import (  # noqa: F401
    LAUNCHES, compare, moe_jam_ffn, moe_jam_ffn_cuda, moe_jam_ffn_ref)
