"""The moe_jam expert FFN: the CUDA kernels (forward and backward), their plain
versions, and the wrapper."""
from repro_torch.kernels.moe_jam.ops import (  # noqa: F401
    BWD_LAUNCHES, LAUNCHES, MoeJamFn, compare, moe_jam_ffn, moe_jam_ffn_bwd_cuda,
    moe_jam_ffn_bwd_ref, moe_jam_ffn_cuda, moe_jam_ffn_ref)
