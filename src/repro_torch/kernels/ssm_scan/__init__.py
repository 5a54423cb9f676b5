"""The selective scan: the CUDA kernel, its plain version, and the wrapper."""
from repro_torch.kernels.ssm_scan.ops import (  # noqa: F401
    LAUNCHES, STATE_DIMS, compare, ssm_scan, ssm_scan_cuda, ssm_scan_ref)
