"""The selective scan: the CUDA kernels (forward and backward), their plain
versions, and the wrapper."""
from repro_torch.kernels.ssm_scan.ops import (  # noqa: F401
    BWD_F32_REL, BWD_LAUNCHES, BWD_TOL, BWD_VS_PLAIN, LAUNCHES, STATE_DIMS, SsmScanFn, compare,
    compare_bwd, ssm_scan, ssm_scan_bwd_cuda, ssm_scan_bwd_ref, ssm_scan_chunk_states,
    ssm_scan_cuda, ssm_scan_ref, ssm_scan_train_cuda)
