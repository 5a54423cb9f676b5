"""The mailbox handlers, Server-Side Sum and Indirect Put: the CUDA
kernels, their plain versions, and the wrappers."""
from repro_torch.kernels.mailbox.ops import (  # noqa: F401
    PUT_LAUNCHES, SUM_LAUNCHES, am_indirect_put, am_server_sum, indirect_put_cuda,
    indirect_put_ref, put_slots, ring_am_put, server_sum_cuda, server_sum_ref)
