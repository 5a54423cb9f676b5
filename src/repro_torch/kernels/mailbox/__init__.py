"""The mailbox kernels, the one-sided ring put and the handlers Server-Side
Sum and Indirect Put: the CUDA kernels, their plain versions, and the
wrappers."""
from repro_torch.kernels.mailbox.ops import (  # noqa: F401
    MAX_SPINS, PUT_LAUNCHES, RING_LAUNCHES, SUM_LAUNCHES, am_indirect_put, am_server_sum,
    indirect_put_cuda, indirect_put_ref, mailbox_put_cuda, mailbox_put_ref, put_slots,
    ring_am_put, ring_put_ref, server_sum_cuda, server_sum_ref)
