"""Public wrappers of the mailbox handler kernels.

``am_server_sum`` and ``am_indirect_put`` take a ``FrameSpec`` for the
USR geometry, as the JAX package's ops do, plus ``kernel``: ``auto``
launches the CUDA kernel on CUDA tensors and takes the plain version on
CPU tensors; ``cuda`` on the CPU raises (``loader.resolve_kernel``, the
rule every kernel of the port follows). There is no fallback from one to
the other. The ring put between devices (``ring_am_put``) waits for
ROADMAP A14 (kernel B7).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.message import FrameSpec
from repro_torch.kernels.loader import resolve_kernel
from repro_torch.kernels.mailbox.kernel import (PUT_LAUNCHES, SUM_LAUNCHES,
                                                indirect_put_cuda, server_sum_cuda)
from repro_torch.kernels.mailbox.ref import indirect_put_ref, put_slots, server_sum_ref


def am_server_sum(frames: torch.Tensor, spec: FrameSpec, *,
                  kernel: str = "auto") -> torch.Tensor:
    """Server-Side Sum handler over ``(N, W)`` frames -> ``(N,)`` int32."""
    o = spec.offsets()
    fn = server_sum_cuda if resolve_kernel(kernel, frames.device) == "cuda" else server_sum_ref
    return fn(frames, o["usr"], spec.payload_words)


def am_indirect_put(frames: torch.Tensor, table: torch.Tensor, heap: torch.Tensor,
                    got: torch.Tensor, spec: FrameSpec, *, kernel: str = "auto"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indirect Put handler: apply ``(N, W)`` frames to the server's
    ``table`` and ``heap`` **in place** (``got[0]`` is the heap base);
    returns the same two tensors."""
    o = spec.offsets()
    if resolve_kernel(kernel, frames.device) == "cuda":
        return indirect_put_cuda(frames, table, heap, got, o["usr"], spec.payload_words)
    return indirect_put_ref(frames, table, heap, o["usr"], spec.payload_words, got[0])


def ring_am_put(*args, **kwargs):
    raise NotImplementedError(
        "ring_am_put is a one-sided put between devices (kernel B7): it waits for "
        "ROADMAP A14 (multi-GPU)")


__all__ = ["PUT_LAUNCHES", "SUM_LAUNCHES", "am_indirect_put", "am_server_sum",
           "indirect_put_cuda", "indirect_put_ref", "put_slots", "ring_am_put",
           "server_sum_cuda", "server_sum_ref"]
