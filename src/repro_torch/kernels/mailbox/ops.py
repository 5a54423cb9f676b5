"""Public wrappers of the mailbox kernels.

``ring_am_put`` (the one-sided ring put, ranks as the CTAs of a cluster
on one card), ``am_server_sum`` and ``am_indirect_put`` take a
``FrameSpec`` for the frame geometry, as the JAX package's ops do, plus
``kernel``: ``auto`` launches the CUDA kernel on CUDA tensors and takes the
plain version on CPU tensors; ``cuda`` on the CPU raises
(``loader.resolve_kernel``, the rule every kernel of the port follows).
There is no fallback from one to the other. Puts between cards wait for
ROADMAP A14.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.message import FrameSpec
from repro_torch.kernels.loader import resolve_kernel
from repro_torch.kernels.mailbox.kernel import (PUT_LAUNCHES, RING_LAUNCHES, SUM_LAUNCHES,
                                                indirect_put_cuda, mailbox_put_cuda,
                                                server_sum_cuda)
from repro_torch.kernels.mailbox.ref import (MAX_SPINS, indirect_put_ref, mailbox_put_ref,
                                             put_slots, ring_put_ref, server_sum_ref)


def ring_am_put(frame_blocks: torch.Tensor, *, spec: FrameSpec, shift: int = 1,
                wait: str = "wfe", stash: bool = True, handler: Optional[str] = None,
                kernel: str = "auto"
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """One-sided ring put of ``(n, N, W)`` int32 frames, rank ``r``'s block
    on row ``r``, to rank ``(r + shift) % n`` -> ``(arrivals (n, N, W),
    spins (n, 1, 1), sums (n, N, 1) | None)``, as the JAX ``ring_am_put``.

    ``wait``: ``"wfe"`` (a hardware wait, 0 spins) or ``"poll"`` (spins on
    the last frame's SIG word, counted up to ``MAX_SPINS``; 0 without
    stash). ``stash=True`` keeps the mailbox on chip, where ``handler="sum"``
    takes each frame's Server-Side Sum on arrival; ``stash=False`` puts to
    device memory, drained by ``am_server_sum`` afterwards (a fused sum
    there raises ``ValueError``, as the JAX kernel does)."""
    if frame_blocks.dim() != 3 or frame_blocks.shape[1] < 1 \
            or frame_blocks.shape[2] != spec.total_words:
        raise ValueError(f"frame_blocks must be (n, N >= 1, {spec.total_words}), got "
                         f"{tuple(frame_blocks.shape)}")
    o = spec.offsets()
    fn = (mailbox_put_cuda if resolve_kernel(kernel, frame_blocks.device) == "cuda"
          else mailbox_put_ref)
    return fn(frame_blocks, shift=shift, wait=wait, stash=stash, handler=handler,
              sig_off=o["sig"], usr_off=o["usr"], payload_words=spec.payload_words)


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


__all__ = ["MAX_SPINS", "PUT_LAUNCHES", "RING_LAUNCHES", "SUM_LAUNCHES", "am_indirect_put",
           "am_server_sum", "indirect_put_cuda", "indirect_put_ref", "mailbox_put_cuda",
           "mailbox_put_ref", "put_slots", "ring_am_put", "ring_put_ref", "server_sum_cuda",
           "server_sum_ref"]
