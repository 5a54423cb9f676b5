"""Reactive mailboxes (paper §III-A, Fig. 1): banked frame slots with
credit flow control, and drain-on-arrival execution.

The port of ``repro/core/mailbox.py`` on one device: ``post_local`` is the
loopback put, ``drain_mailbox`` executes every slot through a dispatcher.
The receiver has ``banks`` x ``frames_per_bank`` slots; a sender holds one
credit per free slot of a bank and may not put to a bank without one.
``ring_put`` and ``alltoall_put`` are the reference transports, with the
ranks on the leading axis of one tensor instead of the devices of a
``shard_map`` axis; the ring put through the CUDA kernel, ranks as the
CTAs of a cluster, is ``kernels.mailbox.ring_am_put``. Puts between cards
wait for ROADMAP A14.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple, Union

import torch

from repro_torch.core.message import SIG_MAGIC, FrameSpec
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MailboxConfig:
    banks: int = 4
    frames_per_bank: int = 16
    spec: FrameSpec = dataclasses.field(default_factory=FrameSpec)

    @property
    def words(self) -> int:
        return self.spec.total_words


def init_mailbox(cfg: MailboxConfig, device=None) -> Dict[str, torch.Tensor]:
    """Preallocated frame slots and full credits, on ``device`` (default
    ``cuda``; ``"cpu"`` to ask for the CPU)."""
    device = resolve_device(device)
    return {
        "frames": torch.zeros((cfg.banks, cfg.frames_per_bank, cfg.words),
                              dtype=torch.int32, device=device),
        "credits": torch.full((cfg.banks,), cfg.frames_per_bank, dtype=torch.int32,
                              device=device),
        "head": torch.zeros((cfg.banks,), dtype=torch.int32, device=device),  # next free slot
    }


def post_local(mb: Dict[str, torch.Tensor], bank: Union[int, torch.Tensor],
               frame: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Loopback put of one frame into ``bank`` at its head slot, in place;
    returns ``mb``. A bank with no credit **drops** the frame: no slot is
    written (the last one keeps its frame) and credits stay at zero. The
    credit check is made on the device, without a host sync."""
    bank = int(bank)
    has_credit = mb["credits"][bank] > 0
    slots = mb["frames"][bank]                                  # (F, W) view
    slot = mb["head"][bank].clamp(max=slots.shape[0] - 1).long().view(1)
    slots.index_copy_(0, slot, torch.where(has_credit, frame.view(1, -1),
                                           slots.index_select(0, slot)))
    delta = has_credit.to(torch.int32)
    mb["credits"][bank] -= delta
    mb["head"][bank] += delta
    return mb


def ring_put(frame_blocks: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """One-sided put to the ring neighbour: ``(n, ..., W)`` frames, rank
    ``r``'s on row ``r``, -> the frames that landed on each rank (rank
    ``r`` sends to ``(r + shift) % n``)."""
    return torch.roll(frame_blocks, shift, 0)


def alltoall_put(frame_blocks: torch.Tensor) -> torch.Tensor:
    """Every rank streams to every other: ``(n, n, N, W)``, where
    ``frame_blocks[r][j]`` is what rank ``r`` addresses to rank ``j``, ->
    arrivals ``(n, n, N, W)`` with ``arrivals[r][j] = frame_blocks[j][r]``."""
    return frame_blocks.transpose(0, 1).contiguous()


def drain_frames(frames: torch.Tensor, dispatch: Callable[[torch.Tensor], torch.Tensor],
                 result_words: int) -> torch.Tensor:
    """Execute every frame slot (invalid slots give zeros): ``(..., N, W)``
    -> ``(..., N, result_words)``."""
    return dispatch(frames).reshape(frames.shape[:-1] + (result_words,))


def drain_mailbox(mb: Dict[str, torch.Tensor],
                  dispatch: Callable[[torch.Tensor], torch.Tensor],
                  cfg: MailboxConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Drain all banks: execute every slot, and return the results with a
    cleared mailbox (fresh tensors, credits restored; ``mb`` itself is left
    as it was, so its frames can still be read)."""
    results = dispatch(mb["frames"])
    cleared = {
        "frames": torch.zeros_like(mb["frames"]),
        "credits": torch.full_like(mb["credits"], cfg.frames_per_bank),
        "head": torch.zeros_like(mb["head"]),
    }
    return results, cleared


def spin_wait_poll(frames: torch.Tensor, spec: FrameSpec,
                   max_spins: int = 1 << 20) -> Tuple[torch.Tensor, torch.Tensor]:
    """Software spin-poll on the SIG word of slot 0 (the 'Polling'
    baseline) -> (spins int32, found bool), as 0-d tensors on the frames'
    device. Nothing can write the frames while this runs, so the loop
    either finds the signal on its first spin or never: its result is
    ``(1, True)`` or ``(max_spins, False)`` (``(0, False)`` when
    ``max_spins`` < 1), which is computed directly instead of spinning."""
    if max_spins < 1:
        return (torch.zeros((), dtype=torch.int32, device=frames.device),
                torch.zeros((), dtype=torch.bool, device=frames.device))
    found = frames[0, spec.offsets()["sig"]] == SIG_MAGIC
    return torch.where(found, 1, max_spins).to(torch.int32), found


def wfe_wait(frames: torch.Tensor, spec: FrameSpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hardware-wait analogue: zero spin iterations, one check (delivery
    has already happened)."""
    found = frames[0, spec.offsets()["sig"]] == SIG_MAGIC
    return torch.zeros((), dtype=torch.int32, device=frames.device), found
