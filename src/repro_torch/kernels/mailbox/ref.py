"""Plain PyTorch versions of the mailbox kernels.

The port of ``repro/kernels/mailbox/ref.py``'s ``ring_put_ref``,
``server_sum_ref`` and ``indirect_put_ref`` (paper Fig. 1, §VI-B1 and
§VI-B2, Fig. 4), and ``mailbox_put_ref``, what the ring put kernel
(``mailbox_put_pallas``) returns. Frames are ``(N, W)`` int32 in the
layout of ``core.message.FrameSpec`` (a ring's ``(n, N, W)``, one block
per rank); the USR words start at ``usr_off``. The CPU path uses these,
and ``chip_smoke.py`` holds the CUDA kernels against them on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.core.message import SIG_MAGIC, wrap_int32

MAX_SPINS = 1 << 20          # the poll's cap (``mailbox_put_pallas``)


def ring_put_ref(frame_blocks: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """``(n, N, W)`` frames, one block per rank -> what lands on each rank:
    rank ``r`` sends to ``(r + shift) % n``."""
    return torch.roll(frame_blocks, shift, 0)


def check_ring_options(shift: int, wait: str, stash: bool, handler: Optional[str]) -> None:
    """Raise ``ValueError`` on options the ring put does not take. A fused
    sum needs the stashed mailbox: the JAX kernel cannot read an HBM
    mailbox from inside the kernel either."""
    if wait not in ("wfe", "poll") or handler not in (None, "sum"):
        raise ValueError(f"wait must be 'wfe' or 'poll' and handler None or 'sum', got "
                         f"{wait!r}, {handler!r}")
    if handler == "sum" and not stash:
        raise ValueError("handler='sum' needs stash=True: the non-stash mailbox is drained "
                         "by am_server_sum afterwards")
    if shift < 0:
        raise ValueError(f"shift must be >= 0, got {shift}")


def mailbox_put_ref(frame_blocks: torch.Tensor, *, shift: int = 1, wait: str = "wfe",
                    stash: bool = True, handler: Optional[str] = None, sig_off: int,
                    usr_off: int, payload_words: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The ring put with its wait and its fused handler: ``(n, N, W)`` int32
    -> ``(arrivals (n, N, W), spins (n, 1, 1), sums (n, N, 1) | None)``.

    ``spins`` is 0 for ``wait="wfe"`` and for ``stash=False``. A poll on a
    stashed mailbox reads the SIG word of the last frame that arrived: the
    put has landed before it looks, so it counts 1 spin where that word is
    ``SIG_MAGIC`` and ``MAX_SPINS`` where it is not. ``handler="sum"``
    gives each arrived frame's Server-Side Sum."""
    check_ring_options(shift, wait, stash, handler)
    arrivals = ring_put_ref(frame_blocks, shift)
    n = frame_blocks.shape[0]
    if wait == "wfe" or not stash:
        spins = torch.zeros((n,), dtype=torch.int32, device=frame_blocks.device)
    else:
        found = arrivals[:, -1, sig_off] == SIG_MAGIC
        spins = torch.where(found, 1, MAX_SPINS).to(torch.int32)
    sums = None
    if handler == "sum":
        sums = server_sum_ref(arrivals.reshape(-1, arrivals.shape[-1]), usr_off,
                              payload_words).view(n, -1, 1)
    return arrivals, spins.view(n, 1, 1), sums


def server_sum_ref(frames: torch.Tensor, usr_off: int, payload_words: int) -> torch.Tensor:
    """Server-Side Sum: ``(N, W)`` frames -> ``(N,)`` int32, the wrap-around
    sum of each frame's USR words (an int64 sum, low 32 bits)."""
    usr = frames[:, usr_off:usr_off + payload_words]
    return wrap_int32(usr.to(torch.int64).sum(1))


def put_slots(keys: torch.Tensor, slots: int,
              got_base: Union[int, torch.Tensor]) -> torch.Tensor:
    """Each key's table row, ``floormod(floormod(key, slots) + got_base,
    slots)``, in int64 (the sum may leave int32's range)."""
    base = got_base.to(torch.int64) if isinstance(got_base, torch.Tensor) else got_base
    return (keys.to(torch.int64) % slots + base) % slots


def indirect_put_ref(frames: torch.Tensor, table: torch.Tensor, heap: torch.Tensor,
                     usr_off: int, payload_words: int,
                     got_base: Union[int, torch.Tensor] = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indirect Put: apply every frame's put, as if in order, to the server
    state **in place**; returns ``(table, heap)``.

    USR = [key, data...]; frame i writes ``table[idx] = [key, idx]`` and
    ``heap[idx] = data`` at ``idx = put_slots(key)``; on a collision the
    later frame's row stands (last writer wins). table ``(slots, 2)``, heap
    ``(slots, PW - 1)`` int32; ``got_base`` an int or a 0-d tensor (the
    GOT-resolved heap base).

    Instead of N sequential updates, the last writer of each row is found
    at once (``scatter_reduce_`` of the frame index with ``amax``), and the
    winners' rows are copied in (``index_copy_`` of unique rows)."""
    slots = table.shape[0]
    n = frames.shape[0]
    keys = frames[:, usr_off]
    idx = put_slots(keys, slots, got_base)
    order = torch.arange(n, device=frames.device)
    last = torch.full((slots,), -1, dtype=torch.int64, device=frames.device)
    last.scatter_reduce_(0, idx, order, "amax", include_self=False)
    win = last[idx] == order
    rows = idx[win]
    table.index_copy_(0, rows, torch.stack([keys[win], rows.to(torch.int32)], 1))
    heap.index_copy_(0, rows, frames[win, usr_off + 1:usr_off + payload_words])
    return table, heap
