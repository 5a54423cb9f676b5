"""Plain PyTorch versions of the mailbox handler kernels.

The port of ``repro/kernels/mailbox/ref.py``'s ``server_sum_ref`` and
``indirect_put_ref`` (paper §VI-B1 and §VI-B2, Fig. 4). Frames are
``(N, W)`` int32 in the layout of ``core.message.FrameSpec``; the USR
words start at ``usr_off``. The CPU path uses these, and ``chip_smoke.py``
holds the CUDA kernels against them on the card.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from repro_torch.core.message import wrap_int32


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
