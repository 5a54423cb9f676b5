"""Load and launch the CUDA mailbox handler kernels.

``csrc/mailbox.cu`` has a plain C interface; ``kernels.loader`` builds it
with ``nvcc`` at first use and loads it with ``ctypes``. Nothing is built
or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import loader

SOURCE = Path(__file__).resolve().parent / "csrc" / "mailbox.cu"
SUM_LAUNCHES = loader.LaunchCounter()
PUT_LAUNCHES = loader.LaunchCounter()
_fns = {}


def _load(name: str):
    if name not in _fns:
        fn = getattr(loader.load(SOURCE), name)
        if name == "mailbox_server_sum":
            # frames, sums; n; w, usr_off, pw; stream
            fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                           + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        else:
            # frames, got, last, table, heap; n; w, usr_off, pw; slots; stream
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                           + [ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _check(frames: torch.Tensor, usr_off: int, payload_words: int, **others):
    for name, t in dict(frames=frames, **others).items():
        if not t.is_cuda or t.device != frames.device:
            raise ValueError(f"{name} must be a CUDA tensor on {frames.device}, got {t.device}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if frames.dim() != 2:
        raise ValueError(f"frames must be (N, W), got {tuple(frames.shape)}")
    if usr_off < 0 or payload_words < 0 or usr_off + payload_words > frames.shape[1]:
        raise ValueError(f"USR words [{usr_off}, {usr_off + payload_words}) do not fit "
                         f"frames of {frames.shape[1]} words")


def _launch(name: str, *args):
    frames = args[0]
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        rc = _load(name)(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
                         stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def server_sum_cuda(frames: torch.Tensor, usr_off: int, payload_words: int) -> torch.Tensor:
    """Server-Side Sum on the card: ``(N, W)`` int32 frames -> ``(N,)``
    int32. Raises on inputs the kernel does not take and on a refused
    launch."""
    _check(frames, usr_off, payload_words)
    n, w = frames.shape
    sums = torch.empty((n,), dtype=torch.int32, device=frames.device)
    if n:
        _launch("mailbox_server_sum", frames, sums, n, w, usr_off, payload_words)
        SUM_LAUNCHES.count += 1
    return sums


def indirect_put_cuda(frames: torch.Tensor, table: torch.Tensor, heap: torch.Tensor,
                      got: torch.Tensor, usr_off: int, payload_words: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indirect Put on the card, in place: ``(N, W)`` int32 frames into
    ``table`` ``(slots, 2)`` and ``heap`` ``(slots, PW - 1)`` int32 at rows
    hashed through ``got[0]`` (``got`` ``(G,)`` int32 on the card); returns
    ``(table, heap)``. Takes a scratch of 4 bytes per table row for the
    call. Raises on inputs the kernel does not take and on a refused
    launch."""
    _check(frames, usr_off, payload_words, table=table, heap=heap, got=got)
    n, w = frames.shape
    slots = table.shape[0]
    if payload_words < 1:
        raise ValueError("an Indirect Put frame needs at least the key word")
    if n >= 2 ** 31 or slots >= 2 ** 31:
        raise ValueError(f"at most 2**31 - 1 frames and table rows, got {n} and {slots}")
    if (table.dim() != 2 or table.shape[1] != 2 or slots < 1
            or heap.shape != (slots, payload_words - 1) or got.dim() != 1 or got.numel() < 1):
        raise ValueError(f"table {tuple(table.shape)}, heap {tuple(heap.shape)}, got "
                         f"{tuple(got.shape)} do not fit (slots, 2), (slots, "
                         f"{payload_words - 1}), (G >= 1,)")
    if n:
        last = torch.empty((slots,), dtype=torch.int32, device=frames.device)
        _launch("mailbox_indirect_put", frames, got, last, table, heap, n, w, usr_off,
                payload_words, slots)
        PUT_LAUNCHES.count += 1
    return table, heap
