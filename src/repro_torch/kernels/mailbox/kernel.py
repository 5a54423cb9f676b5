"""Load and launch the CUDA mailbox kernels.

``csrc/mailbox.cu`` (the Server-Side Sum and Indirect Put handlers) and
``csrc/ring_put.cu`` (the one-sided ring put, ranks as the CTAs of a
cluster) have plain C interfaces; ``kernels.loader`` builds each with
``nvcc`` at first use and loads it with ``ctypes``. Nothing is built or
loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import loader
from repro_torch.kernels.mailbox.ref import check_ring_options

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "mailbox.cu"
RING_SOURCE = CSRC / "ring_put.cu"
SUM_LAUNCHES = loader.LaunchCounter()
PUT_LAUNCHES = loader.LaunchCounter()
RING_LAUNCHES = loader.LaunchCounter()
PUT_DESIGN = "v3: claim table in L2, first write at the claim, contested rows fixed"
SUM_DESIGN = ("v3: a CTA a frame with 16-byte loads for few or wide frames, v2's lane groups "
              "for many")
SUM_ROUTES = ("scalar", "wide")  # the C interface's route codes, in order
WIDE_CTAS_PER_SM = 4            # the wide route's CTAs an SM (mailbox.cu, kWideCtasPerSm)
WIDE_WORDS = 128                # USR words past which a frame takes the wide route
MAX_RANKS = 8                   # the portable cluster size: ranks on one card
CHUNK_BYTES = 48 * 1024         # a ring mailbox buffer (two per rank, two staging)
_ARGTYPES = {
    # frames, sums; n; w, usr_off, pw, route
    "mailbox_server_sum": [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_int] * 4,
    # frames, got, claims, table, heap; n; w, usr_off, pw; slots, claim entries
    "mailbox_indirect_put": ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                             + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 2),
    # frames, arrivals, spins, sums; n; N; w, shift, stash, poll, sig_off, usr_off,
    # pw, chunk
    "mailbox_ring_put": ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong]
                         + [ctypes.c_int] * 8),
}
_fns = {}


def _load(name: str):
    if name not in _fns:
        fn = getattr(loader.load(RING_SOURCE if name == "mailbox_ring_put" else SOURCE), name)
        fn.argtypes = _ARGTYPES[name] + [ctypes.c_void_p]          # ... stream
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


def sum_route(frames: torch.Tensor, usr_off: int, payload_words: int,
              sms: Optional[int] = None) -> str:
    """The route the Server-Side Sum kernel takes for these frames:
    ``wide`` (a CTA a frame) where the USR words sit on 16-byte boundaries
    (frames on a 16-byte boundary; the row pitch, ``usr_off`` and
    ``payload_words`` multiples of 4 words, at least 4) and the call has at
    most ``WIDE_CTAS_PER_SM`` frames an SM or more than ``WIDE_WORDS`` USR
    words a frame, else ``scalar``. ``sms``: the card's SM count (None:
    read from ``frames``' device)."""
    n, w = frames.shape
    aligned = (frames.data_ptr() % 16 == 0 and w % 4 == 0 and usr_off % 4 == 0
               and payload_words % 4 == 0 and payload_words >= 4)
    if not aligned:
        return "scalar"
    if sms is None:
        sms = torch.cuda.get_device_properties(frames.device).multi_processor_count
    return "wide" if payload_words > WIDE_WORDS or n <= WIDE_CTAS_PER_SM * sms else "scalar"


def server_sum_cuda(frames: torch.Tensor, usr_off: int, payload_words: int) -> torch.Tensor:
    """Server-Side Sum on the card: ``(N, W)`` int32 frames -> ``(N,)``
    int32, by the route ``sum_route`` names. Raises on inputs the kernel
    does not take and on a refused launch."""
    _check(frames, usr_off, payload_words)
    n, w = frames.shape
    sums = torch.empty((n,), dtype=torch.int32, device=frames.device)
    if n:
        route = sum_route(frames, usr_off, payload_words)
        _launch("mailbox_server_sum", frames, sums, n, w, usr_off, payload_words,
                SUM_ROUTES.index(route))
        SUM_LAUNCHES.count += 1
    return sums


def indirect_put_cuda(frames: torch.Tensor, table: torch.Tensor, heap: torch.Tensor,
                      got: torch.Tensor, usr_off: int, payload_words: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indirect Put on the card, in place: ``(N, W)`` int32 frames into
    ``table`` ``(slots, 2)`` and ``heap`` ``(slots, PW - 1)`` int32 at rows
    hashed through ``got[0]`` (``got`` ``(G,)`` int32 on the card); returns
    ``(table, heap)``. Takes a claim table of ``claim_entries(n, slots)``
    8-byte entries and a flag byte each for the call (18 MiB at 2^20
    frames, whatever the table's size). Raises on inputs the kernel does
    not take and on a refused launch."""
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
    if table.data_ptr() % 8:
        raise ValueError("table must be 8-byte aligned: a row is one 8-byte store")
    if n:
        entries = claim_entries(n, slots)
        # the claim table, then a contest flag byte an entry
        claims = torch.empty((entries + entries // 8,), dtype=torch.int64, device=frames.device)
        _launch("mailbox_indirect_put", frames, got, claims, table, heap, n, w, usr_off,
                payload_words, slots, entries)
        PUT_LAUNCHES.count += 1
    return table, heap


def claim_entries(n: int, slots: int) -> int:
    """Entries of the Indirect Put's claim table: the power of two at least
    twice the rows ``n`` frames can touch (so probing stays short), and at
    least 32 (one warp's read)."""
    return max(32, 1 << (2 * min(n, slots) - 1).bit_length())


def ring_chunk_frames(words: int) -> int:
    """Frames of ``words`` int32 words in one ring mailbox buffer."""
    if words < 1 or 4 * words > CHUNK_BYTES:
        raise ValueError(f"a ring put takes frames of 1 to {CHUNK_BYTES // 4} words, got {words}")
    return CHUNK_BYTES // (4 * words)


def mailbox_put_cuda(frame_blocks: torch.Tensor, *, shift: int = 1, wait: str = "wfe",
                     stash: bool = True, handler: Optional[str] = None, sig_off: int,
                     usr_off: int, payload_words: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The one-sided ring put on the card: ``(n, N, W)`` int32 frames, one
    block per rank, the ranks the CTAs of one cluster -> ``(arrivals (n, N,
    W), spins (n, 1, 1), sums (n, N, 1) | None)``, as ``mailbox_put_ref``.
    As many clusters as fit on the card share the frames, each a slice of
    48 KiB chunks; only the one that holds frame N-1 polls. Raises on
    inputs the kernel does not take and on a refused launch."""
    n = frame_blocks.shape[0] if frame_blocks.dim() == 3 else 0
    if n > MAX_RANKS:
        raise ValueError(f"a ring on one card has at most {MAX_RANKS} ranks (the CTAs of a "
                         f"cluster), got {n}: puts between cards are ROADMAP A14")
    if not frame_blocks.is_cuda:
        raise ValueError(f"frame_blocks must be a CUDA tensor, got {frame_blocks.device}")
    if frame_blocks.dtype != torch.int32 or not frame_blocks.is_contiguous():
        raise ValueError(f"frame_blocks must be contiguous int32, got {frame_blocks.dtype}")
    if frame_blocks.dim() != 3 or n < 1 or frame_blocks.shape[1] < 1:
        raise ValueError(f"frame_blocks must be (n >= 1, N >= 1, W), got "
                         f"{tuple(frame_blocks.shape)}")
    _, frames, words = frame_blocks.shape
    if words % 4 or frame_blocks.data_ptr() % 16:
        raise ValueError(f"frames must be 16-byte rows on a 16-byte boundary, got W = {words}")
    check_ring_options(shift, wait, stash, handler)
    if not 0 <= sig_off < words or usr_off < 0 or payload_words < 0 \
            or usr_off + payload_words > words:
        raise ValueError(f"SIG word {sig_off} or USR words [{usr_off}, "
                         f"{usr_off + payload_words}) do not fit frames of {words} words")
    chunk = min(ring_chunk_frames(words), frames)
    dev = frame_blocks.device
    arrivals = torch.empty_like(frame_blocks)
    spins = torch.empty((n, 1, 1), dtype=torch.int32, device=dev)
    sums = (torch.empty((n, frames, 1), dtype=torch.int32, device=dev) if handler == "sum"
            else None)
    _launch("mailbox_ring_put", frame_blocks, arrivals, spins, sums, n, frames, words, shift,
            int(stash), int(wait == "poll"), sig_off, usr_off, payload_words, chunk)
    RING_LAUNCHES.count += 1
    return arrivals, spins, sums
