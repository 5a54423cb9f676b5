"""Active-message frames (paper Fig. 1): the cross-framework ABI.

The port of ``repro/core/message.py``. A frame is a flat int32 vector::

    HDR (8 words) | GOTP (G words) | STATE (state_words) | USR (payload_words)
    | SIG (2 words)  — padded to a multiple of 16 words (64 B frames).

HDR  = [MAGIC, func_id, elem_id, payload_words, state_words, src_rank,
        seq_no, flags]
GOTP = int32 symbol indices into the receiver's ``GotTable``.
STATE= bitcast function state (empty for Local Function frames).
USR  = bitcast user payload.
SIG  = [SIG_MAGIC, checksum(USR)], the arrival signal the mailbox waits on.

The same inputs give the same int32 words, bit for bit, as the JAX
package, so frames cross between the two as plain int32 arrays. Unlike
the JAX ``pack_frame``, ``pack_frames`` takes leading batch dimensions
(``(..., PW)`` payloads -> ``(..., W)`` frames); one frame is the case
with no batch dimension. ``unpack_frame`` and ``frame_valid`` take either.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device

MAGIC = 0x7C4A_11                   # "Two-Chains" header magic
SIG_MAGIC = 0x516A_22               # signal magic ("SIG MAG" of Fig. 1)
HEADER_WORDS = 8
SIG_WORDS = 2
ALIGN_WORDS = 16                    # 64 B frames, as in the paper

# Named HDR word offsets: every consumer that indexes into the header uses
# these instead of bare integers.
HDR_MAGIC = 0
HDR_FUNC_ID = 1
HDR_ELEM_ID = 2
HDR_PAYLOAD_WORDS = 3
HDR_STATE_WORDS = 4
HDR_SRC_RANK = 5
HDR_SEQ_NO = 6
HDR_FLAGS = 7

FLAG_INJECTED = 1                   # STATE section carries function state
FLAG_READONLY_USR = 2               # security reconfig: payload read-only
FLAG_RECV_GOT = 4                   # security reconfig: receiver sets GOT

Field = Union[int, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FrameSpec:
    """Static frame geometry (agreed at package build time)."""

    got_slots: int = 4
    state_words: int = 0             # 0 => Local Function frames
    payload_words: int = 16

    @property
    def body_words(self) -> int:
        return (HEADER_WORDS + self.got_slots + self.state_words
                + self.payload_words + SIG_WORDS)

    @property
    def total_words(self) -> int:
        return -(-self.body_words // ALIGN_WORDS) * ALIGN_WORDS

    @property
    def total_bytes(self) -> int:
        return 4 * self.total_words

    def offsets(self) -> Dict[str, int]:
        o_got = HEADER_WORDS
        o_state = o_got + self.got_slots
        o_usr = o_state + self.state_words
        o_sig = o_usr + self.payload_words
        return {"got": o_got, "state": o_state, "usr": o_usr, "sig": o_sig}


# ---------------------------------------------------------------------------
# int32 words
# ---------------------------------------------------------------------------

def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of an int64 tensor as int32 (two's complement)."""
    return (((x + 2 ** 31) & 0xFFFF_FFFF) - 2 ** 31).to(torch.int32)


def checksum(words: torch.Tensor) -> torch.Tensor:
    """Wrap-around int32 sum over the last axis: the SIG integrity word.
    Summed in int64, then the low 32 bits, which is what JAX's int32 sum
    gives (it wraps mod 2**32)."""
    return wrap_int32(words.to(torch.int64).sum(-1))


def f32_to_words(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).reshape(-1).view(torch.int32)


def words_to_f32(w: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    return w.contiguous().view(torch.float32).reshape(shape)


def bf16_to_words(x: torch.Tensor) -> torch.Tensor:
    """Two bf16 per int32 word, the first of each pair in the low half; an
    odd count is padded with a zero bf16. (A little-endian view of the
    bf16 pairs as int32 is exactly ``lo | hi << 16``.)"""
    flat = x.to(torch.bfloat16).reshape(-1)
    if flat.numel() % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    return flat.contiguous().view(torch.int32)


def words_to_bf16(w: torch.Tensor, size: int, shape: Tuple[int, ...]) -> torch.Tensor:
    return w.contiguous().view(torch.bfloat16)[:size].reshape(shape)


# ---------------------------------------------------------------------------
# pack / unpack
# ---------------------------------------------------------------------------

def pack_frames(spec: FrameSpec, *, func_id: Field, elem_id: Field = 0,
                src_rank: Field = 0, seq_no: Field = 0, flags: Field = 0,
                got: Optional[torch.Tensor] = None,
                state_words: Optional[torch.Tensor] = None,
                payload_words: Optional[torch.Tensor] = None,
                device=None) -> torch.Tensor:
    """Build frames ``(..., spec.total_words)`` int32.

    ``got`` ``(..., G)``, ``state_words`` ``(..., SW)`` and
    ``payload_words`` ``(..., PW)`` are int32 word tensors (``None``:
    zeros); header fields are ints or tensors of the batch shape. The batch
    shape is what they broadcast to; ``()`` gives one frame ``(W,)``. The
    frames land on the device of the first tensor given, else on
    ``device`` (default ``cuda``; ``"cpu"`` to ask for the CPU).
    """
    o = spec.offsets()
    sections = ((got, spec.got_slots, "got", "got"),
                (state_words, spec.state_words, "state_words", "state"),
                (payload_words, spec.payload_words, "payload_words", "usr"))
    fields = (func_id, elem_id, src_rank, seq_no, flags)
    shapes, dev = [], None
    for t, width, name, _ in sections:
        if t is None:
            continue
        if t.shape[-1:] != (width,):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want (..., {width}) "
                             f"for {spec}")
        shapes.append(t.shape[:-1])
        dev = dev or t.device
    for f in fields:
        if isinstance(f, torch.Tensor):
            shapes.append(f.shape)
            dev = dev or f.device
    # numpy's broadcast rule (torch.broadcast_shapes imports its symbolic
    # shape machinery at first use, a second of host time)
    batch = torch.Size(np.broadcast_shapes(*shapes))
    frames = torch.zeros(batch + (spec.total_words,), dtype=torch.int32,
                         device=dev or resolve_device(device))
    header = (MAGIC, func_id, elem_id, spec.payload_words, spec.state_words,
              src_rank, seq_no, flags)
    for i, value in enumerate(header):
        frames[..., i] = value
    for t, width, _, at in sections:
        if t is not None and width:
            frames[..., o[at]:o[at] + width] = t
    frames[..., o["sig"]] = SIG_MAGIC
    if payload_words is not None:
        frames[..., o["sig"] + 1] = checksum(payload_words)
    return frames


def unpack_frame(spec: FrameSpec, frame: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Views of each field of ``(..., W)`` frames."""
    o = spec.offsets()
    return {
        "magic": frame[..., HDR_MAGIC],
        "func_id": frame[..., HDR_FUNC_ID],
        "elem_id": frame[..., HDR_ELEM_ID],
        "payload_words": frame[..., HDR_PAYLOAD_WORDS],
        "state_words": frame[..., HDR_STATE_WORDS],
        "src_rank": frame[..., HDR_SRC_RANK],
        "seq_no": frame[..., HDR_SEQ_NO],
        "flags": frame[..., HDR_FLAGS],
        "got": frame[..., o["got"]:o["got"] + spec.got_slots],
        "state": frame[..., o["state"]:o["state"] + spec.state_words],
        "usr": frame[..., o["usr"]:o["usr"] + spec.payload_words],
        "sig_magic": frame[..., o["sig"]],
        "sig_checksum": frame[..., o["sig"] + 1],
    }


def raise_first_bad_frame(what: str, checks) -> None:
    """Validate a train frame by frame in one pass over the whole train.
    ``checks`` is a sequence of ``(failed, describe)`` in the order a
    frame-by-frame loop would run them: ``failed`` a bool mask over the
    frames, ``describe(i)`` the message for frame ``i``. The first frame
    that fails any check raises ``ValueError(f"{what} frame {i}: ...")``
    with its first failing check's message, as that loop would."""
    bad = None
    for failed, _ in checks:
        bad = failed.copy() if bad is None else bad | failed
    if bad is not None and bad.any():
        i = int(np.argmax(bad))
        msg = next(describe(i) for failed, describe in checks if failed[i])
        raise ValueError(f"{what} frame {i}: {msg}")


def frame_valid(spec: FrameSpec, frame: torch.Tensor) -> torch.Tensor:
    """Signal + integrity check of ``(..., W)`` frames -> bool ``(...)``."""
    f = unpack_frame(spec, frame)
    return ((f["magic"] == MAGIC)
            & (f["sig_magic"] == SIG_MAGIC)
            & (f["sig_checksum"] == checksum(f["usr"])))
