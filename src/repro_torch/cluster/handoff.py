"""Migration handoff wire format: tickets over mailbox frames.

The port of ``repro/cluster/handoff.py``. A live migration is a function
injection whose function state is the request's sequence state: the
source engine serializes it into a ``MigrationTicket`` and the router
ships it to the target as a train of active-message frames in the
paper's mailbox format (``core.message``). ``encode_handoff`` packs one
ticket into ``HANDOFF_SPEC`` frames; ``decode_handoff`` validates every
frame's SIG (magic + checksum) and the train's metadata (func_id, dense
elem_ids, one train length, the spec's widths, zero GOT and padding words)
before reassembling, so a truncated, reordered or corrupted handoff is an
error, never a wrong restore.

Layout: the ticket's JSON metadata and its raw state buffer behind an
8-byte length prefix, cut into ``payload_words`` chunks, one in the USR
section of each frame; ``elem_id`` is the chunk index, ``seq_no`` the
train length, ``FLAG_INJECTED`` marks tickets that carry state bytes.

Unlike the JAX package, which packs and checks a train frame by frame,
the port packs and validates the train as one ``(N, W)`` int32 array (a
llama3.2-1b ticket of 3,800 tokens is ~30,900 frames); the frames' words
are the same, and a rejected train names the same frame and fault.
"""
from __future__ import annotations

import json
import struct
from typing import Sequence, Union

import numpy as np
import torch

from repro_torch.core.message import (FLAG_INJECTED, HDR_ELEM_ID, HDR_FLAGS, HDR_FUNC_ID,
                                      HDR_PAYLOAD_WORDS, HDR_SEQ_NO, HDR_SRC_RANK,
                                      HDR_STATE_WORDS, FrameSpec, frame_valid, pack_frames,
                                      raise_first_bad_frame)
from repro_torch.engine.engine import MigrationTicket

__all__ = ["MIGRATE_FUNC_ID", "HANDOFF_SPEC", "encode_handoff", "decode_handoff"]

# func_id of the migration handler in the cluster's frame lane: far above
# the dense per-lane jam ids, so a handoff frame is never taken for a
# registered jam by a shared dispatcher
MIGRATE_FUNC_ID = 0x7C

# 1008 payload words + header/GOT/SIG = 1024 words: 4 KiB frames
HANDOFF_SPEC = FrameSpec(got_slots=4, state_words=0, payload_words=1008)

_PREFIX = struct.Struct("<II")          # (meta_bytes, state_bytes)

Train = Union[np.ndarray, Sequence[np.ndarray]]


def encode_handoff(ticket: MigrationTicket) -> np.ndarray:
    """Pack a ticket into its train of mailbox frames, ``(N, W)`` int32 in
    train order (row ``i`` is frame ``i``)."""
    meta = json.dumps({
        "rid": ticket.rid, "cache_kind": ticket.cache_kind,
        "priority": ticket.priority, "max_new_tokens": ticket.max_new_tokens,
        "prompt": [int(t) for t in ticket.prompt],
        "out_tokens": [int(t) for t in ticket.out_tokens],
        "pos": ticket.pos,
    }).encode("utf-8")
    state = ticket.state or b""
    blob = _PREFIX.pack(len(meta), len(state)) + meta + state
    blob += b"\x00" * (-len(blob) % 4)
    pw = HANDOFF_SPEC.payload_words
    n_frames = max(1, -(-(len(blob) // 4) // pw))
    payload = np.zeros(n_frames * pw, dtype="<i4")
    payload[:len(blob) // 4] = np.frombuffer(blob, dtype="<i4")
    # state is normalized to b"" above, so FLAG_INJECTED means "carries
    # bytes": an empty state buffer rides (and restores) as None
    frames = pack_frames(HANDOFF_SPEC, func_id=MIGRATE_FUNC_ID,
                         elem_id=torch.arange(n_frames, dtype=torch.int32),
                         seq_no=n_frames, flags=FLAG_INJECTED if state else 0,
                         payload_words=torch.from_numpy(payload.reshape(n_frames, pw)))
    return frames.numpy()


def _as_train(frames: Train) -> np.ndarray:
    if isinstance(frames, np.ndarray) and frames.ndim == 2:
        train = frames
    else:
        for i, f in enumerate(frames):
            if np.shape(f) != (HANDOFF_SPEC.total_words,):
                raise ValueError(f"handoff frame {i}: shape {np.shape(f)}, expected "
                                 f"({HANDOFF_SPEC.total_words},)")
        train = np.asarray(frames, dtype=np.int32)
    if not len(train):
        raise ValueError("empty handoff: no frames to decode")
    if train.shape[1:] != (HANDOFF_SPEC.total_words,):
        raise ValueError(f"handoff frame 0: shape {train.shape[1:]}, expected "
                         f"({HANDOFF_SPEC.total_words},)")
    return np.ascontiguousarray(train, dtype=np.int32)


def _check_train(train: np.ndarray) -> None:
    """Every frame check of the JAX ``decode_handoff``, over the whole
    train at once; the first failing frame's first failing check raises,
    with the JAX package's message."""
    n = len(train)
    offs = HANDOFF_SPEC.offsets()
    flags = train[:, HDR_FLAGS]
    checks = (
        (~frame_valid(HANDOFF_SPEC, torch.from_numpy(train)).numpy(),
         lambda i: "bad magic or SIG checksum (corrupt or torn frame — refusing to "
                   "restore from it)"),
        (train[:, HDR_FUNC_ID] != MIGRATE_FUNC_ID,
         lambda i: f"func_id={int(train[i, HDR_FUNC_ID])} is not the migration handler "
                   f"({MIGRATE_FUNC_ID})"),
        (train[:, HDR_ELEM_ID] != np.arange(n),
         lambda i: f"elem_id={int(train[i, HDR_ELEM_ID])} — the train is reordered or "
                   f"missing a frame"),
        (train[:, HDR_SEQ_NO] != n,
         lambda i: f"train length {int(train[i, HDR_SEQ_NO])} != {n} frames received "
                   f"(truncated handoff)"),
        # the SIG checksum covers the USR words alone, so every other word
        # is checked too: any single-bit flip is a detected fault
        (train[:, HDR_PAYLOAD_WORDS] != HANDOFF_SPEC.payload_words,
         lambda i: f"payload_words={int(train[i, HDR_PAYLOAD_WORDS])} != spec "
                   f"{HANDOFF_SPEC.payload_words}"),
        (train[:, HDR_STATE_WORDS] != HANDOFF_SPEC.state_words,
         lambda i: f"state_words={int(train[i, HDR_STATE_WORDS])} != spec "
                   f"{HANDOFF_SPEC.state_words}"),
        (train[:, HDR_SRC_RANK] != 0,
         lambda i: f"src_rank={int(train[i, HDR_SRC_RANK])} (handoff trains ride the "
                   f"in-process lane: rank 0)"),
        ((flags != 0) & (flags != FLAG_INJECTED),
         lambda i: f"unexpected flags {int(flags[i]):#x}"),
        (flags != flags[0],
         lambda i: f"flags {int(flags[i]):#x} differ from the rest of the train "
                   f"({int(flags[0]):#x})"),
        ((train[:, offs["got"]:offs["state"]] != 0).any(axis=1),
         lambda i: "non-zero GOT words (corrupt frame)"),
        ((train[:, offs["sig"] + 2:] != 0).any(axis=1),
         lambda i: "non-zero alignment padding (corrupt frame)"),
    )
    raise_first_bad_frame("handoff", checks)


def decode_handoff(frames: Train) -> MigrationTicket:
    """Validate and reassemble a frame train (``(N, W)``, or a sequence of
    ``(W,)`` frames) back into a ticket."""
    train = _as_train(frames)
    _check_train(train)
    o_usr, pw = HANDOFF_SPEC.offsets()["usr"], HANDOFF_SPEC.payload_words
    blob = np.ascontiguousarray(train[:, o_usr:o_usr + pw]).astype("<i4").tobytes()
    meta_len, state_len = _PREFIX.unpack_from(blob)
    if _PREFIX.size + meta_len + state_len > len(blob):
        raise ValueError(f"handoff declares {meta_len}+{state_len} payload bytes but the "
                         f"train carries only {len(blob) - _PREFIX.size}")
    meta = json.loads(blob[_PREFIX.size:_PREFIX.size + meta_len])
    off = _PREFIX.size + meta_len
    state = blob[off:off + state_len] if state_len else None
    if bool(train[0, HDR_FLAGS] & FLAG_INJECTED) != (state is not None):
        raise ValueError("handoff FLAG_INJECTED disagrees with the declared state length")
    return MigrationTicket(
        rid=meta["rid"], cache_kind=meta["cache_kind"], priority=meta["priority"],
        max_new_tokens=meta["max_new_tokens"], prompt=list(meta["prompt"]),
        out_tokens=list(meta["out_tokens"]), pos=meta["pos"], state=state)
