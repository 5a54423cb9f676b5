"""Graph-edge wire format: intermediate tensors over mailbox frames.

The port of ``repro/fabric/graph/edges.py``. When the router places two
adjacent graph nodes on different replicas, the edge value crosses the
fabric exactly like a migration ticket does (``cluster.handoff``): packed
into a train of active-message frames in the paper's mailbox format and
validated word by word on arrival, so a dropped, reordered or corrupted
edge is a loud decode error the router's retry loop can catch, never a
silently wrong tensor feeding the downstream node. On arrival the value
is installed as a fabric lease (``graph/<gid>/<node>``).

Layout mirrors the handoff train: an 8-byte length prefix over JSON
metadata (edge name, dtype, shape) and the raw array bytes, cut into
``payload_words`` words per frame; ``elem_id`` is the chunk index,
``seq_no`` the train length, ``FLAG_INJECTED`` set always (an edge tensor
*is* injected state).

As the port's handoff trains do, the train is packed and validated as one
``(N, W)`` int32 array; its words are the JAX package's, and a bad train
is refused at the same frame with the same message. Edge values are host
arrays: a torch tensor is read through numpy, and ``decode_edge`` returns
a numpy array.
"""
from __future__ import annotations

import json
import struct
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.message import (FLAG_INJECTED, HDR_ELEM_ID, HDR_FLAGS, HDR_FUNC_ID,
                                      HDR_PAYLOAD_WORDS, HDR_SEQ_NO, HDR_SRC_RANK,
                                      HDR_STATE_WORDS, FrameSpec, frame_valid, pack_frames,
                                      raise_first_bad_frame)

__all__ = ["GRAPH_FUNC_ID", "EDGE_SPEC", "edge_nbytes", "encode_edge", "decode_edge"]

# func_id of the graph-edge handler in the cluster's frame lane: beside the
# migration handler (0x7C), far above the dense per-lane jam ids
GRAPH_FUNC_ID = 0x7D

# the 4 KiB geometry of HANDOFF_SPEC: edge values (k candidate tokens,
# small logit rows) almost always fit one frame
EDGE_SPEC = FrameSpec(got_slots=4, state_words=0, payload_words=1008)

_PREFIX = struct.Struct("<II")          # (meta_bytes, data_bytes)

Train = Union[np.ndarray, Sequence[np.ndarray]]


def _as_array(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    arr = np.asarray(value)
    if arr.dtype == object:
        raise TypeError(
            f"graph edges carry numeric tensors; got dtype=object "
            f"({type(value).__name__})")
    return np.ascontiguousarray(arr)


def edge_nbytes(value) -> int:
    """Wire bytes of an edge value: the affinity axis's unit."""
    return int(_as_array(value).nbytes)


def encode_edge(name: str, value) -> np.ndarray:
    """Pack one edge value into its train of mailbox frames, ``(N, W)``
    int32 in train order (row ``i`` is frame ``i``)."""
    arr = _as_array(value)
    meta = json.dumps({"name": name, "dtype": str(arr.dtype),
                       "shape": list(arr.shape)}).encode("utf-8")
    blob = _PREFIX.pack(len(meta), arr.nbytes) + meta + arr.tobytes()
    blob += b"\x00" * (-len(blob) % 4)
    pw = EDGE_SPEC.payload_words
    n_frames = max(1, -(-(len(blob) // 4) // pw))
    payload = np.zeros(n_frames * pw, dtype="<i4")
    payload[:len(blob) // 4] = np.frombuffer(blob, dtype="<i4")
    frames = pack_frames(EDGE_SPEC, func_id=GRAPH_FUNC_ID,
                         elem_id=torch.arange(n_frames, dtype=torch.int32),
                         seq_no=n_frames, flags=FLAG_INJECTED,
                         payload_words=torch.from_numpy(payload.reshape(n_frames, pw)))
    return frames.numpy()


def _shape_error(i: int, shape) -> ValueError:
    return ValueError(f"edge frame {i}: shape {shape}, expected "
                      f"({EDGE_SPEC.total_words},)")


def _check_train(train: np.ndarray, n: int) -> None:
    """Every frame check of the JAX ``decode_edge`` over ``train`` (the
    first frames of a train of ``n``) at once; the first failing frame's
    first failing check raises, with the JAX package's message."""
    if not len(train):
        return
    offs = EDGE_SPEC.offsets()
    pw = EDGE_SPEC.payload_words
    checks = (
        (~frame_valid(EDGE_SPEC, torch.from_numpy(train)).numpy(),
         lambda i: "bad magic or SIG checksum (corrupt or torn frame — refusing the edge "
                   "value)"),
        (train[:, HDR_FUNC_ID] != GRAPH_FUNC_ID,
         lambda i: f"func_id={int(train[i, HDR_FUNC_ID])} is not the graph-edge handler "
                   f"({GRAPH_FUNC_ID})"),
        (train[:, HDR_ELEM_ID] != np.arange(len(train)),
         lambda i: f"elem_id={int(train[i, HDR_ELEM_ID])} — the train is reordered or "
                   f"missing a frame"),
        (train[:, HDR_SEQ_NO] != n,
         lambda i: f"train length {int(train[i, HDR_SEQ_NO])} != {n} frames received "
                   f"(truncated edge)"),
        (train[:, HDR_PAYLOAD_WORDS] != pw,
         lambda i: f"payload_words={int(train[i, HDR_PAYLOAD_WORDS])} != spec {pw}"),
        (train[:, HDR_STATE_WORDS] != EDGE_SPEC.state_words,
         lambda i: f"state_words={int(train[i, HDR_STATE_WORDS])} != spec "
                   f"{EDGE_SPEC.state_words}"),
        (train[:, HDR_SRC_RANK] != 0,
         lambda i: f"src_rank={int(train[i, HDR_SRC_RANK])} (edge trains ride the "
                   f"in-process lane: rank 0)"),
        (train[:, HDR_FLAGS] != FLAG_INJECTED,
         lambda i: f"flags {int(train[i, HDR_FLAGS]):#x} (edge tensors always ride "
                   f"FLAG_INJECTED)"),
        ((train[:, offs["got"]:offs["state"]] != 0).any(axis=1),
         lambda i: "non-zero GOT words (corrupt frame)"),
        ((train[:, offs["sig"] + 2:] != 0).any(axis=1),
         lambda i: "non-zero alignment padding (corrupt frame)"),
    )
    raise_first_bad_frame("edge", checks)


def decode_edge(frames: Train) -> Tuple[str, np.ndarray]:
    """Validate and reassemble a frame train (``(N, W)``, or a sequence of
    ``(W,)`` frames) back into ``(name, value)``."""
    if len(frames) == 0:
        raise ValueError("empty edge train: no frames to decode")
    n = len(frames)
    if isinstance(frames, np.ndarray) and frames.ndim == 2:
        if frames.shape[1] != EDGE_SPEC.total_words:
            raise _shape_error(0, frames.shape[1:])
        train, bad_shape = frames, None
    else:
        # a frame of the wrong shape is refused where the JAX loop meets it:
        # after every earlier frame passed its checks
        bad_shape = next((i for i, f in enumerate(frames)
                          if np.shape(f) != (EDGE_SPEC.total_words,)), None)
        good = frames[:bad_shape] if bad_shape is not None else frames
        train = np.asarray([np.asarray(f) for f in good], dtype=np.int32).reshape(
            len(good), EDGE_SPEC.total_words)
    train = np.ascontiguousarray(train, dtype=np.int32)
    _check_train(train, n)
    if bad_shape is not None:
        raise _shape_error(bad_shape, np.shape(frames[bad_shape]))
    o_usr, pw = EDGE_SPEC.offsets()["usr"], EDGE_SPEC.payload_words
    blob = np.ascontiguousarray(train[:, o_usr:o_usr + pw]).astype("<i4").tobytes()
    meta_len, data_len = _PREFIX.unpack_from(blob)
    if _PREFIX.size + meta_len + data_len > len(blob):
        raise ValueError(
            f"edge declares {meta_len}+{data_len} payload bytes but the "
            f"train carries only {len(blob) - _PREFIX.size}")
    meta = json.loads(blob[_PREFIX.size:_PREFIX.size + meta_len])
    off = _PREFIX.size + meta_len
    value = np.frombuffer(blob[off:off + data_len],
                          dtype=meta["dtype"]).reshape(meta["shape"])
    return meta["name"], value
