"""KV caches and the recurrent layout for serving, and the sequence-state
protocol pieces.

``KVCache`` is the slots backend's contiguous cache: ``(B, S_max, K, D)``
k/v per layer and one ``length`` shared by every row, the JAX package's
``KVCache`` without its ``ring`` option (no path of the JAX package
passes ``ring=True``). ``MLACache`` is its MLA counterpart: the compressed
latent ``c_kv`` (B, S_max, r) and the rope key ``k_rope`` (B, S_max, dr)
shared by every head.

``PagedKVCache`` is one shared block pool ``(N_blocks, block_size, K, D)``
per layer; requests own blocks through a per-request block table, so
memory is allocated at sequence-length granularity instead of
``slots * max_len``. Logical position ``p`` of request ``b`` lives at
``(block_tables[b, p // block_size], p % block_size)``.

``RecurrentLayout`` is the per-step view of the recurrent backend, whose
state is constant-size per slot; ``slot_axis``/``gather_slot_rows``/
``scatter_slot_rows`` move one slot's rows of such a cache.

``state_to_bytes``/``state_from_bytes`` are the migration seam's wire
format, the JAX package's ``RST1`` buffer: a request's state tree as one
buffer that crosses engines (``ssm_cache_to_bytes``/``ssm_cache_from_bytes``
name it for one recurrent cache).
"""
from __future__ import annotations

import dataclasses
import json
import struct
import warnings
from typing import Any, Dict, List, NamedTuple, Optional, Protocol, Tuple, runtime_checkable

import numpy as np
import torch


@dataclasses.dataclass
class KVCache:
    """Contiguous GQA cache: k/v (B, S_max, K, D), ``length`` tokens already
    in it (a host int, shared by every row)."""

    k: torch.Tensor
    v: torch.Tensor
    length: int

    @property
    def max_len(self) -> int:
        return self.k.shape[1]

    def append(self, k_new: torch.Tensor, v_new: torch.Tensor) -> "KVCache":
        """Write S_new tokens (B, S_new, K, D) at row ``length`` of every
        batch row, **in place**; the new cache counts ``length + S_new``.
        The start is clamped into ``[0, S_max - S_new]``, as the JAX
        package's ``dynamic_update_slice`` clamps it: past the end, the
        tokens land on the last rows."""
        s_new = k_new.shape[1]
        pos = min(max(self.length, 0), self.max_len - s_new)
        self.k[:, pos:pos + s_new] = k_new.to(self.k.dtype)
        self.v[:, pos:pos + s_new] = v_new.to(self.v.dtype)
        return KVCache(self.k, self.v, self.length + s_new)


@dataclasses.dataclass
class MLACache:
    """Contiguous MLA cache: ``c_kv`` (B, S_max, r), ``k_rope`` (B, S_max,
    dr), ``length`` tokens already in it (a host int, shared by every
    row)."""

    c_kv: torch.Tensor
    k_rope: torch.Tensor
    length: int

    @property
    def max_len(self) -> int:
        return self.c_kv.shape[1]

    def append(self, c_new: torch.Tensor, kr_new: torch.Tensor) -> "MLACache":
        """Write S_new tokens (``c_new`` (B, S_new, r), ``kr_new`` (B, S_new,
        dr)) at row ``length``, **in place**, the start clamped as
        ``KVCache.append`` clamps it; the new cache counts ``length +
        S_new``."""
        s_new = c_new.shape[1]
        pos = min(max(self.length, 0), self.max_len - s_new)
        self.c_kv[:, pos:pos + s_new] = c_new.to(self.c_kv.dtype)
        self.k_rope[:, pos:pos + s_new] = kr_new.to(self.k_rope.dtype)
        return MLACache(self.c_kv, self.k_rope, self.length + s_new)


@dataclasses.dataclass
class PagedLayout:
    """Per-step view of the paged pool.

    block_tables: (B, max_blocks) int32 — pool block ids per request, in
        logical order; -1 marks unallocated slots.
    starts: (B,) int32 — tokens already resident per request (the absolute
        position of this step's first new token).
    n_valid: (B,) int32 — how many of this step's ``chunk`` token columns
        are real for each request (decode rows 1, prefill rows up to
        ``chunk``, idle rows 0).
    block_size: tokens per pool block.

    The destination rows of a pool write are the same for every layer of a
    step, so ``PagedKVCache.write`` computes them once and keeps them here.
    """

    block_tables: torch.Tensor
    starts: torch.Tensor
    n_valid: torch.Tensor
    block_size: int
    _write_rows: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = \
        dataclasses.field(default_factory=dict, repr=False, compare=False)

    def token_positions(self, chunk: int) -> torch.Tensor:
        cols = torch.arange(chunk, dtype=torch.int32, device=self.starts.device)
        return self.starts[:, None] + cols[None, :]

    def token_valid(self, chunk: int) -> torch.Tensor:
        cols = torch.arange(chunk, dtype=torch.int32, device=self.n_valid.device)
        return cols[None, :] < self.n_valid[:, None]

    def write_rows(self, chunk: int, num_blocks: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(src, dst)``: flat (request, column) indices of the tokens to
        write and their flat pool rows.

        Same rows as the JAX package's ``PagedKVCache._dest_rows``, where
        invalid columns, ``-1`` table entries and rows past the pool are
        sent out of bounds and dropped by ``mode="drop"``. PyTorch has no
        drop mode, so those tokens are filtered out here instead (one
        device-to-host sync per step, shared by every layer)."""
        key = (chunk, num_blocks)
        if key not in self._write_rows:
            bs = self.block_size
            pos = self.token_positions(chunk)                          # (B, C)
            blk_idx = torch.div(pos, bs, rounding_mode="floor").clamp(
                0, self.block_tables.shape[1] - 1).long()
            blk = torch.gather(self.block_tables, 1, blk_idx)
            rows = blk.long() * bs + torch.remainder(pos, bs)
            keep = self.token_valid(chunk) & (blk >= 0) & (rows < num_blocks * bs)
            src = keep.reshape(-1).nonzero().squeeze(1)
            self._write_rows[key] = (src, rows.reshape(-1)[src])
        return self._write_rows[key]


@dataclasses.dataclass
class PagedKVCache:
    """Block-pool GQA cache: requests gather/scatter through a block table."""

    k_pool: torch.Tensor              # (N_blocks, block_size, K, D)
    v_pool: torch.Tensor
    block_size: int = 16

    @property
    def num_blocks(self) -> int:
        return self.k_pool.shape[0]

    def write(self, k_new: torch.Tensor, v_new: torch.Tensor,
              layout: PagedLayout) -> "PagedKVCache":
        """Scatter (B, C, K, D) new tokens into the pool at their logical
        positions, **in place**, and return ``self``.

        The JAX version is functional: it returns new pools and relies on
        the step donating the old buffers. Columns ``>= n_valid``, ``-1``
        table entries and rows past the pool are dropped, as there."""
        chunk = k_new.shape[1]
        src, dst = layout.write_rows(chunk, self.num_blocks)
        tail = self.k_pool.shape[2:]
        for pool, new in ((self.k_pool, k_new), (self.v_pool, v_new)):
            flat = pool.view(-1, *tail)
            flat.index_copy_(0, dst, new.reshape(-1, *tail)[src].to(pool.dtype))
        return self

    def gather(self, block_tables: torch.Tensor,
               seq_lens: Optional[torch.Tensor] = None):
        """Materialize each request's logical (T, K, D) view, T = M * bs.

        Table entries outside the pool are clamped into it, as a JAX gather
        clamps them: unallocated slots (-1) read block 0 and ids past the
        pool its last block — callers mask both. With ``seq_lens``
        (resident tokens per request) also returns ``max_resident``: the
        longest live sequence rounded up to ``block_size`` and clamped to
        T, as a Python int."""
        bs = self.block_size
        B, M = block_tables.shape
        rows = (block_tables.clamp(0, self.num_blocks - 1).long()[:, :, None] * bs
                + torch.arange(bs, device=block_tables.device)[None, None, :])
        rows = rows.reshape(B, M * bs)
        tail = self.k_pool.shape[2:]
        k = self.k_pool.view(-1, *tail)[rows]
        v = self.v_pool.view(-1, *tail)[rows]
        if seq_lens is None:
            return k, v
        longest = int(seq_lens.max()) if seq_lens.numel() else 0
        max_resident = min(-(-longest // bs) * bs, M * bs)
        return k, v, max_resident


@dataclasses.dataclass
class RecurrentLayout:
    """Per-step serving view for recurrent (SSM) stacks: ``PagedLayout``
    minus the block tables, since state is constant-size per request.

    starts: (B,) int32 — tokens already absorbed into the state per row.
    n_valid: (B,) int32 — real token columns this step (decode rows 1,
        prefill rows up to ``chunk``, idle rows 0). The real columns are
        always the prefix ``[0, n_valid)``.
    """

    starts: torch.Tensor
    n_valid: torch.Tensor

    def token_positions(self, chunk: int) -> torch.Tensor:
        cols = torch.arange(chunk, dtype=torch.int32, device=self.starts.device)
        return self.starts[:, None] + cols[None, :]

    def token_valid(self, chunk: int) -> torch.Tensor:
        cols = torch.arange(chunk, dtype=torch.int32, device=self.n_valid.device)
        return cols[None, :] < self.n_valid[:, None]


def map_pair(fn, tree, other):
    """``fn(leaf, other_leaf)`` over two dict/list trees of one structure."""
    if isinstance(tree, dict):
        return {k: map_pair(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_pair(fn, v, o) for v, o in zip(tree, other)]
    return fn(tree, other)


def slot_axis(live_shape: Tuple[int, ...], one_shape: Tuple[int, ...],
              slots: int) -> Optional[int]:
    """The batch (slot) axis of a cache leaf, found structurally: the first
    axis where the live leaf has ``slots`` extent, the one-row template has
    extent 1, and every leading dim matches. None for leaves with no
    per-slot axis."""
    if len(live_shape) != len(one_shape):
        return None
    for ax in range(len(live_shape)):
        if (live_shape[ax] == slots and one_shape[ax] == 1
                and live_shape[:ax] == one_shape[:ax]):
            return ax
    return None


def gather_slot_rows(cache: Any, template: Any, slot: int, slots: int) -> Any:
    """A copy of one slot's rows of a batched cache (the port's per-layer
    dict tree), on the cache's device. Leaves without a slot axis are
    copied whole."""
    def take(live, one):
        ax = slot_axis(tuple(live.shape), tuple(one.shape), slots)
        return live.clone() if ax is None else live.narrow(ax, slot, 1).clone()
    return map_pair(take, cache, template)


def scatter_slot_rows(cache: Any, row: Any, slot: int, slots: int) -> Any:
    """Write one-row state into ``slot`` of a batched cache, **in place**,
    and return the cache. Leaves without a slot axis are left untouched."""
    def put(live, one):
        ax = slot_axis(tuple(live.shape), tuple(one.shape), slots)
        if ax is not None:
            live.narrow(ax, slot, 1).copy_(one)
        return live
    return map_pair(put, cache, row)


# ---------------------------------------------------------------------------
# state serialization (the migration seam)
# ---------------------------------------------------------------------------

_STATE_MAGIC = b"RST1"

# torch dtype <-> the numpy dtype name the JAX package writes in the header
_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float16: "float16",
                torch.float32: "float32", torch.float64: "float64",
                torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
                torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool"}
_NAMED_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}


class LeafSpec(NamedTuple):
    """Shape and dtype of one state leaf: the ``like=`` template of
    ``state_from_bytes`` where no tensor of that shape exists yet."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a port state tree (dicts in insertion order, lists in
    order): the order ``state_to_bytes`` writes them in."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, LeafSpec):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def _unflatten(like: Any, leaves) -> Any:
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves) for k, v in like.items()}
    if isinstance(like, (list, tuple)) and not isinstance(like, LeafSpec):
        return [_unflatten(v, leaves) for v in like]
    return next(leaves)


def state_to_bytes(tree: Any) -> bytes:
    """Pack a state tree of tensors into one ``RST1`` buffer: the magic, a
    little-endian header length, a JSON header (each leaf's dtype name and
    shape, in ``tree_leaves`` order) and the leaves' raw bytes. The tree's
    structure does not travel: sender and receiver agree on it (same model
    config). bf16 goes as its raw bytes. The leaves are copied to the host
    in one transfer (one ``cat`` of their bytes on their device), and
    joined to the header with no further copy of them."""
    leaves = tree_leaves(tree)
    header = json.dumps([{"dtype": _DTYPE_NAMES[t.dtype], "shape": list(t.shape)}
                         for t in leaves]).encode("utf-8")
    parts = [_STATE_MAGIC, struct.pack("<I", len(header)), header]
    if leaves:
        flat = torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8)
                          for t in leaves])
        parts.append(memoryview(flat.cpu().numpy()))
    return b"".join(parts)


def state_header(buf: bytes) -> List[LeafSpec]:
    """The leaves an ``RST1`` buffer declares (its header), in order."""
    if buf[:4] != _STATE_MAGIC:
        raise ValueError("state buffer does not start with the RST1 magic")
    (hlen,) = struct.unpack("<I", buf[4:8])
    return [LeafSpec(tuple(meta["shape"]), _NAMED_DTYPES[meta["dtype"]])
            for meta in json.loads(buf[8:8 + hlen].decode("utf-8"))]


def state_leaves(buf: bytes, device=None) -> List[torch.Tensor]:
    """The leaves of an ``RST1`` buffer as its header declares them, on
    ``device`` (default the CPU), moved there in one transfer. Trailing
    bytes raise."""
    specs = state_header(buf)
    off = 8 + struct.unpack("<I", buf[4:8])[0]
    sizes = [int(np.prod(sp.shape, dtype=np.int64)) * sp.dtype.itemsize for sp in specs]
    if off + sum(sizes) != len(buf):
        raise ValueError(f"state buffer has {len(buf) - off - sum(sizes)} trailing bytes")
    data = torch.zeros(0, dtype=torch.uint8)    # torch.frombuffer refuses 0 bytes
    if len(buf) > off:
        with warnings.catch_warnings():         # read-only bytes: only read, then copied
            warnings.simplefilter("ignore", UserWarning)
            data = torch.frombuffer(buf, dtype=torch.uint8, offset=off)
    data = data.to(device or "cpu", copy=True)
    out, start = [], 0
    for sp, n in zip(specs, sizes):
        raw = data[start:start + n]
        if start % sp.dtype.itemsize:
            raw = raw.clone()           # a view of another width needs an aligned start
        out.append(raw.view(sp.dtype).reshape(sp.shape))
        start += n
    return out


def state_from_bytes(buf: bytes, like: Any, device=None) -> Any:
    """Inverse of ``state_to_bytes``: a tree shaped as ``like`` (tensors or
    ``LeafSpec`` leaves) on ``device`` (default the CPU). A leaf count,
    dtype or shape that differs from ``like``, and trailing bytes, raise
    rather than reinterpret the bytes."""
    specs, refs = state_header(buf), tree_leaves(like)
    if len(specs) != len(refs):
        raise ValueError(f"state buffer holds {len(specs)} leaves, template has "
                         f"{len(refs)}")
    for sp, ref in zip(specs, refs):
        if (tuple(ref.shape), ref.dtype) != (sp.shape, sp.dtype):
            raise ValueError(f"state leaf mismatch: buffer has {_DTYPE_NAMES[sp.dtype]}"
                             f"{sp.shape}, template expects "
                             f"{_DTYPE_NAMES.get(ref.dtype, ref.dtype)}{tuple(ref.shape)}")
    return _unflatten(like, iter(state_leaves(buf, device)))


def ssm_cache_to_bytes(cache: Any) -> bytes:
    """Serialize one recurrent cache (the port's ``{"layers": [...]}`` of
    per-layer state dicts)."""
    return state_to_bytes(cache)


def ssm_cache_from_bytes(buf: bytes, like: Any, device=None) -> Any:
    """Rebuild a recurrent cache from ``ssm_cache_to_bytes`` output; ``like``
    gives the structure (an init-shaped cache works)."""
    return state_from_bytes(buf, like, device)


# ---------------------------------------------------------------------------
# SequenceState — the per-request sequence-state backend protocol
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SequenceCapacity:
    """What a backend's admission-limiting resource looks like.

    ``free_units is None`` means the resource is not consumable and
    admission is gated on free slots alone."""

    kind: str                        # backend name ("paged"/"slots"/"recurrent")
    unit: str                        # "blocks" | "slots"
    total_units: Optional[int]
    free_units: Optional[int]


@runtime_checkable
class SequenceState(Protocol):
    """Pluggable per-request sequence-state backend for the Engine.

    The engine owns requests and the tick loop; the backend owns what a
    request's state costs. Entries are duck-typed scheduler records
    (``pos``/``blocks``/``snapshot``/``seq()``); ``cache`` is the live
    device tree, threaded through because several backends rebuild it.
    """

    kind: str
    supports_preemption: bool

    def init(self, entry: Any, cache: Any, slot: int) -> Any:
        """Prepare ``slot`` for ``entry`` at admission; returns the cache."""

    def append(self, entry: Any, n: int) -> None:
        """Host-side accounting after ``n`` tokens entered the state."""

    def units_needed(self, entry: Any) -> int:
        """Capacity units required to advance this entry one step."""

    def grow(self, entry: Any, upto_tokens: int) -> bool:
        """Reserve capacity for ``upto_tokens``; False when exhausted."""

    def evict(self, entry: Any, cache: Any, slot: int) -> Any:
        """Release the entry's state for requeue; returns the cache."""

    def release(self, entry: Any) -> None:
        """Drop all state owned by a finished entry."""

    def gather(self, entry: Any, cache: Any, slot: int) -> Any:
        """The request's state as a tree of tensors (a copy)."""

    def serialize(self, entry: Any, cache: Any, slot: int) -> bytes:
        """The migration seam: the request's state as one buffer."""

    def restore(self, entry: Any, cache: Any, slot: int, buf: bytes) -> Any:
        """Inverse of ``serialize``: write a migrated request's state into
        ``slot``. The buffer is position-independent (logical token order,
        no block ids or slot indices), so source and target may differ in
        pool geometry, block allocation and slot; only the model config and
        the backend's kind must match. Returns the cache; the entry already
        owns the capacity its resident prefix needs (the engine grows it
        first)."""

    def capacity(self) -> SequenceCapacity: ...

    def metrics(self) -> Dict[str, Any]: ...

    def validate(self, prompt_len: int, max_new: int,
                 max_len: int) -> Optional[str]:
        """Reject-at-submit check; an error string or None."""
