"""Sequence-state backends for ``repro_torch.engine.Engine``.

``PagedKVState`` runs over the shared per-layer block pool, with the
host-side ``BlockPool`` free list; ``RecurrentState`` over constant-size
per-slot recurrent state; ``SlotKVState`` over one contiguous ``max_len``
cache row per slot. Each also moves a request's state between engines
(``gather``/``serialize``/``restore``), in the ``RST1`` format of
``models.kvcache.state_to_bytes``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Set

import torch

from repro_torch.models.kvcache import (LeafSpec, SequenceCapacity, SequenceState,
                                        gather_slot_rows, map_pair, scatter_slot_rows,
                                        state_from_bytes, state_to_bytes)

__all__ = ["BlockPool", "PagedKVState", "RecurrentState", "SequenceCapacity",
           "SequenceState", "SlotKVState"]


class BlockPool:
    """Host-side free list over the device block pool's block ids.

    Guarded against lifecycle bugs: releasing a block that is already free
    (double-free) or outside the pool raises with the offending id, and
    ``alloc`` detects a corrupted free list (the same id handed out twice)
    rather than silently aliasing two requests onto one block.
    """

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks))
        self._free_set: Set[int] = set(self._free)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - len(self._free)

    def alloc(self) -> Optional[int]:
        if not self._free:
            return None
        blk = self._free.pop()
        if blk not in self._free_set:
            raise RuntimeError(
                f"double-alloc of block {blk}: free list is corrupted (the "
                f"id appears more than once)")
        self._free_set.remove(blk)
        return blk

    def release(self, blocks: List[int]) -> None:
        # validate the whole batch before mutating so a bad id cannot leave
        # the pool half-released
        seen: Set[int] = set()
        for blk in blocks:
            if not 0 <= blk < self.num_blocks:
                raise ValueError(
                    f"release of unknown block id {blk} (pool holds ids "
                    f"0..{self.num_blocks - 1})")
            if blk in self._free_set or blk in seen:
                raise ValueError(f"double-free of block {blk}")
            seen.add(blk)
        self._free.extend(blocks)
        self._free_set.update(blocks)


class PagedKVState:
    """``SequenceState`` over the shared per-layer block pool.

    Capacity is consumable (``free_units`` = free pool blocks); ``grow``
    allocates one block at a time and reports False when the pool runs
    dry — the engine then preempts a policy-chosen victim. Eviction is
    recompute-style: blocks go back to the pool and ``pos`` resets, so
    re-admission re-prefills the prompt+generated prefix. Partial
    allocations are kept across a failed grow, as in the JAX package, so
    the FIFO schedule matches it exactly.
    """

    kind = "paged"
    supports_preemption = True

    def __init__(self, num_blocks: int, block_size: int):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.pool = BlockPool(num_blocks)

    def blocks_for(self, tokens: int) -> int:
        return -(-tokens // self.block_size)

    def init(self, entry: Any, cache: Any, slot: int) -> Any:
        return cache                      # blocks attach lazily in grow()

    def append(self, entry: Any, n: int) -> None:
        return None                       # pos is the engine's ledger

    def units_needed(self, entry: Any) -> int:
        return self.blocks_for(len(entry.seq()) + 1)

    def grow(self, entry: Any, upto_tokens: int) -> bool:
        need = self.blocks_for(upto_tokens)
        while len(entry.blocks) < need:
            blk = self.pool.alloc()
            if blk is None:
                return False              # caller preempts and retries
            entry.blocks.append(blk)
        return True

    def evict(self, entry: Any, cache: Any, slot: int) -> Any:
        self.pool.release(entry.blocks)
        entry.blocks = []
        entry.pos = 0
        return cache

    def release(self, entry: Any) -> None:
        if entry.blocks:
            self.pool.release(entry.blocks)
            entry.blocks = []

    def _block_axis(self, shape) -> Optional[int]:
        """The pool-block axis of a cache leaf, found structurally (shape
        ``[..., num_blocks, block_size, ...]``). A leaf where more than one
        adjacent pair of dims matches ``(num_blocks, block_size)`` is
        ambiguous, and picking the wrong axis would serialize garbage, so
        it raises. None for leaves with no block axis (they copy
        through)."""
        axes = [ax for ax in range(len(shape) - 1)
                if shape[ax] == self.num_blocks and shape[ax + 1] == self.block_size]
        if not axes:
            return None
        if len(axes) > 1:
            raise ValueError(
                f"ambiguous block axis in paged-cache leaf of shape {tuple(shape)}: dims "
                f"{axes} all match (num_blocks={self.num_blocks}, block_size="
                f"{self.block_size}); resize the pool (num_blocks/block_size) so the pair "
                f"is unique, or reshape the colliding leaf dims")
        return axes[0]

    def gather(self, entry: Any, cache: Any, slot: int) -> Any:
        """The request's resident tokens as a contiguous tree on the cache's
        device: its blocks taken out of every pool leaf, the (blocks,
        block_size) axes merged and trimmed to ``entry.pos`` tokens. Logical
        token order and no block ids, so any pool geometry can restore
        it."""
        def take(leaf):
            ax = self._block_axis(leaf.shape)
            if ax is None:
                return leaf.clone()
            blocks = torch.tensor(entry.blocks, dtype=torch.long, device=leaf.device)
            got = leaf.index_select(ax, blocks)
            merged = got.reshape(leaf.shape[:ax] + (len(entry.blocks) * self.block_size,)
                                 + leaf.shape[ax + 2:])
            return merged.narrow(ax, 0, entry.pos)
        return _map(take, cache)

    def serialize(self, entry: Any, cache: Any, slot: int) -> bytes:
        return state_to_bytes(self.gather(entry, cache, slot))

    def gather_like(self, entry: Any, cache: Any) -> Any:
        """``LeafSpec`` tree of ``gather``'s output for ``entry``: the
        template ``state_from_bytes`` reads a buffer against (its shapes
        depend on ``entry.pos``, not on the pool)."""
        def like(leaf):
            shape = tuple(leaf.shape)
            ax = self._block_axis(shape)
            if ax is not None:
                shape = shape[:ax] + (entry.pos,) + shape[ax + 2:]
            return LeafSpec(shape, leaf.dtype)
        return _map(like, cache)

    def restore(self, entry: Any, cache: Any, slot: int, buf: bytes) -> Any:
        """Inverse of ``serialize``, **in place**: cut the contiguous token
        rows by *this* pool's block size and write them to ``entry.blocks``,
        which the engine has already grown to cover ``entry.pos`` tokens.
        The rest of the last block is zero-padded: attention masks
        positions past the row's end, and later appends overwrite them."""
        n_blocks = self.blocks_for(entry.pos)
        if len(entry.blocks) < n_blocks:
            raise RuntimeError(
                f"restore of {entry.pos} tokens needs {n_blocks} blocks, entry owns "
                f"{len(entry.blocks)} (grow before restoring)")
        row = state_from_bytes(buf, self.gather_like(entry, cache), _device(cache))

        def put(leaf, got):
            ax = self._block_axis(leaf.shape)
            if ax is None:
                return leaf
            pad = n_blocks * self.block_size - entry.pos
            if pad:
                zeros = got.new_zeros(got.shape[:ax] + (pad,) + got.shape[ax + 1:])
                got = torch.cat([got, zeros], dim=ax)
            got = got.reshape(leaf.shape[:ax] + (n_blocks, self.block_size)
                              + leaf.shape[ax + 2:])
            blocks = torch.tensor(entry.blocks[:n_blocks], dtype=torch.long,
                                  device=leaf.device)
            leaf.index_copy_(ax, blocks, got.to(leaf.dtype))
            return leaf
        map_pair(put, cache, row)
        return cache

    def capacity(self) -> SequenceCapacity:
        return SequenceCapacity(kind="paged", unit="blocks",
                                total_units=self.num_blocks,
                                free_units=self.pool.free_blocks)

    def metrics(self) -> Dict[str, Any]:
        return {"free_blocks": self.pool.free_blocks,
                "used_blocks": self.pool.used_blocks}

    def validate(self, prompt_len: int, max_new: int,
                 max_len: int) -> Optional[str]:
        return _over_length(prompt_len, max_new, max_len)


def _over_length(prompt_len: int, max_new: int, max_len: int) -> Optional[str]:
    if prompt_len + max_new > max_len:
        return (f"prompt ({prompt_len}) + max_new_tokens ({max_new}) "
                f"exceeds max_len={max_len}")
    return None


class RecurrentState:
    """``SequenceState`` over constant-size recurrent state (SSM).

    A request's whole sequence state is its slot's rows of the cache
    (conv history and state), so there is no consumable pool: ``grow``
    always succeeds and admission is gated on free slots alone. Eviction
    snapshots the slot's rows into ``entry.snapshot`` and keeps
    ``entry.pos``; re-admission scatters the snapshot back and decoding
    resumes where it stopped, never a recompute. The snapshot stays on the
    cache's device as a cloned tensor per leaf.

    ``template_fn`` returns a one-row init cache; it also clears a freed
    slot's stale state before a fresh request runs, since the recurrence
    would otherwise integrate the previous occupant's state.
    """

    kind = "recurrent"
    supports_preemption = True

    def __init__(self, slots: int, template_fn: Callable[[], Any]):
        self.slots = slots
        self._template_fn = template_fn
        self._template: Any = None
        self.snapshots_taken = 0
        self.snapshots_restored = 0

    @property
    def template(self) -> Any:
        if self._template is None:
            self._template = self._template_fn()
        return self._template

    def state_bytes_per_slot(self) -> int:
        return sum(t.numel() * t.element_size() for t in _leaves(self.template)
                   if t.dim() > 0)

    def init(self, entry: Any, cache: Any, slot: int) -> Any:
        row = getattr(entry, "snapshot", None)
        restored = row is not None
        cache = scatter_slot_rows(cache, row if restored else self.template, slot,
                                  self.slots)
        if restored:
            entry.snapshot = None
            self.snapshots_restored += 1
        return cache

    def append(self, entry: Any, n: int) -> None:
        return None

    def units_needed(self, entry: Any) -> int:
        return 0

    def grow(self, entry: Any, upto_tokens: int) -> bool:
        return True

    def evict(self, entry: Any, cache: Any, slot: int) -> Any:
        # the snapshot covers seq[:entry.pos]; pos is kept so re-admission
        # feeds the next unseen token instead of re-prefilling
        entry.snapshot = self.gather(entry, cache, slot)
        self.snapshots_taken += 1
        return cache

    def release(self, entry: Any) -> None:
        entry.snapshot = None

    def gather(self, entry: Any, cache: Any, slot: int) -> Any:
        return gather_slot_rows(cache, self.template, slot, self.slots)

    def serialize(self, entry: Any, cache: Any, slot: int) -> bytes:
        return state_to_bytes(self.gather(entry, cache, slot))

    def restore(self, entry: Any, cache: Any, slot: int, buf: bytes) -> Any:
        """Scatter a migrated request's state rows into ``slot``, the
        byte-level twin of the snapshot-resume path: it resumes at
        ``entry.pos``, never a recompute. The state is a few KB to a few
        hundred MB a slot whatever the sequence length."""
        row = state_from_bytes(buf, self.template, _device(cache))
        return scatter_slot_rows(cache, row, slot, self.slots)

    def capacity(self) -> SequenceCapacity:
        return SequenceCapacity(kind="recurrent", unit="slots",
                                total_units=self.slots, free_units=None)

    def metrics(self) -> Dict[str, Any]:
        return {"state_bytes_per_slot": self.state_bytes_per_slot(),
                "snapshots_taken": self.snapshots_taken,
                "snapshots_restored": self.snapshots_restored}

    def validate(self, prompt_len: int, max_new: int,
                 max_len: int) -> Optional[str]:
        return None                      # constant-size state: no length limit


class SlotKVState:
    """``SequenceState`` over one contiguous ``max_len`` cache row per slot.

    Capacity is the slot rows themselves (not consumable: ``free_units``
    is None); the engine's prefill step fills a fresh row at admission and
    scatters it in (``scatter``), and there is **no preemption path**: a
    slot row has no snapshot or recompute seam, so ``evict`` raises
    instead of silently corrupting the row. ``SchedulerPolicy.pick_victim``
    is never consulted on this backend (the engine warns at construction
    when a policy overrides it). ``gather``/``serialize`` take a slot's
    whole row with the cache's shared ``length``; ``restore`` writes it
    into a slot of another engine.
    """

    kind = "slots"
    supports_preemption = False

    def __init__(self, slots: int):
        self.slots = slots

    def init(self, entry: Any, cache: Any, slot: int) -> Any:
        return cache                      # the engine's prefill scatter fills it

    def scatter(self, cache: Any, filled: Any, slot: int) -> Any:
        """Copy a one-row prefilled cache into ``slot`` of the batched one,
        **in place**. The cache keeps ONE ``length`` for every row, so it
        rises to the longest row's (the JAX package's rule: decode masks
        by absolute position, so the other rows see the gap)."""
        for live, one in zip(cache["layers"], filled["layers"]):
            for key in live:
                live[key][slot].copy_(one[key][0])
        cache["length"] = max(cache["length"], filled["length"])
        return cache

    def append(self, entry: Any, n: int) -> None:
        return None

    def units_needed(self, entry: Any) -> int:
        return 0

    def grow(self, entry: Any, upto_tokens: int) -> bool:
        return True                       # the row always covers max_len

    def evict(self, entry: Any, cache: Any, slot: int) -> Any:
        raise RuntimeError(
            "cache='slots' cannot preempt: a slot row has no snapshot or "
            "recompute path (SchedulerPolicy.pick_victim is never consulted "
            "on this backend) — use cache='paged' (recompute) or "
            "cache='recurrent' (state snapshot)")

    def release(self, entry: Any) -> None:
        return None

    def gather(self, entry: Any, cache: Any, slot: int) -> Any:
        """A copy of ``slot``'s row of every layer, and the cache's shared
        ``length`` as an int32 scalar (the JAX package's row carries it)."""
        return {"length": torch.tensor(cache["length"], dtype=torch.int32,
                                       device=_device(cache["layers"])),
                "layers": [{k: t[slot:slot + 1].clone() for k, t in layer.items()}
                           for layer in cache["layers"]]}

    def serialize(self, entry: Any, cache: Any, slot: int) -> bytes:
        return state_to_bytes(self.gather(entry, cache, slot))

    def restore(self, entry: Any, cache: Any, slot: int, buf: bytes) -> Any:
        """Write a migrated request's row into ``slot``, **in place**. The
        row carries its source's ``length``; the cache keeps one for every
        row, so it rises to cover the restored row (``max``, the rule of
        the prefill's ``scatter``), or the row's tail would be masked
        off."""
        like = {"length": LeafSpec((), torch.int32),
                "layers": [{k: LeafSpec((1,) + tuple(t.shape[1:]), t.dtype)
                            for k, t in layer.items()} for layer in cache["layers"]]}
        row = state_from_bytes(buf, like, _device(cache))
        return self.scatter(cache, dict(row, length=int(row["length"])), slot)

    def capacity(self) -> SequenceCapacity:
        return SequenceCapacity(kind="slots", unit="slots",
                                total_units=self.slots, free_units=None)

    def metrics(self) -> Dict[str, Any]:
        return {}

    def validate(self, prompt_len: int, max_new: int,
                 max_len: int) -> Optional[str]:
        return _over_length(prompt_len, max_new, max_len)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _device(tree) -> torch.device:
    return next(iter(_leaves(tree))).device


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree
