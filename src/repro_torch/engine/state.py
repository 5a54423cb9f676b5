"""Sequence-state backends for ``repro_torch.engine.Engine``.

``PagedKVState`` runs over the shared per-layer block pool, with the
host-side ``BlockPool`` free list; ``RecurrentState`` over constant-size
per-slot recurrent state; ``SlotKVState`` over one contiguous ``max_len``
cache row per slot. The migration half of the protocol (``gather``/
``serialize``/``restore``, and the recurrent backend's ``state_to_bytes``
format) is ROADMAP item A12.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Set

import torch

from repro_torch.models.kvcache import (SequenceCapacity, SequenceState,
                                        gather_slot_rows, scatter_slot_rows)

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
        entry.snapshot = gather_slot_rows(cache, self.template, slot, self.slots)
        self.snapshots_taken += 1
        return cache

    def release(self, entry: Any) -> None:
        entry.snapshot = None

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
    when a policy overrides it). Moving a row between engines
    (``gather``/``serialize``/``restore``) is ROADMAP item A12.
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

    def gather(self, *args: Any) -> Any:
        raise NotImplementedError("moving a slot row between engines is ROADMAP item A12")

    serialize = restore = gather

    def capacity(self) -> SequenceCapacity:
        return SequenceCapacity(kind="slots", unit="slots",
                                total_units=self.slots, free_units=None)

    def metrics(self) -> Dict[str, Any]:
        return {}

    def validate(self, prompt_len: int, max_new: int,
                 max_len: int) -> Optional[str]:
        return _over_length(prompt_len, max_new, max_len)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree
