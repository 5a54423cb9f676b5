"""Scheduler policies for ``repro_torch.engine.Engine``.

A copy of the JAX package's ``engine/scheduler.py``: that module is plain
Python, but importing it runs ``repro/engine/__init__.py``, which imports
JAX, so the port keeps its own.

Two-Chains separates *what runs* (the serve steps) from *who decides
when/where it runs*. A ``SchedulerPolicy`` is the
"who": a small host-side object the engine consults at its three decision
points —

* ``admit(queue, state)`` — which queued entry (by index) admits next, or
  ``None`` to wait. The engine calls this in a loop while slots are free,
  so a policy returning an index keeps admitting until it returns ``None``.
* ``pick_victim(running, state)`` — which running entry to preempt when
  the backend's capacity runs dry (backends with ``supports_preemption``;
  the slots cache never consults it).
* ``budget(entry, state)`` — how many capacity units ``entry`` must be
  able to claim before it may admit (consumable-capacity backends only;
  slots/recurrent gate on free slots alone and ``budget`` is 0).

``SchedulerState`` is the read-only view the engine hands each decision:
the current tick, how many slots are free, the capacity budget still
unpromised this admission round (``None`` for non-consumable backends), a
``blocks_needed`` sizing callback, and the backend's ``SequenceCapacity``
snapshot (``capacity``).

Policies are host-side — swapping one changes *order*, never math
(tests/test_torch_engine.py holds the port's schedules against the JAX
package's under every policy).

``FIFOPolicy`` reproduces the legacy pre-engine servers' behavior
bitwise: strict submission order with head-of-line blocking (while the
head cannot afford its blocks, nobody jumps the queue) and
youngest-admitted victim selection.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Protocol, Sequence, runtime_checkable

__all__ = [
    "SchedulerState", "SchedulerPolicy", "FIFOPolicy", "PriorityPolicy",
    "SJFPolicy", "POLICIES", "resolve_policy",
]


@dataclasses.dataclass(frozen=True)
class SchedulerState:
    """Read-only engine snapshot handed to every policy decision."""

    tick: int                       # engine ticks completed so far
    free_slots: int                 # request rows currently unoccupied
    # free capacity units not yet promised to entries admitted earlier in
    # this same admission round; None when the backend's capacity is not
    # consumable (slots/recurrent gate on free slots alone)
    block_budget: Optional[int]
    # units an entry needs resident to run its next step (prefix + 1 token)
    blocks_needed: Callable[[Any], int]
    # the backend's SequenceCapacity snapshot (kind/unit/total/free); None
    # only for hand-built states in tests
    capacity: Optional[Any] = None


@runtime_checkable
class SchedulerPolicy(Protocol):
    """The pluggable scheduling seam (see module docstring)."""

    name: str

    def admit(self, queue: Sequence[Any],
              state: SchedulerState) -> Optional[int]: ...

    def pick_victim(self, running: Sequence[Any],
                    state: SchedulerState) -> Optional[Any]: ...

    def budget(self, entry: Any, state: SchedulerState) -> int: ...


class _PolicyBase:
    """Shared affordability/budget/victim plumbing.

    ``budget`` defaults to the entry's exact block need; ``pick_victim``
    defaults to the youngest-admitted running entry (the legacy choice: it
    has the least recompute to lose).
    """

    name = "base"

    def budget(self, entry: Any, state: SchedulerState) -> int:
        if state.block_budget is None:
            return 0
        return state.blocks_needed(entry)

    def _affordable(self, entry: Any, state: SchedulerState) -> bool:
        return (state.block_budget is None
                or self.budget(entry, state) <= state.block_budget)

    def pick_victim(self, running: Sequence[Any],
                    state: SchedulerState) -> Optional[Any]:
        if not running:
            return None
        return max(running, key=lambda e: e.admit_seq)

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


class FIFOPolicy(_PolicyBase):
    """Strict submission order with head-of-line blocking — bitwise
    preserves the legacy pre-engine servers' schedule, preemption
    included."""

    name = "fifo"

    def admit(self, queue: Sequence[Any],
              state: SchedulerState) -> Optional[int]:
        if queue and self._affordable(queue[0], state):
            return 0
        return None                     # head blocked => everyone waits


class PriorityPolicy(_PolicyBase):
    """Priority-aware admission: the highest-``Request.priority`` queued
    entry admits first (ties broken by submission order, so equal-priority
    traffic degrades to FIFO). Deadline scheduling is the same mechanism —
    encode urgency into ``priority`` at submit time. Head-of-line blocking
    applies to the *best* candidate: while it cannot afford its blocks,
    nobody lower-priority jumps in, so a large urgent request cannot be
    starved by small background ones. Preemption evicts the lowest-priority
    (then youngest-admitted) running entry."""

    name = "priority"

    def admit(self, queue: Sequence[Any],
              state: SchedulerState) -> Optional[int]:
        if not queue:
            return None
        best = min(range(len(queue)),
                   key=lambda i: (-queue[i].req.priority,
                                  queue[i].arrival_seq))
        return best if self._affordable(queue[best], state) else None

    def pick_victim(self, running: Sequence[Any],
                    state: SchedulerState) -> Optional[Any]:
        if not running:
            return None
        return min(running, key=lambda e: (e.req.priority, -e.admit_seq))


class SJFPolicy(_PolicyBase):
    """Shortest-prompt-first admission (classic SJF on the known part of
    the job): minimizes mean time-to-first-token when prompt lengths vary.
    Ties fall back to submission order; victim selection stays
    youngest-admitted."""

    name = "sjf"

    def admit(self, queue: Sequence[Any],
              state: SchedulerState) -> Optional[int]:
        if not queue:
            return None
        best = min(range(len(queue)),
                   key=lambda i: (len(queue[i].prompt_tokens),
                                  queue[i].arrival_seq))
        return best if self._affordable(queue[best], state) else None


POLICIES = {"fifo": FIFOPolicy, "priority": PriorityPolicy, "sjf": SJFPolicy}


def resolve_policy(scheduler) -> SchedulerPolicy:
    """``"fifo"|"priority"|"sjf"`` or a ready policy object -> policy."""
    if isinstance(scheduler, str):
        if scheduler not in POLICIES:
            raise ValueError(f"unknown scheduler {scheduler!r}; expected one "
                             f"of {sorted(POLICIES)} or a SchedulerPolicy")
        return POLICIES[scheduler]()
    for method in ("admit", "pick_victim", "budget"):
        if not callable(getattr(scheduler, method, None)):
            raise TypeError(
                f"scheduler object {scheduler!r} does not implement the "
                f"SchedulerPolicy protocol (missing {method}())")
    return scheduler
