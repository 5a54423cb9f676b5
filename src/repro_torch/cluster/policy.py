"""Rebalance policies: when the router moves live requests.

The port of ``repro/cluster/policy.py``. The router applies its policy
once per ``tick``: the policy reads cluster state (replica loads, queue
depths, headroom) and returns ``MigrationPlan``s, which the router
executes through the same ``migrate`` path a manual call uses, so no
state moves by a side channel the metrics do not see. Plans are advisory:
the router re-validates each against its routing table and skips a stale
one (the request finished or moved since).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, List, Protocol, runtime_checkable

if TYPE_CHECKING:                       # pragma: no cover - typing only
    from repro_torch.cluster.router import Router

__all__ = ["MigrationPlan", "RebalancePolicy", "MigrateOnOversubscription"]


@dataclasses.dataclass
class MigrationPlan:
    """One proposed move: request ``rid`` from replica ``src`` to ``dst``."""

    rid: int
    src: str
    dst: str
    reason: str = ""


@runtime_checkable
class RebalancePolicy(Protocol):
    """Strategy interface for ``Router(rebalance=...)``."""

    name: str

    def plan(self, router: "Router") -> List[MigrationPlan]:
        """Propose migrations for the current cluster state."""


class MigrateOnOversubscription:
    """Move queued requests off replicas whose queue exceeds ``max_queue``
    onto compatible peers with admission headroom.

    Only queued entries move (tail first: the head admits next where it
    waits). They hold no resident state, so each handoff is a
    metadata-only ticket. Running entries stay put; ``drain`` moves them
    when a replica must empty.
    """

    name = "oversubscription"

    def __init__(self, max_queue: int = 0):
        if max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {max_queue}")
        self.max_queue = max_queue

    def plan(self, router: "Router") -> List[MigrationPlan]:
        plans: List[MigrationPlan] = []
        claimed: dict = {}              # headroom already promised this round
        for src in router.replicas:
            if src.draining or src.failed:
                continue                # drain() and failover own those moves
            queued = router.queued_rids(src.engine_id)
            excess = len(queued) - self.max_queue
            for rid in reversed(queued):
                if excess <= 0:
                    break
                dst = router.best_target(src, claimed=claimed)
                if dst is None:
                    break               # nowhere compatible has headroom
                plans.append(MigrationPlan(
                    rid=rid, src=src.engine_id, dst=dst.engine_id,
                    reason=f"queue depth {len(queued)} > {self.max_queue}"))
                claimed[dst.engine_id] = claimed.get(dst.engine_id, 0) + 1
                excess -= 1
        return plans
