"""Deterministic chaos: seeded fault plans for the cluster.

The port of ``repro/faults/injector.py``. A ``FaultPlan`` declares what
goes wrong (frame perturbation rate and kinds, replica kills at a router
tick, lease-expiry storms) and a ``FaultInjector`` executes it from one
seed: the same plan and seed perturb the same frames in the same way, with
the same numpy draws in the same order as the JAX injector, which is what
lets a chaos run be held token for token against an undisturbed one.

It installs on a ``Router`` (``perturb_train`` wraps the handoff channel,
``on_tick`` rides the router clock, and every replica engine gets its
``fault_hook``, firing between placement resolution and step execution)
or on a ``Fabric`` (every k-th lease ``acquire`` is preceded by a forced
eviction). Every fault is appended to ``events`` and counted in
``counters``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np

__all__ = ["FaultPlan", "FaultInjector", "FAULT_KINDS"]

FAULT_KINDS = ("drop", "corrupt", "duplicate", "reorder")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Declarative, seedable description of the noise.

    ``frame_fault_rate`` is the probability that a handoff frame is
    perturbed (its kind drawn uniformly from ``fault_kinds``). ``kill_at``
    maps ``engine_id -> router tick``: that engine fails at the start of
    the tick, before any replica steps. ``lease_storm_ticks`` arms the
    engine-side fault hook for those ticks (the params lease is evicted
    between placement resolution and execution); ``lease_storm_every`` is
    the fabric-level variant (evict before every k-th ``acquire``).
    """

    seed: int = 0
    frame_fault_rate: float = 0.0
    fault_kinds: Tuple[str, ...] = FAULT_KINDS
    kill_at: Mapping[str, int] = dataclasses.field(default_factory=dict)
    lease_storm_ticks: Tuple[int, ...] = ()
    lease_storm_every: int = 0

    def __post_init__(self):
        bad = set(self.fault_kinds) - set(FAULT_KINDS)
        if bad:
            raise ValueError(f"unknown fault kinds {sorted(bad)}; choose from {FAULT_KINDS}")
        if not 0.0 <= self.frame_fault_rate <= 1.0:
            raise ValueError(f"frame_fault_rate {self.frame_fault_rate} not in [0, 1]")


class FaultInjector:
    """Executes a ``FaultPlan`` deterministically. Install with
    ``injector.install(router_or_fabric)``."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.rng = np.random.default_rng(plan.seed)
        self.events: List[Dict[str, Any]] = []
        self.counters: Dict[str, int] = {k: 0 for k in FAULT_KINDS}
        self.counters.update(trains_perturbed=0, kills=0, lease_storms=0)
        self._tick = 0                # last router tick seen by on_tick
        self._storm_armed = False
        self._acquires = 0

    # -- installation ------------------------------------------------------

    def install(self, target: Any) -> "FaultInjector":
        """Install on a ``Router`` or a ``Fabric``; returns ``self``."""
        if hasattr(target, "install_faults"):        # Router
            target.install_faults(self)
        elif hasattr(target, "leases"):              # Fabric
            target.leases.fault_hook = self._lease_acquire_hook(target)
        else:
            raise TypeError(f"cannot install faults on {type(target).__name__}: "
                            f"expected a Router or a Fabric")
        return self

    def engine_hook(self, engine: Any):
        """The per-engine ``fault_hook``: while a storm is armed, evict the
        engine's params lease in the window between placement resolution
        and step execution."""
        def hook(step_name: str) -> None:
            if not self._storm_armed:
                return
            lease = getattr(engine, "_params_lease", None)
            if lease and engine.fabric.leases.get(lease) is not None:
                engine.fabric.evict(lease)
                self.record("lease_storm", tick=self._tick, engine=engine.engine_id,
                            step=step_name)
        return hook

    def _lease_acquire_hook(self, fabric: Any):
        every = self.plan.lease_storm_every

        def hook(name: str) -> None:
            self._acquires += 1
            if every and self._acquires % every == 0 and fabric.leases.get(name) is not None:
                fabric.evict(name)
                self.record("lease_storm", acquire=self._acquires, lease=name)
        return hook

    # -- the plan, executed ------------------------------------------------

    def on_tick(self, router: Any, tick: int) -> None:
        """Router clock callback: kill scheduled replicas, arm storms."""
        self._tick = tick
        self._storm_armed = tick in self.plan.lease_storm_ticks
        for engine_id, kill_tick in self.plan.kill_at.items():
            if tick != kill_tick:
                continue
            rep = router.replica(engine_id)
            if rep is None or rep.failed or not rep.engine.alive:
                continue
            rep.engine.fail(f"injected kill at router tick {tick}")
            self.record("kill", tick=tick, engine=engine_id)

    def perturb_train(self, frames: Sequence[np.ndarray], *, rid: int,
                      attempt: int = 0) -> np.ndarray:
        """A (possibly) perturbed copy of a handoff train ``(N, W)`` (or a
        sequence of ``(W,)`` frames), as an ``(N', W)`` int32 array.

        Per frame, with probability ``frame_fault_rate``, one of: ``drop``
        (the frame vanishes), ``corrupt`` (one bit flips), ``duplicate``
        (the frame arrives twice), ``reorder`` (it swaps with its
        predecessor; ``duplicate`` for the first frame). The draws are the
        JAX injector's, frame by frame; the train itself is assembled by
        one gather of row indices. The input is never mutated."""
        train = np.asarray(frames, dtype=np.int32)
        rate = self.plan.frame_fault_rate
        if not rate or not len(train):
            return train
        rows: List[int] = []
        flips: Dict[int, Tuple[int, int]] = {}      # output position -> (word, bit)
        touched = 0
        for i in range(len(train)):
            if self.rng.random() >= rate:
                rows.append(i)
                continue
            kind = self.plan.fault_kinds[int(self.rng.integers(len(self.plan.fault_kinds)))]
            if kind == "reorder" and not rows:
                kind = "duplicate"   # nothing earlier to swap with
            if kind == "corrupt":
                word = int(self.rng.integers(train.shape[1]))
                bit = int(self.rng.integers(32))
                flips[len(rows)] = (word, bit)
                rows.append(i)
            elif kind == "duplicate":
                rows += [i, i]
            elif kind == "reorder":  # swap with the previous frame
                prev = rows.pop()
                rows += [i, prev]
                if len(rows) - 2 in flips:          # a corrupted predecessor moves too
                    flips[len(rows) - 1] = flips.pop(len(rows) - 2)
            touched += 1
            self.counters[kind] += 1
            self.record(kind, tick=self._tick, rid=rid, frame=i, attempt=attempt)
        if touched:
            self.counters["trains_perturbed"] += 1
        out = train[np.asarray(rows, dtype=np.int64)]
        for at, (word, bit) in flips.items():
            out[at].view(np.uint32)[word] ^= np.uint32(1) << np.uint32(bit)
        return out

    # -- telemetry ---------------------------------------------------------

    def record(self, kind: str, **detail: Any) -> None:
        if kind == "kill":
            self.counters["kills"] += 1
        elif kind == "lease_storm":
            self.counters["lease_storms"] += 1
        self.events.append({"kind": kind, **detail})

    @property
    def injected(self) -> int:
        """Individual faults injected, all kinds."""
        return (sum(self.counters[k] for k in FAULT_KINDS)
                + self.counters["kills"] + self.counters["lease_storms"])

    def metrics(self) -> Dict[str, Any]:
        return {"injected": self.injected,
                "by_kind": {k: v for k, v in self.counters.items() if v},
                "events": len(self.events)}
