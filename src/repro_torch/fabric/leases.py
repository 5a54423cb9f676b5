"""rFaaS-style warm-state leases.

The port of ``repro/fabric/leases.py``. A lease names a piece of hot
function state (serialized expert words, a weight tree) and keeps its
materialized form warm across calls, with TTL expiry, eviction and
per-lease counters (``Fabric.metrics()["leases"]``).

* A hit needs the *same* key tensors by ``is``: value-equal copies miss,
  since reusing state across genuinely new tensors would serve stale
  function state.
* Entries hold strong references to their key tensors, so ids cannot be
  recycled while an entry is live.

* ``fault_hook``, when set, is called with the lease name at the top of
  every ``acquire``: the chaos seam through which ``repro_torch.faults``
  forces expiry storms without touching a call site.

(The JAX pool's rules for tracers have no counterpart: PyTorch is eager.)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple


@dataclasses.dataclass
class Lease:
    """One named warm-state entry and its lifetime counters."""

    name: str
    ttl_calls: Optional[int] = None       # None => identity-bound, no TTL
    key: Tuple[Any, ...] = ()             # strong refs to the state tensors
    value: Any = None
    live: bool = False
    calls_used: int = 0                   # calls served by the warm value
    hits: int = 0
    misses: int = 0
    expirations: int = 0                  # TTL expiries (a subset of misses)
    evictions: int = 0                    # evict() drops of a live value

    def counters(self) -> Dict[str, Any]:
        return {"hits": self.hits, "misses": self.misses,
                "expirations": self.expirations,
                "evictions": self.evictions,
                "calls_used": self.calls_used,
                "ttl_calls": self.ttl_calls, "live": self.live}


class LeasePool:
    """Named warm-state pool behind ``Fabric.lease``. ``on_hit`` /
    ``on_miss`` let the fabric mirror lease traffic into the process-wide
    transport telemetry."""

    def __init__(self, on_hit: Optional[Callable[[], None]] = None,
                 on_miss: Optional[Callable[[], None]] = None):
        self._leases: Dict[str, Lease] = {}
        self._on_hit = on_hit or (lambda: None)
        self._on_miss = on_miss or (lambda: None)
        self.fault_hook: Optional[Callable[[str], None]] = None

    def acquire(self, name: str, state: Sequence[Any], *,
                ttl_calls: Optional[int] = None,
                materialize: Optional[Callable[[], Any]] = None) -> Any:
        """Return the warm value for ``name``, materializing on a miss.

        A hit needs a live entry whose key tensors are the tensors of
        ``state`` (``is``) and whose TTL is not spent. ``materialize``
        defaults to returning ``state`` itself (residency counting only).
        ``ttl_calls=N`` expires the lease after N calls served by the warm
        value; the next acquire materializes again.
        """
        if ttl_calls is not None and ttl_calls < 1:
            raise ValueError(f"lease {name!r}: ttl_calls must be >= 1 or "
                             f"None, got {ttl_calls}")
        if self.fault_hook is not None:
            self.fault_hook(name)
        key = tuple(state)
        lease = self._leases.get(name)
        if lease is None:
            lease = self._leases[name] = Lease(name)
        lease.ttl_calls = ttl_calls

        if (lease.live and len(lease.key) == len(key)
                and all(a is b for a, b in zip(lease.key, key))):
            if ttl_calls is not None and lease.calls_used >= ttl_calls:
                lease.live = False            # the warm value served its term
                lease.value = None
                lease.expirations += 1
            else:
                lease.hits += 1
                lease.calls_used += 1
                self._on_hit()
                return lease.value

        lease.misses += 1
        self._on_miss()
        lease.key = key
        lease.value = state if materialize is None else materialize()
        lease.live = True
        lease.calls_used = 1
        return lease.value

    def evict(self, name: str) -> bool:
        """Drop ``name``'s warm value (counters survive). Returns whether a
        live value was released; counted per name (``evictions``)."""
        lease = self._leases.get(name)
        if lease is None or not lease.live:
            return False
        lease.live = False
        lease.value = None
        lease.key = ()
        lease.evictions += 1
        return True

    def get(self, name: str) -> Optional[Lease]:
        return self._leases.get(name)

    def metrics(self) -> Dict[str, Dict[str, Any]]:
        return {name: lease.counters()
                for name, lease in sorted(self._leases.items())}
