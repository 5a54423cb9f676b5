"""Transport estimates and process-wide transport telemetry.

The parts of ``repro/core/costmodel.py`` (``TransportEstimate``) and
``repro/core/transport.py`` (``TransportTelemetry``, ``get_telemetry``,
``reset_telemetry``) that ``Fabric.metrics()`` and the Engine's
``placement="auto"`` read; the summary keeps the JAX package's format.
The shard_map seam (``sharded_call``), the MoE transport (which records
builds and decisions here, and whose estimates carry token and capacity
counts) and its weight-gather cache wait for ROADMAP A14, and
``estimate_transport`` (TPU constants) for A15.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Tuple


@dataclasses.dataclass(frozen=True)
class TransportEstimate:
    """Bytes a call would ship under each placement, and the choice."""

    local_bytes: int          # what 'local' ships (the payload)
    injected_bytes: int       # what 'injected' ships (the function state)
    common_bytes: int         # shipped either way
    chosen: str
    affinity_bytes: int = 0   # upstream state not co-resident with the placement

    def describe(self) -> str:
        return (f"local={self.local_bytes/2**20:.2f}MiB "
                f"injected={self.injected_bytes/2**20:.2f}MiB "
                f"common={self.common_bytes/2**20:.2f}MiB "
                f"affinity={self.affinity_bytes/2**20:.2f}MiB "
                f"-> {self.chosen}")


@dataclasses.dataclass
class TransportTelemetry:
    """Process-wide transport counters."""

    builds: Dict[str, int] = dataclasses.field(default_factory=dict)
    decisions: List[Tuple[str, TransportEstimate]] = dataclasses.field(
        default_factory=list)
    gather_hits: int = 0
    gather_misses: int = 0

    def summary(self) -> str:
        builds = " ".join(f"{k}={v}" for k, v in sorted(self.builds.items()))
        modes: Dict[str, int] = {}
        for _, est in self.decisions:
            modes[est.chosen] = modes.get(est.chosen, 0) + 1
        chose = " ".join(f"{k}:{v}" for k, v in sorted(modes.items()))
        return (f"builds[{builds}] auto[{chose or '-'}] "
                f"gather_cache[hit={self.gather_hits} "
                f"miss={self.gather_misses}]")


_TELEMETRY = TransportTelemetry()
_LOCK = threading.Lock()


def get_telemetry() -> TransportTelemetry:
    return _TELEMETRY


def reset_telemetry() -> TransportTelemetry:
    """Zero the counters (tests); returns the fresh object."""
    global _TELEMETRY
    with _LOCK:
        _TELEMETRY = TransportTelemetry()
    return _TELEMETRY
