"""Fault tolerance of the training loop: failure injection, straggler
detection, restart policy (a copy of ``repro/runtime/fault.py``; pure
Python).

The trainer assumes steps *will* fail and hosts *will* straggle.
Mechanisms:

  * ``FaultInjector`` — deterministic failure/jitter schedule used by tests
    and the tail-latency benchmark (the stress-ng analogue of paper §VII-C):
    raises ``InjectedFault`` at chosen steps, adds per-step latency jitter.
  * ``StragglerMonitor`` — per-step EWMA of step wall time; a step slower
    than ``threshold``x the EWMA is flagged. On real multi-host deployments
    the flagged host is the restart/re-mesh candidate; here it feeds the
    tail-latency statistics and the elastic-re-mesh decision in the trainer.
  * ``RestartPolicy`` — bounded restarts with exponential backoff.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence


class InjectedFault(RuntimeError):
    """A simulated host/step failure."""


@dataclasses.dataclass
class FaultInjector:
    """Deterministic fault schedule: fail at given steps, jitter others.

    ``fail_steps``: steps that raise (once each — a restart passes them).
    ``jitter_ms``: (step % len) -> extra milliseconds of sleep, the memory-
    pressure stand-in for the paper's fully-loaded-system runs.
    """

    fail_steps: Sequence[int] = ()
    jitter_ms: Sequence[float] = ()
    _fired: set = dataclasses.field(default_factory=set)

    def before_step(self, step: int) -> None:
        if step in self.fail_steps and step not in self._fired:
            self._fired.add(step)
            raise InjectedFault(f"injected failure at step {step}")
        if self.jitter_ms:
            d = self.jitter_ms[step % len(self.jitter_ms)]
            if d > 0:
                time.sleep(d / 1e3)


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time outlier detection (per-host in multi-process runs)."""

    alpha: float = 0.1
    threshold: float = 3.0
    warmup: int = 5
    ewma: Optional[float] = None
    count: int = 0
    history: List[float] = dataclasses.field(default_factory=list)
    flagged: List[int] = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt_s: float) -> bool:
        """Record one step time; returns True when flagged as straggler."""
        self.history.append(dt_s)
        self.count += 1
        if self.ewma is None:
            self.ewma = dt_s
            return False
        is_straggler = (self.count > self.warmup
                        and dt_s > self.threshold * self.ewma)
        if is_straggler:
            self.flagged.append(step)
        else:  # stragglers don't poison the running mean
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt_s
        return is_straggler

    def percentile(self, q: float) -> float:
        if not self.history:
            return 0.0
        xs = sorted(self.history)
        i = min(len(xs) - 1, max(0, int(q / 100.0 * len(xs))))
        return xs[i]

    def tail_spread(self, tail_q: float = 99.9) -> float:
        """(tail - median) / median — Eq. (1) of the paper."""
        med = self.percentile(50.0)
        if med <= 0:
            return 0.0
        return (self.percentile(tail_q) - med) / med


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 3
    backoff_s: float = 0.0
    restarts: int = 0

    def on_failure(self, err: BaseException) -> bool:
        """True => restart; False => give up (re-raise)."""
        if self.restarts >= self.max_restarts:
            return False
        self.restarts += 1
        if self.backoff_s:
            time.sleep(self.backoff_s * (2 ** (self.restarts - 1)))
        return True


@dataclasses.dataclass
class StepStats:
    """Aggregated per-run statistics the trainer returns."""

    steps: int = 0
    restarts: int = 0
    stragglers: int = 0
    p50_s: float = 0.0
    p999_s: float = 0.0
    tail_spread: float = 0.0
    final_metrics: Dict[str, float] = dataclasses.field(default_factory=dict)
