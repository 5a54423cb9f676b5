"""Typed failure vocabulary of the chaos and recovery layer.

Dependency-free, so every layer imports them without cycles: the engine
raises ``EngineFailedError`` from its guards, the cluster raises
``MigrationFailedError`` (after rolling the request back) and
``RequestFailedError`` (from ``ClusterHandle`` once a request is lost).
All three are ``RuntimeError``s.
"""
from __future__ import annotations

__all__ = ["EngineFailedError", "MigrationFailedError", "RequestFailedError"]


class EngineFailedError(RuntimeError):
    """An Engine is in the failed state (``Engine.fail()`` was called or a
    fault killed it); ticking, submitting and exporting against it are
    refused until ``Engine.restart()``."""

    def __init__(self, engine_id: str, reason: str):
        self.engine_id = engine_id
        self.reason = reason
        super().__init__(f"engine {engine_id} has failed: {reason}")


class MigrationFailedError(RuntimeError):
    """A migration could not be completed.

    ``Router.migrate`` raises it only *after* the two-phase protocol has
    rolled the request back onto the source replica (or, when the source
    itself is dead, left it to the failover path), so catching it never
    means a lost request. ``rolled_back`` records whether the request is
    live again on the source."""

    def __init__(self, rid: int, reason: str, *, rolled_back: bool = True):
        self.rid = rid
        self.reason = reason
        self.rolled_back = rolled_back
        tail = ("request restored on source" if rolled_back
                else "request NOT restored (source dead)")
        super().__init__(f"migration of rid {rid} failed: {reason} ({tail})")


class RequestFailedError(RuntimeError):
    """A request reached a terminal failure in the cluster: its replica
    died with no compatible peer to recover onto, or recovery exhausted
    its retransmits. ``ClusterHandle.tokens()`` / ``result()`` raise it
    instead of stalling; the reason is also in ``Router.metrics()["faults"]
    ["requests_failed"]``."""

    def __init__(self, rid: int, reason: str):
        self.rid = rid
        self.reason = reason
        super().__init__(f"request {rid} failed: {reason}")
