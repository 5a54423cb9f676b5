"""Streaming request API for ``repro_torch.engine.Engine``.

``engine.submit(req)`` returns a ``RequestHandle`` — the client-side view
of one in-flight request. Clients no longer need ``run_until_drained``:

* ``handle.tokens()`` is a generator yielding tokens **as ticks produce
  them**. Pulling the generator drives ``engine.tick()`` whenever no
  undelivered token is buffered, so a plain ``for tok in handle.tokens()``
  serves the whole engine (all co-scheduled requests advance too — their
  handles simply find their tokens already buffered).
* ``handle.on_token(fn)`` registers a callback invoked as ``fn(token,
  index)`` the moment the engine appends a token — inside ``tick()``,
  whoever is driving it (another handle's generator, ``run_until_drained``,
  or a manual tick loop).
* ``handle.result()`` drives the engine until this request completes and
  returns the finished ``Request``; its ``max_ticks`` is a stall bound
  (ticks without progress, reset on every token), like ``tokens()``.

Tokens stream with tick granularity: a preempted-and-recomputed request
re-emits nothing (generated tokens are kept across preemption), so the
stream each client observes is exactly the request's final
``out_tokens`` — byte-for-byte, under every scheduler policy.
"""
from __future__ import annotations

from typing import Callable, Iterator, List, TYPE_CHECKING

if TYPE_CHECKING:                       # pragma: no cover - typing only
    from repro_torch.engine.engine import Engine, Request

__all__ = ["RequestHandle"]


class RequestHandle:
    """Client-side streaming view of one submitted request."""

    def __init__(self, engine: "Engine", req: "Request"):
        self._engine = engine
        self.req = req
        self._callbacks: List[Callable[[int, int], None]] = []
        self._delivered = 0             # callback cursor into out_tokens

    @property
    def rid(self) -> int:
        return self.req.rid

    @property
    def done(self) -> bool:
        return self.req.done

    def on_token(self, fn: Callable[[int, int], None]) -> "RequestHandle":
        """Register ``fn(token, index)``; returns self for chaining.

        Tokens already produced before registration are replayed to ``fn``
        immediately so late subscribers never miss the head of the stream
        (the engine-side cursor ``_delivered`` already covers them; future
        tokens arrive through ``_pump`` like everyone else's)."""
        for i, tok in enumerate(self.req.out_tokens):
            fn(tok, i)
        self._callbacks.append(fn)
        self._delivered = max(self._delivered, len(self.req.out_tokens))
        return self

    def _pump(self) -> None:
        """Engine-side: deliver newly appended tokens to callbacks.
        Iterates a snapshot so a callback that registers another callback
        mid-delivery cannot double-deliver the in-flight token (on_token's
        replay already covers it)."""
        while self._delivered < len(self.req.out_tokens):
            i = self._delivered
            self._delivered = i + 1
            for fn in list(self._callbacks):
                fn(self.req.out_tokens[i], i)

    def tokens(self, max_ticks: int = 10_000) -> Iterator[int]:
        """Yield this request's tokens as the engine produces them,
        ticking the engine whenever nothing new is buffered. Raises
        ``RuntimeError`` after ``max_ticks`` consecutive engine ticks
        **without progress** (no new token for this request) — a stall
        bound, not a lifetime bound: a slow-but-progressing generation
        (chunked prefill, preemption/recompute churn) streams past any
        total tick count as long as tokens keep arriving."""
        i = 0
        ticked = 0                      # ticks since this request progressed
        while True:
            out = self.req.out_tokens
            if i < len(out):
                ticked = 0              # progress: reset the stall counter
            while i < len(out):
                yield out[i]
                i += 1
            if self.req.done:
                return
            if not self._engine.pending():
                # request vanished without completing (e.g. external reset)
                return
            if ticked >= max_ticks:
                raise RuntimeError(
                    f"request {self.req.rid} made no progress in "
                    f"{max_ticks} engine ticks (streaming stall bound)")
            self._engine.tick()
            ticked += 1

    def result(self, max_ticks: int = 10_000) -> "Request":
        """Drive the engine until this request completes; return it.

        ``max_ticks`` is the same **stall bound** ``tokens()`` applies —
        consecutive ticks without a new token for *this* request, reset on
        every token — not a bound on total ticks, so a long generation
        behind preemption churn completes as long as it keeps moving.
        Raises ``RuntimeError`` if the request leaves this engine without
        completing (exported to another replica, or the engine was reset):
        a silent half-finished ``Request`` would read as a short
        generation. Migration-transparent clients should hold the
        router's cluster handle instead of an engine-level one."""
        for _ in self.tokens(max_ticks=max_ticks):
            pass
        if not self.req.done:
            raise RuntimeError(
                f"request {self.req.rid} left this engine before "
                f"completing ({len(self.req.out_tokens)} tokens buffered) "
                f"— it was migrated or the engine was reset; track "
                f"migrated requests through the cluster-level handle")
        return self.req

    def __repr__(self) -> str:
        return (f"RequestHandle(rid={self.req.rid}, "
                f"tokens={len(self.req.out_tokens)}, done={self.req.done})")
