"""``DecodeSession``: a graph node's private decode cursor on an Engine.

The port of ``repro/fabric/graph/session.py``. Graph nodes that wrap a
model (the draft and verify nodes of the speculative graph) need more
than ``Engine.submit`` offers: they append tokens, read the greedy token
at *chosen* positions, and roll the sequence back when a speculation
round rejects candidates. ``DecodeSession`` gives them that **without a
parallel serving stack**: it holds a real ``_Entry`` on the engine's own
block pool, grown through ``Engine._ensure_capacity`` (so session growth
preempts policy-chosen victims exactly like request growth does, and
requests can starve sessions of blocks: one capacity economy), and steps
through the engine's fabric-registered paged step (``engine.paged_step``,
and ``engine.paged_verify`` for a verify: one invocation surface, the same
kernels, the same placement and lease telemetry, the launches counted on
the engine). It keeps the chunked-prefill invariants that make
speculation output-neutral:

* the batch row carries only this session (the other rows have
  ``n_valid = 0``: the fixed step shape already serves idle rows);
* rollback is a **position-cursor reset**: KV rows past ``pos`` are
  masked by the row's end and overwritten by the next append, so
  rejecting speculated tokens costs no copy;
* preemption is the paged backend's own evict-and-recompute
  (``state.evict``): a preempted session re-prefills its accepted prefix
  in chunks.

Step inputs are built on the host and moved to ``engine.device``.
"""
from __future__ import annotations

import itertools
import time
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["DecodeSession"]

# session rids live far above request rids so logs and metrics never collide
_sids = itertools.count(1 << 30)


class DecodeSession:
    """One sequence's decode/verify cursor on a paged engine."""

    def __init__(self, engine, prompt, *, label: str = "graph",
                 placement: Optional[str] = None):
        from repro_torch.engine.engine import Request, _Entry
        if engine.cache_kind != "paged":
            raise ValueError(
                f"DecodeSession needs cache='paged' (position-cursor "
                f"rollback rides the block table); engine "
                f"{engine.engine_id} has cache={engine.cache_kind!r}")
        if engine.params is None:
            raise ValueError(f"engine {engine.engine_id} has no params loaded")
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("DecodeSession needs a non-empty prompt")
        self.engine = engine
        self.label = label
        self.placement = placement or engine.placement
        self.sid = next(_sids)
        req = Request(rid=self.sid, prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=engine.max_len - len(prompt))
        self.entry = _Entry(req=req, submit_time=time.perf_counter(),
                            prompt_tokens=list(prompt))
        self.steps = 0                  # decode/prefill step invocations
        self.verify_steps = 0           # multi-token verify invocations
        self.released = False

    # -- sequence bookkeeping ---------------------------------------------

    @property
    def known(self) -> List[int]:
        """prompt ++ accepted: the tokens this session believes in."""
        return self.entry.seq()

    @property
    def accepted(self) -> List[int]:
        return self.entry.req.out_tokens

    @property
    def pos(self) -> int:
        """Tokens resident (and *valid*) in the paged cache."""
        return self.entry.pos

    def kv_bytes(self) -> int:
        """Resident KV bytes, the session's contribution to a placement
        decision's affinity axis (shipping a session = recompute). The JAX
        package's formula, 4 bytes an element whatever the cache dtype, so
        that placement decisions are the same in both packages."""
        cfg = self.engine.cfg
        attn = cfg.attention
        if attn is None:
            per_tok = 2 * cfg.num_layers * cfg.d_model * 4
        else:
            kv_heads = attn.num_kv_heads or attn.num_heads
            per_tok = 2 * cfg.num_layers * kv_heads * attn.head_dim * 4
        return int(self.entry.pos * per_tok)

    def _check(self) -> None:
        if self.released:
            raise RuntimeError(f"session {self.label}#{self.sid} was released")
        self.engine._check_alive(f"session {self.label} step")

    # -- stepping ----------------------------------------------------------

    def _step(self, tokens: List[int], *, verify: bool = False):
        """One fixed-shape step with only this session's row live.

        Feeds ``tokens`` at positions ``pos..pos+n-1``; returns the last
        fed position's greedy token (decode), or every fed position's
        greedy token (verify, ``emit="all"``: a ``(chunk,)`` row)."""
        eng = self.engine
        n = len(tokens)
        if not 0 < n <= eng.chunk:
            raise ValueError(f"session {self.label}#{self.sid}: {n} tokens per step, "
                             f"chunk={eng.chunk}")
        eng._ensure_capacity(self.entry, self.entry.pos + n)
        toks = np.zeros((eng.slots, eng.chunk), np.int32)
        toks[0, :n] = tokens
        tables = np.full((eng.slots, eng.max_blocks_per_seq), -1, np.int32)
        tables[0, :len(self.entry.blocks)] = self.entry.blocks
        starts = np.zeros((eng.slots,), np.int32)
        starts[0] = self.entry.pos
        n_valid = np.zeros((eng.slots,), np.int32)
        n_valid[0] = n
        args = (toks, tables, starts, n_valid)
        if verify:
            out = eng._verify_call(*args, placement=self.placement)
            self.verify_steps += 1
            row = out[0]                # (chunk,) greedy per fed position
        else:
            out = eng._session_step_call(*args, placement=self.placement)
            self.steps += 1
            row = int(out[0])
        self.entry.pos += n
        return row

    def ensure_ready(self) -> None:
        """Make the session decode-ready: all of ``known`` but the newest
        token resident (``pos == len(known) - 1``), prefilling in chunks
        after construction, preemption or a failover rebuild."""
        self._check()
        known = self.known
        while self.entry.pos < len(known) - 1:
            n = min(self.engine.chunk, len(known) - 1 - self.entry.pos)
            self._step(known[self.entry.pos:self.entry.pos + n])

    def propose(self, k: int) -> List[int]:
        """Greedy-decode ``k`` tokens ahead of ``known`` (the draft node's
        model path). The extension is *speculative*: nothing is accepted;
        ``accept`` later truncates ``pos`` back to the verified prefix."""
        self._check()
        if k < 1:
            raise ValueError(f"propose needs k >= 1, got {k}")
        self.ensure_ready()
        work = list(self.known)
        while len(work) - len(self.known) < k:
            n = min(self.engine.chunk, len(work) - self.entry.pos)
            tok = self._step(work[self.entry.pos:self.entry.pos + n])
            if self.entry.pos == len(work):
                work.append(int(tok))
        return work[len(self.known):]

    def verify(self, candidates: List[int]) -> Tuple[int, int]:
        """One speculation round against ``candidates`` (the verify node's
        model path): feed ``[known[-1], c_1..c_k]`` through the verify
        step, read the greedy token at every position, and accept the
        longest prefix where each candidate equals the target's own greedy
        choice, plus the target's bonus token after it. Returns
        ``(n_accepted, bonus)``; ``accept`` has already extended ``known``
        and rolled ``pos`` back to the valid prefix, so every emitted token
        is the token target-only greedy decode would have produced."""
        self._check()
        k = len(candidates)
        if k < 1:
            raise ValueError("verify needs at least one candidate")
        if k + 1 > self.engine.chunk:
            raise ValueError(
                f"session {self.label}#{self.sid}: k={k} candidates need "
                f"a {k + 1}-token verify chunk, engine chunk="
                f"{self.engine.chunk} (lower k or raise chunk)")
        self.ensure_ready()
        feed = [self.known[-1]] + [int(c) for c in candidates]
        row = self._step(feed, verify=True)
        greedy = [int(t) for t in row[:len(feed)]]
        a = 0
        while a < k and int(candidates[a]) == greedy[a]:
            a += 1
        bonus = greedy[a]
        self.accept([int(c) for c in candidates[:a]] + [bonus])
        return a, bonus

    def accept(self, tokens: List[int]) -> None:
        """Commit ``tokens`` onto ``known`` and truncate ``pos`` to the
        longest prefix of the new ``known`` actually resident: the
        rollback. Cache rows past ``pos`` are dead (masked by the row's
        end, overwritten by the next append), so rejection costs nothing."""
        if not tokens:
            return
        l_old = len(self.known)
        self.entry.req.out_tokens.extend(int(t) for t in tokens)
        self.entry.pos = min(self.entry.pos, l_old + len(tokens) - 1)

    # -- lifecycle ---------------------------------------------------------

    def preempt(self) -> None:
        """Evict this session through the paged backend (blocks back to the
        pool, ``pos = 0``); the next step re-prefills ``known`` in chunks."""
        self._check()
        self.engine.cache = self.engine.state.evict(self.entry, self.engine.cache, 0)
        self.entry.preemptions += 1

    def release(self) -> None:
        """Return the session's blocks to the pool; the session is dead."""
        if not self.released:
            self.engine.state.release(self.entry)
            self.released = True

    def metrics(self) -> dict:
        return {
            "sid": self.sid,
            "label": self.label,
            "engine_id": self.engine.engine_id,
            "known_tokens": len(self.known),
            "accepted_tokens": len(self.accepted),
            "pos": self.entry.pos,
            "steps": self.steps,
            "verify_steps": self.verify_steps,
            "preemptions": self.entry.preemptions,
            "kv_bytes": self.kv_bytes(),
        }
