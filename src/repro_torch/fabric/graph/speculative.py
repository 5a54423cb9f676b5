"""Draft -> verify speculative decoding: the first served graph.

The port of ``repro/fabric/graph/speculative.py``. Two nodes wired by
name, served as a ``fabric.graph`` DAG:

* **draft** consumes the prompt edge and proposes ``k`` candidate tokens:
  either a *model* draft (a second engine drafting greedily through its
  own ``DecodeSession``) or an *ngram* draft (prompt lookup: the longest
  recent suffix match in the known sequence proposes its historical
  continuation; no second model at all);
* **verify** consumes the prompt and draft edges and feeds
  ``[known[-1], c_1..c_k]`` through the target engine's verify step
  (``emit="all"``, the chunked-prefill shape), accepting the longest
  prefix where each candidate equals the target's own greedy choice, plus
  the target's bonus token.

Every emitted token is the target's greedy token *by construction*, so
speculation is output-neutral against target-only greedy decode; what it
buys is fewer target steps per emitted token (each verify step covers up
to ``k + 1`` tokens).

``SpeculativeDecoder`` orchestrates one engine pair (engine mode) or a
router tier (router mode): per-round node placement through
``Router.place_node`` (affinity-scored: the verify node lands where its
draft edge and KV leases live), draft -> verify edges shipped as mailbox
frame trains (``fabric.graph.edges``) when they cross replicas, and
verify-node failover on ``EngineFailedError``: a dead replica's session is
rebuilt elsewhere from the known tokens, recompute-style, with the output
stream unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.faults.errors import EngineFailedError
from repro_torch.fabric.graph.edges import edge_nbytes
from repro_torch.fabric.graph.executor import GraphHandle, edge_lease_name
from repro_torch.fabric.graph.session import DecodeSession
from repro_torch.fabric.graph.spec import GraphSpec, Node, TensorSpec

__all__ = ["NgramDraft", "draft_verify_spec", "SpeculativeDecoder"]


class NgramDraft:
    """Prompt-lookup draft: propose the continuation that followed the
    longest (up to ``max_ngram``) most recent earlier occurrence of the
    current suffix. Deterministic, model-free, and strong exactly where
    greedy decode repeats itself (cycles, copied spans, templated
    text) — the classic prompt-lookup-decoding trick."""

    name = "ngram"

    def __init__(self, max_ngram: int = 3):
        if max_ngram < 1:
            raise ValueError(f"max_ngram must be >= 1, got {max_ngram}")
        self.max_ngram = max_ngram

    def propose(self, known: List[int], k: int) -> List[int]:
        """Exactly ``k`` candidates (padded by repeating the last guess
        so the verify chunk keeps one fixed shape)."""
        for n in range(min(self.max_ngram, len(known) - 1), 0, -1):
            suffix = known[-n:]
            for i in range(len(known) - n - 1, -1, -1):
                if known[i:i + n] == suffix:
                    cont = known[i + n:i + n + k]
                    if cont:
                        cont = cont + [cont[-1]] * (k - len(cont))
                        return [int(t) for t in cont[:k]]
        return [int(known[-1])] * k


def draft_verify_spec(name: str = "draft_verify", *,
                      draft_fn, verify_fn) -> GraphSpec:
    """The two-node speculation DAG. The draft→verify edge carries the
    candidate run as int32 — declared on both ends, so a mis-typed
    drafter is rejected at build time, never at trace time."""
    cand_spec = TensorSpec((None,), "int32")
    nodes = (
        Node("draft", draft_fn, inputs=("prompt",), out_spec=cand_spec),
        Node("verify", verify_fn, inputs=("prompt", "draft"),
             in_specs={"draft": cand_spec}, emits="emitted"),
    )
    return GraphSpec.build(name, nodes, inputs=("prompt",),
                           outputs=("verify",))


@dataclasses.dataclass
class SpecStats:
    """Per-request speculation telemetry (the bench/metrics schema)."""

    rounds: int = 0
    emitted: int = 0
    proposed: int = 0
    accepted: int = 0                   # candidates accepted (bonus excluded)
    target_verify_steps: int = 0
    target_prefill_steps: int = 0
    draft_steps: int = 0
    verify_rebuilds: int = 0
    failovers: int = 0

    def as_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["acceptance_rate"] = (self.accepted / self.proposed
                                if self.proposed else 0.0)
        # the headline: target-model steps spent per emitted token,
        # prefill excluded (identical under baseline and speculation)
        d["target_steps_per_token"] = (self.target_verify_steps
                                       / max(1, self.emitted))
        return d


class SpeculativeDecoder:
    """Serve draft/verify speculation over one engine pair or a router.

    Engine mode: ``SpeculativeDecoder(target=eng, draft=draft_eng)``
    (model draft) or ``draft=NgramDraft()`` / ``draft=None`` (ngram).
    Router mode: ``SpeculativeDecoder(router=router,
    target_model="target", draft_model="draft")`` — per-round placement,
    frame-shipped edges, failover.
    """

    def __init__(self, *, target=None, draft=None, router=None,
                 target_model: str = "default",
                 draft_model: Optional[str] = None,
                 k: int = 2, max_ngram: int = 3, max_failovers: int = 2):
        if (target is None) == (router is None):
            raise ValueError(
                "pass exactly one of target= (engine mode) or router=")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.target = target
        self.router = router
        self.target_model = target_model
        self.draft_model = draft_model
        self.k = k
        self.max_failovers = max_failovers
        if draft is None and draft_model is None:
            draft = NgramDraft(max_ngram=max_ngram)
        self.draft = draft              # NgramDraft | draft Engine | None
        chunk = self._target_chunk()
        if k + 1 > chunk:
            raise ValueError(
                f"k={k} needs a {k + 1}-token verify chunk; the target "
                f"engine serves chunk={chunk} (lower k or raise chunk=)")
        self.tasks: List[_SpecTask] = []

    def _target_chunk(self) -> int:
        if self.target is not None:
            return self.target.chunk
        reps = self._replicas(self.target_model)
        if not reps:
            raise ValueError(
                f"router has no replica serving model="
                f"{self.target_model!r}")
        return min(r.engine.chunk for r in reps)

    def _replicas(self, model: str):
        return [r for r in self.router.replicas
                if r.model == model and not r.failed and not r.draining]

    @property
    def draft_mode(self) -> str:
        if isinstance(self.draft, NgramDraft):
            return "ngram"
        return "model"

    def submit(self, prompt, max_new_tokens: int,
               eos_id: Optional[int] = None) -> GraphHandle:
        """Submit one speculated generation; returns the streaming
        ``GraphHandle`` (owner = the engine or router, so pulling tokens
        ticks the serving tier like any request handle would)."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        task = _SpecTask(self, prompt, max_new_tokens, eos_id)
        spec = draft_verify_spec(draft_fn=task.draft_node,
                                 verify_fn=task.verify_node)
        owner = self.target if self.target is not None else self.router
        handle = owner.submit_graph(
            spec, {"prompt": np.asarray(prompt, np.int32)},
            loop_until=lambda values: bool(values["verify"]["done"]))
        task.bind(handle.run)
        self.tasks.append(task)
        return handle

    def metrics(self) -> Dict[str, Any]:
        return {
            "k": self.k,
            "draft": self.draft_mode,
            "mode": "router" if self.router is not None else "engine",
            "requests": [t.stats.as_dict() for t in self.tasks],
        }


class _SpecTask:
    """One request's speculation state: the session pair, the accepted-
    token ledger, and the two node callables the graph executor fires."""

    def __init__(self, dec: SpeculativeDecoder, prompt: List[int],
                 max_new_tokens: int, eos_id: Optional[int]):
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.dec = dec
        self.prompt = prompt
        self.max_new = max_new_tokens
        self.eos_id = eos_id
        self.known = list(prompt)
        self.stats = SpecStats()
        self.run = None
        self.verify_sess: Optional[DecodeSession] = None
        self.draft_sess: Optional[DecodeSession] = None
        self._kv_anchor = (np.asarray([id(self)], np.int64),)
        self._draft_anchor = (np.asarray([id(self) + 1], np.int64),)
        # sequence headroom: known may overshoot prompt+max_new by up to
        # k (overshoot accepted into the session, never emitted)
        need = len(prompt) + max_new_tokens + dec.k + 1
        max_len = (dec.target.max_len if dec.target is not None
                   else min(r.engine.max_len
                            for r in dec._replicas(dec.target_model)))
        if need > max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) + speculation headroom ({dec.k + 1}) "
                f"exceeds max_len={max_len}")

    def bind(self, run) -> None:
        self.run = run

    @property
    def emitted(self) -> int:
        return self.stats.emitted

    # -- placement helpers (router mode) -----------------------------------

    def _kv_edge(self, node: str) -> str:
        return edge_lease_name(self.run.gid, f"{node}.kv")

    def _draft_edge(self) -> str:
        return edge_lease_name(self.run.gid, "draft")

    def _anchor_kv(self, sess: DecodeSession, node: str, anchor) -> None:
        """Publish the session's residency as a lease on its replica —
        the affinity signal that keeps the node sticky there."""
        fab = sess.engine.fabric
        if fab is not None:
            fab.lease(self._kv_edge(node), anchor)

    def _place(self, node: str, model: str, edges, exclude=()):
        return self.dec.router.place_node(
            gid=self.run.gid, node=node, model=model, edges=edges,
            exclude=exclude)

    def _build_session(self, engine, node: str, label: str,
                       anchor) -> DecodeSession:
        sess = DecodeSession(engine, self.known, label=label)
        sess.ensure_ready()
        if node == "verify":
            self.stats.target_prefill_steps += sess.steps
        self._anchor_kv(sess, node, anchor)
        return sess

    def _retire_session(self, sess: Optional[DecodeSession],
                        node: str) -> None:
        if sess is None:
            return
        eng = sess.engine
        try:
            sess.release()
            if eng.fabric is not None:
                eng.fabric.evict(self._kv_edge(node))
        except Exception:
            pass                        # dead replica: nothing to free

    # -- the two graph nodes ------------------------------------------------

    def draft_node(self, prompt) -> np.ndarray:
        dec = self.dec
        k = dec.k
        if dec.draft_mode == "ngram":
            if self.run is not None:
                self.run.record_site(
                    "draft", engine_id="host", placement="local")
            cands = dec.draft.propose(self.known, k)
            return np.asarray(cands, np.int32)
        return self._model_draft(k)

    def _model_draft(self, k: int) -> np.ndarray:
        dec = self.dec
        if dec.router is None:
            if self.draft_sess is None:
                self.draft_sess = self._build_session(
                    dec.draft, "draft", "spec.draft", self._draft_anchor)
            self.run.record_site(
                "draft", engine_id=dec.draft.engine_id,
                placement=self.draft_sess.placement)
            before = self.draft_sess.steps
            cands = self.draft_sess.propose(k)
            self.stats.draft_steps += self.draft_sess.steps - before
            return np.asarray(cands, np.int32)
        # router mode: affinity-placed, failover-rebuilt
        exclude: set = set()
        for _ in range(dec.max_failovers + 1):
            edges = [(self._kv_edge("draft"),
                      max(1, self.draft_sess.kv_bytes())
                      if self.draft_sess is not None else 1)]
            rep = self._place("draft", dec.draft_model, edges, exclude)
            try:
                if (self.draft_sess is None
                        or self.draft_sess.engine is not rep.engine):
                    self._retire_session(self.draft_sess, "draft")
                    self.draft_sess = self._build_session(
                        rep.engine, "draft", "spec.draft",
                        self._draft_anchor)
                self.run.record_site("draft", engine_id=rep.engine_id,
                                     placement=self.draft_sess.placement)
                before = self.draft_sess.steps
                cands = self.draft_sess.propose(k)
                self.stats.draft_steps += self.draft_sess.steps - before
                # publish the candidate run as a lease on the draft
                # replica: a verify node placed co-resident consumes it
                # warm instead of re-shipping the edge
                arr = np.asarray(cands, np.int32)
                if rep.engine.fabric is not None:
                    rep.engine.fabric.lease(self._draft_edge(), (arr,))
                return arr
            except EngineFailedError as exc:
                dec.router.mark_failed(rep.engine_id, reason=str(exc))
                exclude.add(rep.engine_id)
                self.draft_sess = None
                self.stats.failovers += 1
        raise EngineFailedError(
            "draft", f"no live replica serves model={dec.draft_model!r} "
            f"after {dec.max_failovers + 1} attempts")

    def verify_node(self, prompt, cands) -> Dict[str, Any]:
        dec = self.dec
        # keep the producer's array object: lease identity (`is`-keyed)
        # is what lets a co-resident verify consume the edge warm
        cand_arr = np.asarray(cands, np.int32)
        if cand_arr.ndim != 1:          # reshape would break `is`-identity
            cand_arr = cand_arr.reshape(-1)
        cands = [int(c) for c in cand_arr]
        if dec.router is None:
            a, bonus = self._verify_on(dec.target, cands,
                                       site_engine=dec.target.engine_id)
        else:
            a, bonus = self._verify_routed(cand_arr)
        accepted = cands[:a] + [bonus]
        self.stats.rounds += 1
        self.stats.proposed += len(cands)
        self.stats.accepted += a
        # sync the ledger + the draft session's view of the sequence
        self.known.extend(accepted)
        if self.draft_sess is not None:
            self.draft_sess.accept(accepted)
        # emit: never past max_new, never past eos
        remaining = self.max_new - self.stats.emitted
        emitted = accepted[:remaining]
        if self.eos_id is not None and self.eos_id in emitted:
            emitted = emitted[:emitted.index(self.eos_id) + 1]
        self.stats.emitted += len(emitted)
        done = (self.stats.emitted >= self.max_new
                or (self.eos_id is not None and self.eos_id in emitted))
        return {"emitted": emitted, "accepted": a, "bonus": bonus,
                "done": done, "round": self.stats.rounds,
                "seq": list(self.known)}

    def _verify_on(self, engine, cands: List[int], *,
                   site_engine: str,
                   placement: Optional[str] = None) -> tuple:
        if self.verify_sess is None or self.verify_sess.engine is not engine:
            self._retire_session(self.verify_sess, "verify")
            self.verify_sess = self._build_session(
                engine, "verify", "spec.verify", self._kv_anchor)
            if self.stats.rounds:
                self.stats.verify_rebuilds += 1
        self.run.record_site("verify", engine_id=site_engine,
                             placement=placement
                             or self.verify_sess.placement)
        before = self.verify_sess.verify_steps
        a, bonus = self.verify_sess.verify(cands)
        self.stats.target_verify_steps += (self.verify_sess.verify_steps
                                           - before)
        self._anchor_kv(self.verify_sess, "verify", self._kv_anchor)
        return a, bonus

    def _verify_routed(self, cands: List[int]) -> tuple:
        dec = self.dec
        arr = np.asarray(cands, np.int32)
        exclude: set = set()
        for _ in range(dec.max_failovers + 1):
            edges = [(self._draft_edge(), edge_nbytes(arr)),
                     (self._kv_edge("verify"),
                      max(1, self.verify_sess.kv_bytes())
                      if self.verify_sess is not None else 1)]
            rep = self._place("verify", dec.target_model, edges, exclude)
            try:
                # lease-or-ship the draft edge onto the chosen replica:
                # co-resident consumes the warm lease, cross-replica rides
                # a validated mailbox frame train (fabric.graph.edges)
                shipped = dec.router.ship_edge(rep, self._draft_edge(), arr)
                return self._verify_on(
                    rep.engine, [int(c) for c in shipped],
                    site_engine=rep.engine_id)
            except EngineFailedError as exc:
                dec.router.mark_failed(rep.engine_id, reason=str(exc))
                exclude.add(rep.engine_id)
                self.verify_sess = None
                self.stats.failovers += 1
        raise EngineFailedError(
            "verify", f"no live replica serves model="
            f"{dec.target_model!r} after {dec.max_failovers + 1} attempts")
