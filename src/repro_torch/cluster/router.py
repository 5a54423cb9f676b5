"""``Router``: one submit surface over N engine replicas, with live
request migration.

The port of ``repro/cluster/router.py``. The router owns a table
``rid -> engine_id`` and four verbs:

* ``submit(req)`` places the request on one replica via the fabric cost
  model (warm-params-lease bytes first — a replica whose rFaaS lease
  already holds the model serves for free, a cold one charges the weight
  tree) plus per-replica load (queue depth + active slots, then pool
  occupancy), and returns a ``ClusterHandle`` that survives migration.
* ``tick()`` advances every busy replica one engine tick, then applies
  the rebalance policy (``cluster.policy``).
* ``migrate(rid, dst)`` performs a live handoff: export the request's
  sequence state as a ``MigrationTicket``, round-trip it through real
  mailbox frames (``cluster.handoff``: the wire a cross-host fabric
  would DMA), import on the target, and rebind the cluster handle. The
  migrated request resumes with the greedy output it would have had
  without moving (tests/test_torch_cluster.py, per cache backend).
* ``drain(engine_id)`` migrates everything off a replica (shutdown path),
  raising if any request would be stranded.
* ``mark_failed(engine_id)`` — the crash path: recover the dead replica's
  queued + in-flight requests onto compatible peers, from periodic
  sequence-state snapshots (``snapshot_every``) or a prompt +
  delivered-tokens recompute. The per-tick health probe calls it
  automatically; migrations retransmit damaged trains with bounded
  retries and roll back on failure (``repro_torch.faults``).

and the graph tier's three (``repro_torch.fabric.graph``):

* ``place_node`` places one graph-node invocation: ``_place``'s key with
  a locality axis (``TransportEstimate.affinity_bytes``, the upstream edge
  bytes not leased on the candidate) between cold-start bytes and load;
* ``ship_edge`` delivers an edge value to a replica: a warm lease there is
  consumed in place, anything else rides a validated mailbox frame train
  (``fabric.graph.edges``) through the installed fault injector, with the
  handoff's bounded retries;
* ``submit_graph`` queues a graph run that every router tick advances one
  round.

Replicas are heterogeneous: each brings its own device, cache backend and
model tag (replicas may share one card); routing and migration stay within matching (model,
cache_kind): weights differ across models and sequence-state bytes are
only meaningful to their own backend. ``metrics()`` merges the router's
decisions with every replica's ``Engine.metrics()`` (keyed by the
engine's stable ``engine_id``) into one surface.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Union

from repro_torch.cluster.handoff import HANDOFF_SPEC, decode_handoff, encode_handoff
from repro_torch.core.transport import TransportEstimate
from repro_torch.engine.engine import Engine, MigrationTicket, Request
from repro_torch.engine.stream import RequestHandle
from repro_torch.faults.errors import (EngineFailedError, MigrationFailedError,
                                       RequestFailedError)

__all__ = ["Replica", "Router", "ClusterHandle"]


@dataclasses.dataclass
class Replica:
    """One engine behind the router, plus its routing attributes.

    ``model`` tags which weights the engine serves (requests and
    migrations never cross model tags); ``draining`` replicas accept no
    new placements and are emptied by ``Router.drain``; ``failed``
    replicas (health probe or ``Router.mark_failed``) are additionally
    never ticked or targeted again — their requests were recovered onto
    peers or terminally failed."""

    engine: Engine
    model: str = "default"
    draining: bool = False
    failed: bool = False

    @property
    def engine_id(self) -> str:
        return self.engine.engine_id

    @property
    def cache_kind(self) -> str:
        return self.engine.cache_kind

    def free_slots(self) -> int:
        return sum(e is None for e in self.engine.slot_entry)

    def occupancy(self) -> float:
        cap = self.engine.state.capacity()
        if cap.free_units is None:
            used = self.engine.slots - self.free_slots()
            return used / max(1, self.engine.slots)
        return 1.0 - cap.free_units / max(1, cap.total_units)

    def load(self) -> Dict[str, Any]:
        return {"queue_depth": len(self.engine.queue),
                "active": self.engine.slots - self.free_slots(),
                "slots": self.engine.slots,
                "occupancy": self.occupancy()}


class ClusterHandle:
    """Client-side view of one routed request — the migration-transparent
    counterpart of ``engine.stream.RequestHandle``.

    The handle tracks the request *through the router's table*: after a
    migration it is rebound to the target engine's handle, the token
    stream continues from where it was (tickets carry ``out_tokens``, so
    the prefix is preserved verbatim), and callbacks fire exactly once
    per token — the rebind replays nothing a subscriber already saw.
    """

    def __init__(self, router: "Router", rid: int):
        self._router = router
        self.rid = rid
        self._bound: Optional[RequestHandle] = None
        self._callbacks: List[Any] = []
        self._delivered = 0             # cluster-level delivery cursor
        # every token delivered through the cursor, in order — the
        # recovery layer rebuilds a dead replica's request from exactly
        # this stream when no state snapshot exists
        self._tokens: List[int] = []

    @property
    def req(self) -> Request:
        return self._bound.req

    @property
    def done(self) -> bool:
        return self._bound.req.done

    @property
    def engine_id(self) -> str:
        """The replica currently serving (or last to serve) the request."""
        return self._router._table[self.rid]

    def _bind(self, handle: RequestHandle) -> None:
        """(Re)attach to an engine-level handle. The engine handle replays
        all buffered tokens to a new subscriber, so the relay drops
        indices below the cluster-level cursor — after a migration the
        target's replay of the preserved prefix is filtered out and
        subscribers see each index exactly once."""
        self._bound = handle

        def relay(tok: int, i: int) -> None:
            if i < self._delivered:
                return
            self._delivered = i + 1
            self._tokens.append(tok)
            for fn in list(self._callbacks):
                fn(tok, i)

        handle.on_token(relay)

    def on_token(self, fn) -> "ClusterHandle":
        """Register ``fn(token, index)``; already-produced tokens are
        replayed immediately (same contract as the engine handle)."""
        for i, tok in enumerate(self.req.out_tokens):
            fn(tok, i)
        self._callbacks.append(fn)
        return self

    def tokens(self, max_ticks: int = 10_000) -> Iterator[int]:
        """Yield tokens as the *cluster* produces them, driving
        ``router.tick()`` when nothing new is buffered. ``max_ticks`` is
        a stall bound (cluster ticks without progress for this request,
        reset on every token). Migration is invisible here: the generator
        re-reads the currently bound request each round."""
        i = 0
        stalled = 0
        while True:
            self._raise_if_failed()
            out = self.req.out_tokens   # re-read: migration swaps req
            if i < len(out):
                stalled = 0
            while i < len(out):
                yield out[i]
                i += 1
            if self.done:
                return
            if not self._router.pending():
                return
            if stalled >= max_ticks:
                raise RuntimeError(
                    f"request {self.rid} made no progress in {max_ticks} "
                    f"cluster ticks (streaming stall bound)")
            self._router.tick()
            stalled += 1

    def _raise_if_failed(self) -> None:
        """Surface a terminal cluster failure as a typed error instead of
        a silent stall: the reason (replica died with no compatible peer,
        recovery exhausted retransmits, ...) comes straight from the
        router's failed-request registry."""
        reason = self._router.request_failure(self.rid)
        if reason is not None:
            raise RequestFailedError(self.rid, reason)

    def result(self, max_ticks: int = 10_000) -> Request:
        """Drive the cluster until this request completes; return it.
        ``max_ticks`` is the stall bound ``tokens()`` applies. Raises
        ``RequestFailedError`` when the cluster terminally lost the
        request (reason attached)."""
        for _ in self.tokens(max_ticks=max_ticks):
            pass
        if not self.req.done:
            self._raise_if_failed()
            raise RuntimeError(
                f"request {self.rid} vanished from the cluster before "
                f"completing ({len(self.req.out_tokens)} tokens buffered)")
        return self.req

    def __repr__(self) -> str:
        return (f"ClusterHandle(rid={self.rid}, on={self.engine_id}, "
                f"tokens={len(self.req.out_tokens)}, done={self.done})")


class Router:
    """Route requests over replicas; migrate them live when it helps."""

    def __init__(self, replicas: Sequence[Union[Replica, Engine]], *,
                 rebalance=None, name: str = "cluster",
                 max_retries: int = 6, retry_backoff_s: float = 0.001,
                 snapshot_every: int = 0):
        if not replicas:
            raise ValueError("a router needs at least one replica")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        self.name = name
        self.replicas: List[Replica] = [
            r if isinstance(r, Replica) else Replica(r) for r in replicas]
        self._by_id: Dict[str, Replica] = {}
        for r in self.replicas:
            if r.engine_id in self._by_id:
                raise ValueError(
                    f"duplicate engine_id {r.engine_id!r}: give each "
                    f"replica a distinct Engine(engine_id=...)")
            self._by_id[r.engine_id] = r
        self.rebalance = rebalance
        # handoff retry policy: a damaged train is retransmitted up to
        # max_retries times, sleeping retry_backoff_s * 2^attempt between
        # tries (0 disables the sleep — the determinism tests want that)
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        # snapshot cadence: every N router ticks, serialize each routed
        # request's sequence state (Engine.snapshot_request) so failover
        # restores from the last snapshot instead of a full recompute.
        # 0 (default) disables snapshots — failover then rebuilds from
        # prompt + delivered tokens, which is correct but recomputes.
        self.snapshot_every = snapshot_every
        self._table: Dict[int, str] = {}            # rid -> engine_id
        self._handles: Dict[int, ClusterHandle] = {}
        self.placements: List[Dict[str, Any]] = []  # submit decisions
        self.migrations: List[Dict[str, Any]] = []  # executed handoffs
        self.rebalance_events = 0
        self.handoff_frames = 0
        self.handoff_bytes = 0
        # the graph tier: cross-replica node placement and frame-shipped edges
        self._graphs: List[Any] = []
        self._graphs_done: List[Any] = []
        self.graph_invocations = 0
        self.node_placements: List[Dict[str, Any]] = []
        self._edge_anchors: Dict[Any, Any] = {}     # (engine_id, name) -> lease key
        self.edge_frames = 0
        self.edge_bytes = 0
        self.edge_retransmits = 0
        self.edge_local_hits = 0
        # chaos and recovery state
        self.tick_no = 0
        self.faults = None                          # installed FaultInjector
        self._snapshots: Dict[int, MigrationTicket] = {}
        self._failed: Dict[int, str] = {}           # rid -> terminal reason
        self.failures: List[Dict[str, Any]] = []    # replica failure events
        self.faults_detected = 0
        self.retransmits = 0
        self.failovers = 0
        self.requests_recovered = 0
        self.health_probes = 0
        self.snapshots_taken = 0
        self._last_train_frames = 0
        self._last_train_ms = (0.0, 0.0)            # (encode, decode), all attempts

    def replica(self, engine_id: str) -> Optional[Replica]:
        """The replica with this engine_id, or None."""
        return self._by_id.get(engine_id)

    def request_failure(self, rid: int) -> Optional[str]:
        """Terminal failure reason for ``rid``, or None while it lives."""
        return self._failed.get(rid)

    def install_faults(self, injector) -> None:
        """Install a ``repro_torch.faults.FaultInjector``: its ``perturb_train``
        wraps the handoff channel, its ``on_tick`` rides the router clock
        (kills, storm arming), and every replica engine gets its
        ``fault_hook`` armed — no call site changes anywhere."""
        self.faults = injector
        for r in self.replicas:
            r.engine.fault_hook = injector.engine_hook(r.engine)

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------

    def _estimate(self, replica: Replica, req: Request) -> TransportEstimate:
        """Fabric cost model for placing ``req`` on ``replica``: the
        request payload ships either way (local_bytes); a cold replica
        additionally charges injecting the weight tree, a warm params
        lease charges nothing (the rFaaS lease already paid it)."""
        eng = replica.engine
        payload = 4 * (len(req.prompt) + req.max_new_tokens)
        warm = eng.params is not None and eng._lease_warm(eng.params)
        injected = 0 if warm else eng._params_nbytes()
        return TransportEstimate(local_bytes=payload, injected_bytes=injected,
                                 common_bytes=0, chosen="injected" if warm else "local")

    def _place(self, req: Request, model: Optional[str]) -> Replica:
        cands = [r for r in self.replicas if not r.draining and not r.failed
                 and (model is None or r.model == model)]
        if not cands:
            raise ValueError(
                f"no live replica serves model={model!r} (replicas: "
                f"{[(r.engine_id, r.model) for r in self.replicas]})")
        best: Optional[Replica] = None
        best_key = None
        best_est = None
        for r in cands:
            est = self._estimate(r, req)
            load = r.load()
            # lexicographic: cold-start bytes (cost model), then queued +
            # active work, then pool occupancy, then stable id for ties
            key = (est.injected_bytes,
                   load["queue_depth"] + load["active"],
                   load["occupancy"], r.engine_id)
            if best is None or key < best_key:
                best, best_key, best_est = r, key, est
        self.placements.append({
            "rid": req.rid, "engine_id": best.engine_id,
            "model": best.model, "estimate": best_est.describe(),
            "load": best.load()})
        return best

    # -- graph-node placement (locality first, then load) ------------------

    @staticmethod
    def _lease_live(engine: Engine, name: str) -> bool:
        lease = engine.fabric.leases.get(name)
        return bool(lease is not None and lease.live)

    def place_node(self, *, gid: int, node: str, model: str = "default",
                   edges: Sequence = (), exclude=()) -> Replica:
        """Place one graph-node invocation on a replica.

        ``_place``'s lexicographic key with the locality axis between
        cold-start bytes and load: ``affinity_bytes`` sums the wire bytes of
        every upstream edge (``edges`` is a sequence of ``(lease_name,
        nbytes)``) whose lease is *not* live on the candidate's fabric. A
        replica that already holds the node's upstream outputs (the draft
        edge, the verify session's KV) scores 0 and wins before load does,
        which keeps a graph's verify node where its draft output lease
        lives instead of bouncing to the emptiest replica every round.
        Every decision is logged with its ``TransportEstimate`` in
        ``metrics()["router"]["node_placements"]``."""
        cands = [r for r in self.replicas
                 if not r.draining and not r.failed and r.model == model
                 and r.engine_id not in exclude]
        if not cands:
            raise ValueError(
                f"no live replica serves model={model!r} for graph node "
                f"{node!r} (gid={gid}; replicas: "
                f"{[(r.engine_id, r.model) for r in self.replicas]})")
        edges = list(edges)
        payload = sum(int(nb) for _, nb in edges)
        best = best_key = best_est = None
        for r in cands:
            eng = r.engine
            aff = sum(int(nb) for name, nb in edges if not self._lease_live(eng, name))
            warm = eng.params is not None and eng._lease_warm(eng.params)
            est = TransportEstimate(
                local_bytes=payload, injected_bytes=0 if warm else eng._params_nbytes(),
                common_bytes=0, chosen="injected" if warm else "local",
                affinity_bytes=aff)
            load = r.load()
            key = (est.injected_bytes, aff, load["queue_depth"] + load["active"],
                   load["occupancy"], r.engine_id)
            if best is None or key < best_key:
                best, best_key, best_est = r, key, est
        self.node_placements.append({
            "gid": gid, "node": node, "engine_id": best.engine_id,
            "model": best.model, "estimate": best_est.describe(),
            "affinity_bytes": best_est.affinity_bytes, "load": best.load()})
        return best

    def ship_edge(self, replica: Replica, name: str, value):
        """Deliver one graph-edge value to ``replica`` and lease it there.
        A co-resident value (the lease already holds this very array) is
        consumed warm: residency, zero wire bytes. Anything else rides a
        validated mailbox frame train (``fabric.graph.edges``) through the
        installed fault injector, retransmitted like a migration handoff up
        to ``max_retries`` times. Returns the replica-resident value (the
        decoded copy when it shipped)."""
        from repro_torch.fabric.graph.edges import EDGE_SPEC, decode_edge, encode_edge
        fab = replica.engine.fabric
        lease = fab.leases.get(name)
        if (lease is not None and lease.live and len(lease.key) == 1
                and lease.key[0] is value):
            self.edge_local_hits += 1
            return fab.lease(name, lease.key)[0]
        delay = self.retry_backoff_s
        last: Optional[Exception] = None
        for attempt in range(self.max_retries + 1):
            frames = encode_edge(name, value)
            if self.faults is not None:
                frames = self.faults.perturb_train(frames, rid=-(1 + hash(name) % 1000),
                                                   attempt=attempt)
            self.edge_frames += len(frames)
            self.edge_bytes += len(frames) * EDGE_SPEC.total_bytes
            try:
                got_name, decoded = decode_edge(frames)
                if got_name != name:
                    raise ValueError(f"edge train decoded as {got_name!r}, expected {name!r}")
                break
            except ValueError as err:
                self.faults_detected += 1
                last = err
                if attempt < self.max_retries:
                    self.edge_retransmits += 1
                    if delay > 0:
                        time.sleep(delay)
                        delay *= 2
        else:
            raise ValueError(f"edge {name!r} still damaged after {self.max_retries} "
                             f"retransmits: {last}")
        state = (decoded,)
        self._edge_anchors[(replica.engine_id, name)] = state
        fab.lease(name, state)
        return decoded

    def submit_graph(self, spec, inputs, *, loop_until=None, max_rounds: int = 256,
                     resolve=None, on_node_error=None):
        """Queue a ``fabric.graph`` run at the cluster tier; returns its
        streaming ``GraphHandle`` (owner: this router). Each router tick
        advances every active graph one round; the run's node callables
        place themselves each round through ``place_node`` and move edge
        values with ``ship_edge`` (``SpeculativeDecoder`` in router mode is
        the canonical client)."""
        from repro_torch.fabric.graph.executor import GraphRun
        run = GraphRun(spec, inputs, fabric=None, loop_until=loop_until,
                       max_rounds=max_rounds, resolve=resolve, on_node_error=on_node_error)
        self._graphs.append(run)
        return run.handle._bind(self)

    def _tick_graphs(self) -> int:
        fired = 0
        for run in list(self._graphs):
            if not run.done:
                fired += run.advance()
            if run.done:
                self._graphs.remove(run)
                self._graphs_done.append(run)
        self.graph_invocations += fired
        return fired

    def submit(self, req: Request, *,
               model: Optional[str] = None) -> ClusterHandle:
        """Place ``req`` on the best replica (optionally pinned to a
        ``model`` tag); returns a migration-transparent handle. rids must
        be unique cluster-wide — they key the routing table."""
        if req.rid in self._table:
            raise ValueError(f"rid {req.rid} is already routed (to "
                             f"{self._table[req.rid]}); rids must be "
                             f"unique across the cluster")
        replica = self._place(req, model)
        handle = replica.engine.submit(req)
        self._table[req.rid] = replica.engine_id
        ch = ClusterHandle(self, req.rid)
        ch._bind(handle)
        self._handles[req.rid] = ch
        return ch

    # ------------------------------------------------------------------
    # serving loop
    # ------------------------------------------------------------------

    def pending(self) -> bool:
        if any(not run.done for run in self._graphs):
            return True
        return any(r.engine.pending() for r in self.replicas
                   if not r.failed)

    def tick(self) -> int:
        """One cluster round: run the fault plan (if installed) and the
        health probe, tick every live busy replica, take periodic
        sequence-state snapshots, then let the rebalance policy move
        work. Returns rows advanced across all live replicas."""
        self.tick_no += 1
        if self.faults is not None:
            self.faults.on_tick(self, self.tick_no)
        self._probe_health()
        advanced = 0
        for r in self.replicas:
            if r.failed or not r.engine.pending():
                continue
            try:
                advanced += r.engine.tick()
            except EngineFailedError:
                self.mark_failed(r.engine_id,
                                 reason=r.engine.failed_reason
                                 or "died mid-tick")
        self._take_snapshots()
        self._apply_rebalance()
        if self._graphs:
            advanced += self._tick_graphs()
        return advanced

    def _probe_health(self) -> None:
        """Per-tick liveness probe: any replica whose engine has entered
        the failed state is marked failed and its requests recovered
        before this tick's steps run — so a kill between ticks is
        detected at a deterministic point."""
        for r in self.replicas:
            if r.failed:
                continue
            self.health_probes += 1
            if not r.engine.alive:
                self.mark_failed(
                    r.engine_id,
                    reason=r.engine.failed_reason or "health probe: dead")

    def _take_snapshots(self) -> None:
        if not self.snapshot_every or self.tick_no % self.snapshot_every:
            return
        for rid, eid in list(self._table.items()):
            rep = self._by_id[eid]
            ch = self._handles.get(rid)
            if (rep.failed or rid in self._failed
                    or ch is None or ch.done):
                continue
            try:
                self._snapshots[rid] = rep.engine.snapshot_request(rid)
                self.snapshots_taken += 1
            except KeyError:
                # finished (or mid-handoff) since we read the table
                self._snapshots.pop(rid, None)

    def run_until_drained(self, max_ticks: int = 10_000) -> List[Request]:
        """Tick until every replica drains; returns completed requests in
        completion order (per replica, submit-interleaved)."""
        ticks = 0
        while self.pending() and ticks < max_ticks:
            self.tick()
            ticks += 1
        return [req for r in self.replicas for req in r.engine.completed]

    def _apply_rebalance(self) -> None:
        if self.rebalance is None:
            return
        plans = self.rebalance.plan(self)
        executed = 0
        for p in plans:
            # re-validate against the table: the plan is advisory
            if self._table.get(p.rid) != p.src:
                continue
            handle = self._handles.get(p.rid)
            if handle is not None and handle.done:
                continue
            try:
                self.migrate(p.rid, p.dst,
                             reason=p.reason or self.rebalance.name)
            except MigrationFailedError:
                # rolled back onto the source; the policy may retry on a
                # later round — noisy-network rebalancing is best-effort
                continue
            executed += 1
        if executed:
            self.rebalance_events += 1

    # ------------------------------------------------------------------
    # migration + drain
    # ------------------------------------------------------------------

    def compatible_targets(self, src: Replica) -> List[Replica]:
        """Every live replica a request on ``src`` could migrate to (same
        model tag and cache backend), regardless of current headroom."""
        return [r for r in self.replicas
                if r is not src and not r.draining and not r.failed
                and r.model == src.model and r.cache_kind == src.cache_kind]

    def best_target(self, src: Replica, *,
                    claimed: Optional[Dict[str, int]] = None
                    ) -> Optional[Replica]:
        """The compatible replica with the most admission headroom (free
        slots beyond its own queue, minus headroom ``claimed`` by plans
        earlier in the same round); None when nobody can take more."""
        claimed = claimed or {}
        best, best_key = None, None
        for r in self.replicas:
            if r is src or r.draining or r.failed:
                continue
            if r.model != src.model or r.cache_kind != src.cache_kind:
                continue
            head = (r.free_slots() - len(r.engine.queue)
                    - claimed.get(r.engine_id, 0))
            if head <= 0:
                continue
            key = (head, -r.occupancy(), r.engine_id)
            if best is None or key > best_key:
                best, best_key = r, key
        return best

    def queued_rids(self, engine_id: str) -> List[int]:
        """rids queued (not running) on a replica, queue order."""
        return [e.req.rid for e in self._by_id[engine_id].engine.queue]

    def _transmit(self, ticket: MigrationTicket, *,
                  rid: int) -> MigrationTicket:
        """Phase one of a handoff: push the ticket's frame train through
        the (possibly noisy) channel until it validates. Each attempt
        re-encodes from the ticket, passes through the installed fault
        injector (if any), and is charged to the wire counters; a train
        that fails ``decode_handoff`` counts as a detected fault and is
        retransmitted with exponential backoff, up to ``max_retries``
        times. Raises ``ValueError`` once retries are exhausted — the
        caller decides what rollback means."""
        delay = self.retry_backoff_s
        last: Optional[Exception] = None
        encode_s = decode_s = 0.0
        for attempt in range(self.max_retries + 1):
            t0 = time.perf_counter()
            frames = encode_handoff(ticket)
            encode_s += time.perf_counter() - t0
            self._last_train_frames = len(frames)
            if self.faults is not None:
                frames = self.faults.perturb_train(frames, rid=rid,
                                                   attempt=attempt)
            self.handoff_frames += len(frames)
            self.handoff_bytes += len(frames) * HANDOFF_SPEC.total_bytes
            t0 = time.perf_counter()
            try:
                arrived = decode_handoff(frames)
                self._last_train_ms = (encode_s * 1e3, (decode_s + time.perf_counter() - t0) * 1e3)
                return arrived
            except ValueError as err:
                decode_s += time.perf_counter() - t0
                self.faults_detected += 1
                last = err
                if attempt < self.max_retries:
                    self.retransmits += 1
                    if delay > 0:
                        time.sleep(delay)
                        delay *= 2
        raise ValueError(
            f"handoff of rid {rid} still damaged after {self.max_retries} "
            f"retransmits: {last}")

    def migrate(self, rid: int, dst_id: str, *,
                reason: str = "manual") -> ClusterHandle:
        """Live-migrate ``rid`` to replica ``dst_id`` — a two-phase,
        retryable protocol: export the ticket, retransmit its frame train
        until it validates (``_transmit``), import on the destination,
        and only then update the routing table and rebind the handle
        (the destination's successful ``import_request`` is the ack that
        releases the source). Any failure after export — retries
        exhausted, import rejected — rolls the ticket back onto the
        source and raises ``MigrationFailedError``: a failed migration
        never loses or duplicates a request. Raises ``KeyError`` /
        ``ValueError`` for unknown rids/replicas, incompatible targets
        (model or cache_kind mismatch), and self-migration — all checked
        before export, so those leave the request untouched. The handoff
        lands in ``migrations`` with its host times in ms: ``export_ms``
        (the state serialized and copied off the device), ``encode_ms`` and
        ``decode_ms`` (over every attempt), ``import_ms`` (queueing on the
        target; the state is restored when the target admits it)."""
        if rid not in self._table:
            raise KeyError(f"rid {rid} is not routed on this cluster")
        src_id = self._table[rid]
        if dst_id == src_id:
            raise ValueError(f"rid {rid} already lives on {dst_id}")
        if dst_id not in self._by_id:
            raise KeyError(f"unknown replica {dst_id!r} (have "
                           f"{sorted(self._by_id)})")
        src, dst = self._by_id[src_id], self._by_id[dst_id]
        if dst.model != src.model:
            raise ValueError(
                f"cannot migrate rid {rid} from {src_id} (model="
                f"{src.model!r}) to {dst_id} (model={dst.model!r}): "
                f"replicas serve different weights")
        if dst.cache_kind != src.cache_kind:
            # checked before export: discovering this at import would have
            # already destroyed the request on the source
            raise ValueError(
                f"cannot migrate rid {rid} from {src_id} (cache_kind="
                f"{src.cache_kind!r}) to {dst_id} (cache_kind="
                f"{dst.cache_kind!r}): sequence-state bytes are only "
                f"meaningful to their own backend")
        t0 = time.perf_counter()
        ticket = src.engine.export_request(rid)
        export_ms = (time.perf_counter() - t0) * 1e3
        retransmits_before = self.retransmits
        try:
            arrived = self._transmit(ticket, rid=rid)
            t0 = time.perf_counter()
            handle = dst.engine.import_request(arrived)
            import_ms = (time.perf_counter() - t0) * 1e3
        except (ValueError, EngineFailedError) as err:
            # two-phase abort: the destination never acked, so the ticket
            # re-imports on the source verbatim — the request requeues
            # there exactly as it was exported, lost nowhere, held once
            try:
                rollback = src.engine.import_request(ticket)
            except EngineFailedError:
                # source died mid-migration; leave the rid routed to it —
                # the failover path recovers it like any other
                raise MigrationFailedError(
                    rid, f"{err} — and the source {src_id} died before "
                    f"rollback", rolled_back=False) from err
            ch = self._handles.get(rid)
            if ch is not None:
                ch._bind(rollback)
            raise MigrationFailedError(rid, str(err)) from err
        self._table[rid] = dst_id
        ch = self._handles.get(rid)
        if ch is not None:
            ch._bind(handle)
        self.migrations.append({
            "rid": rid, "src": src_id, "dst": dst_id, "pos": ticket.pos,
            "state_bytes": len(ticket.state) if ticket.state else 0,
            "frames": self._last_train_frames,
            "retransmits": self.retransmits - retransmits_before,
            "reason": reason, "export_ms": export_ms, "encode_ms": self._last_train_ms[0],
            "decode_ms": self._last_train_ms[1], "import_ms": import_ms})
        return ch if ch is not None else ClusterHandle(self, rid)

    def _spill_target(self, src: Replica) -> Optional[Replica]:
        """Where drain/failover sends a request: a compatible peer with
        admission headroom when one exists, else the least-loaded
        compatible replica's queue (evacuation beats queueing
        discipline), else None."""
        dst = self.best_target(src)
        if dst is None:
            cands = self.compatible_targets(src)
            dst = min(cands,
                      key=lambda r: (len(r.engine.queue)
                                     - r.free_slots(), r.engine_id),
                      default=None)
        return dst

    def drain(self, engine_id: str) -> List[int]:
        """Shutdown path: stop placing on ``engine_id`` and migrate every
        unfinished request it holds to compatible peers. Transactional
        per request: a rid with no target, or whose migration fails
        (import rejected, retries exhausted), stays queued on the source
        — ``migrate`` rolls it back — and drain moves on to the next rid,
        so a mid-drain failure never destroys a request or leaves the
        routing table half-updated. Raises (after moving what it can)
        when any rid was stranded; the replica stays marked draining
        either way."""
        rep = self._by_id[engine_id]    # KeyError for unknown ids
        rep.draining = True
        rids = [e.req.rid for e in rep.engine.queue]
        rids += [e.req.rid for e in rep.engine.slot_entry if e is not None]
        moved, stranded = [], []
        for rid in rids:
            dst = self._spill_target(rep)
            if dst is None:
                stranded.append(rid)
                continue
            try:
                self.migrate(rid, dst.engine_id, reason="drain")
            except MigrationFailedError:
                # rolled back: still queued on the source, table unchanged
                stranded.append(rid)
                continue
            moved.append(rid)
        if stranded:
            raise RuntimeError(
                f"drain of {engine_id} stranded rids {stranded}: no "
                f"compatible replica (model={rep.model!r}, cache_kind="
                f"{rep.cache_kind!r}) exists; moved {moved} first")
        return moved

    # ------------------------------------------------------------------
    # failure detection + failover
    # ------------------------------------------------------------------

    def _fail_request(self, rid: int, reason: str) -> None:
        self._failed[rid] = reason
        self._snapshots.pop(rid, None)

    def _recovery_ticket(self, rid: int,
                         rep: Replica) -> Optional[MigrationTicket]:
        """Rebuild a dead replica's request as a ticket: the last periodic
        snapshot when one exists (restore + regenerate the few tokens
        since), else prompt + delivered tokens with no state (full
        recompute on the peer). Greedy decoding is deterministic and
        position-invariant, so either road reproduces the undisturbed
        output bitwise; the ClusterHandle's delivery cursor filters the
        regenerated prefix so subscribers see each index exactly once."""
        snap = self._snapshots.get(rid)
        if snap is not None:
            return snap
        ch = self._handles.get(rid)
        if ch is None:
            return None
        req = ch.req
        return MigrationTicket(
            rid=rid, cache_kind=rep.cache_kind, priority=req.priority,
            max_new_tokens=req.max_new_tokens,
            prompt=[int(t) for t in req.prompt],
            out_tokens=list(ch._tokens), pos=0, state=None)

    def mark_failed(self, engine_id: str, *,
                    reason: str = "marked failed") -> List[int]:
        """Fail a replica and recover every unfinished request it held
        onto compatible peers. Safe to call on an already-dead engine
        (the health probe does) or a live one (operator action — the
        engine is failed first so it cannot race the recovery). Requests
        with no compatible live peer, or whose recovery train cannot be
        delivered, are terminally failed — recorded per rid, surfaced as
        ``RequestFailedError`` — never silently stalled. Returns the
        recovered rids."""
        rep = self._by_id[engine_id]    # KeyError for unknown ids
        if rep.failed:
            return []
        rep.failed = True
        rep.draining = True
        if rep.engine.alive:
            rep.engine.fail(reason)
        recovered: List[int] = []
        lost: List[int] = []
        for rid, eid in list(self._table.items()):
            if eid != engine_id or rid in self._failed:
                continue
            ch = self._handles.get(rid)
            if ch is not None and ch.done:
                continue
            ticket = self._recovery_ticket(rid, rep)
            if ticket is None:
                continue
            dst = self._spill_target(rep)
            if dst is None:
                self._fail_request(
                    rid, f"replica {engine_id} died ({reason}) and no "
                    f"compatible live replica can recover the request")
                lost.append(rid)
                continue
            retransmits_before = self.retransmits
            try:
                arrived = self._transmit(ticket, rid=rid)
                handle = dst.engine.import_request(arrived)
            except (ValueError, EngineFailedError) as err:
                self._fail_request(
                    rid, f"recovery from dead replica {engine_id} "
                    f"failed: {err}")
                lost.append(rid)
                continue
            self._table[rid] = dst.engine_id
            if ch is not None:
                ch._bind(handle)
            self.requests_recovered += 1
            recovered.append(rid)
            self.migrations.append({
                "rid": rid, "src": engine_id, "dst": dst.engine_id,
                "pos": ticket.pos,
                "state_bytes": len(ticket.state) if ticket.state else 0,
                "frames": self._last_train_frames,
                "retransmits": self.retransmits - retransmits_before,
                "reason": f"failover ({reason})", "encode_ms": self._last_train_ms[0],
                "decode_ms": self._last_train_ms[1]})
        self.failovers += 1
        self.failures.append({
            "engine_id": engine_id, "tick": self.tick_no, "reason": reason,
            "recovered": list(recovered), "lost": list(lost)})
        return recovered

    # ------------------------------------------------------------------
    # telemetry — one merged surface
    # ------------------------------------------------------------------

    def metrics(self) -> Dict[str, Any]:
        """Cluster + router + per-replica telemetry, one JSON-friendly
        dict. Replica blocks are the engines' own ``metrics()`` keyed by
        their stable ``engine_id``; totals aggregate across them. A router
        that ran graphs adds ``graphs`` first, with the engine's schema."""
        replicas = {r.engine_id: r.engine.metrics() for r in self.replicas}
        totals = {
            "completed": sum(m["completed"] for m in replicas.values()),
            "preemptions": sum(m["preemptions"] for m in replicas.values()),
            "queued": sum(m["queued"] for m in replicas.values()),
            "active_slots": sum(m["active_slots"]
                                for m in replicas.values()),
            "migrations": len(self.migrations),
        }
        out: Dict[str, Any] = {}
        if self._graphs or self._graphs_done:
            out["graphs"] = {
                "active": sum(1 for g in self._graphs if not g.done),
                "completed": len(self._graphs_done),
                "node_invocations": self.graph_invocations,
                "runs": [g.metrics() for g in (*self._graphs, *self._graphs_done)],
            }
        out.update({
            "cluster": {
                "name": self.name,
                "replicas": [
                    {"engine_id": r.engine_id, "model": r.model,
                     "cache": r.cache_kind, "draining": r.draining,
                     "failed": r.failed, **r.load()}
                    for r in self.replicas],
                "rebalance": getattr(self.rebalance, "name", None),
            },
            "router": {
                "placements": list(self.placements),
                "migrations": list(self.migrations),
                "rebalance_events": self.rebalance_events,
                "handoff_frames": self.handoff_frames,
                "handoff_bytes": self.handoff_bytes,
                "node_placements": list(self.node_placements),
                "edge_frames": self.edge_frames,
                "edge_bytes": self.edge_bytes,
                "edge_retransmits": self.edge_retransmits,
                "edge_local_hits": self.edge_local_hits,
            },
            "faults": {
                "installed": self.faults is not None,
                "injected": (self.faults.metrics() if self.faults is not None
                             else {"injected": 0, "by_kind": {},
                                   "events": 0}),
                "detected": self.faults_detected,
                "retransmits": self.retransmits,
                "failovers": self.failovers,
                "requests_recovered": self.requests_recovered,
                "requests_failed": dict(self._failed),
                "failures": list(self.failures),
                "health_probes": self.health_probes,
                "snapshots_taken": self.snapshots_taken,
                "lease_fallbacks": sum(r.engine.lease_fallbacks
                                       for r in self.replicas),
            },
            "replicas": replicas,
            "totals": totals,
        })
        return out
