"""``fabric.graph`` executor: round-based runs of a compiled GraphSpec.

The port of ``repro/fabric/graph/executor.py``. A ``GraphRun`` advances a
validated spec one **round** at a time: every node fires once per round in
the spec's topological order, each firing being one *node invocation*,
the scheduling unit the engine and router tiers admit beside raw requests
(``Engine.submit_graph`` advances each active run by one round per tick).
Node outputs are published under the node's own name (they *are* the
state) and, when a fabric is attached, each output is also installed as
a warm lease (``graph/<gid>/<node>``) on the port's ``fabric.leases``, so
downstream consumers re-read it through ``fabric.lease`` instead of
re-shipping it per edge, and placement tiers can score co-residency
(``TransportEstimate.affinity_bytes``).

Iterative graphs (decode loops) pass ``loop_until``: the run repeats
rounds until the predicate over the values dict holds. ``GraphHandle`` is
the client-side view: ``tokens()`` streams whatever the spec's ``emits``
nodes produce, driving the owning engine's ``tick()`` with the stall
bound of ``RequestHandle.tokens()``.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import (Any, Callable, Dict, Iterator, List, Mapping, Optional,
                    Tuple)

from repro_torch.fabric.graph.spec import GraphSpec, Node

__all__ = ["NodeInvocation", "GraphRun", "GraphHandle", "edge_lease_name"]

_gids = itertools.count()


def edge_lease_name(gid: int, node: str) -> str:
    """Lease name under which node ``node`` of run ``gid`` publishes its
    output — one namespace shared by the executor, the router's edge
    shipper, and the affinity scorer."""
    return f"graph/{gid}/{node}"


@dataclasses.dataclass
class NodeInvocation:
    """Record of one node firing — the graph tier's placement log entry,
    surfaced (as dicts) through engine/router metrics."""

    round: int
    node: str
    placement: str
    status: str = "ok"                  # "ok" | "error"
    engine_id: Optional[str] = None
    detail: str = ""

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class GraphRun:
    """One in-flight execution of a ``GraphSpec``.

    ``resolve`` maps a node to the callable that executes it; the default
    runs ``node.fn`` directly when callable and otherwise treats it as a
    registered fabric function name (``fabric.call(fn, args,
    placement=node.placement)``). Orchestrators (the router's
    cross-replica mode) pre-bind callables and stamp per-node sites via
    ``record_site`` so invocation records carry real engine ids.
    """

    def __init__(self, spec: GraphSpec, inputs: Mapping[str, Any], *,
                 fabric=None, gid: Optional[int] = None,
                 resolve: Optional[Callable[[Node], Callable[..., Any]]]
                 = None,
                 loop_until: Optional[Callable[[Dict[str, Any]], bool]]
                 = None,
                 max_rounds: int = 256,
                 on_node_error: Optional[
                     Callable[[Node, BaseException], bool]] = None):
        spec.validate_inputs(inputs)
        self.spec = spec
        self.gid = next(_gids) if gid is None else gid
        self.fabric = fabric
        self.values: Dict[str, Any] = dict(inputs)
        self.loop_until = loop_until
        self.max_rounds = max_rounds
        self.on_node_error = on_node_error
        self._resolve = resolve
        self.round = 0
        self.done = False
        self.invocations: List[NodeInvocation] = []
        self._sites: Dict[str, Dict[str, Any]] = {}
        self._edge_state: Dict[str, Tuple[Any, ...]] = {}
        self.handle = GraphHandle(self)

    # -- orchestrator hooks -------------------------------------------------

    def record_site(self, node: str, *, engine_id: Optional[str] = None,
                    placement: Optional[str] = None) -> None:
        """Stamp where the next invocation of ``node`` actually runs; the
        executor merges it into that node's invocation records."""
        self._sites[node] = {"engine_id": engine_id, "placement": placement}

    # -- edge values --------------------------------------------------------

    def edge_value(self, name: str) -> Any:
        """Resolve one wire: graph inputs from the bound values, node
        outputs through their fabric lease (a warm hit — residency, not a
        re-ship; the lease counters in ``fabric.metrics()`` are the
        edge-traffic telemetry)."""
        if name in self._edge_state and self.fabric is not None:
            state = self._edge_state[name]
            return self.fabric.lease(edge_lease_name(self.gid, name),
                                     state)[0]
        return self.values[name]

    def _publish(self, node: Node, value: Any) -> None:
        self.values[node.name] = value
        state = (value,)
        self._edge_state[node.name] = state
        if self.fabric is not None:
            self.fabric.lease(edge_lease_name(self.gid, node.name), state)

    # -- execution ----------------------------------------------------------

    def _runner(self, node: Node) -> Callable[..., Any]:
        if self._resolve is not None:
            bound = self._resolve(node)
            if bound is not None:
                return bound
        if callable(node.fn):
            return node.fn
        if self.fabric is None:
            raise RuntimeError(
                f"graph {self.spec.name!r}: node {node.name!r} names the "
                f"fabric function {node.fn!r} but the run has no fabric")
        return lambda *args: self.fabric.call(node.fn, args,
                                              placement=node.placement)

    def _invoke(self, node: Node) -> None:
        def rec_for() -> NodeInvocation:
            # sites are stamped *inside* bound callables (the router path
            # decides placement mid-invocation), so read them afterwards
            site = self._sites.get(node.name, {})
            return NodeInvocation(
                round=self.round, node=node.name,
                placement=site.get("placement") or node.placement,
                engine_id=site.get("engine_id"))
        try:
            args = [self.edge_value(src) for src in node.inputs]
            out = self._runner(node)(*args)
        except BaseException as exc:
            rec = rec_for()
            rec.status = "error"
            rec.detail = f"{type(exc).__name__}: {exc}"
            self.invocations.append(rec)
            if self.on_node_error is not None \
                    and self.on_node_error(node, exc):
                return self._invoke(node)       # recovered: re-fire
            raise
        rec = rec_for()
        self.invocations.append(rec)
        self._sites.pop(node.name, None)
        self._publish(node, out)
        if node.emits is not None:
            if not isinstance(out, Mapping) or node.emits not in out:
                raise TypeError(
                    f"graph {self.spec.name!r}: node {node.name!r} "
                    f"declares emits={node.emits!r} but returned "
                    f"{type(out).__name__} without that key")
            for tok in out[node.emits]:
                self.handle._push(int(tok))

    def advance(self) -> int:
        """Run one round — every node once, topo order. Returns the
        number of node invocations; marks the run done when the loop
        predicate holds (or after the single round, for loop-free
        graphs). ``max_rounds`` bounds runaway predicates loudly."""
        if self.done:
            return 0
        node_map = self.spec.node_map
        fired = 0
        for name in self.spec.order:
            self._invoke(node_map[name])
            fired += 1
        self.round += 1
        if self.loop_until is None or bool(self.loop_until(self.values)):
            self.done = True
            self.handle._finish()
        elif self.round >= self.max_rounds:
            raise RuntimeError(
                f"graph {self.spec.name!r} (gid={self.gid}) exceeded "
                f"max_rounds={self.max_rounds} without satisfying "
                f"loop_until — runaway loop")
        return fired

    def result(self) -> Dict[str, Any]:
        """The declared outputs' final values (run must be done)."""
        if not self.done:
            raise RuntimeError(
                f"graph {self.spec.name!r} (gid={self.gid}) is still "
                f"running (round {self.round}) — drive handle.result() or "
                f"tick the owner until done")
        return {name: self.values[name] for name in self.spec.outputs}

    def metrics(self) -> Dict[str, Any]:
        return {
            "gid": self.gid,
            "graph": self.spec.name,
            "rounds": self.round,
            "done": self.done,
            "node_invocations": len(self.invocations),
            "invocations": [rec.as_dict() for rec in self.invocations],
        }


class GraphHandle:
    """Client-side streaming view of one submitted graph run.

    Mirrors ``RequestHandle``: ``tokens()`` yields emitted tokens as
    rounds produce them, ticking the owner (engine or router) whenever
    nothing new is buffered, with the same stall-bound semantics;
    ``result()`` drives to completion and returns the graph outputs.
    The owner is attached by ``submit_graph``; undriven handles (pure
    ``GraphRun.advance()`` loops) still collect tokens.
    """

    def __init__(self, run: GraphRun):
        self.run = run
        self._owner = None              # has .tick(); set by submit_graph
        self._tokens: List[int] = []
        self._callbacks: List[Callable[[int, int], None]] = []

    @property
    def gid(self) -> int:
        return self.run.gid

    @property
    def done(self) -> bool:
        return self.run.done

    def _bind(self, owner) -> "GraphHandle":
        self._owner = owner
        return self

    def _push(self, tok: int) -> None:
        self._tokens.append(tok)
        i = len(self._tokens) - 1
        for fn in list(self._callbacks):
            fn(tok, i)

    def _finish(self) -> None:
        pass                            # done state lives on the run

    def on_token(self, fn: Callable[[int, int], None]) -> "GraphHandle":
        for i, tok in enumerate(self._tokens):
            fn(tok, i)
        self._callbacks.append(fn)
        return self

    def tokens(self, max_ticks: int = 10_000) -> Iterator[int]:
        """Yield emitted tokens, driving the owner's ``tick()`` when
        nothing new is buffered. ``max_ticks`` is a stall bound (ticks
        without a new token), not a lifetime bound."""
        i = 0
        stalled = 0
        while True:
            if i < len(self._tokens):
                stalled = 0
            while i < len(self._tokens):
                yield self._tokens[i]
                i += 1
            if self.run.done:
                return
            if self._owner is None:
                raise RuntimeError(
                    f"graph {self.run.spec.name!r} (gid={self.run.gid}) "
                    f"has no owner to tick — submit it through "
                    f"Engine.submit_graph or drive GraphRun.advance()")
            if stalled >= max_ticks:
                raise RuntimeError(
                    f"graph {self.run.spec.name!r} (gid={self.run.gid}) "
                    f"made no progress in {max_ticks} ticks "
                    f"(streaming stall bound)")
            self._owner.tick()
            stalled += 1

    def result(self, max_ticks: int = 10_000) -> Dict[str, Any]:
        for _ in self.tokens(max_ticks=max_ticks):
            pass
        return self.run.result()

    def __repr__(self) -> str:
        return (f"GraphHandle(gid={self.run.gid}, "
                f"graph={self.run.spec.name!r}, "
                f"tokens={len(self._tokens)}, done={self.run.done})")
