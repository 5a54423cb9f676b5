"""``fabric.graph`` spec layer: validated DAGs of fabric functions.

The port of ``repro/fabric/graph/spec.py`` (pure Python, kept as its own
copy: importing the JAX module runs ``repro/fabric/__init__.py``). A
served graph is a DAG of named nodes wired *by name*, hypergraph-style:
a node's inputs name either graph inputs or other nodes, and a node's
output **is** the state under its own name; there is no separate state
schema. ``GraphSpec.build`` compiles the node set once: duplicate names,
dangling edges, cycles, unknown outputs and shape/dtype-mismatched edges
are all rejected **here**, with the JAX package's messages word for word,
never later at serve time. The topological order is the JAX one
(Kahn's algorithm, stable in declaration order).

``TensorSpec.accepts`` reads a torch tensor's dtype as the JAX copy reads
a numpy one (``"int32"``, not ``"torch.int32"``).

The executor (``fabric.graph.executor``) runs a spec round by round; the
engine and router tiers schedule its node invocations and lower its edges
onto fabric leases.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

__all__ = ["GraphValidationError", "TensorSpec", "Node", "GraphSpec"]

_PLACEMENTS = ("local", "injected", "auto")


class GraphValidationError(ValueError):
    """A graph failed ``GraphSpec.build``-time validation. The message
    always names the offending node or edge."""


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape/dtype contract for one edge value. ``None`` dims are
    wildcards (unknown extent, e.g. a variable-length token run)."""

    shape: Tuple[Optional[int], ...]
    dtype: str

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(self.shape))

    def compatible(self, other: "TensorSpec") -> bool:
        if self.dtype != other.dtype:
            return False
        if len(self.shape) != len(other.shape):
            return False
        return all(a is None or b is None or a == b
                   for a, b in zip(self.shape, other.shape))

    def accepts(self, value: Any) -> Optional[str]:
        """``None`` when ``value`` satisfies this spec, else a reason."""
        shape = tuple(getattr(value, "shape", ()))
        dtype = str(getattr(value, "dtype", type(value).__name__))
        if dtype.startswith("torch."):
            dtype = dtype[len("torch."):]
        if len(shape) != len(self.shape):
            return (f"rank {len(shape)} (shape {shape}) != spec rank "
                    f"{len(self.shape)} ({self.describe()})")
        for ax, (got, want) in enumerate(zip(shape, self.shape)):
            if want is not None and got != want:
                return (f"dim {ax} is {got}, spec wants {want} "
                        f"({self.describe()})")
        if dtype != self.dtype:
            return f"dtype {dtype} != spec dtype {self.dtype}"
        return None

    def describe(self) -> str:
        dims = ",".join("?" if d is None else str(d) for d in self.shape)
        return f"{self.dtype}[{dims}]"


@dataclasses.dataclass(frozen=True)
class Node:
    """One graph node: a fabric function (callable, or the registered
    name of a fabric collective) consuming named edge values.

    ``inputs`` name graph inputs or upstream nodes; the node's return
    value is published under ``name`` for downstream consumers — node
    outputs *are* the state. ``emits`` optionally names a key of a
    mapping-valued output whose items stream to the ``GraphHandle`` as
    tokens. ``out_spec``/``in_specs`` declare per-edge tensor contracts,
    checked edge-by-edge at build time.
    """

    name: str
    fn: Union[str, Callable[..., Any]]
    inputs: Tuple[str, ...] = ()
    placement: str = "auto"
    out_spec: Optional[TensorSpec] = None
    in_specs: Mapping[str, TensorSpec] = dataclasses.field(
        default_factory=dict)
    emits: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "inputs", tuple(self.inputs))
        object.__setattr__(self, "in_specs", dict(self.in_specs))


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    """A compiled graph: validated nodes + a deterministic topo order.

    Built only through ``GraphSpec.build`` — the constructor performs no
    checking, so every spec in circulation has already passed validation.
    """

    name: str
    nodes: Tuple[Node, ...]
    inputs: Tuple[str, ...]
    outputs: Tuple[str, ...]
    order: Tuple[str, ...]              # topo order, declaration-stable

    @property
    def node_map(self) -> Dict[str, Node]:
        return {n.name: n for n in self.nodes}

    def edges(self) -> List[Tuple[str, str]]:
        """Every (source, consumer-node) wire, graph inputs included."""
        return [(src, n.name) for n in self.nodes for src in n.inputs]

    @classmethod
    def build(cls, name: str, nodes: Sequence[Node],
              inputs: Sequence[str] = (),
              outputs: Sequence[str] = ()) -> "GraphSpec":
        """Validate and compile a node set into a ``GraphSpec``.

        Rejection reasons (all ``GraphValidationError``, all naming the
        offending node/edge): empty/duplicate node names, a node name
        shadowing a graph input, an unknown placement, a node input that
        names neither a graph input nor a node (dangling edge), a node
        consuming itself, a cycle (the error prints one), an output that
        names nothing, and a node→node edge whose declared ``out_spec``
        and ``in_specs`` disagree.
        """
        nodes = tuple(nodes)
        inputs = tuple(inputs)
        outputs = tuple(outputs)
        if not nodes:
            raise GraphValidationError(f"graph {name!r} has no nodes")
        if len(set(inputs)) != len(inputs):
            dupes = sorted({i for i in inputs if inputs.count(i) > 1})
            raise GraphValidationError(
                f"graph {name!r}: duplicate graph inputs {dupes}")

        by_name: Dict[str, Node] = {}
        for node in nodes:
            if not node.name or not isinstance(node.name, str):
                raise GraphValidationError(
                    f"graph {name!r}: node with empty/non-string name "
                    f"{node.name!r}")
            if node.name in by_name:
                raise GraphValidationError(
                    f"graph {name!r}: duplicate node name {node.name!r}")
            if node.name in inputs:
                raise GraphValidationError(
                    f"graph {name!r}: node {node.name!r} shadows the graph "
                    f"input of the same name (edges are wired by name — "
                    f"rename one)")
            if node.placement not in _PLACEMENTS:
                raise GraphValidationError(
                    f"graph {name!r}: node {node.name!r} placement "
                    f"{node.placement!r} is not one of {_PLACEMENTS}")
            if not callable(node.fn) and not isinstance(node.fn, str):
                raise GraphValidationError(
                    f"graph {name!r}: node {node.name!r} fn must be a "
                    f"callable or a registered fabric function name, got "
                    f"{type(node.fn).__name__}")
            by_name[node.name] = node

        known = set(inputs) | set(by_name)
        for node in nodes:
            for src in node.inputs:
                if src == node.name:
                    raise GraphValidationError(
                        f"graph {name!r}: node {node.name!r} consumes "
                        f"itself (edge {node.name!r}->{node.name!r})")
                if src not in known:
                    raise GraphValidationError(
                        f"graph {name!r}: node {node.name!r} consumes "
                        f"{src!r}, which is neither a graph input "
                        f"{sorted(inputs)} nor a node "
                        f"{sorted(by_name)} (dangling edge "
                        f"{src!r}->{node.name!r})")
            for spec_src in node.in_specs:
                if spec_src not in node.inputs:
                    raise GraphValidationError(
                        f"graph {name!r}: node {node.name!r} declares an "
                        f"in_spec for {spec_src!r}, which is not one of "
                        f"its inputs {list(node.inputs)}")
        for out in outputs:
            if out not in known:
                raise GraphValidationError(
                    f"graph {name!r}: output {out!r} names neither a node "
                    f"nor a graph input")

        # edge tensor contracts: producer's out_spec vs consumer's in_spec
        for node in nodes:
            for src in node.inputs:
                producer = by_name.get(src)
                if producer is None:
                    continue            # graph input: checked at bind time
                want = node.in_specs.get(src)
                have = producer.out_spec
                if want is not None and have is not None \
                        and not have.compatible(want):
                    raise GraphValidationError(
                        f"graph {name!r}: edge {src!r}->{node.name!r} is "
                        f"shape/dtype-mismatched — producer {src!r} emits "
                        f"{have.describe()} but consumer {node.name!r} "
                        f"expects {want.describe()}")

        order = cls._topo_order(name, nodes, set(inputs))
        return cls(name=name, nodes=nodes, inputs=inputs, outputs=outputs,
                   order=tuple(order))

    @staticmethod
    def _topo_order(name: str, nodes: Tuple[Node, ...],
                    graph_inputs: set) -> List[str]:
        """Kahn's algorithm, stable in declaration order; a leftover
        residue is a cycle, reported by walking it."""
        by_name = {n.name: n for n in nodes}
        indeg = {n.name: sum(1 for s in n.inputs if s in by_name)
                 for n in nodes}
        consumers: Dict[str, List[str]] = {n.name: [] for n in nodes}
        for n in nodes:
            for s in n.inputs:
                if s in by_name:
                    consumers[s].append(n.name)
        ready = [n.name for n in nodes if indeg[n.name] == 0]
        order: List[str] = []
        while ready:
            cur = ready.pop(0)
            order.append(cur)
            for nxt in consumers[cur]:
                indeg[nxt] -= 1
                if indeg[nxt] == 0:
                    ready.append(nxt)
        if len(order) == len(nodes):
            return order
        residue = [n for n in indeg if indeg[n] > 0]
        # walk node-edges inside the residue until a repeat: that's a cycle
        cur, seen, path = residue[0], set(), []
        while cur not in seen:
            seen.add(cur)
            path.append(cur)
            cur = next(s for s in by_name[cur].inputs
                       if s in by_name and indeg[s] > 0)
        cycle = path[path.index(cur):] + [cur]
        raise GraphValidationError(
            f"graph {name!r} has a cycle: {' -> '.join(cycle)}")

    def validate_inputs(self, values: Mapping[str, Any]) -> None:
        """Check bound graph-input values before any node runs: every
        declared input present (a missing one names the consuming nodes),
        no undeclared extras, and graph-input edges satisfying the
        consumer's ``in_specs``. Raises ``GraphValidationError``."""
        for inp in self.inputs:
            if inp not in values:
                consumers = [n.name for n in self.nodes if inp in n.inputs]
                raise GraphValidationError(
                    f"graph {self.name!r}: missing input {inp!r} "
                    f"(consumed by nodes {consumers})")
        extra = sorted(set(values) - set(self.inputs))
        if extra:
            raise GraphValidationError(
                f"graph {self.name!r}: unknown inputs {extra} (declared "
                f"inputs: {sorted(self.inputs)})")
        for node in self.nodes:
            for src in node.inputs:
                if src not in values:
                    continue
                spec = node.in_specs.get(src)
                if spec is None:
                    continue
                why = spec.accepts(values[src])
                if why:
                    raise GraphValidationError(
                        f"graph {self.name!r}: input edge "
                        f"{src!r}->{node.name!r}: {why}")
