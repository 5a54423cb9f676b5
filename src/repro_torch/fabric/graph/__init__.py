"""``repro_torch.fabric.graph``: served DAGs of fabric functions.

The port of ``repro/fabric/graph/``, with the same public names. A request
can be a graph: nodes are fabric functions wired by name (node outputs
*are* the state, hypergraph-style), compiled once into a validated
``GraphSpec``, executed round by round as *node invocations* by the
engine and router tiers, with edges lowered onto fabric leases and,
across replicas, mailbox frame trains. The first served graph is the
two-node draft -> verify speculative-decoding pipeline
(``fabric.graph.speculative``).
"""
from repro_torch.fabric.graph.edges import (EDGE_SPEC, GRAPH_FUNC_ID, decode_edge,
                                            edge_nbytes, encode_edge)
from repro_torch.fabric.graph.executor import (GraphHandle, GraphRun, NodeInvocation,
                                               edge_lease_name)
from repro_torch.fabric.graph.session import DecodeSession
from repro_torch.fabric.graph.spec import GraphSpec, GraphValidationError, Node, TensorSpec
from repro_torch.fabric.graph.speculative import (NgramDraft, SpeculativeDecoder,
                                                  draft_verify_spec)

__all__ = [
    "GraphSpec", "GraphValidationError", "Node", "TensorSpec",
    "GraphRun", "GraphHandle", "NodeInvocation", "edge_lease_name",
    "DecodeSession", "NgramDraft", "SpeculativeDecoder",
    "draft_verify_spec",
    "GRAPH_FUNC_ID", "EDGE_SPEC", "encode_edge", "decode_edge",
    "edge_nbytes",
]
