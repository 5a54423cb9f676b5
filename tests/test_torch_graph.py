"""Port parity: the graph half of ROADMAP A12 against the JAX package.

Both packages get the same numpy inputs in one process. The JAX engines
are built on a plain ``jax.sharding.Mesh`` (all-Auto axes) on their ``ref``
paths, in float32: the module patches the JAX ``models.model.forward`` to
compute in float32 and ``init_paged_cache`` to a float32 pool, as the
port's ``Engine(compute_dtype=torch.float32)`` runs, on the same weights
(``bridge.params_from_jax``). The fleet is ``tests/test_graph.py``'s:
``granite-20b`` smoke targets ``t1``/``t2`` on one weight tree (the port
adds ``ref`` for its baselines) and a ``llama3.2-1b`` smoke draft ``d1``,
on its ``ENG_KW`` geometry, built once per module in each package.

* **Spec.** The seeded random-DAG property cases of ``tests/test_graph.py``
  through both ``GraphSpec.build``s: the same topological order and run
  result, or the same ``GraphValidationError`` message; the targeted
  rejections, and ``validate_inputs``/``TensorSpec.accepts`` on torch
  tensors.
* **Edges.** ``encode_edge`` trains word for word against JAX's, each
  package decoding the other's, and every rejection with JAX's message.
* **Engine.** A generic DAG through ``Engine.submit_graph`` (outputs,
  streamed tokens, the ``metrics()["graphs"]`` schema); ``DecodeSession``
  (``propose``/``verify`` tokens and positions against the JAX session,
  rollback exact); speculation in engine mode (ngram k 1/2/4, a model
  draft, a preemption in the middle of the graph): outputs equal the
  port's own target-only greedy decode and the JAX decoder's, and the
  whole ``SpecStats`` equals the JAX decoder's.
* **Router.** Locality (the verify node sticks with its leases), the draft
  edge consumed warm under self-speculation, cross-model edges over
  frames (also under a 0.3 frame fault rate), failover from a
  ``FaultPlan`` kill and from a death in the middle of the verify step:
  outputs, stats, ``node_placements`` (engine ids in order) and the edge
  counters equal JAX's.
* k larger than the chunk is refused with JAX's message, and the
  launcher exits 0 on both tiers.
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro.fabric.graph as jgraph
from repro.cluster import Replica as JReplica
from repro.cluster import Router as JRouter
from repro.configs.base import SHAPES, RunConfig, ShardingConfig
from repro.configs.registry import get_smoke as j_get_smoke
from repro.engine import Engine as JEngine
from repro.engine import Request as JRequest
from repro.faults import FaultInjector as JFaultInjector
from repro.faults import FaultPlan as JFaultPlan
from repro.faults.errors import EngineFailedError as JEngineFailedError
from repro.models import model as jmodel
import repro_torch.fabric.graph as tgraph
from repro_torch import bridge
from repro_torch.cluster import FaultInjector, FaultPlan, Replica, Router
from repro_torch.configs.registry import get_smoke
from repro_torch.core.message import HDR_FUNC_ID
from repro_torch.engine import Engine, Request
from repro_torch.faults.errors import EngineFailedError
from repro_torch.launch import serve_graph
from test_torch_engine import share_cores_among_workers  # noqa: F401  (autouse)

# tests/test_graph.py's geometry: chunk 6 => k <= 5
ENG_KW = dict(cache="paged", slots=3, max_len=48, num_blocks=24, block_size=4, chunk=6)
MAX_NEW = 10
N_PROPERTY_CASES = 25
PACKAGES = {"port": tgraph, "jax": jgraph}


# ---------------------------------------------------------------------------
# spec: tests/test_graph.py's seeded random DAGs through both packages
# ---------------------------------------------------------------------------

def _sum_fn(*args):
    return int(sum(int(a) for a in args))


def _random_dag(g, rng: random.Random):
    """tests/test_graph.py's generator, over package ``g``'s ``Node``."""
    n_inputs = rng.randint(1, 3)
    n_nodes = rng.randint(1, 6)
    inputs = tuple(f"in{i}" for i in range(n_inputs))
    avail = list(inputs)
    nodes = []
    for i in range(n_nodes):
        k = rng.randint(1, min(3, len(avail)))
        srcs = tuple(rng.sample(avail, k))
        nodes.append(g.Node(f"n{i}", _sum_fn, inputs=srcs))
        avail.append(f"n{i}")
    return inputs, nodes, (nodes[-1].name,)


def _valid(g, seed):
    rng = random.Random(seed)
    inputs, nodes, outputs = _random_dag(g, rng)
    return f"rand{seed}", nodes, inputs, outputs, rng


def _cycle(g, seed):
    rng = random.Random(1000 + seed)
    inputs, nodes, outputs = _random_dag(g, rng)
    if len(nodes) < 2:
        nodes.append(g.Node("extra", _sum_fn, inputs=(nodes[0].name,)))
    first, last = nodes[0], nodes[-1]
    nodes[0] = dataclasses.replace(first, inputs=first.inputs + (last.name,))
    if first.name not in last.inputs:
        nodes[-1] = dataclasses.replace(nodes[-1], inputs=nodes[-1].inputs + (first.name,))
    return f"cyc{seed}", nodes, inputs, outputs, rng


def _dangling(g, seed):
    rng = random.Random(2000 + seed)
    inputs, nodes, outputs = _random_dag(g, rng)
    i = rng.randrange(len(nodes))
    nodes[i] = dataclasses.replace(nodes[i], inputs=(f"ghost{seed}",) + nodes[i].inputs[1:])
    return f"dang{seed}", nodes, inputs, outputs, rng


def _duplicate(g, seed):
    rng = random.Random(3000 + seed)
    inputs, nodes, outputs = _random_dag(g, rng)
    dupe = dataclasses.replace(nodes[rng.randrange(len(nodes))])
    return f"dup{seed}", nodes + [dupe], inputs, outputs, rng


def _mismatch(g, seed):
    rng = random.Random(4000 + seed)
    inputs, nodes, outputs = _random_dag(g, rng)
    by_name = {n.name: i for i, n in enumerate(nodes)}
    edge = next(((s, n) for n in nodes for s in n.inputs if s in by_name), None)
    if edge is None:
        nodes.append(g.Node("tail", _sum_fn, inputs=(nodes[0].name,)))
        edge = (nodes[0].name, nodes[-1])
    src, consumer = edge
    ci = by_name.get(consumer.name, len(nodes) - 1)
    si = by_name[src]
    nodes[si] = dataclasses.replace(nodes[si], out_spec=g.TensorSpec((4,), "int32"))
    bad = rng.choice([g.TensorSpec((5,), "int32"), g.TensorSpec((4,), "float32"),
                      g.TensorSpec((4, 1), "int32")])
    nodes[ci] = dataclasses.replace(nodes[ci], in_specs={src: bad})
    return f"mis{seed}", nodes, inputs, outputs, rng


PROPERTIES = {"valid": _valid, "cycle": _cycle, "dangling": _dangling,
              "duplicate": _duplicate, "mismatch": _mismatch}


def _build_and_run(g, prop, seed):
    """The topological order and run result of one property case, or the
    ``GraphValidationError`` message."""
    name, nodes, inputs, outputs, rng = PROPERTIES[prop](g, seed)
    try:
        spec = g.GraphSpec.build(name, nodes, inputs=inputs, outputs=outputs)
    except g.GraphValidationError as err:
        return ("rejected", str(err))
    values = {inp: rng.randint(0, 100) for inp in inputs}
    run = g.GraphRun(spec, values)
    run.advance()
    return ("built", spec.order, spec.edges(), run.result(), len(run.invocations))


@pytest.mark.parametrize("seed", range(N_PROPERTY_CASES))
@pytest.mark.parametrize("prop", sorted(PROPERTIES))
def test_spec_properties_match_jax(prop, seed):
    port = _build_and_run(tgraph, prop, seed)
    assert port == _build_and_run(jgraph, prop, seed)
    assert port[0] == ("built" if prop == "valid" else "rejected"), port
    if prop == "cycle":
        assert "cycle" in port[1]
    if prop == "dangling":
        assert "dangling edge" in port[1] and f"ghost{seed}" in port[1]


def _rejections(g, arr_f32, arr_i32):
    """tests/test_graph.py's targeted rejections, each message (or None)."""
    a = g.Node("a", _sum_fn, inputs=("p",))
    ts = g.TensorSpec((None,), "int32")
    cases = [
        lambda: g.GraphSpec.build("g", [], inputs=("p",)),
        lambda: g.GraphSpec.build("g", [a], inputs=("p", "p")),
        lambda: g.GraphSpec.build("g", [g.Node("p", _sum_fn, inputs=("p",))], inputs=("p",)),
        lambda: g.GraphSpec.build("g", [dataclasses.replace(a, placement="remote")],
                                  inputs=("p",)),
        lambda: g.GraphSpec.build("g", [g.Node("a", 42, inputs=("p",))], inputs=("p",)),
        lambda: g.GraphSpec.build("g", [g.Node("a", _sum_fn, inputs=("a",))], inputs=("p",)),
        lambda: g.GraphSpec.build("g", [a], inputs=("p",), outputs=("zzz",)),
        lambda: g.GraphSpec.build("g", [dataclasses.replace(
            a, in_specs={"q": g.TensorSpec((1,), "int32")})], inputs=("p",)),
        lambda: g.GraphSpec.build("g", [g.Node("a", _sum_fn, inputs=("b",)),
                                        g.Node("b", _sum_fn, inputs=("a",))]),
    ]
    spec = g.GraphSpec.build("g", [g.Node("a", _sum_fn, inputs=("p",), in_specs={"p": ts}),
                                   g.Node("b", _sum_fn, inputs=("a",))],
                             inputs=("p",), outputs=("b",))
    cases += [lambda: g.GraphRun(spec, {}),
              lambda: g.GraphRun(spec, {"p": arr_i32, "zzz": 2}),
              lambda: g.GraphRun(spec, {"p": arr_f32}),
              lambda: g.GraphRun(spec, {"p": arr_i32[None]}),
              lambda: g.GraphRun(spec, {"p": arr_i32})]
    out = []
    for case in cases:
        try:
            case()
            out.append(None)
        except g.GraphValidationError as err:
            out.append(str(err))
    return out + [ts.accepts(arr_i32), ts.accepts(arr_f32), ts.describe()]


def test_targeted_rejections_match_jax_on_torch_tensors():
    """The build catalogue, and bind-time checks with the port given torch
    tensors where JAX is given numpy arrays: the same messages
    (``TensorSpec.accepts`` reads ``torch.int32`` as ``int32``)."""
    port = _rejections(tgraph, torch.zeros(3, dtype=torch.float32),
                       torch.zeros(3, dtype=torch.int32))
    ref = _rejections(jgraph, np.zeros(3, np.float32), np.zeros(3, np.int32))
    assert port == ref
    assert port[-3:] == [None, "dtype float32 != spec dtype int32", "int32[?]"]
    assert sum(m is None for m in port) == 2          # the ok bind and accepts
    assert "missing input 'p' (consumed by nodes ['a'])" in port[9]
    assert "a -> b -> a" in port[8] or "b -> a -> b" in port[8]


def test_draft_verify_spec_and_ngram_match_jax():
    for g in PACKAGES.values():
        spec = g.draft_verify_spec(draft_fn=lambda p: None, verify_fn=lambda p, d: None)
        assert spec.order == ("draft", "verify")
        assert spec.edges() == [("prompt", "draft"), ("prompt", "verify"), ("draft", "verify")]
        assert spec.node_map["verify"].in_specs["draft"].describe() == "int32[?]"
    rng = np.random.default_rng(0)
    for _ in range(40):
        known = [int(t) for t in rng.integers(0, 4, size=int(rng.integers(1, 12)))]
        k, n = int(rng.integers(1, 5)), int(rng.integers(1, 4))
        assert (tgraph.NgramDraft(n).propose(known, k)
                == jgraph.NgramDraft(n).propose(known, k))


# ---------------------------------------------------------------------------
# edges: the same words, decoded across, rejected alike
# ---------------------------------------------------------------------------

EDGE_VALUES = {
    "int32 run": np.arange(7, dtype=np.int32),
    "float32 matrix": np.linspace(0, 1, 33, dtype=np.float32).reshape(3, 11),
    "empty": np.array([], dtype=np.int32),
    "several frames": np.arange(5000, dtype=np.int32),
}


@pytest.mark.parametrize("kind", sorted(EDGE_VALUES))
def test_edge_frames_equal_jax_and_cross_decode(kind):
    value = EDGE_VALUES[kind]
    frames = tgraph.encode_edge("graph/0/draft", torch.from_numpy(value.copy()))
    jframes = jgraph.encode_edge("graph/0/draft", value)
    assert frames.dtype == np.int32 and frames.shape == (len(jframes),
                                                         tgraph.EDGE_SPEC.total_words)
    np.testing.assert_array_equal(frames, np.stack(jframes))
    assert (len(frames) > 1) == (kind == "several frames")
    assert list(frames[:, HDR_FUNC_ID]) == [tgraph.GRAPH_FUNC_ID] * len(frames)
    for name, got in (tgraph.decode_edge(frames), tgraph.decode_edge(jframes),
                      jgraph.decode_edge(list(frames))):
        assert name == "graph/0/draft"
        assert got.dtype == value.dtype and got.shape == value.shape
        np.testing.assert_array_equal(got, value)
    assert tgraph.edge_nbytes(torch.from_numpy(value.copy())) == jgraph.edge_nbytes(value)


def test_edge_decode_rejects_like_jax():
    frames = tgraph.encode_edge("big", np.arange(5000, dtype=np.int32))
    usr = tgraph.EDGE_SPEC.offsets()["usr"]

    def rejects(train, match):
        with pytest.raises(ValueError, match=match) as port:
            tgraph.decode_edge(train)
        with pytest.raises(ValueError, match=match) as ref:
            jgraph.decode_edge([np.asarray(f) for f in train])
        assert str(port.value) == str(ref.value)

    bad = frames.copy()
    bad[0, usr + 5] ^= 0xFF
    rejects(bad, "magic or SIG checksum")
    bad = frames.copy()
    bad[1, 0] = 0
    rejects(bad, "magic or SIG checksum")
    rejects(frames[:-1], "truncated")
    rejects(frames[::-1], "reordered")
    rejects(np.concatenate([frames[:1], frames]), "truncated")
    alien = frames.copy()
    alien[0, HDR_FUNC_ID] = 0x7C
    rejects(alien, "not the graph-edge handler")
    pad = frames.copy()
    pad[1, -1] = 1
    rejects(pad, "padding")
    short = [np.asarray(f) for f in frames]
    short[1] = short[1][:-1]
    with pytest.raises(ValueError) as port:
        tgraph.decode_edge(short)
    with pytest.raises(ValueError) as ref:
        jgraph.decode_edge(short)
    assert str(port.value) == str(ref.value) and "shape" in str(port.value)
    for g in PACKAGES.values():
        with pytest.raises(ValueError, match="empty edge train"):
            g.decode_edge([])


# ---------------------------------------------------------------------------
# the fleet: JAX (float32 on a plain Mesh) and the port, on one weight tree
# ---------------------------------------------------------------------------

def _jax_float32(mp):
    """Run the JAX engines' steps and pools in float32, as the port's."""
    forward, init_pool = jmodel.forward, jmodel.init_paged_cache

    def forward_f32(*args, **kw):
        kw.setdefault("compute_dtype", jnp.float32)
        return forward(*args, **kw)

    mp.setattr(jmodel, "forward", forward_f32)
    mp.setattr(jmodel, "init_paged_cache",
               lambda cfg, nb, bs, dtype=jnp.float32: init_pool(cfg, nb, bs, dtype))


@pytest.fixture(scope="module")
def fleet():
    with pytest.MonkeyPatch.context() as mp:
        _jax_float32(mp)
        mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
        jax_ns = dict(Engine=JEngine, Request=JRequest, Router=JRouter, Replica=JReplica,
                      FaultInjector=JFaultInjector, FaultPlan=JFaultPlan,
                      EngineFailedError=JEngineFailedError, g=jgraph)
        port_ns = dict(Engine=Engine, Request=Request, Router=Router, Replica=Replica,
                       FaultInjector=FaultInjector, FaultPlan=FaultPlan,
                       EngineFailedError=EngineFailedError, g=tgraph)

        def jax_engine(arch, eid, params=None):
            jcfg = j_get_smoke(arch)
            run = RunConfig(model=jcfg, shape=SHAPES["decode_32k"],
                            sharding=ShardingConfig(fsdp_params=False, seq_axis=None))
            with mesh:
                e = JEngine(jcfg, run, mesh, engine_id=eid, kernel="ref", **ENG_KW)
                e.load_params(params)
            return e

        jax_ns["t1"] = jax_engine("granite-20b", "t1")
        jax_ns["t2"] = jax_engine("granite-20b", "t2", jax_ns["t1"].params)
        jax_ns["d1"] = jax_engine("llama3.2-1b", "d1")

        def port_engine(arch, eid, params):
            e = Engine(get_smoke(arch), device="cpu", kernel="ref", engine_id=eid,
                       compute_dtype=torch.float32, **ENG_KW)
            e.load_params(params)
            return e

        tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jax_ns["t1"].params),
                                         get_smoke("granite-20b"))
        for eid in ("t1", "t2", "ref"):
            port_ns[eid] = port_engine("granite-20b", eid, tparams)
        port_ns["d1"] = port_engine("llama3.2-1b", "d1", bridge.params_from_jax(
            jax.tree.map(np.asarray, jax_ns["d1"].params), get_smoke("llama3.2-1b")))
        yield dict(port=port_ns, jax=jax_ns, mesh=mesh, cfg=get_smoke("granite-20b"),
                   baselines={})


def _prompt(fleet, seed=0, n=6):
    rng = np.random.default_rng(seed)
    return rng.integers(0, fleet["cfg"].vocab_size, size=(n,)).astype(np.int32)


def _baseline(fleet, prompt, max_new=MAX_NEW):
    """Target-only greedy decode on the port's reference engine (cached)."""
    key = (tuple(int(t) for t in prompt), max_new)
    if key not in fleet["baselines"]:
        ref = fleet["port"]["ref"]
        ref.restart()
        h = ref.submit(Request(9000 + len(fleet["baselines"]), prompt, max_new_tokens=max_new))
        fleet["baselines"][key] = list(h.tokens())
    return fleet["baselines"][key]


def _both(fleet, body):
    """``body(ns)`` on the port's namespace, then on the JAX one (inside its
    mesh); engines are restarted and their fault hooks cleared around it."""
    out = []
    for pkg in ("port", "jax"):
        ns = fleet[pkg]
        for eid in ("t1", "t2", "d1"):
            ns[eid].restart()
        try:
            if pkg == "jax":
                with fleet["mesh"]:
                    out.append(body(ns))
            else:
                out.append(body(ns))
        finally:
            for eid in ("t1", "t2", "d1"):
                ns[eid].fault_hook = None
                ns[eid].restart()
    return out


# ---------------------------------------------------------------------------
# engine tier
# ---------------------------------------------------------------------------

def test_generic_dag_served_by_engine_matches_jax(fleet):
    def body(ns):
        g, eng = ns["g"], ns["t1"]
        spec = g.GraphSpec.build(
            "pipeline",
            [g.Node("scale", lambda p: p * 2, inputs=("prompt",)),
             g.Node("shift", lambda s: s + 1, inputs=("scale",)),
             g.Node("reduce", lambda a, b: {"total": int(a.sum() + b.sum()),
                                             "toks": [int(b[0])]},
                    inputs=("scale", "shift"), emits="toks")],
            inputs=("prompt",), outputs=("reduce", "shift"))
        handle = eng.submit_graph(spec, {"prompt": np.arange(4, dtype=np.int32)})
        assert eng.pending()
        out = handle.result()
        m = eng.metrics()["graphs"]
        run = next(r for r in m["runs"] if r["gid"] == handle.gid)
        leases = {k for k in eng.metrics()["fabric"]["leases"] if k.startswith("graph/")}
        return (out["reduce"], out["shift"].tolist(), list(handle.tokens()), sorted(m),
                sorted(run), {k: v for k, v in run.items() if k != "gid"}, eng.pending(),
                sorted(k.split("/", 2)[2] for k in leases))

    port, ref = _both(fleet, body)
    assert port == ref
    assert port[0]["total"] == int((np.arange(4) * 2).sum() + (np.arange(4) * 2 + 1).sum())
    assert port[2] == [1] and port[3] == ["active", "completed", "node_invocations", "runs"]
    assert [i["node"] for i in port[5]["invocations"]] == ["scale", "shift", "reduce"]
    assert port[5]["rounds"] == 1 and port[7] == ["reduce", "scale", "shift"]


def test_decode_session_matches_jax_and_rolls_back_exactly(fleet):
    """``propose`` drafts the same tokens as the JAX session; ``verify`` of
    rejected candidates hands back the target's greedy tokens one bonus at
    a time, with the positions, steps and ``kv_bytes`` of the JAX session;
    the accepted run is the target-only greedy decode."""
    prompt = _prompt(fleet, seed=3)
    vocab = fleet["cfg"].vocab_size

    def body(ns):
        sess = ns["g"].DecodeSession(ns["t1"], [int(t) for t in prompt])
        sess.ensure_ready()
        trace = [("ready", sess.pos, sess.steps)]
        proposed = sess.propose(3)
        trace.append(("propose", proposed, sess.pos, sess.steps))
        sess.accept([])                             # nothing to commit
        out = []
        while len(out) < 4:
            bad = [((out[-1] if out else 0) + 1) % vocab] * 2
            a, bonus = sess.verify(bad)
            out.extend(bad[:a] + [bonus])
            trace.append(("verify", a, bonus, sess.pos, len(sess.known), sess.verify_steps,
                          sess.kv_bytes()))
        sess.preempt()
        trace.append(("preempt", sess.pos, sess.entry.blocks))
        sess.ensure_ready()
        trace.append(("again", sess.pos, sess.steps, sess.metrics()["preemptions"]))
        sess.release()
        return out, trace

    (port_out, port_trace), ref = _both(fleet, body)
    assert (port_out, port_trace) == ref
    assert port_out[:4] == _baseline(fleet, prompt, 4)
    assert port_trace[1][1] == _baseline(fleet, prompt, 3)    # the draft is the greedy run


SPEC_CASES = {"ngram k1": (1, False, False), "ngram k2": (2, False, False),
              "ngram k4": (4, False, False), "model draft k2": (2, True, False),
              "preempt mid-graph k2": (2, False, True)}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_speculation_engine_mode_matches_jax(fleet, case):
    k, model, preempt = SPEC_CASES[case]
    prompt = _prompt(fleet, seed={"model draft k2": 1, "preempt mid-graph k2": 2}.get(case, 0))

    def body(ns):
        dec = ns["g"].SpeculativeDecoder(target=ns["t1"], draft=ns["d1"] if model else None,
                                         k=k)
        got = []
        for tok in dec.submit(prompt, MAX_NEW).tokens():
            got.append(tok)
            if preempt and len(got) == 3:
                dec.tasks[0].verify_sess.preempt()
        m = ns["t1"].metrics()
        inv = m["graphs"]["runs"][-1]["invocations"][-1]
        return (got, dec.tasks[0].stats.as_dict(), dec.metrics()["draft"],
                "engine.paged_verify" in m["fabric"]["functions"],
                {key: inv[key] for key in ("node", "placement", "status", "engine_id")})

    port, ref = _both(fleet, body)
    assert port == ref
    got, stats = port[0], port[1]
    assert got == _baseline(fleet, prompt)
    assert stats["emitted"] == MAX_NEW and stats["proposed"] == stats["rounds"] * k
    assert stats["target_steps_per_token"] <= 1.0
    assert (stats["draft_steps"] > 0) == model and port[2] == ("model" if model else "ngram")
    assert port[3] and port[4]["engine_id"] == "t1"


def test_engine_counts_session_steps_and_verify_launches(fleet):
    """The port's own counters: a session's steps count in ``steps``, its
    verify steps in ``verify_steps``, both through the engine's fabric (one
    call each), and the verify step is built once."""
    eng = fleet["port"]["t1"]
    eng.restart()
    steps0, calls0 = eng.steps, dict(eng.fabric.metrics()["calls"])
    dec = tgraph.SpeculativeDecoder(target=eng, k=2)
    list(dec.submit(_prompt(fleet, seed=9), 4).tokens())
    stats = dec.tasks[0].stats
    calls = eng.fabric.metrics()["calls"]
    assert eng.steps - steps0 == stats.target_prefill_steps
    assert calls["engine.paged_step"] - calls0.get("engine.paged_step", 0) == \
        stats.target_prefill_steps
    assert calls["engine.paged_verify"] - calls0.get("engine.paged_verify", 0) == \
        stats.target_verify_steps
    assert eng.metrics()["verify_steps"] >= stats.target_verify_steps
    bundle = eng.verify_bundle
    eng.ensure_verify_step()
    assert eng.verify_bundle is bundle and bundle.meta["emit"] == "all"
    assert eng.metrics()["nonfinite_logits"] == 0
    eng.restart()


def test_k_larger_than_chunk_rejected_like_jax(fleet):
    msgs = []
    for pkg in ("port", "jax"):
        ns = fleet[pkg]
        with pytest.raises(ValueError, match="verify chunk") as err:
            ns["g"].SpeculativeDecoder(target=ns["t1"], k=ENG_KW["chunk"])
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# router tier
# ---------------------------------------------------------------------------

def _router_summary(router, dec):
    m = router.metrics()
    r = m["router"]
    return dict(
        verify=[p["engine_id"] for p in r["node_placements"] if p["node"] == "verify"],
        draft=[p["engine_id"] for p in r["node_placements"] if p["node"] == "draft"],
        affinity=[p["affinity_bytes"] for p in r["node_placements"]],
        edges={k: r[k] for k in ("edge_frames", "edge_bytes", "edge_retransmits",
                                 "edge_local_hits")},
        graphs=(m["graphs"]["completed"], m["graphs"]["node_invocations"]),
        stats=dec.tasks[0].stats.as_dict(),
        detected=m["faults"]["detected"])


def test_router_locality_verify_sticks_with_draft_lease(fleet):
    prompt = _prompt(fleet, seed=4)

    def body(ns):
        t1, t2 = ns["t1"], ns["t2"]
        router = ns["Router"]([ns["Replica"](t1, model="target"),
                               ns["Replica"](t2, model="target")])
        dec = ns["g"].SpeculativeDecoder(router=router, target_model="target", k=2)
        got, loaded = [], False
        for tok in dec.submit(prompt, MAX_NEW).tokens():
            got.append(tok)
            if len(got) == 3 and not loaded:
                # pile background work onto the replica holding the leases
                t1.submit(ns["Request"](rid=777, prompt=np.asarray(prompt), max_new_tokens=8))
                loaded = True
        loads = [p["load"]["queue_depth"] + p["load"]["active"]
                 for p in router.node_placements if p["node"] == "verify"]
        return got, _router_summary(router, dec), loads

    port, ref = _both(fleet, body)
    assert port == ref
    got, summary, loads = port
    assert got == _baseline(fleet, prompt)
    assert set(summary["verify"]) == {"t1"} and any(n > 0 for n in loads[3:])
    assert summary["affinity"][-1] == 0


def test_router_self_speculation_consumes_draft_edge_warm(fleet):
    prompt = _prompt(fleet, seed=5)

    def body(ns):
        router = ns["Router"]([ns["Replica"](ns["t1"], model="target"),
                               ns["Replica"](ns["t2"], model="target")])
        dec = ns["g"].SpeculativeDecoder(router=router, target_model="target",
                                         draft_model="target", k=2)
        return list(dec.submit(prompt, MAX_NEW).tokens()), _router_summary(router, dec)

    port, ref = _both(fleet, body)
    assert port == ref
    got, s = port
    assert got == _baseline(fleet, prompt)
    assert s["stats"]["acceptance_rate"] == 1.0
    assert s["stats"]["target_steps_per_token"] < 1.0 / 1.3
    assert s["edges"]["edge_local_hits"] > 0 and s["edges"]["edge_frames"] == 0
    assert s["graphs"][0] == 1 and s["graphs"][1] > 0


@pytest.mark.parametrize("fault_rate", [0.0, 0.3])
def test_router_cross_model_edges_ride_frames(fleet, fault_rate):
    """A llama draft for the granite target: every draft -> verify edge is
    shipped as frames; under the 0.3 frame fault rate the damaged trains
    are retransmitted, and the injector's events equal the JAX one's."""
    prompt = _prompt(fleet, seed=6)

    def body(ns):
        router = ns["Router"]([ns["Replica"](ns["t1"], model="target"),
                               ns["Replica"](ns["d1"], model="draft")], retry_backoff_s=0)
        inj = None
        if fault_rate:
            inj = ns["FaultInjector"](ns["FaultPlan"](seed=7, frame_fault_rate=fault_rate))
            inj.install(router)
        dec = ns["g"].SpeculativeDecoder(router=router, target_model="target",
                                         draft_model="draft", k=2)
        got = list(dec.submit(prompt, MAX_NEW).tokens())
        # an event's rid hashes the edge's lease name, whose gid is each
        # package's own run counter
        events = [{k: v for k, v in ev.items() if k != "rid"} for ev in inj.events] \
            if inj else []
        return got, _router_summary(router, dec), events

    port, ref = _both(fleet, body)
    assert port == ref
    got, s, events = port
    assert got == _baseline(fleet, prompt)
    e = s["edges"]
    assert e["edge_frames"] > 0 and e["edge_local_hits"] == 0
    assert e["edge_bytes"] == e["edge_frames"] * tgraph.EDGE_SPEC.total_bytes
    assert (e["edge_retransmits"] > 0) == bool(fault_rate) == bool(events)
    assert s["detected"] == e["edge_retransmits"]


def test_router_failover_via_fault_plan_kill(fleet):
    prompt = _prompt(fleet, seed=7)

    def body(ns):
        router = ns["Router"]([ns["Replica"](ns["t1"], model="target"),
                               ns["Replica"](ns["t2"], model="target")])
        inj = ns["FaultInjector"](ns["FaultPlan"](kill_at={"t1": 4})).install(router)
        dec = ns["g"].SpeculativeDecoder(router=router, target_model="target", k=2)
        got = list(dec.submit(prompt, MAX_NEW).tokens())
        return got, _router_summary(router, dec), inj.counters["kills"]

    port, ref = _both(fleet, body)
    assert port == ref
    got, s, kills = port
    assert got == _baseline(fleet, prompt)
    assert s["stats"]["verify_rebuilds"] >= 1 and kills == 1
    assert set(s["verify"]) == {"t1", "t2"} and s["verify"][0] == "t1" \
        and s["verify"][-1] == "t2"


def test_router_failover_on_midcall_death(fleet):
    """The replica dies inside the verify invocation (the fault hook,
    between placement resolution and step execution, on the 4th
    ``engine.paged_verify``): the node retries elsewhere, the session is
    rebuilt and the stream is unchanged."""
    prompt = _prompt(fleet, seed=8)

    def body(ns):
        t1, t2 = ns["t1"], ns["t2"]
        router = ns["Router"]([ns["Replica"](t1, model="target"),
                               ns["Replica"](t2, model="target")])
        calls = {"n": 0}

        def arm(eng):
            def chaos(step_name):
                if step_name == "engine.paged_verify":
                    calls["n"] += 1
                    if calls["n"] == 4:
                        eng.fail("chaos: died mid verify step")
                        raise ns["EngineFailedError"](eng.engine_id,
                                                      "chaos: died mid verify step")
            eng.fault_hook = chaos

        dec = ns["g"].SpeculativeDecoder(router=router, target_model="target", k=2)
        handle = dec.submit(prompt, MAX_NEW)
        for e in (t1, t2):
            arm(e)
        return list(handle.tokens()), _router_summary(router, dec), calls["n"]

    port, ref = _both(fleet, body)
    assert port == ref
    got, s, n = port
    assert got == _baseline(fleet, prompt)
    assert s["stats"]["failovers"] >= 1 and s["stats"]["verify_rebuilds"] >= 1 and n > 4


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tier", ["engine", "router"])
def test_serve_graph_launcher_exits_zero(tier, capsys):
    assert serve_graph.main(["--device", "cpu", "--tier", tier, "--k", "2",
                             "--requests", "1", "--max-new", "6"]) == 0
    assert "OK: 1 requests bitwise identical" in capsys.readouterr().out
