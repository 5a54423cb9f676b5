"""Port parity: the paged ``Engine`` against the JAX package's.

The port's ``Engine(device="cpu", kernel="ref")`` and the JAX
``Engine(cache="paged", kernel="ref")`` serve the same requests on
``get_smoke("llama3.2-1b")`` with the same weights, on the geometry of
``tests/test_engine.py::_mk_engine`` (3 slots, max_len 32, 16 blocks of 4,
chunk 4) and on a smaller pool that forces preemption.

* With ``eos_id=None`` the schedule does not depend on the tokens, so the
  admission order, the tick count and the preemption count must match
  exactly under FIFO, priority and SJF.
* Each emitted token must be the argmax of the JAX float32 forward over
  the same prefix, except where that forward's top-2 logit margin is
  under ``MARGIN_TOL``. Both engines compute in bfloat16, so near-ties
  may flip: the exceptions are counted and reported (at most one in ten
  tokens is allowed).
* ``RequestHandle.tokens()`` streams exactly the drained run's tokens.
* ``get_smoke("olmoe-1b-7b")`` (MoE, 8 experts, top-2) on a pool that
  forces preemption under FIFO: the schedule matches the JAX engine's
  exactly. A MoE layer's capacity and drops depend on the whole step
  batch, so a single-sequence forward is no oracle for its tokens: every
  step the port ran is replayed instead through the JAX paged forward in
  float32 on the same inputs. The port's engine with its step built in
  float32 must emit that forward's argmax in every row, except where its
  top-2 margin is under ``F32_MARGIN_TOL`` (float32 noise; at most one in
  ten rows). In bfloat16 the router turns rounding noise into discrete
  changes (a token at a near-tie of its top-k takes another expert, and
  its request's later tokens see that through attention; the JAX package
  notes the same envelope for its own MoE references), so the bf16
  engine's rows must be the float32 argmax or within the llama margin
  ``MARGIN_TOL`` in at least ``MOE_BF16_SHARE`` of the rows. (On the CPU
  the port's expert FFN is the moe_jam kernel's plain version: float32
  sums, ``h`` rounded to bf16 once; the JAX model's ``expert_ffn`` rounds
  ``g``, ``u`` and ``h``. Neither rounds in float32.)
* Fabric placement (``placement="local"|"injected"|"auto"``) on the llama
  smoke: at each placement the schedule, the resolved placement, the
  params lease's counters, the fabric's call counts and every
  ``placement="auto"`` decision equal the JAX ``Engine(placement=...)``'s
  on the same requests, and the tokens meet the float32 oracle as above;
  placement changes no token (local, injected and auto are compared
  exactly with each other, and with ``inject_params``, which makes
  ``auto`` resolve injected from the first tick).
* ``get_smoke("mamba-130m")`` on the recurrent backend: 3 requests on 2
  slots, prompts of 4, 5 and 7 tokens with chunk 4 (on and off the chunk
  boundary), one forced mid-decode ``preempt(rid)``. The schedule
  (admission order, ticks, preemptions) and the snapshot counts match the
  JAX ``Engine(cache="recurrent")`` exactly (the JAX engine takes no
  ``kernel`` for this backend: its step always runs the ``lax.scan`` of
  ``models/ssm.py``). Each token equals the argmax of the JAX float32
  forward over the request's unbatched sequence from a zero state (the
  oracle of ``tests/test_engine.py``'s recurrent test, rebuilt here):
  exactly for the port's engine in float32, except where that forward's
  top-2 margin is under ``F32_MARGIN_TOL``; within ``MARGIN_TOL`` for the
  bf16 engine (at most one in ten tokens under the margin each).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs.base import SHAPES, RunConfig, ShardingConfig
from repro.configs.registry import get_smoke as j_get_smoke
from repro.engine import Engine as JEngine
from repro.engine import Request as JRequest
from repro.models import model as jmodel
from repro.models.kvcache import PagedLayout as JPagedLayout
from repro_torch.bridge import params_from_jax
from repro_torch.configs.registry import default_cache_backend, get_smoke
from repro_torch.engine import Engine, RecurrentState, Request
from repro_torch.models import model as tmodel
from repro_torch.runtime.steps import make_paged_serve_step, make_recurrent_serve_step

@pytest.fixture(scope="module", autouse=True)
def share_cores_among_workers():
    """Under pytest-xdist, run this module's torch ops on the worker's share
    of the host's cores (at least one intra-op thread), then restore the
    default. Every xdist worker otherwise starts a thread per core, and six
    workers oversubscribe the host: on an 8-core CPU host one port test
    took 194 s in six concurrent processes at the default against 12 s at
    one thread each. The port's other test files import this fixture."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers <= 1:
        yield
        return
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // workers))
    yield
    torch.set_num_threads(before)


# bf16 logits of the smoke model deviate from float32 by up to ~2.5e-2
# (random 16-token prompts, logits up to ~3 in magnitude); two such errors
# of opposite sign can flip a top-2 margin below twice that
MARGIN_TOL = 5e-2
# float32 logits of the two packages agree to ~1e-4 (test_torch_model)
F32_MARGIN_TOL = 1e-3
# olmoe smoke, bf16 against float32: a router flip moves a row's logits by
# up to ~1.2 (logits ~1 in magnitude); 1-3 of ~53 step rows flipped in the
# workloads measured
MOE_BF16_SHARE = 0.85
GEOM = dict(slots=3, max_len=32, num_blocks=16, block_size=4, chunk=4)


@pytest.fixture(scope="module")
def setup():
    jcfg = j_get_smoke("llama3.2-1b")
    # all-Auto axes: the step's sharding constraints refuse Explicit ones
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    run = RunConfig(model=jcfg, shape=SHAPES["decode_32k"],
                    sharding=ShardingConfig(fsdp_params=False, seq_axis=None))
    with mesh:
        jparams = jax.jit(lambda k: jmodel.init_params(jcfg, k)[0])(jax.random.PRNGKey(0))
    cfg = get_smoke("llama3.2-1b")
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    oracle = jax.jit(lambda p, t: jmodel.forward(jcfg, p, t, compute_dtype=jnp.float32)[0])
    return dict(jcfg=jcfg, cfg=cfg, mesh=mesh, run=run, jparams=jparams,
                tparams=tparams, oracle=oracle)


def _workload(cfg, n, seed, lo=4, hi=12):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=(int(rng.integers(lo, hi)),))
               .astype(np.int32) for _ in range(n)]
    return prompts


def _serve_jax(s, prompts, max_new, priorities, **kw):
    with s["mesh"]:
        e = JEngine(s["jcfg"], s["run"], s["mesh"], cache="paged", kernel="ref",
                    **{**GEOM, **kw})
        e.load_params(s["jparams"])
        for rid, p in enumerate(prompts):
            e.submit(JRequest(rid, p, max_new_tokens=max_new, priority=priorities[rid]))
        e.run_until_drained()
    return e


def _serve_torch(s, prompts, max_new, priorities, stream=False, **kw):
    e = Engine(s["cfg"], device="cpu", cache="paged", kernel="ref", **{**GEOM, **kw})
    e.load_params(s["tparams"])
    handles = [e.submit(Request(rid, p, max_new_tokens=max_new, priority=priorities[rid]))
               for rid, p in enumerate(prompts)]
    streamed = {h.rid: list(h.tokens()) for h in handles} if stream else None
    if not stream:
        e.run_until_drained()
    return e, streamed


def _schedule(e):
    return dict(admission=list(e.admission_log), ticks=e.ticks,
                preemptions=e.preempt_count, completed=len(e.completed))


def _oracle_exceptions(s, prompts, engine, margin=MARGIN_TOL, gaps=None):
    """Count emitted tokens that differ from the float32 argmax where the
    top-2 margin is >= ``margin`` (faults) and where it is below
    (exceptions). ``gaps``, where given, receives each (rid, position)'s
    top-2 margin."""
    faults, exceptions, total = [], 0, 0
    for r in engine.completed:
        seq = np.concatenate([prompts[r.rid], np.asarray(r.out_tokens, np.int32)])
        logits = np.asarray(s["oracle"](s["jparams"], jnp.asarray(seq[None, :-1])))[0]
        for i, tok in enumerate(r.out_tokens):
            row = logits[len(prompts[r.rid]) - 1 + i]
            top2 = np.sort(row)[-2:]
            total += 1
            if gaps is not None:
                gaps[(r.rid, i)] = float(top2[1] - top2[0])
            if tok != int(np.argmax(row)):
                if top2[1] - top2[0] >= margin:
                    faults.append((r.rid, i, tok, int(np.argmax(row)),
                                   float(top2[1] - top2[0])))
                else:
                    exceptions += 1
    return faults, exceptions, total


def same_tokens_but_at_ties(ours, theirs, gaps, margin=MARGIN_TOL):
    """Hold each request's tokens (``{rid: tokens}``) to the JAX engine's:
    equal up to the first position where they differ, and there the float32
    oracle's top-2 margin (``gaps[(rid, position)]``, on the prefix both
    share) is below ``margin``, a near tie that bf16 rounding may break
    either way. Later tokens follow different inputs and are not compared.
    Returns how many tokens are equal."""
    assert ours.keys() == theirs.keys()
    same = 0
    for rid in ours:
        a, b = list(ours[rid]), list(theirs[rid])
        assert len(a) == len(b), rid
        p = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), len(a))
        same += p
        if p < len(a):
            assert gaps[(rid, p)] < margin, (rid, p, a, b, gaps[(rid, p)])
    return same


@pytest.mark.parametrize("scheduler,kw,n,max_new,seed", [
    ("fifo", {}, 4, 4, 0),
    ("fifo", dict(slots=2, num_blocks=10), 3, 14, 3),       # forces preemption
    ("priority", dict(slots=1), 4, 3, 10),
    ("sjf", dict(slots=2), 4, 3, 11),
])
def test_engine_schedule_and_tokens_match_jax(setup, scheduler, kw, n, max_new, seed):
    prompts = _workload(setup["cfg"], n, seed, lo=10 if "num_blocks" in kw else 4,
                        hi=11 if "num_blocks" in kw else 12)
    priorities = [0, 5, 1, 9, 2][:n]
    je = _serve_jax(setup, prompts, max_new, priorities, scheduler=scheduler, **kw)
    te, _ = _serve_torch(setup, prompts, max_new, priorities, scheduler=scheduler, **kw)
    assert _schedule(te) == _schedule(je)
    if "num_blocks" in kw:
        assert te.preempt_count >= 1, "the small pool did not force preemption"
    if scheduler == "priority":
        assert te.admission_log == [3, 1, 2, 0]
    m = te.metrics()
    assert m["paged_kernel"] == "ref"
    assert m["kernel_launches"] == {"paged_attention": 0, "moe_jam": 0}
    assert m["nonfinite_logits"] == 0 and m["steps"] <= m["ticks"]
    assert all(len(r.out_tokens) == max_new for r in te.completed)
    faults, exceptions, total = _oracle_exceptions(setup, prompts, te)
    print(f"[{scheduler} {kw}] {exceptions}/{total} tokens differ from the "
          f"float32 argmax inside the bf16 margin")
    assert not faults, faults
    assert exceptions <= total // 10


def test_stream_matches_drained_run(setup):
    prompts = _workload(setup["cfg"], 4, 21)
    prio = [0] * 4
    drained, _ = _serve_torch(setup, prompts, 5, prio)
    streamed_engine, streamed = _serve_torch(setup, prompts, 5, prio, stream=True)
    assert streamed == {r.rid: r.out_tokens for r in drained.completed}
    assert _schedule(streamed_engine)["admission"] == _schedule(drained)["admission"]


def test_engine_defaults_to_cuda_and_raises_without_it(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(setup["cfg"], **GEOM)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        Engine(setup["cfg"], device="cpu", kernel="cuda", **GEOM)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(setup["cfg"], cache="slots", **GEOM)
    with pytest.raises(ValueError, match="cache must be"):
        Engine(setup["cfg"], device="cpu", cache="contiguous", **GEOM)


PLACEMENTS = ("local", "injected", "auto")
FABRIC_KEYS = ("functions", "calls", "decisions", "leases", "placements", "lease_fallbacks")


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_placement_schedule_and_fabric_telemetry_match_jax(setup, placement):
    prompts = _workload(setup["cfg"], 3, 40)
    prio = [0] * 3
    je = _serve_jax(setup, prompts, 4, prio, placement=placement)
    te, _ = _serve_torch(setup, prompts, 4, prio, placement=placement)
    assert _schedule(te) == _schedule(je)
    tm, jm = te.metrics(), je.metrics()
    assert tm["engine"]["placement"] == jm["engine"]["placement"] == placement
    for key in FABRIC_KEYS:
        assert tm["fabric"][key] == jm["fabric"][key], key
    assert tm["transport_decisions"] == jm["transport_decisions"]
    step = "engine.paged_step"
    assert tm["fabric"]["calls"] == {step: te.steps} and te.steps == te.ticks
    if placement == "injected":
        lease = tm["fabric"]["leases"][f"{step}.params"]
        assert (lease["misses"], lease["hits"]) == (1, te.ticks - 1)
    else:
        assert tm["fabric"]["leases"] == {}
    if placement == "auto":
        assert len(tm["transport_decisions"]) == te.ticks
        assert all(d.endswith("-> local") for d in tm["transport_decisions"])
    faults, exceptions, total = _oracle_exceptions(setup, prompts, te)
    assert not faults, faults
    assert exceptions <= total // 10


def test_placement_changes_no_token_and_inject_params_warms_auto(setup):
    prompts = _workload(setup["cfg"], 3, 41)
    prio = [0] * 3
    outs = {}
    for placement in PLACEMENTS:
        te, _ = _serve_torch(setup, prompts, 5, prio, placement=placement)
        outs[placement] = {r.rid: r.out_tokens for r in te.completed}
    assert outs["local"] == outs["injected"] == outs["auto"]

    def injected_auto(engine, request_cls):
        engine.inject_params(setup["jparams"] if request_cls is JRequest else setup["tparams"])
        for rid, p in enumerate(prompts):
            engine.submit(request_cls(rid, p, max_new_tokens=5))
        engine.run_until_drained()
        return engine.metrics()

    with setup["mesh"]:
        jm = injected_auto(JEngine(setup["jcfg"], setup["run"], setup["mesh"], cache="paged",
                                   kernel="ref", placement="auto", **GEOM), JRequest)
    e = Engine(setup["cfg"], device="cpu", cache="paged", kernel="ref", placement="auto",
               **GEOM)
    tm = injected_auto(e, Request)
    for key in FABRIC_KEYS:
        assert tm["fabric"][key] == jm["fabric"][key], key
    assert tm["fabric"]["placements"]["engine.paged_step"] == "injected"
    lease = tm["fabric"]["leases"]["engine.paged_step.params"]
    assert (lease["misses"], lease["hits"]) == (1, e.ticks)
    assert all(d.endswith("-> injected") for d in tm["transport_decisions"])
    assert {r.rid: r.out_tokens for r in e.completed} == outs["local"]
    with pytest.raises(ValueError, match="placement"):
        Engine(setup["cfg"], device="cpu", placement="teleport", **GEOM)


@pytest.fixture(scope="module")
def olmoe(setup):
    jcfg = j_get_smoke("olmoe-1b-7b")
    with setup["mesh"]:
        jparams = jax.jit(lambda k: jmodel.init_params(jcfg, k)[0])(jax.random.PRNGKey(2))
    cfg = get_smoke("olmoe-1b-7b")
    bs = GEOM["block_size"]

    @jax.jit
    def jstep(params, cache, tok, tab, st, nv):
        logits, cache, _ = jmodel.forward(jcfg, params, tok, cache=cache,
                                          paged=JPagedLayout(tab, st, nv, bs),
                                          paged_kernel="ref", compute_dtype=jnp.float32)
        return logits, cache

    run = RunConfig(model=jcfg, shape=SHAPES["decode_32k"],
                    sharding=ShardingConfig(fsdp_params=False, seq_axis=None))
    return dict(setup, jcfg=jcfg, cfg=cfg, run=run, jparams=jparams, jstep=jstep,
                tparams=params_from_jax(jax.tree.map(np.asarray, jparams), cfg))


def _serve_recorded(s, prompts, max_new, dtype, **kw):
    """The port's FIFO engine on ``prompts``, its step built in ``dtype``;
    returns it and each step's inputs and emitted tokens (numpy)."""
    e = Engine(s["cfg"], device="cpu", cache="auto", kernel="ref", **{**GEOM, **kw})
    e.load_params(s["tparams"])
    if dtype != torch.bfloat16:
        e.bundle = make_paged_serve_step(
            s["cfg"], slots=e.slots, chunk=e.chunk, num_blocks=e.num_blocks,
            block_size=e.block_size, max_blocks_per_seq=e.max_blocks_per_seq,
            kernel="ref", device="cpu", compute_dtype=dtype)
        e.cache = tmodel.init_paged_cache(s["cfg"], e.num_blocks, e.block_size,
                                          dtype=dtype, device="cpu")
    steps, inner = [], e.bundle.fn

    def recording(params, cache, tokens, tables, starts, n_valid):
        out = inner(params, cache, tokens, tables, starts, n_valid)
        steps.append([a.numpy().copy() for a in (tokens, tables, starts, n_valid, out[0])])
        return out

    e.bundle.fn = recording
    for rid, p in enumerate(prompts):
        e.submit(Request(rid, p, max_new_tokens=max_new))
    e.run_until_drained()
    return e, steps


def _against_f32(s, steps, num_blocks, margin):
    """Replay the steps through the JAX paged forward in float32; returns
    (rows, rows equal to its argmax, faults: rows that differ by a top-2
    margin >= ``margin``)."""
    jcache = jmodel.init_paged_cache(s["jcfg"], num_blocks, GEOM["block_size"],
                                     dtype=jnp.float32)
    rows, equal, faults = 0, 0, []
    for i, (tok, tab, st, nv, got) in enumerate(steps):
        logits, jcache = s["jstep"](s["jparams"], jcache,
                                    *map(jnp.asarray, (tok, tab, st, nv)))
        logits = np.asarray(logits)
        for r in np.nonzero(nv > 0)[0]:
            row = logits[r, nv[r] - 1]
            top2 = np.sort(row)[-2:]
            rows += 1
            if got[r] == int(np.argmax(row)):
                equal += 1
            elif top2[1] - top2[0] >= margin:
                faults.append((i, int(r), int(got[r]), int(np.argmax(row)),
                               float(top2[1] - top2[0])))
    return rows, equal, faults


def test_olmoe_engine_schedule_and_tokens_match_jax(olmoe):
    kw = dict(slots=2, num_blocks=10)
    prompts = _workload(olmoe["cfg"], 3, 3, lo=10, hi=11)
    je = _serve_jax(olmoe, prompts, 14, [0, 0, 0], scheduler="fifo", **kw)
    for dtype, margin in ((torch.float32, F32_MARGIN_TOL), (torch.bfloat16, MARGIN_TOL)):
        e, steps = _serve_recorded(olmoe, prompts, 14, dtype, **kw)
        assert e.cache_kind == "paged"
        assert _schedule(e) == _schedule(je) and e.preempt_count >= 1
        assert all(len(r.out_tokens) == 14 for r in e.completed)
        m = e.metrics()
        assert m["kernel_launches"] == {"paged_attention": 0, "moe_jam": 0}
        assert m["nonfinite_logits"] == 0
        rows, equal, faults = _against_f32(olmoe, steps, kw["num_blocks"], margin)
        print(f"[olmoe {dtype}] {equal}/{rows} step rows equal the float32 argmax; "
              f"{len(faults)} differ by a top-2 margin >= {margin}")
        if dtype == torch.float32:
            assert not faults, faults
            assert rows - equal <= rows // 10
        else:
            assert rows - len(faults) >= MOE_BF16_SHARE * rows, faults


# ---------------------------------------------------------------------------
# mamba-130m: the recurrent backend
# ---------------------------------------------------------------------------

REC_GEOM = dict(slots=2, max_len=48, chunk=4)
REC_LENS, REC_NEW = (4, 5, 7), 6


@pytest.fixture(scope="module")
def mamba(setup):
    jcfg = j_get_smoke("mamba-130m")
    with setup["mesh"]:
        jparams = jax.jit(lambda k: jmodel.init_params(jcfg, k)[0])(jax.random.PRNGKey(3))
    cfg = get_smoke("mamba-130m")
    run = RunConfig(model=jcfg, shape=SHAPES["decode_32k"],
                    sharding=ShardingConfig(fsdp_params=False, seq_axis=None))
    oracle = jax.jit(lambda p, t: jmodel.forward(jcfg, p, t, compute_dtype=jnp.float32)[0])
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32) for n in REC_LENS]
    return dict(setup, jcfg=jcfg, cfg=cfg, run=run, jparams=jparams, oracle=oracle,
                prompts=prompts,
                tparams=params_from_jax(jax.tree.map(np.asarray, jparams), cfg))


def _recurrent_engine(s, dtype, placement="local", **geom):
    """The port's recurrent engine on the CPU, its step, cache and state
    template built in ``dtype``."""
    e = Engine(s["cfg"], device="cpu", cache="auto", placement=placement, **geom)
    e.load_params(s["tparams"])
    if dtype != torch.bfloat16:
        e.bundle = make_recurrent_serve_step(s["cfg"], slots=e.slots, chunk=e.chunk,
                                             kernel="ref", device="cpu", compute_dtype=dtype)
        make = lambda n: tmodel.init_recurrent_cache(s["cfg"], n, dtype=dtype, device="cpu")
        e.state = RecurrentState(e.slots, lambda: make(1))
        e.cache = make(e.slots)
    return e


def _drive_recurrent(e, request_cls, prompts):
    """Submit, tick twice, preempt the request in the first occupied slot
    (in decode by then), drain; returns the preempted rid."""
    for rid, p in enumerate(prompts):
        e.submit(request_cls(rid, p, max_new_tokens=REC_NEW))
    e.tick()
    e.tick()
    victim = next(x for x in e.slot_entry if x is not None)
    assert victim.pos > len(victim.prompt_tokens), "the victim is not in decode"
    e.preempt(victim.req.rid)
    e.run_until_drained()
    return victim.req.rid


def test_recurrent_engine_schedule_and_tokens_match_jax(mamba):
    with mamba["mesh"]:
        je = JEngine(mamba["jcfg"], mamba["run"], mamba["mesh"], cache="recurrent",
                     **REC_GEOM)
        je.load_params(mamba["jparams"])
        j_victim = _drive_recurrent(je, JRequest, mamba["prompts"])
    jm = je.state.metrics()
    snaps = ("snapshots_taken", "snapshots_restored")
    want_sched = dict(_schedule(je), **{k: jm[k] for k in snaps})
    for dtype, margin in ((torch.float32, F32_MARGIN_TOL), (torch.bfloat16, MARGIN_TOL)):
        e = _recurrent_engine(mamba, dtype, **REC_GEOM)
        assert e.cache_kind == "recurrent" and e.kernel == "ref"
        assert _drive_recurrent(e, Request, mamba["prompts"]) == j_victim
        m = e.metrics()
        assert dict(_schedule(e), **{k: m[k] for k in snaps}) == want_sched
        if dtype == torch.bfloat16:      # the JAX engine's conv history is bf16 too
            assert m["state_bytes_per_slot"] == jm["state_bytes_per_slot"]
        assert m["preemptions"] >= 1 and m["snapshots_restored"] >= 1
        assert m["kernel_launches"] == {"ssm_scan": 0} and m["nonfinite_logits"] == 0
        assert all(len(r.out_tokens) == REC_NEW for r in e.completed)
        gaps = {}
        faults, exceptions, total = _oracle_exceptions(mamba, mamba["prompts"], e, margin,
                                                       gaps)
        same = same_tokens_but_at_ties({r.rid: r.out_tokens for r in e.completed},
                                       {r.rid: r.out_tokens for r in je.completed}, gaps)
        print(f"[mamba {dtype}] {exceptions}/{total} tokens differ from the float32 "
              f"argmax inside the margin {margin}; {same}/{total} equal to the JAX engine's")
        assert not faults, faults
        assert exceptions <= total // 10


def test_recurrent_engine_placement_injected_changes_no_token(mamba):
    """The recurrent step through the fabric at placement="injected": the
    tokens of local, the params lease one miss and a hit every later step,
    also with a step bundle swapped in after construction (float32)."""
    outs = {}
    for placement in ("local", "injected"):
        e = _recurrent_engine(mamba, torch.float32, placement=placement, **REC_GEOM)
        _drive_recurrent(e, Request, mamba["prompts"])
        outs[placement] = {r.rid: r.out_tokens for r in e.completed}
        m = e.metrics()
        assert m["fabric"]["placements"] == {"engine.recurrent_step": placement}
        assert m["fabric"]["calls"] == {"engine.recurrent_step": e.steps}
    lease = m["fabric"]["leases"]["engine.recurrent_step.params"]
    assert (lease["misses"], lease["hits"]) == (1, e.steps - 1)
    assert outs["local"] == outs["injected"]


def test_recurrent_engine_retemplates_a_freed_slot(mamba):
    """One slot serves two requests in turn: the second emits what it emits
    on a fresh engine, so the first one's state did not leak into it."""
    def serve(prompts):
        e = _recurrent_engine(mamba, torch.float32, slots=1, max_len=48, chunk=4)
        for rid, p in enumerate(prompts):
            e.submit(Request(rid, p, max_new_tokens=4))
        e.run_until_drained()
        return {r.rid: r.out_tokens for r in e.completed}

    a, b = mamba["prompts"][2], mamba["prompts"][0]
    assert serve([a, b])[1] == serve([b])[0]
    # and at the backend: a fresh entry gets the template, a snapshot its rows
    st = RecurrentState(2, lambda: {"layers": [{"state": torch.full((1, 3), 2.0)}]})
    cache = {"layers": [{"state": torch.full((2, 3), 9.0)}]}

    class Entry:
        snapshot = None
    st.init(Entry(), cache, 1)
    assert cache["layers"][0]["state"].tolist() == [[9.0] * 3, [2.0] * 3]
    victim = Entry()
    st.evict(victim, cache, 0)
    cache["layers"][0]["state"].zero_()
    st.init(victim, cache, 1)
    assert cache["layers"][0]["state"].tolist() == [[0.0] * 3, [9.0] * 3]
    assert victim.snapshot is None
    assert st.metrics() == {"state_bytes_per_slot": 12, "snapshots_taken": 1,
                            "snapshots_restored": 1}


def test_default_cache_backend_per_family(mamba):
    assert default_cache_backend(mamba["cfg"]) == "recurrent"
    assert default_cache_backend(get_smoke("llama3.2-1b")) == "paged"
    assert default_cache_backend(get_smoke("deepseek-v2-lite-16b")) == "slots"
    assert default_cache_backend(get_smoke("xlstm-1.3b")) == "recurrent"
    assert default_cache_backend(get_smoke("hymba-1.5b")) == "slots"
    assert default_cache_backend(get_smoke("qwen2-vl-72b")) == "slots"
    assert default_cache_backend(j_get_smoke("qwen2-vl-72b")) == "slots"
    with pytest.raises(ValueError, match="recurrent serving supports"):
        Engine(get_smoke("llama3.2-1b"), device="cpu", cache="recurrent", **REC_GEOM)
    with pytest.raises(ValueError, match="paged serving supports"):
        e = Engine(mamba["cfg"], device="cpu", cache="paged", num_blocks=16, block_size=4,
                   **REC_GEOM)
        e.load_params(mamba["tparams"])
    e = Engine(mamba["cfg"], device="cpu", cache="recurrent", **REC_GEOM)
    with pytest.raises(KeyError, match="not running"):
        e.preempt(0)


def test_recurrent_entry_points_default_to_cuda_and_raise_without_it(mamba):
    from repro_torch.runtime.steps import make_recurrent_serve_step

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(mamba["cfg"], cache="recurrent", **REC_GEOM)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(mamba["cfg"], cache="auto", **REC_GEOM)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_recurrent_serve_step(mamba["cfg"], slots=2, chunk=4)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        Engine(mamba["cfg"], device="cpu", cache="recurrent", kernel="cuda", **REC_GEOM)
