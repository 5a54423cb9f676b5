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
"""
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
from repro_torch.bridge import params_from_jax
from repro_torch.configs.registry import get_smoke
from repro_torch.engine import Engine, Request

# bf16 logits of the smoke model deviate from float32 by up to ~2.5e-2
# (random 16-token prompts, logits up to ~3 in magnitude); two such errors
# of opposite sign can flip a top-2 margin below twice that
MARGIN_TOL = 5e-2
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


def _oracle_exceptions(s, prompts, engine):
    """Count emitted tokens that differ from the float32 argmax where the
    margin is >= MARGIN_TOL (faults) and where it is below (exceptions)."""
    faults, exceptions, total = [], 0, 0
    for r in engine.completed:
        seq = np.concatenate([prompts[r.rid], np.asarray(r.out_tokens, np.int32)])
        logits = np.asarray(s["oracle"](s["jparams"], jnp.asarray(seq[None, :-1])))[0]
        for i, tok in enumerate(r.out_tokens):
            row = logits[len(prompts[r.rid]) - 1 + i]
            top2 = np.sort(row)[-2:]
            total += 1
            if tok != int(np.argmax(row)):
                if top2[1] - top2[0] >= MARGIN_TOL:
                    faults.append((r.rid, i, tok, int(np.argmax(row)),
                                   float(top2[1] - top2[0])))
                else:
                    exceptions += 1
    return faults, exceptions, total


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
    assert m["paged_kernel"] == "ref" and m["kernel_launches"] == 0
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
    with pytest.raises(NotImplementedError, match="A7"):
        Engine(setup["cfg"], device="cpu", cache="slots", **GEOM)
