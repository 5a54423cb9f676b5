"""Port parity: the contiguous forward and the slots Engine against the JAX
package's, on the dense-GQA smokes of ``gemma3-4b`` (6 layers, 5 local of
window 8 and 1 global), ``stablelm-3b`` (MHA, 25% rotary) and
``granite-20b`` (MQA, non-gated MLP).

* Configs, layer plans and the default backend equal the JAX package's.
* Forward parity in float32 from the same weights (``params_from_jax``): a
  prefill of two rows into a fresh contiguous cache, then decode steps,
  and a forward with no cache. Logits and every layer's k/v rows
  (``bridge.slot_cache_from_jax``) within ``ATOL`` (1e-4: float32 through a
  few layers, sums in other orders; ~3e-6 seen), the shared ``length``
  exactly. ``path="flash"`` lowers the chunking threshold in both packages
  (``CHUNK_THRESHOLD``, and the JAX package's ``Q_CHUNK``/``KV_CHUNK``, by
  monkeypatch: no file changes) so the prefill and the cacheless forward
  take the JAX ``_sdpa_chunked`` and the port's flash attention (its plain
  version on the CPU, one call per layer); ``path="sdpa"`` keeps both on
  plain ``_sdpa``.
* The real threshold: ``S * S > 2^22`` in both packages; a 2,112-token
  prompt prefills through flash attention at the threshold as it stands
  and matches the JAX prefill.
* bfloat16: the JAX package scans a group's repeated layers at prefill and
  unrolls them at decode; the port unrolls both. The logits differ by
  rounding, within ``BF16_LOGITS`` of the largest |logit|.
* The slots Engine: the port's ``Engine(cache="slots", device="cpu",
  kernel="ref")`` against the JAX ``Engine(cache="slots")`` on the gemma
  smoke, FIFO and priority, with prompts of unaligned lengths, so every
  slot decodes at the one shared cache length (the reference's lockstep,
  exact only for aligned admissions, reproduced as it is). Admission
  order, ticks, completions and the final shared length match exactly.
  The tokens are held against the JAX float32 forward driven through the
  port's own admissions and decode inputs (prefill into a fresh row,
  scatter, length rule, decode): each emitted token is the argmax of the
  logits its step computed (and a decode step's own output), and that
  forward's argmax, except where its top-2 margin is under the bf16
  margin (``MARGIN_TOL``) for the bf16 engine, under ``F32_MARGIN_TOL``
  for the port's engine built in float32 (at most one in ten tokens
  each). Each request's tokens are the JAX engine's up to a first
  difference, which must fall on a near tie of the float32 forward.
* The fabric: ``engine.decode`` at the engine's placement, ``engine.prefill``
  at local; the ``pick_victim`` warning; ``evict`` raises; a slot's row
  moves into another cache's slot (``serialize``/``restore``);
  ``--cache slots`` on the serve CLI.
* An SSM stack on slots (``mamba-130m``'s smoke, 2 slots of 32 rows,
  prompts of 4, 7 and 5 tokens, 4 new each): the same schedule as the JAX
  slots engine, the float32 engine's prefill and decode logits within
  ``ATOL`` of the JAX float32 forward driven through its own admissions
  and decode inputs, and the tokens as above (``slots_engine_parity``,
  which the xLSTM and hybrid tests use too).

The JAX prefill and decode are jitted here (a compile per shape, not per
op); the JAX engine's own prefill forward is jitted the same way.
"""
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs.base import SHAPES, RunConfig, ShardingConfig
from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import get_smoke as j_get_smoke
from repro.engine import Engine as JEngine
from repro.engine import Request as JRequest
from repro.engine import engine as j_engine_mod
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro_torch.bridge import params_from_jax, slot_cache_from_jax
from repro_torch.configs.registry import default_cache_backend, get_config, get_smoke
from repro_torch.engine import Engine, Request, SlotKVState
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.runtime.steps import make_prefill_step, make_serve_step
from test_torch_engine import same_tokens_but_at_ties
from test_torch_engine import share_cores_among_workers  # noqa: F401  (autouse)

ARCHS = ("gemma3-4b", "stablelm-3b", "granite-20b")
ATOL = 1e-4
BF16_LOGITS = 0.03
MARGIN_TOL = 5e-2          # as tests/test_torch_engine.py
F32_MARGIN_TOL = 1e-3
GEOM = dict(slots=2, max_len=48)
# unaligned in every two-slot wave, FIFO and priority; two lengths, so the
# JAX prefill compiles twice
LENS, MAX_NEW = (5, 9, 9, 5, 5), 8
PRIORITIES = (0, 5, 1, 9, 2)


@pytest.fixture(scope="module")
def models():
    out = {}
    for i, arch in enumerate(ARCHS):
        jcfg = j_get_smoke(arch)
        jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(i))[0]
        cfg = get_smoke(arch)
        out[arch] = dict(jcfg=jcfg, cfg=cfg, jparams=jparams,
                         tparams=params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    return out


def _patch_threshold(monkeypatch, path):
    if path == "flash":
        monkeypatch.setattr(jattn, "CHUNK_THRESHOLD", 64)
        monkeypatch.setattr(jattn, "Q_CHUNK", 4)
        monkeypatch.setattr(jattn, "KV_CHUNK", 4)
        monkeypatch.setattr(tattn, "CHUNK_THRESHOLD", 64)


def _count_flash(monkeypatch):
    calls = []
    inner = tattn.flash_attention

    def counting(*args, **kw):
        calls.append(kw.get("window"))
        return inner(*args, **kw)

    monkeypatch.setattr(tattn, "flash_attention", counting)
    return calls


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_configs_plans_and_backend_match_jax(arch):
    cfg = get_config(arch)
    assert cfg.to_json() == j_get_config(arch).to_json()
    assert get_smoke(arch).to_json() == j_get_smoke(arch).to_json()
    assert tmodel.layer_plan(cfg) == jmodel.layer_plan(j_get_config(arch))
    assert tmodel.layer_plan(get_smoke(arch)) == jmodel.layer_plan(j_get_smoke(arch))
    assert default_cache_backend(cfg) == "paged"


@pytest.mark.parametrize("path", ["sdpa", "flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_contiguous_forward_and_decode_match_jax(models, monkeypatch, arch, path):
    m = models[arch]
    jcfg, cfg, jp, tp = m["jcfg"], m["cfg"], m["jparams"], m["tparams"]
    _patch_threshold(monkeypatch, path)
    calls = _count_flash(monkeypatch)
    f32 = dict(compute_dtype=jnp.float32)
    jprefill = jax.jit(lambda p, t, c: jmodel.forward(jcfg, p, t, cache=c, **f32)[:2])
    jdecode = jax.jit(lambda p, c, t: jmodel.decode_step(jcfg, p, c, t, **f32))
    rng = np.random.default_rng(7)
    tok = rng.integers(0, cfg.vocab_size, size=(2, 13)).astype(np.int32)
    jl, jc = jprefill(jp, jnp.asarray(tok), jmodel.init_cache(jcfg, 2, 24, dtype=jnp.float32))
    tc = tmodel.init_cache(cfg, 2, 24, dtype=torch.float32, device="cpu")
    tl, tc, aux = tmodel.forward(cfg, tp, torch.from_numpy(tok), cache=tc, paged_kernel="ref",
                                 compute_dtype=torch.float32)
    assert aux == 0.0 and tl.shape == (2, 13, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    assert len(calls) == (cfg.num_layers if path == "flash" else 0)
    for step in range(2):
        t1 = rng.integers(0, cfg.vocab_size, size=(2, 1)).astype(np.int32)
        jl, jc = jdecode(jp, jc, jnp.asarray(t1))
        tl, tc = tmodel.decode_step(cfg, tp, tc, torch.from_numpy(t1), kernel="ref",
                                    compute_dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0,
                                   err_msg=f"decode step {step}")
    want = slot_cache_from_jax(jax.tree.map(np.asarray, jc), cfg)
    assert tc["length"] == want["length"] == 15
    for i, (got_l, want_l) in enumerate(zip(tc["layers"], want["layers"])):
        for kv in ("k", "v"):
            np.testing.assert_allclose(got_l[kv].numpy(), want_l[kv].numpy(), atol=ATOL,
                                       rtol=0, err_msg=f"layer {i} {kv}")
    # no cache: every position's logits
    jl = jax.jit(lambda p, t: jmodel.forward(jcfg, p, t, **f32)[0])(jp, jnp.asarray(tok))
    tl, none, _ = tmodel.forward(cfg, tp, torch.from_numpy(tok), paged_kernel="ref",
                                 compute_dtype=torch.float32)
    assert none is None
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    assert len(calls) == (2 * cfg.num_layers if path == "flash" else 0)


def test_real_threshold_holds_at_2112_tokens(models, monkeypatch):
    for mod in (jattn, tattn):
        assert not mod._use_chunked(2048, 2048) and mod._use_chunked(2049, 2049)
    assert tattn.CHUNK_THRESHOLD == jattn.CHUNK_THRESHOLD == 1 << 22
    m = models["gemma3-4b"]
    jcfg, cfg = m["jcfg"], m["cfg"]
    calls = _count_flash(monkeypatch)
    tok = np.random.default_rng(8).integers(0, cfg.vocab_size, size=(1, 2112)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: jmodel.forward(
        jcfg, p, t, cache=jmodel.init_cache(jcfg, 1, 2120, dtype=jnp.float32),
        compute_dtype=jnp.float32)[:2])(m["jparams"], jnp.asarray(tok))
    step = make_prefill_step(cfg, max_len=2120, kernel="ref", device="cpu",
                             compute_dtype=torch.float32)
    tl, tc = step.fn(m["tparams"], torch.from_numpy(tok))
    assert calls == [8, 8, 8, 8, 8, None]           # 5 local layers and 1 global
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[:, -1], atol=ATOL, rtol=0)
    want = slot_cache_from_jax(jax.tree.map(np.asarray, jc), cfg)
    assert tc["length"] == want["length"] == 2112
    for got_l, want_l in zip(tc["layers"], want["layers"]):
        for kv in ("k", "v"):
            np.testing.assert_allclose(got_l[kv].numpy(), want_l[kv].numpy(), atol=ATOL,
                                       rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_unrolled_layers_within_margin_of_scanned(models, arch):
    """The JAX package scans the repeated layers of stablelm's and granite's
    smokes at prefill (gemma's six layers form one unrepeated group); the
    port unrolls them. Prefill and two decode steps in bf16."""
    m = models[arch]
    jcfg, cfg = m["jcfg"], m["cfg"]
    jp = jax.tree.map(lambda t: t.astype(jnp.bfloat16), m["jparams"])
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    tok = np.random.default_rng(9).integers(0, cfg.vocab_size, size=(2, 13)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: jmodel.forward(
        jcfg, p, t, cache=jmodel.init_cache(jcfg, 2, 24))[:2])(jp, jnp.asarray(tok))
    tc = tmodel.init_cache(cfg, 2, 24, device="cpu")
    tl, tc, _ = tmodel.forward(cfg, tp, torch.from_numpy(tok), cache=tc, paged_kernel="ref")
    worst = float(np.abs(tl.numpy() - np.asarray(jl)).max() / np.abs(np.asarray(jl)).max())
    jdecode = jax.jit(lambda p, c, t: jmodel.decode_step(jcfg, p, c, t))
    for _ in range(2):
        t1 = np.asarray(np.asarray(jl)[:, -1].argmax(-1)[:, None], np.int32)
        jl, jc = jdecode(jp, jc, jnp.asarray(t1))
        tl, tc = tmodel.decode_step(cfg, tp, tc, torch.from_numpy(t1), kernel="ref")
        worst = max(worst, float(np.abs(tl.numpy() - np.asarray(jl)).max()
                                 / np.abs(np.asarray(jl)).max()))
    print(f"[{arch} bf16] largest logit difference {worst:.4f} of max |logit|")
    assert worst <= BF16_LOGITS


# ---------------------------------------------------------------------------
# the slots Engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def slots_env(models):
    m = models["gemma3-4b"]
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, m["cfg"].vocab_size, size=(n,)).astype(np.int32) for n in LENS]
    return slots_parity_env(m["jcfg"], m["cfg"], m["jparams"], prompts, **GEOM)


def slots_parity_env(jcfg, cfg, jparams, prompts, *, slots, max_len):
    """A slots engine comparison's inputs: a plain Mesh (all-Auto axes), the
    run config, the JAX float32 oracle (prefill into a fresh ``max_len``
    row, decode), the JAX engine's prefill forward jitted (the engine calls
    it eagerly), and the port's weights (float32, from the same JAX ones).
    The state and hybrid stacks' tests import it."""
    f32 = dict(compute_dtype=jnp.float32)
    jitted = types.SimpleNamespace(**vars(jmodel))
    jitted.forward = jax.jit(jmodel.forward, static_argnums=(0,))
    return dict(
        jcfg=jcfg, cfg=cfg, jparams=jparams, prompts=prompts, jitted=jitted,
        geom=dict(slots=slots, max_len=max_len),
        tparams=params_from_jax(jax.tree.map(np.asarray, jparams), cfg),
        mesh=Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model")),
        run=RunConfig(model=jcfg, shape=SHAPES["decode_32k"],
                      sharding=ShardingConfig(fsdp_params=False, seq_axis=None)),
        oracle=dict(
            prefill=jax.jit(lambda p, t: jmodel.forward(
                jcfg, p, t, cache=jmodel.init_cache(jcfg, 1, max_len, dtype=jnp.float32),
                **f32)[:2]),
            decode=jax.jit(lambda p, c, t: jmodel.decode_step(jcfg, p, c, t, **f32))))


def _serve_jax(env, monkeypatch, scheduler="fifo", placement="local", max_new=MAX_NEW):
    monkeypatch.setattr(j_engine_mod, "model_lib", env["jitted"])
    with env["mesh"], warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        e = JEngine(env["jcfg"], env["run"], env["mesh"], cache="slots", scheduler=scheduler,
                    placement=placement, **env["geom"])
        e.load_params(env["jparams"])
        for rid, p in enumerate(env["prompts"]):
            e.submit(JRequest(rid, p, max_new_tokens=max_new, priority=PRIORITIES[rid]))
        e.run_until_drained()
    return e


def _serve_torch(env, monkeypatch, scheduler="fifo", dtype=torch.bfloat16, placement="local",
                 cache="slots", max_new=MAX_NEW):
    """The port's slots engine (``cache`` "slots" or "auto") with its steps
    built in ``dtype``; returns it and its recorded prefills and decode
    steps: ``(kind, slots, (rid, position) of each slot's token, input
    tokens, logits, the step's tokens)``, a prefill's for its one slot
    (logits (1, V), no step tokens: the engine takes the argmax), a
    decode's for the active slots (every row's logits (slots, V), its
    tokens (slots, 1))."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        e = Engine(env["cfg"], device="cpu", cache=cache, kernel="ref", scheduler=scheduler,
                   placement=placement, **env["geom"])
    assert e.cache_kind == "slots"
    e.load_params(env["tparams"])
    if dtype != torch.bfloat16:
        e.bundle = make_serve_step(env["cfg"], slots=e.slots, kernel="ref", device="cpu",
                                   compute_dtype=dtype)
        e.prefill_bundle = make_prefill_step(env["cfg"], max_len=e.max_len, kernel="ref",
                                             device="cpu", compute_dtype=dtype)
        e.cache = tmodel.init_cache(env["cfg"], e.slots, e.max_len, dtype=dtype, device="cpu")
    events, decode_logits = [], []
    inner = tmodel.decode_step

    def rec_decode_step(*args, **kw):
        logits, c = inner(*args, **kw)
        decode_logits.append(logits[:, -1].numpy().copy())
        return logits, c

    monkeypatch.setattr(tmodel, "decode_step", rec_decode_step)
    prefill, decode = e.prefill_bundle.fn, e.bundle.fn

    def rec_prefill(params, tokens):
        out = prefill(params, tokens)
        # the admitted request was stamped just before its prefill
        events.append(("prefill", [e.slot_entry.index(None)], [(e.admission_log[-1], 0)],
                       tokens.numpy().copy(), out[0].numpy().copy(), None))
        return out

    def rec_decode(params, c, tokens):
        out = decode(params, c, tokens)
        active = [i for i, x in enumerate(e.slot_entry) if x is not None]
        at = [(e.slot_entry[i].req.rid, len(e.slot_entry[i].req.out_tokens)) for i in active]
        events.append(("decode", active, at, tokens.numpy().copy(), decode_logits[-1],
                       out[0].numpy().copy()))
        return out

    e.prefill_bundle.fn, e.bundle.fn = rec_prefill, rec_decode
    for rid, p in enumerate(env["prompts"]):
        e.submit(Request(rid, p, max_new_tokens=max_new, priority=PRIORITIES[rid]))
    e.run_until_drained()
    monkeypatch.setattr(tmodel, "decode_step", inner)
    return e, events


def _schedule(e):
    return dict(admission=list(e.admission_log), ticks=e.ticks, completed=len(e.completed),
                length=int(e.cache["length"]))


def _scatter(live, one, slot, slots):
    """The JAX engine's prefill scatter (``Engine._prefill_slot``)."""
    def put(a, b):
        for ax in range(a.ndim):
            if a.shape[ax] == slots and b.shape[ax] == 1 and a.shape[:ax] == b.shape[:ax]:
                return a.at[(slice(None),) * ax + (slot,)].set(jnp.take(b, 0, axis=ax))
        return a
    return {"length": jnp.maximum(live["length"], one["length"]),
            "groups": jax.tree.map(put, live["groups"], one["groups"])}


def _drive_oracle(env, events, margin, emitted):
    """The JAX float32 forward driven through recorded admissions and decode
    inputs. Each token the engine emitted (``emitted``, ``{rid: tokens}``)
    must be the argmax of the logits its step computed, and a decode
    step's own output; it is held against the oracle's argmax under the
    top-2 ``margin``. Returns (tokens compared, tokens that differ from the
    oracle's argmax under the margin, tokens that differ past it, the
    largest logit difference over the prefills and the active decode rows,
    the oracle's top-2 margin at each (rid, position))."""
    slots = env["geom"]["slots"]
    jcache = jmodel.init_cache(env["jcfg"], slots, env["geom"]["max_len"], dtype=jnp.float32)
    total, exceptions, faults, worst, gaps = 0, 0, [], 0.0, {}

    def check(at, row, got, stepped):
        nonlocal total, exceptions, worst
        tok = emitted[at[0]][at[1]]
        assert tok == int(np.argmax(got)), (at, tok, int(np.argmax(got)))
        assert stepped is None or tok == int(stepped), (at, tok, int(stepped))
        total += 1
        worst = max(worst, float(np.abs(got - row).max()))
        top2 = np.sort(row)[-2:]
        gaps[at] = float(top2[1] - top2[0])
        if tok != int(np.argmax(row)):
            if gaps[at] >= margin:
                faults.append((at, tok, int(np.argmax(row)), gaps[at]))
            else:
                exceptions += 1

    for kind, where, at, inp, out, stepped in events:
        if kind == "prefill":
            logits, filled = env["oracle"]["prefill"](env["jparams"], jnp.asarray(inp))
            check(at[0], np.asarray(logits)[0, -1], out[0], None)
            jcache = _scatter(jcache, filled, where[0], slots)
        else:
            logits, jcache = env["oracle"]["decode"](env["jparams"], jcache, jnp.asarray(inp))
            for r, a in zip(where, at):
                check(a, np.asarray(logits)[r, -1], out[r], stepped[r, 0])
    return total, exceptions, faults, worst, gaps


@pytest.mark.parametrize("scheduler", ["fifo", "priority"])
def test_slots_engine_schedule_and_tokens_match_jax(slots_env, monkeypatch, scheduler):
    je = _serve_jax(slots_env, monkeypatch, scheduler)
    want = _schedule(je)
    if scheduler == "priority":
        assert want["admission"] == [3, 1, 4, 2, 0]
    for dtype, margin in ((torch.bfloat16, MARGIN_TOL), (torch.float32, F32_MARGIN_TOL)):
        e, events = _serve_torch(slots_env, monkeypatch, scheduler, dtype)
        assert _schedule(e) == want
        assert all(len(r.out_tokens) == MAX_NEW for r in e.completed)
        m = e.metrics()
        assert m["kernel"] == "ref" and m["kernel_launches"] == {"flash_attention": 0}
        assert m["nonfinite_logits"] == 0 and m["steps"] == e.ticks
        assert "chunk" not in m and m["engine"]["cache"] == "slots"
        ours = {r.rid: r.out_tokens for r in e.completed}
        total, exceptions, faults, _, gaps = _drive_oracle(slots_env, events, margin, ours)
        same = same_tokens_but_at_ties(ours, {r.rid: r.out_tokens for r in je.completed}, gaps)
        print(f"[slots {scheduler} {dtype}] {exceptions}/{total} tokens differ from the "
              f"float32 argmax inside the margin {margin}; {same}/{total} equal to the JAX "
              f"engine's")
        assert not faults, faults
        assert exceptions <= total // 10


@pytest.mark.parametrize("placement", ["local", "injected"])
def test_slots_fabric_steps_and_placements_match_jax(slots_env, monkeypatch, placement):
    je = _serve_jax(slots_env, monkeypatch, placement=placement)
    e, _ = _serve_torch(slots_env, monkeypatch, placement=placement)
    tm, jm = e.metrics()["fabric"], je.metrics()["fabric"]
    for key in ("functions", "calls", "decisions", "leases", "placements", "lease_fallbacks"):
        assert tm[key] == jm[key], key
    assert tm["functions"] == ["engine.decode", "engine.prefill"]
    assert tm["calls"] == {"engine.prefill": len(LENS), "engine.decode": e.ticks}
    assert tm["placements"] == {"engine.decode": placement, "engine.prefill": "local"}


def test_slots_backend_cannot_preempt_and_warns(slots_env, monkeypatch):
    monkeypatch.setattr(j_engine_mod, "model_lib", slots_env["jitted"])
    with slots_env["mesh"], pytest.warns(UserWarning, match="pick_victim will never"):
        JEngine(slots_env["jcfg"], slots_env["run"], slots_env["mesh"], cache="slots",
                scheduler="priority", **GEOM)
    with pytest.warns(UserWarning, match="pick_victim will never"):
        Engine(slots_env["cfg"], device="cpu", cache="slots", scheduler="priority", **GEOM)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        e = Engine(slots_env["cfg"], device="cpu", cache="slots", **GEOM)
    e.load_params(slots_env["tparams"])
    e.submit(Request(0, slots_env["prompts"][0], max_new_tokens=MAX_NEW))
    e.tick()
    with pytest.raises(RuntimeError, match="cannot preempt"):
        e.preempt(0)
    state = SlotKVState(2)
    assert (state.kind, state.supports_preemption) == ("slots", False)
    assert state.capacity().free_units is None and state.grow(None, 10**6)
    # moving a slot row between engines (the cluster half of A12): slot 0's
    # row and the shared length restore into slot 1 of a fresh cache
    other = tmodel.init_cache(slots_env["cfg"], 2, GEOM["max_len"], device="cpu")
    state.restore(None, other, 1, state.serialize(None, e.cache, 0))
    assert other["length"] == e.cache["length"] > 0
    for live, moved in zip(e.cache["layers"], other["layers"]):
        for key in live:
            assert torch.equal(moved[key][1], live[key][0]) and not moved[key][0].any()
    with pytest.raises(ValueError, match="exceeds max_len"):
        e.submit(Request(1, np.zeros(45, np.int32), max_new_tokens=4))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        Engine(slots_env["cfg"], device="cpu", cache="slots", kernel="cuda", **GEOM)
    # an SSM stack serves on slots (C1): the parity case is below
    e = Engine(get_smoke("mamba-130m"), device="cpu", cache="slots", **GEOM)
    assert e.cache_kind == "slots" and e.kernel_launches == {"ssm_scan": 0}


# ---------------------------------------------------------------------------
# any stack on the slots Engine against the JAX one (the state and hybrid
# stacks' tests import ``slots_parity_env`` and ``slots_engine_parity``)
# ---------------------------------------------------------------------------

def slots_engine_parity(env, max_new, monkeypatch, cache="slots"):
    """The port's slots Engine against the JAX ``Engine(cache="slots")`` on
    ``env``'s prompts, FIFO: admission order, ticks, completions and the
    shared length exactly, in bf16 and in float32; the float32 engine's
    prefill and active decode logits within ``ATOL`` of the JAX float32
    forward driven through its own admissions and decode inputs, and its
    tokens that forward's argmax (but under ``F32_MARGIN_TOL``, at most one
    in ten); the bf16 engine's tokens that argmax within ``MARGIN_TOL``
    (at most one in ten under it); each engine's tokens the JAX engine's
    (``same_tokens_but_at_ties``)."""
    je = _serve_jax(env, monkeypatch, max_new=max_new)
    want = _schedule(je)
    theirs = {r.rid: r.out_tokens for r in je.completed}
    for dtype, margin in ((torch.float32, F32_MARGIN_TOL), (torch.bfloat16, MARGIN_TOL)):
        e, events = _serve_torch(env, monkeypatch, dtype=dtype, cache=cache, max_new=max_new)
        assert _schedule(e) == want
        assert all(len(r.out_tokens) == max_new for r in e.completed)
        m = e.metrics()
        assert m["kernel"] == "ref" and not any(m["kernel_launches"].values())
        assert m["nonfinite_logits"] == 0 and m["steps"] == e.ticks
        ours = {r.rid: r.out_tokens for r in e.completed}
        total, exceptions, faults, worst, gaps = _drive_oracle(env, events, margin, ours)
        same = same_tokens_but_at_ties(ours, theirs, gaps)
        print(f"[{env['cfg'].name} slots {dtype}] {exceptions}/{total} tokens differ from the "
              f"float32 argmax inside the margin {margin}; largest logit difference "
              f"{worst:.2e}; {same}/{total} equal to the JAX engine's")
        assert not faults, faults
        assert exceptions <= total // 10
        if dtype == torch.float32:
            assert worst <= ATOL, worst


def test_mamba_slots_engine_matches_jax(monkeypatch):
    """C1: an SSM stack on slots. The state rows ``{"conv", "state"}``
    scatter into the slot at admission and every slot's state advances at
    every decode tick, as in the JAX package."""
    jcfg = j_get_smoke("mamba-130m")
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(3))[0]
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, jcfg.vocab_size, size=(n,)).astype(np.int32) for n in (4, 7, 5)]
    env = slots_parity_env(jcfg, get_smoke("mamba-130m"), jparams, prompts, slots=2,
                           max_len=32)
    slots_engine_parity(env, 4, monkeypatch)


def test_serve_cli_slots_on_the_cpu(monkeypatch, capsys):
    from repro_torch.launch import serve

    monkeypatch.setattr("sys.argv", ["serve", "--arch", "gemma3-4b", "--smoke", "--device",
                                     "cpu", "--cache", "slots", "--max-len", "64",
                                     "--prompt-len", "20", "--requests", "3", "--max-new", "4",
                                     "--metrics-json"])
    serve.main()
    out = capsys.readouterr().out
    assert "[serve:slots/fifo] 3/3 requests, 12 tokens" in out
    assert '"cache": "slots"' in out and "flash_attention" in out
