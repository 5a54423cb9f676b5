"""Port parity: the cluster half of ROADMAP A12 against the JAX package.

* **Wire.** For the same ticket (stateless, one frame, several frames) the
  port's ``encode_handoff`` train equals the JAX ``encode_handoff``'s word
  for word; each package decodes the other's train; ``decode_handoff``
  rejects a flipped bit, a dropped, duplicated or reordered frame and a bad
  train length with the JAX messages.
* **State format.** For the same cache contents, the JAX backends'
  ``serialize`` bytes, converted by ``bridge.state_from_jax``, equal the
  port backends' ``serialize`` bytes exactly: paged and slots
  (``llama3.2-1b`` smoke, a repeated group), slots for ``gemma3-4b``'s,
  recurrent for ``mamba-130m``'s and ``xlstm-1.3b``'s (mixed per-layer
  dicts, which also round-trip through ``ssm_cache_to_bytes``).
* **Migration against JAX (float32).** Two port engines per backend, in
  float32 on the geometry of ``tests/test_cluster.py``: a request migrated
  after 1, 2 or 4 ticks (paged; 1 and 2 are mid-chunked-prefill), 1 or 3
  (slots, recurrent mamba) emits the tokens of the JAX package's greedy
  solo run (its float32 forward over the request's sequence), and every
  logits row the port's steps produced for it is within ``ATOL`` of that
  forward's at the same position.
* **Cross-framework import.** A ticket the JAX paged engine takes
  mid-decode (``snapshot_request``) goes through ``bridge.state_from_jax``
  and the wire, imports into the port's engine and finishes with the JAX
  engine's tokens (both bf16: equal up to a near tie of the float32
  oracle, ``test_torch_engine.same_tokens_but_at_ties``).
* **xLSTM.** A recurrent ``xlstm-1.3b`` smoke migration against the port's
  own solo run.
* **Router**, against the port's own solo run (each solo on a restarted
  engine, so a slots run starts at length 0): the properties of
  ``tests/test_cluster.py``, placement by load and model pinning,
  duplicate ids, rebalance (and that it is advisory), drain (and with no
  peer), the validation errors, callbacks exactly once across a
  migration, ``metrics()`` with the JAX router's keys, and the launcher's
  clean run.
"""
import dataclasses
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.cluster import decode_handoff as j_decode
from repro.cluster import encode_handoff as j_encode
from repro.configs.base import SHAPES, RunConfig, ShardingConfig
from repro.configs.registry import get_smoke as j_get_smoke
from repro.engine import Engine as JEngine
from repro.engine import MigrationTicket as JTicket
from repro.engine import Request as JRequest
from repro.engine import state as jstate
from repro.models import model as jmodel
from repro.models.kvcache import state_to_bytes as j_state_to_bytes
from repro_torch import bridge
from repro_torch.cluster import (HANDOFF_SPEC, MIGRATE_FUNC_ID, MigrateOnOversubscription,
                                 MigrationPlan, Replica, Router, decode_handoff, encode_handoff)
from repro_torch.configs.registry import get_smoke
from repro_torch.core.message import HDR_ELEM_ID, HDR_FUNC_ID, HDR_SEQ_NO
from repro_torch.engine import Engine, Request
from repro_torch.engine import state as tstate
from repro_torch.engine.engine import MigrationTicket
from repro_torch.launch import serve_cluster
from repro_torch.models import model as tmodel
from repro_torch.models.kvcache import (ssm_cache_from_bytes, ssm_cache_to_bytes,
                                        state_to_bytes, tree_leaves)
from test_torch_engine import MARGIN_TOL, same_tokens_but_at_ties
from test_torch_engine import share_cores_among_workers  # noqa: F401  (autouse)

# float32 logits of the two packages agree to ~1e-4 (test_torch_model)
ATOL = 1e-4
# the geometry of tests/test_cluster.py's fixtures
PAGED = dict(cache="paged", slots=2, max_len=32, num_blocks=16, block_size=4, chunk=4)
SLOTS = dict(cache="slots", slots=2, max_len=32)
RECURRENT = dict(cache="recurrent", slots=2, max_len=48, chunk=4)
ORACLE_LEN = 48                          # every oracle sequence is padded to this


# ---------------------------------------------------------------------------
# shared helpers (test_torch_faults imports them)
# ---------------------------------------------------------------------------

def port_engines(arch, geom, n, *, prefix, params=None, dtype=torch.float32):
    """``n`` port engines and a solo reference engine of one geometry, in
    ``dtype`` on the CPU, sharing one weight tree (``params``, else drawn
    from seed 0)."""
    cfg = get_smoke(arch)
    engines = []
    for i in range(n + 1):
        eid = f"{prefix}-ref" if i == n else f"{prefix}-{chr(ord('a') + i)}"
        e = Engine(cfg, device="cpu", kernel="ref", engine_id=eid, compute_dtype=dtype,
                   **geom)
        e.load_params(params if params is not None else
                      (engines[0].params if engines else None))
        engines.append(e)
    return cfg, engines[:n], engines[n]


def prompt_of(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)


def solo(ref, prompt, rid, max_new):
    """The request alone on a restarted reference engine."""
    ref.restart()
    h = ref.submit(Request(rid, prompt, max_new_tokens=max_new))
    ref.run_until_drained()
    return list(h.req.out_tokens)


@pytest.fixture(scope="module")
def jax_models():
    """The llama and mamba smokes' JAX weights, the port's copies, and the
    JAX float32 forward (no cache) jitted once per model."""
    out = {}
    for arch, seed in (("llama3.2-1b", 0), ("mamba-130m", 3)):
        jcfg = j_get_smoke(arch)
        jparams = jax.jit(lambda k, c=jcfg: jmodel.init_params(c, k)[0])(
            jax.random.PRNGKey(seed))
        cfg = get_smoke(arch)
        out[arch] = dict(
            jcfg=jcfg, cfg=cfg, jparams=jparams,
            tparams=bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg),
            oracle=jax.jit(lambda p, t, c=jcfg: jmodel.forward(
                c, p, t, compute_dtype=jnp.float32)[0]))
    return out


def oracle_logits(m, seq):
    """The JAX float32 forward's logits at every position of ``seq``."""
    pad = np.zeros((1, ORACLE_LEN), np.int32)
    pad[0, :len(seq)] = seq
    return np.asarray(m["oracle"](m["jparams"], jnp.asarray(pad)))[0, :len(seq)]


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------

TICKETS = {
    "stateless": dict(state=None, pos=0),
    "one frame": dict(state=b"\x01\x02" * 700, pos=9),
    "several frames": dict(state=bytes(range(256)) * 40, pos=9),
}


def _ticket(cls, state, pos):
    return cls(rid=7, cache_kind="paged", priority=3, max_new_tokens=5, prompt=[1, 2, 3],
               out_tokens=[4, 5], pos=pos, state=state)


@pytest.mark.parametrize("kind", sorted(TICKETS))
def test_handoff_frames_equal_jax_and_cross_decode(kind):
    t = _ticket(MigrationTicket, **TICKETS[kind])
    jt = _ticket(JTicket, **TICKETS[kind])
    frames = encode_handoff(t)
    jframes = j_encode(jt)
    assert frames.dtype == np.int32 and frames.shape == (len(jframes), HANDOFF_SPEC.total_words)
    np.testing.assert_array_equal(frames, np.stack(jframes))
    assert (len(frames) > 1) == (kind == "several frames")
    assert list(frames[:, HDR_FUNC_ID]) == [MIGRATE_FUNC_ID] * len(frames)
    assert list(frames[:, HDR_ELEM_ID]) == list(range(len(frames)))
    assert decode_handoff(frames) == t
    assert decode_handoff(jframes) == t                  # a sequence of (W,) frames
    assert dataclasses.asdict(j_decode(list(frames))) == dataclasses.asdict(jt)


def _rejects(frames, match):
    """Both packages reject the train with the same message."""
    with pytest.raises(ValueError, match=match) as port:
        decode_handoff(frames)
    with pytest.raises(ValueError, match=match) as ref:
        j_decode([np.asarray(f) for f in frames])
    assert str(port.value) == str(ref.value)


def test_handoff_decode_rejects_like_jax():
    frames = encode_handoff(_ticket(MigrationTicket, **TICKETS["several frames"]))
    bad = frames.copy()
    bad[0, HANDOFF_SPEC.offsets()["usr"] + 3] ^= 0xFF
    _rejects(bad, "SIG checksum")
    _rejects(frames[:-1], "truncated")
    _rejects(frames[::-1], "reordered")
    _rejects(np.concatenate([frames[:1], frames]), "truncated")     # duplicated
    alien = frames.copy()
    alien[0, HDR_FUNC_ID] = 9
    _rejects(alien, "not the migration handler")
    long = frames.copy()
    long[:, HDR_SEQ_NO] += 1
    _rejects(long, "truncated")
    pad = frames.copy()
    pad[1, -1] = 1
    _rejects(pad, "padding")
    with pytest.raises(ValueError, match="no frames"):
        decode_handoff([])


# ---------------------------------------------------------------------------
# the state format: the JAX backends' bytes, converted, are the port's
# ---------------------------------------------------------------------------

def _fill(tree, rng):
    """Random contents for every array of a JAX cache tree (numpy)."""
    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "int32":
            return np.asarray(7, np.int32) if a.ndim == 0 else a
        return rng.standard_normal(a.shape).astype(a.dtype)
    return jax.tree.map(one, tree)


def _port_order(cache, like):
    """``cache``'s layer dicts in the key order of the port's own caches
    (``like``), which its buffers follow (the bridge keeps JAX's sorted
    keys)."""
    return dict(cache, layers=[{k: layer[k] for k in ref}
                               for layer, ref in zip(cache["layers"], like["layers"])])


@pytest.mark.parametrize("arch,kind", [("llama3.2-1b", "paged"), ("llama3.2-1b", "slots"),
                                       ("gemma3-4b", "slots"), ("mamba-130m", "recurrent"),
                                       ("xlstm-1.3b", "recurrent")])
def test_state_from_jax_equals_port_bytes(arch, kind):
    jcfg, cfg = j_get_smoke(arch), get_smoke(arch)
    rng = np.random.default_rng(5)
    entry = types.SimpleNamespace(pos=6, blocks=[3, 0], snapshot=None)
    if kind == "paged":
        jcache = _fill(jmodel.init_paged_cache(jcfg, 5, 4), rng)
        jbuf = jstate.PagedKVState(5, 4).serialize(entry, jcache, 0)
        tcache = {"layers": [{k: bridge.to_tensor(v) for k, v in t.items()}
                             for t in bridge.flatten_groups(jcache["groups"], cfg)]}
        tbuf = tstate.PagedKVState(5, 4).serialize(entry, tcache, 0)
    else:
        jcache = _fill(jmodel.init_cache(jcfg, 3, 8), rng)
        template = lambda: jmodel.init_cache(jcfg, 1, 8)
        if kind == "slots":
            jbuf = jstate.SlotKVState(3, template).serialize(entry, jcache, 1)
            tcache = _port_order(bridge.slot_cache_from_jax(jcache, cfg),
                                 tmodel.init_cache(cfg, 1, 1, device="meta"))
            tbuf = tstate.SlotKVState(3).serialize(entry, tcache, 1)
        else:
            jbuf = jstate.RecurrentState(3, template).serialize(entry, jcache, 1)
            tcache = _port_order(bridge.recurrent_cache_from_jax(jcache, cfg),
                                 tmodel.init_recurrent_cache(cfg, 1, device="meta"))
            tbuf = tstate.RecurrentState(3, lambda: tmodel.init_recurrent_cache(
                cfg, 1, device="cpu")).serialize(entry, tcache, 1)
    assert bridge.state_from_jax(cfg, kind, jbuf) == tbuf
    if kind == "recurrent":
        back = ssm_cache_from_bytes(ssm_cache_to_bytes(tcache), tcache)
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(back), tree_leaves(tcache)))
    with pytest.raises(ValueError, match="leaves"):
        bridge.state_from_jax(cfg, kind, j_state_to_bytes({"x": np.zeros(2, np.float32)}))


def test_paged_state_restores_into_another_geometry():
    """A paged request's state, serialized from 4-token blocks, restores
    into a pool of 8-token blocks and gathers back the same tokens; a
    buffer for another request length is refused."""
    cfg = get_smoke("llama3.2-1b")
    src = tstate.PagedKVState(6, 4)
    cache = tmodel.init_paged_cache(cfg, 6, 4, dtype=torch.float32, device="cpu")
    for layer in cache["layers"]:
        for t in layer.values():
            t.copy_(torch.randn_like(t))
    entry = types.SimpleNamespace(pos=7, blocks=[5, 1], snapshot=None)
    buf = src.serialize(entry, cache, 0)
    dst = tstate.PagedKVState(3, 8)
    other = tmodel.init_paged_cache(cfg, 3, 8, dtype=torch.float32, device="cpu")
    moved = types.SimpleNamespace(pos=7, blocks=[2], snapshot=None)
    dst.restore(moved, other, 0, buf)
    want, got = src.gather(entry, cache, 0), dst.gather(moved, other, 0)
    for a, b in zip(want["layers"], got["layers"]):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert not other["layers"][0]["k"][2, 7:].any()        # the tail is zero-padded
    with pytest.raises(ValueError, match="state leaf mismatch"):
        dst.restore(types.SimpleNamespace(pos=6, blocks=[2]), other, 0, buf)
    with pytest.raises(ValueError, match="ambiguous block axis"):
        tstate.PagedKVState(2, 2)._block_axis((2, 2, 2, 2))


# ---------------------------------------------------------------------------
# migration against the JAX package (float32)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_pairs(jax_models):
    """Two float32 port engines per backend on the JAX weights."""
    llama, mamba = jax_models["llama3.2-1b"], jax_models["mamba-130m"]
    return {
        "paged": (llama, port_engines("llama3.2-1b", PAGED, 2, prefix="jp",
                                      params=llama["tparams"])[1]),
        "slots": (llama, port_engines("llama3.2-1b", SLOTS, 2, prefix="js",
                                      params=llama["tparams"])[1]),
        "recurrent": (mamba, port_engines("mamba-130m", RECURRENT, 2, prefix="jr",
                                          params=mamba["tparams"])[1]),
    }


class _LogitsRecorder:
    """Every logits row the port's steps compute, keyed by the absolute
    position of the token it follows: paged and recurrent steps (each row's
    last valid column), the slots prefill (its last position) and the slots
    decode (row 0: the request is alone and sits in slot 0 of each
    engine)."""

    def __init__(self, monkeypatch):
        self.rows = {}
        forward, decode = tmodel.forward, tmodel.decode_step

        def rec_forward(cfg, params, tokens, **kw):
            out = forward(cfg, params, tokens, **kw)
            layout = kw.get("paged") or kw.get("recurrent")
            if layout is not None:
                for b in np.nonzero(layout.n_valid.numpy())[0]:
                    nv = int(layout.n_valid[b])
                    self.rows[int(layout.starts[b]) + nv - 1] = out[0][b, nv - 1].numpy().copy()
            elif kw.get("last_only"):                    # the slots prefill
                self.rows[tokens.shape[1] - 1] = out[0][0, -1].numpy().copy()
            return out

        def rec_decode(cfg, params, cache, token, **kw):
            at = cache["length"]
            logits, c = decode(cfg, params, cache, token, **kw)
            self.rows[at] = logits[0, -1].numpy().copy()
            return logits, c

        monkeypatch.setattr(tmodel, "forward", rec_forward)
        monkeypatch.setattr(tmodel, "decode_step", rec_decode)


@pytest.mark.parametrize("kind,ticks_before,plen", [
    ("paged", 1, 11), ("paged", 2, 11), ("paged", 4, 11),
    ("slots", 1, 6), ("slots", 3, 6), ("recurrent", 1, 7), ("recurrent", 3, 7)])
def test_migration_matches_jax(jax_pairs, monkeypatch, kind, ticks_before, plen):
    m, (a, b) = jax_pairs[kind]
    for e in (a, b):
        e.restart()
    rid = 100 + ticks_before
    prompt = prompt_of(m["cfg"], plen, seed=rid)
    rec = _LogitsRecorder(monkeypatch)
    router = Router([Replica(a), Replica(b)])
    h = router.submit(Request(rid, prompt, max_new_tokens=6))
    assert h.engine_id == a.engine_id
    for _ in range(ticks_before):
        router.tick()
    router.migrate(rid, b.engine_id)
    assert h.engine_id == b.engine_id
    router.run_until_drained()
    got = list(h.req.out_tokens)
    mig = router.migrations[0]
    assert mig["state_bytes"] > 0 and mig["frames"] >= 1
    if kind == "paged" and ticks_before <= 2:
        assert 0 < mig["pos"] < plen, "not mid-prefill as intended"
    want = oracle_logits(m, np.concatenate([prompt, np.asarray(got[:-1], np.int32)]))
    assert got == [int(np.argmax(want[plen - 1 + i])) for i in range(len(got))]
    assert set(range(plen - 1, len(want))) <= set(rec.rows)
    worst = max(float(np.abs(rec.rows[p] - want[p]).max()) for p in rec.rows)
    print(f"[{kind} after {ticks_before}] {len(rec.rows)} logits rows, worst |port - jax| "
          f"{worst:.2e}")
    assert worst <= ATOL


def test_jax_ticket_finishes_on_the_port(jax_models):
    """The JAX paged engine's mid-decode snapshot, through the bridge and
    the wire, finishes on the port's engine with the JAX engine's tokens."""
    m = jax_models["llama3.2-1b"]
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    run = RunConfig(model=m["jcfg"], shape=SHAPES["decode_32k"],
                    sharding=ShardingConfig(fsdp_params=False, seq_axis=None))
    prompt = prompt_of(m["cfg"], 8, seed=31)
    geom = {k: v for k, v in PAGED.items() if k != "cache"}
    with mesh:
        je = JEngine(m["jcfg"], run, mesh, cache="paged", kernel="ref", **geom)
        je.load_params(m["jparams"])
        jh = je.submit(JRequest(31, prompt, max_new_tokens=8))
        for _ in range(4):
            je.tick()
        jt = je.snapshot_request(31)
        je.run_until_drained()
    want = list(jh.req.out_tokens)
    assert 0 < len(jt.out_tokens) < len(want) and jt.pos > len(prompt), "not mid-decode"
    ticket = MigrationTicket(**dict(dataclasses.asdict(jt),
                                    state=bridge.state_from_jax(m["cfg"], "paged", jt.state)))
    engine = Engine(m["cfg"], device="cpu", kernel="ref", **PAGED)
    engine.load_params(m["tparams"])
    h = engine.import_request(decode_handoff(encode_handoff(ticket)))
    engine.run_until_drained()
    assert engine.metrics()["migrations"] == {"in": 1, "out": 0}
    logits = oracle_logits(m, np.concatenate([prompt, np.asarray(want[:-1], np.int32)]))
    top2 = np.sort(logits, axis=-1)[:, -2:]
    gaps = {(31, i): float(top2[len(prompt) - 1 + i, 1] - top2[len(prompt) - 1 + i, 0])
            for i in range(len(want))}
    assert same_tokens_but_at_ties({31: h.req.out_tokens}, {31: want}, gaps,
                                   MARGIN_TOL) >= len(jt.out_tokens)


def test_xlstm_migration_matches_solo():
    """xLSTM's mixed per-layer state (mLSTM conv/state/n/m, sLSTM
    state/c/n/m) round-trips: a migrated request mid-prefill and one in
    decode finish as the port's solo run."""
    cfg, (a, b), ref = port_engines("xlstm-1.3b", dict(cache="recurrent", slots=2, max_len=48,
                                                        chunk=4), 2, prefix="xl")
    for ticks_before in (1, 3):
        rid = 160 + ticks_before
        prompt = prompt_of(cfg, 7, seed=rid)
        want = solo(ref, prompt, rid, 4)
        for e in (a, b):
            e.restart()
        router = Router([Replica(a), Replica(b)])
        h = router.submit(Request(rid, prompt, max_new_tokens=4))
        for _ in range(ticks_before):
            router.tick()
        router.migrate(rid, b.engine_id)
        router.run_until_drained()
        assert h.req.out_tokens == want
        # the whole per-slot state rides: the one-row template's buffer size
        assert router.migrations[0]["state_bytes"] == len(state_to_bytes(a.state.template))


# ---------------------------------------------------------------------------
# the Router, against the port's own solo run
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def paged_pair():
    return port_engines("llama3.2-1b", PAGED, 2, prefix="paged")


@pytest.fixture(scope="module")
def slots_pair():
    return port_engines("llama3.2-1b", SLOTS, 2, prefix="slots")


@pytest.fixture(scope="module")
def recurrent_pair():
    return port_engines("mamba-130m", RECURRENT, 2, prefix="rec")


def _reset(*engines):
    for e in engines:
        e.restart()


def test_cluster_handle_callbacks_exactly_once_across_migration(paged_pair):
    cfg, (a, b), ref = paged_pair
    _reset(a, b)
    prompt = prompt_of(cfg, 8, seed=41)
    want = solo(ref, prompt, 410, 8)
    router = Router([Replica(a), Replica(b)])
    seen = []
    h = router.submit(Request(411, prompt, max_new_tokens=8))
    h.on_token(lambda tok, i: seen.append((i, tok)))
    for _ in range(4):
        router.tick()
    assert len(h.req.out_tokens) >= 1, "request should be decoding by now"
    router.migrate(411, b.engine_id)
    streamed = list(h.tokens())
    assert h.done and h.req.out_tokens == want
    assert streamed == want and seen == list(enumerate(want))
    assert h.engine_id == b.engine_id
    assert "rid=411" in repr(h)


def test_router_places_by_load_and_pins_models(paged_pair, recurrent_pair):
    cfg, (a, b), _ = paged_pair
    mcfg, (ra, rb), _ = recurrent_pair
    _reset(a, b, ra, rb)
    router = Router([Replica(a, model="llama"), Replica(b, model="llama"),
                     Replica(ra, model="mamba"), Replica(rb, model="mamba")])
    hs = [router.submit(Request(500 + i, prompt_of(cfg, 5, seed=i), max_new_tokens=2),
                        model="llama") for i in range(4)]
    hm = router.submit(Request(510, prompt_of(mcfg, 5, seed=9), max_new_tokens=2),
                       model="mamba")
    with pytest.raises(ValueError, match="no live replica serves"):
        router.submit(Request(511, prompt_of(cfg, 4), max_new_tokens=1), model="gpt5")
    router.run_until_drained()
    placed = [p["engine_id"] for p in router.placements]
    assert placed[:4].count(a.engine_id) == 2 and placed[:4].count(b.engine_id) == 2
    assert placed[4] in (ra.engine_id, rb.engine_id)
    assert all(h.done for h in hs + [hm])
    assert all("estimate" in p and "load" in p for p in router.placements)


def test_router_rejects_duplicate_rids_and_engine_ids(paged_pair):
    cfg, (a, b), _ = paged_pair
    _reset(a, b)
    with pytest.raises(ValueError, match="duplicate engine_id"):
        Router([Replica(a), Replica(a)])
    router = Router([Replica(a), Replica(b)])
    h = router.submit(Request(530, prompt_of(cfg, 4), max_new_tokens=1))
    with pytest.raises(ValueError, match="already routed"):
        router.submit(Request(530, prompt_of(cfg, 4), max_new_tokens=1))
    router.run_until_drained()
    assert h.done


def test_rebalance_migrates_queued_work_and_is_advisory(paged_pair):
    """A replica back from draining takes its peer's queue through the
    frame path (metadata-only tickets); a stale plan is skipped."""
    cfg, (a, b), ref = paged_pair
    prompts = [prompt_of(cfg, 5, seed=60 + i) for i in range(4)]
    want = [solo(ref, p, 600 + i, 4) for i, p in enumerate(prompts)]
    _reset(a, b)
    rep_a, rep_b = Replica(a), Replica(b, draining=True)
    router = Router([rep_a, rep_b], rebalance=MigrateOnOversubscription(max_queue=0))
    hs = [router.submit(Request(600 + i, p, max_new_tokens=4)) for i, p in enumerate(prompts)]
    assert all(h.engine_id == a.engine_id for h in hs)
    rep_b.draining = False
    router.tick()
    assert router.migrations, "rebalance did not move queued work"
    assert all(m["reason"].startswith("queue depth") and m["state_bytes"] == 0
               for m in router.migrations)
    router.run_until_drained()
    assert [h.req.out_tokens for h in hs] == want
    assert router.rebalance_events >= 1
    moved = {m["rid"] for m in router.migrations}
    assert all(router._table[r] == b.engine_id for r in moved)

    class StalePlanner:
        name = "stale"

        def plan(self, router):
            return [MigrationPlan(rid=9999, src=a.engine_id, dst=b.engine_id)]

    router = Router([Replica(a), Replica(b)], rebalance=StalePlanner())
    h = router.submit(Request(610, prompt_of(cfg, 4), max_new_tokens=2))
    router.run_until_drained()
    assert h.done and not router.migrations and router.rebalance_events == 0


def test_drain_moves_running_and_queued_or_raises_with_no_peer(paged_pair):
    cfg, (a, b), ref = paged_pair
    prompts = [prompt_of(cfg, 6, seed=70 + i) for i in range(3)]
    want = [solo(ref, p, 700 + i, 4) for i, p in enumerate(prompts)]
    _reset(a, b)
    rep_a, rep_b = Replica(a), Replica(b, draining=True)
    router = Router([rep_a, rep_b])
    hs = [router.submit(Request(700 + i, p, max_new_tokens=4)) for i, p in enumerate(prompts)]
    router.tick()                       # a is mid-flight: 2 running, 1 queued
    rep_b.draining = False
    assert sorted(router.drain(a.engine_id)) == [700, 701, 702]
    assert rep_a.draining and not a.pending()
    assert all(h.engine_id == b.engine_id for h in hs)
    h9 = router.submit(Request(709, prompt_of(cfg, 4), max_new_tokens=1))
    assert h9.engine_id == b.engine_id   # a draining replica takes no placement
    router.run_until_drained()
    assert [h.req.out_tokens for h in hs] == want

    _reset(a)
    router = Router([Replica(a)])
    h = router.submit(Request(720, prompt_of(cfg, 5), max_new_tokens=3))
    with pytest.raises(RuntimeError, match="stranded rids \\[720\\]"):
        router.drain(a.engine_id)
    assert router.replica(a.engine_id).draining
    assert h.result().done               # it still completes where it is


def test_migrate_validation_errors(paged_pair, slots_pair):
    cfg, (a, b), _ = paged_pair
    _, (sa, _), _ = slots_pair
    _reset(a, b, sa)
    router = Router([Replica(a, model="llama"), Replica(b, model="other"),
                     Replica(sa, model="llama")])
    with pytest.raises(KeyError, match="not routed"):
        router.migrate(12345, b.engine_id)
    h = router.submit(Request(800, prompt_of(cfg, 5), max_new_tokens=2), model="llama")
    assert h.engine_id == a.engine_id
    with pytest.raises(ValueError, match="already lives"):
        router.migrate(800, a.engine_id)
    with pytest.raises(KeyError, match="unknown replica"):
        router.migrate(800, "ghost-engine")
    with pytest.raises(ValueError, match="different weights"):
        router.migrate(800, b.engine_id)
    with pytest.raises(ValueError, match="cache"):
        router.migrate(800, sa.engine_id)
    with pytest.raises(ValueError, match="cache_kind"):
        sa.import_request(a.snapshot_request(800))
    assert h.engine_id == a.engine_id
    router.run_until_drained()
    assert h.done
    assert router.compatible_targets(router.replica(a.engine_id)) == []
    with pytest.raises(KeyError, match="finished"):
        a.export_request(800)
    # the graph verbs refuse what the JAX ones refuse
    with pytest.raises(ValueError, match="no live replica serves model='ghost' for graph node"):
        router.place_node(gid=0, node="verify", model="ghost")
    with pytest.raises(ValueError, match="the verify step rides the paged"):
        sa.ensure_verify_step()
    a.ensure_verify_step()
    assert "engine.paged_verify" in a.metrics()["fabric"]["functions"]


def test_cluster_metrics_keys_equal_jax(paged_pair):
    """``Router.metrics()`` has the JAX router's keys, block for block, and
    the engines' migration counters line up with the router's log."""
    cfg, (a, b), _ = paged_pair
    _reset(a, b)
    router = Router([Replica(a), Replica(b)], name="test-cluster")
    hs = [router.submit(Request(900 + i, prompt_of(cfg, 5, seed=90 + i), max_new_tokens=3))
          for i in range(3)]
    router.tick()
    router.migrate(hs[0].rid, b.engine_id if hs[0].engine_id == a.engine_id else a.engine_id)
    router.run_until_drained()
    m = router.metrics()
    # the JAX Router.metrics() keys (repro/cluster/router.py), no graph run
    assert set(m) == {"cluster", "router", "replicas", "totals", "faults"}
    assert set(m["cluster"]) == {"name", "replicas", "rebalance"}
    assert set(m["router"]) == {"placements", "migrations", "rebalance_events",
                                "handoff_frames", "handoff_bytes", "node_placements",
                                "edge_frames", "edge_bytes", "edge_retransmits",
                                "edge_local_hits"}
    assert set(m["faults"]) == {"installed", "injected", "detected", "retransmits",
                                "failovers", "requests_recovered", "requests_failed",
                                "failures", "health_probes", "snapshots_taken",
                                "lease_fallbacks"}
    assert set(m["totals"]) == {"completed", "preemptions", "queued", "active_slots",
                                "migrations"}
    assert m["faults"]["installed"] is False and m["faults"]["requests_failed"] == {}
    assert [r["engine_id"] for r in m["cluster"]["replicas"]] == [a.engine_id, b.engine_id]
    for r in m["cluster"]["replicas"]:
        assert {"model", "cache", "draining", "failed", "queue_depth", "active", "slots",
                "occupancy"} <= set(r)
    assert set(m["replicas"]) == {a.engine_id, b.engine_id}
    for eid, em in m["replicas"].items():
        assert em["engine"]["engine_id"] == eid and em["engine"]["failed_reason"] is None
    r = m["router"]
    assert len(r["placements"]) == 3 and len(r["migrations"]) == 1
    assert r["handoff_bytes"] == r["handoff_frames"] * HANDOFF_SPEC.total_bytes >= 1
    assert m["totals"]["migrations"] == 1 and m["totals"]["completed"] >= 3
    # the engines' counters live across routers (earlier tests moved work too)
    assert sum(em["migrations"]["in"] for em in m["replicas"].values()) >= 1
    assert sum(em["migrations"]["out"] for em in m["replicas"].values()) >= 1


def test_serve_cluster_launcher_clean_run(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve_cluster", "--smoke", "--device", "cpu", "--replicas",
        "llama3.2-1b:paged,llama3.2-1b:paged,mamba-130m:recurrent", "--requests", "5",
        "--prompt-len", "6", "--max-new", "3", "--migrate-after", "2"])
    serve_cluster.main()
    out = capsys.readouterr().out
    assert "[cluster] 5/5 requests over 3 replicas" in out
    assert "forced migration: rid" in out
