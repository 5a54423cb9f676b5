"""Port parity: ``repro_torch.faults`` and the cluster's recovery paths.

* **Injector.** The same plan and seed give the JAX injector's events,
  counters and perturbed trains, frame for frame, on the same train; plan
  validation; ``perturb_train`` never mutates its input; ``install``
  refuses other targets.
* **Chaos identity**, against the port's own solo run (each on a
  restarted engine), per backend, the properties of
  ``tests/test_faults.py``: under a seeded plan (frame faults at 0.35 and
  one replica kill) every request drains with the tokens of its solo run,
  each index delivered once, ``detected == retransmits``, one failover,
  nothing lost. Then retransmission until a train is clean, rollback when
  retries run out, a transactional drain under total noise, failover by
  recompute and from a snapshot, a typed failure with no peer, the health
  probe, an idempotent ``mark_failed``, the verbs refused until
  ``restart``, the lease storm falling back to local (engine hook and the
  lease pool's ``fault_hook``), and the launcher's chaos run.
"""
import sys

import numpy as np
import pytest

from repro.engine import MigrationTicket as JTicket
from repro.faults import FaultInjector as JFaultInjector
from repro.faults import FaultPlan as JFaultPlan
from repro.cluster import encode_handoff as j_encode
from repro_torch.cluster import MigrateOnOversubscription, Replica, Router, encode_handoff
from repro_torch.engine import Engine, Request
from repro_torch.engine.engine import MigrationTicket
from repro_torch.fabric import Fabric
from repro_torch.faults import (FAULT_KINDS, EngineFailedError, FaultInjector, FaultPlan,
                                MigrationFailedError, RequestFailedError)
from repro_torch.launch import serve_cluster
from test_torch_cluster import PAGED, RECURRENT, SLOTS, port_engines, prompt_of, solo
from test_torch_engine import share_cores_among_workers  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def paged_pair():
    return port_engines("llama3.2-1b", PAGED, 2, prefix="ft-paged")


@pytest.fixture(scope="module")
def slots_pair():
    return port_engines("llama3.2-1b", SLOTS, 2, prefix="ft-slots")


@pytest.fixture(scope="module")
def recurrent_pair():
    return port_engines("mamba-130m", RECURRENT, 2, prefix="ft-rec")


def _reset(*engines):
    for e in engines:
        e.restart()


def _ticket(cls, state=b"\x05\x06" * 900, rid=41):
    return cls(rid=rid, cache_kind="paged", priority=0, max_new_tokens=4, prompt=[1, 2, 3, 4],
               out_tokens=[9], pos=5, state=state)


# ---------------------------------------------------------------------------
# the injector itself
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,rate,kinds", [(123, 0.7, FAULT_KINDS), (4, 1.0, ("reorder",)),
                                             (9, 0.5, ("corrupt", "reorder", "duplicate"))])
def test_injector_events_and_trains_equal_jax(seed, rate, kinds):
    """Same plan and seed: the JAX injector's draws, events, counters and
    trains (a corrupted frame that a later reorder moves included)."""
    state = bytes(range(256)) * 60                      # a 4-frame train
    frames = encode_handoff(_ticket(MigrationTicket, state=state))
    jframes = j_encode(_ticket(JTicket, state=state))
    ours = FaultInjector(FaultPlan(seed=seed, frame_fault_rate=rate, fault_kinds=kinds))
    theirs = JFaultInjector(JFaultPlan(seed=seed, frame_fault_rate=rate, fault_kinds=kinds))
    for attempt in range(6):
        got = ours.perturb_train(frames, rid=1, attempt=attempt)
        want = theirs.perturb_train(jframes, rid=1, attempt=attempt)
        assert got.shape == (len(want), frames.shape[1])
        if want:
            np.testing.assert_array_equal(got, np.stack(want))
    assert ours.events == theirs.events and ours.counters == theirs.counters
    assert ours.injected == theirs.injected and ours.metrics() == theirs.metrics()


def test_fault_plan_validates_and_install_rejects_unknown_targets():
    with pytest.raises(ValueError, match="unknown fault kinds"):
        FaultPlan(fault_kinds=("corrupt", "gamma-ray"))
    with pytest.raises(ValueError, match="not in"):
        FaultPlan(frame_fault_rate=1.5)
    assert FaultPlan().fault_kinds == FAULT_KINDS
    with pytest.raises(TypeError, match="expected a Router or a Fabric"):
        FaultInjector(FaultPlan()).install(object())


def test_perturb_train_never_mutates_input():
    frames = encode_handoff(_ticket(MigrationTicket))
    before = frames.copy()
    inj = FaultInjector(FaultPlan(seed=3, frame_fault_rate=1.0, fault_kinds=("corrupt",)))
    perturbed = inj.perturb_train(frames, rid=1)
    np.testing.assert_array_equal(frames, before)
    assert (perturbed != before).any(axis=1).all()
    assert inj.counters["corrupt"] == len(frames) and inj.counters["trains_perturbed"] == 1
    assert inj.injected == len(frames)


# ---------------------------------------------------------------------------
# chaos: frame faults + one replica kill, per backend
# ---------------------------------------------------------------------------

def _chaos_run(pair, *, rid0, seed, snapshot_every, n_req=4, plen=6, max_new=6, rate=0.35,
               rebalance=None, kill_tick=4):
    cfg, (a, b), ref = pair
    prompts = {rid0 + i: prompt_of(cfg, plen, seed=seed + i) for i in range(n_req)}
    want = {rid: solo(ref, p, rid, max_new) for rid, p in prompts.items()}
    _reset(a, b)
    router = Router([Replica(a), Replica(b)], rebalance=rebalance, max_retries=10,
                    retry_backoff_s=0.0, snapshot_every=snapshot_every)
    inj = FaultInjector(FaultPlan(seed=seed, frame_fault_rate=rate,
                                  kill_at={a.engine_id: kill_tick})).install(router)
    seen = {rid: [] for rid in prompts}
    handles = {rid: router.submit(Request(rid, p, max_new_tokens=max_new))
               for rid, p in prompts.items()}
    for rid, h in handles.items():
        h.on_token(lambda tok, i, rid=rid: seen[rid].append((i, tok)))
    while router.pending():
        router.tick()
    m = router.metrics()["faults"]
    assert m["installed"] and inj.counters["kills"] == 1
    assert m["requests_failed"] == {}
    assert m["failovers"] == 1 and m["requests_recovered"] >= 1
    assert m["detected"] == m["retransmits"]
    for rid, h in handles.items():
        got = list(h.result().out_tokens)
        assert got == want[rid], f"rid {rid} diverged under chaos"
        assert seen[rid] == list(enumerate(got))
    return router


@pytest.mark.parametrize("backend", ["paged", "slots", "recurrent"])
def test_chaos_identity(paged_pair, slots_pair, recurrent_pair, backend):
    """Paged: snapshots on and the oversubscription rebalance churning
    migrations through the noisy channel. Slots: one request a replica and
    recompute failover (``snapshot_every=0``), so the recovered request
    prefills at the survivor's current length (the backend is exact only
    for aligned admissions). Recurrent mamba: snapshots of its O(1) state."""
    if backend == "paged":
        router = _chaos_run(paged_pair, rid0=1000, seed=7, snapshot_every=2, n_req=6,
                            rebalance=MigrateOnOversubscription())
        assert router.snapshots_taken >= 1
    elif backend == "slots":
        _chaos_run(slots_pair, rid0=1100, seed=11, snapshot_every=0, n_req=2)
    else:
        _chaos_run(recurrent_pair, rid0=1200, seed=13, snapshot_every=2, max_new=5)


def _other(router, rid, a, b):
    return b.engine_id if router._table[rid] == a.engine_id else a.engine_id


def test_noisy_migration_retransmits_until_clean(paged_pair):
    cfg, (a, b), ref = paged_pair
    p = prompt_of(cfg, 7, seed=21)
    want = solo(ref, p, 1300, 6)
    _reset(a, b)
    router = Router([Replica(a), Replica(b)], max_retries=20, retry_backoff_s=0.0)
    FaultInjector(FaultPlan(seed=2, frame_fault_rate=0.8)).install(router)
    h = router.submit(Request(1300, p, max_new_tokens=6))
    router.tick()
    router.tick()
    dst = _other(router, 1300, a, b)
    router.migrate(1300, dst)
    assert list(h.result().out_tokens) == want
    assert router._table[1300] == dst
    assert router.faults_detected >= 1 and router.retransmits >= 1
    assert router.migrations[-1]["retransmits"] == router.retransmits


def test_migration_rolls_back_when_retries_exhaust(paged_pair):
    cfg, (a, b), ref = paged_pair
    p = prompt_of(cfg, 6, seed=22)
    want = solo(ref, p, 1310, 6)
    _reset(a, b)
    router = Router([Replica(a), Replica(b)], max_retries=2, retry_backoff_s=0.0)
    FaultInjector(FaultPlan(seed=0, frame_fault_rate=1.0,
                            fault_kinds=("corrupt",))).install(router)
    h = router.submit(Request(1310, p, max_new_tokens=6))
    router.tick()
    router.tick()
    src = router._table[1310]
    with pytest.raises(MigrationFailedError, match="still damaged") as err:
        router.migrate(1310, _other(router, 1310, a, b))
    assert err.value.rolled_back
    assert router._table[1310] == src
    assert router.retransmits == 2 and router.faults_detected == 3
    router.faults = None                                 # the network heals
    assert list(h.result().out_tokens) == want


def test_drain_is_transactional_under_total_noise(paged_pair):
    cfg, (a, b), ref = paged_pair
    p = prompt_of(cfg, 6, seed=23)
    want = solo(ref, p, 1320, 6)
    _reset(a, b)
    router = Router([Replica(a), Replica(b)], max_retries=1, retry_backoff_s=0.0)
    FaultInjector(FaultPlan(seed=0, frame_fault_rate=1.0, fault_kinds=("drop",))).install(router)
    h = router.submit(Request(1320, p, max_new_tokens=6))
    router.tick()
    src = router._table[1320]
    with pytest.raises(RuntimeError, match="stranded rids \\[1320\\]"):
        router.drain(src)
    assert router._table[1320] == src and router.replica(src).draining
    router.faults = None
    assert list(h.result().out_tokens) == want


@pytest.mark.parametrize("snapshot_every", [0, 1])
def test_failover_recomputes_or_restores_from_snapshot(paged_pair, snapshot_every):
    """``snapshot_every=0``: the recovery ticket is prompt + delivered
    tokens (pos 0, a recompute); 1: the last snapshot (pos > 0, state
    bytes). Either way the tokens are the solo run's, each index once."""
    cfg, (a, b), ref = paged_pair
    rid = 1330 + snapshot_every
    p = prompt_of(cfg, 8, seed=24 + snapshot_every)
    want = solo(ref, p, rid, 8)
    _reset(a, b)
    router = Router([Replica(a), Replica(b)], retry_backoff_s=0.0,
                    snapshot_every=snapshot_every)
    seen = []
    h = router.submit(Request(rid, p, max_new_tokens=8))
    h.on_token(lambda tok, i: seen.append((i, tok)))
    for _ in range(4):
        router.tick()
    router.replica(router._table[rid]).engine.fail("chaos kill")
    got = list(h.result().out_tokens)
    assert got == want and seen == list(enumerate(got))
    m = router.metrics()["faults"]
    assert m["failovers"] == 1 and m["requests_recovered"] == 1
    last = router.migrations[-1]
    assert last["reason"].startswith("failover")
    if snapshot_every:
        assert router.snapshots_taken >= 1 and last["pos"] > 0 and last["state_bytes"] > 0
    else:
        assert m["snapshots_taken"] == 0 and last["pos"] == 0


def test_request_fails_typed_when_no_peer_exists(paged_pair):
    cfg, (a, b), _ = paged_pair
    _reset(a, b)
    router = Router([Replica(a)])
    h = router.submit(Request(1350, prompt_of(cfg, 5, seed=26), max_new_tokens=4))
    router.tick()
    a.fail("power loss")
    with pytest.raises(RequestFailedError, match="no compatible"):
        h.result()
    with pytest.raises(RequestFailedError):
        list(h.tokens())
    m = router.metrics()["faults"]
    assert "power loss" in m["requests_failed"][1350]
    assert m["failures"][0]["lost"] == [1350]


def test_health_probe_and_idempotent_mark_failed(paged_pair):
    """A kill between ticks is found by the next tick's probe and the
    request moves; ``mark_failed`` on a live replica fails it first, moves
    its work, and a second call is a no-op."""
    cfg, (a, b), ref = paged_pair
    p = prompt_of(cfg, 6, seed=27)
    want = solo(ref, p, 1360, 6)
    _reset(a, b)
    router = Router([Replica(a), Replica(b)], retry_backoff_s=0.0)
    h = router.submit(Request(1360, p, max_new_tokens=6))
    router.tick()
    victim = router._table[1360]
    router.replica(victim).engine.fail("yanked cable")
    router.tick()                                        # the probe fires here
    assert router.replica(victim).failed and router._table[1360] != victim
    assert router.health_probes >= 2
    assert list(h.result().out_tokens) == want

    p = prompt_of(cfg, 6, seed=28)
    want = solo(ref, p, 1370, 6)
    _reset(a, b)
    router = Router([Replica(a), Replica(b)], retry_backoff_s=0.0)
    h = router.submit(Request(1370, p, max_new_tokens=6))
    router.tick()
    victim = router._table[1370]
    assert router.mark_failed(victim, reason="maintenance") == [1370]
    assert not router.replica(victim).engine.alive
    assert router.mark_failed(victim) == []
    assert list(h.result().out_tokens) == want
    assert router.failovers == 1


def test_failed_engine_refuses_verbs_until_restart(paged_pair):
    cfg, (a, _), ref = paged_pair
    _reset(a)
    p = prompt_of(cfg, 5, seed=29)
    a.submit(Request(1380, p, max_new_tokens=3))
    a.tick()
    ticket = a.snapshot_request(1380)
    a.fail("oom")
    assert not a.alive and a.failed_reason == "oom"
    for verb, call in [("tick", a.tick),
                       ("submit", lambda: a.submit(Request(1381, p, max_new_tokens=3))),
                       ("export_request", lambda: a.export_request(1380)),
                       ("import_request", lambda: a.import_request(ticket)),
                       ("snapshot_request", lambda: a.snapshot_request(1380))]:
        with pytest.raises(EngineFailedError, match=verb):
            call()
    assert a.metrics()["engine"]["failed_reason"] == "oom"
    a.restart()
    assert a.alive and not a.pending()                   # request state abandoned
    want = solo(ref, p, 1382, 4)
    h = a.submit(Request(1383, p, max_new_tokens=4))
    assert list(h.result().out_tokens) == want


def test_lease_storm_falls_back_to_local():
    """An armed storm evicts the params lease between placement resolution
    and execution: auto-resolved injected calls fall back to local
    (``lease_fallbacks``), tokens unchanged. On a bare Fabric the lease
    pool's ``fault_hook`` evicts before every k-th acquire."""
    cfg, (eng,), ref = port_engines("llama3.2-1b", dict(PAGED, placement="auto"), 1,
                                    prefix="ft-lease")
    eng.inject_params(eng.params)
    p = prompt_of(cfg, 6, seed=30)
    want = solo(ref, p, 1390, 6)
    router = Router([Replica(eng)])
    FaultInjector(FaultPlan(seed=0, lease_storm_ticks=(2, 3))).install(router)
    h = router.submit(Request(1390, p, max_new_tokens=6))
    assert list(h.result().out_tokens) == want
    m = router.metrics()["faults"]
    assert m["lease_fallbacks"] >= 1 and m["lease_fallbacks"] == eng.lease_fallbacks
    assert m["injected"]["by_kind"]["lease_storms"] >= 1
    assert eng.metrics()["fabric"]["leases"]["engine.paged_step.params"]["evictions"] >= 1

    fabric = Fabric()
    inj = FaultInjector(FaultPlan(lease_storm_every=3)).install(fabric)
    state = (np.zeros(2),)
    for _ in range(6):
        fabric.lease("w", state)
    lease = fabric.metrics()["leases"]["w"]
    assert inj.counters["lease_storms"] == 2 and lease["evictions"] == 2
    assert lease["misses"] == 3 and lease["hits"] == 3


def test_serve_cluster_launcher_chaos_run(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve_cluster", "--smoke", "--device", "cpu", "--replicas",
        "llama3.2-1b:paged,llama3.2-1b:paged", "--requests", "4", "--prompt-len", "6",
        "--max-new", "4", "--migrate-after", "2", "--fault-rate", "0.3", "--fault-seed", "7",
        "--kill-after", "3"])
    serve_cluster.main()
    out = capsys.readouterr().out
    assert "[chaos] outputs identical to the baseline across 4 requests" in out
