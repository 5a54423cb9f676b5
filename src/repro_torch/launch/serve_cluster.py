"""Cluster launcher: a Router over N engine replicas, with live migration.

The port of ``repro/launch/serve_cluster.py``, with the same flags:

  # two paged llama replicas on the CPU, one forced migration after 3
  # router ticks:
  PYTHONPATH=src python -m repro_torch.launch.serve_cluster --smoke --device cpu \\
      --replicas llama3.2-1b:paged,llama3.2-1b:paged --migrate-after 3

  # a mixed fleet (models and backends), priority scheduling:
  PYTHONPATH=src python -m repro_torch.launch.serve_cluster --smoke --device cpu \\
      --replicas llama3.2-1b:paged,llama3.2-1b:paged,mamba-130m:recurrent \\
      --scheduler priority --requests 9 --migrate-after 2

  # chaos: seeded frame faults and a replica kill; a clean run first, then
  # the same requests under the fault plan, exit 1 unless every output is
  # identical:
  PYTHONPATH=src python -m repro_torch.launch.serve_cluster --smoke --device cpu \\
      --replicas llama3.2-1b:paged,llama3.2-1b:paged --migrate-after 3 \\
      --fault-rate 0.3 --fault-seed 7 --kill-after 5

Each ``--replicas`` entry is ``arch:cache`` (cache one of paged, slots,
recurrent, auto). Replicas of one arch share one weight tree, installed
through ``Engine.inject_params``, so every replica's params lease is warm
and ``placement="auto"`` resolves injected from the first tick; the
router's cost model then places by load among warm replicas. Requests go
through ``Router.submit`` with priorities ``rid % 3``. ``--migrate-after
N`` forces one live migration of an in-flight request between compatible
replicas after N router ticks and exits 1 if none was possible. The chaos
flags (``--fault-rate``, ``--fault-kinds``, ``--fault-seed``,
``--kill-after``, ``--snapshot-every``) wrap the run in the two-phase
identity check above. Replicas run on the card (side by side on one)
unless ``--device cpu``; without ``--smoke`` they take the full configs.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from repro_torch.cluster import (EngineFailedError, FaultInjector, FaultPlan,
                                 MigrateOnOversubscription, MigrationFailedError, Replica,
                                 RequestFailedError, Router)
from repro_torch.configs.registry import ARCHS, default_cache_backend, get_config, get_smoke
from repro_torch.engine import Engine, Request


def _parse_replicas(spec: str, smoke: bool, error) -> list:
    out = []
    for i, item in enumerate(spec.split(",")):
        item = item.strip()
        if not item:
            continue
        arch, _, cache = item.partition(":")
        cache = cache or "auto"
        if arch not in ARCHS:
            error(f"--replicas[{i}]: unknown arch {arch!r}")
        if cache not in ("auto", "paged", "slots", "recurrent"):
            error(f"--replicas[{i}]: unknown cache {cache!r}")
        cfg = get_smoke(arch) if smoke else get_config(arch)
        if cfg.is_encoder:
            error(f"--replicas[{i}]: {arch} is encoder-only")
        if cache == "auto":
            cache = default_cache_backend(cfg)
        out.append((arch, cache, cfg))
    if not out:
        error("--replicas is empty")
    return out


def _force_migration(router: Router, handles) -> tuple:
    """Live-migrate the first unfinished request whose replica has a
    compatible live peer (one with headroom first, else any: it queues
    there); returns (rid, src, dst), or None when none could move."""
    for h in handles:
        if h.done or router.request_failure(h.rid) is not None:
            continue
        src = router.replica(h.engine_id)
        if src.failed:
            continue
        dst = router.best_target(src) or next(iter(router.compatible_targets(src)), None)
        if dst is None:
            continue
        try:
            router.migrate(h.rid, dst.engine_id, reason="forced")
        except (MigrationFailedError, EngineFailedError):
            continue                    # rolled back, or the source died: next one
        return h.rid, src.engine_id, dst.engine_id
    return None


def _run_phase(label, engines, specs, prompts, args, *, injector=None, snapshot_every=0):
    """Serve the fixed request set once on restarted engines behind a fresh
    router; returns (outputs per rid, failed rids, metrics, the forced
    migration, whether the cluster is still pending)."""
    for eng, _arch in engines:
        eng.restart()
    replicas = [Replica(eng, model=arch) for eng, arch in engines]
    rebalance = MigrateOnOversubscription() if args.rebalance == "oversubscription" else None
    router = Router(replicas, rebalance=rebalance, snapshot_every=snapshot_every,
                    retry_backoff_s=0.0 if injector else 0.001)
    if injector is not None:
        injector.install(router)
    handles = [router.submit(Request(rid, prompts[rid], max_new_tokens=args.max_new,
                                     priority=rid % 3), model=specs[rid % len(specs)][0])
               for rid in range(args.requests)]
    t0 = time.perf_counter()
    forced, ticks = None, 0
    while router.pending() and ticks < 10_000:
        router.tick()
        ticks += 1
        if args.migrate_after and forced is None and ticks >= args.migrate_after:
            forced = _force_migration(router, handles)
    dt = time.perf_counter() - t0
    outputs, failed = {}, {}
    for h in handles:
        try:
            outputs[h.rid] = list(h.result().out_tokens)
        except RequestFailedError as err:
            failed[h.rid] = str(err)

    m = router.metrics()
    total = sum(len(t) for t in outputs.values())
    print(f"[{label}] {len(outputs)}/{args.requests} requests over {len(replicas)} replicas, "
          f"{total} tokens in {dt:.2f}s ({total / max(dt, 1e-9):.1f} tok/s, {ticks} ticks)")
    for r in m["cluster"]["replicas"]:
        em = m["replicas"][r["engine_id"]]
        print(f"  {r['engine_id']}: model={r['model']} cache={r['cache']} "
              f"completed={em['completed']} migrations={em['migrations']} "
              f"failed={r['failed']} placement={em['engine']['placement']}")
    f = m["faults"]
    print(f"[{label}] migrations={m['totals']['migrations']} (handoff: "
          f"{m['router']['handoff_frames']} frames, {m['router']['handoff_bytes']} bytes) "
          f"rebalance_events={m['router']['rebalance_events']}")
    if injector is not None:
        print(f"[{label}] faults: injected={f['injected']['injected']} detected={f['detected']} "
              f"retransmits={f['retransmits']} failovers={f['failovers']} "
              f"recovered={f['requests_recovered']} snapshots={f['snapshots_taken']}")
    if forced:
        print(f"[{label}] forced migration: rid {forced[0]} {forced[1]} -> {forced[2]}")
    return outputs, failed, m, forced, router.pending()


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--replicas", required=True,
                   help="comma list of arch:cache replica specs, e.g. "
                        "llama3.2-1b:paged,llama3.2-1b:paged")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=12)
    p.add_argument("--max-new", type=int, default=8)
    p.add_argument("--slots", type=int, default=3)
    p.add_argument("--max-len", type=int, default=64)
    p.add_argument("--blocks", type=int, default=0,
                   help="paged replicas: pool blocks (0 => one max_len sequence per slot)")
    p.add_argument("--block-size", type=int, default=8)
    p.add_argument("--chunk", type=int, default=4)
    p.add_argument("--scheduler", choices=("fifo", "priority", "sjf"), default="fifo")
    p.add_argument("--rebalance", choices=("none", "oversubscription"),
                   default="oversubscription")
    p.add_argument("--migrate-after", type=int, default=0, metavar="N",
                   help="after N router ticks, force one live migration of an in-flight "
                        "request between compatible replicas; exit 1 if none was possible")
    p.add_argument("--fault-rate", type=float, default=0.0,
                   help="per-frame fault probability on handoff trains; >0 runs a "
                        "noise-free baseline first and exits 1 unless the chaos run "
                        "matches it token for token")
    p.add_argument("--fault-kinds", default="drop,corrupt,duplicate,reorder",
                   help="comma list of frame fault kinds to draw from")
    p.add_argument("--fault-seed", type=int, default=0)
    p.add_argument("--kill-after", type=int, default=0, metavar="N",
                   help="kill the first replica at router tick N of the chaos phase "
                        "(needs a compatible peer)")
    p.add_argument("--snapshot-every", type=int, default=2,
                   help="chaos phase: sequence-state snapshot cadence (router ticks; "
                        "0 = recompute-only failover)")
    p.add_argument("--metrics-json", action="store_true",
                   help="print the final cluster metrics() as JSON")
    args = p.parse_args()

    specs = _parse_replicas(args.replicas, args.smoke, p.error)
    # one weight tree per arch, injected into every replica of that arch:
    # the rFaaS lease model, N warm executors and one shipped weight state
    engines, params_by_arch = [], {}
    for i, (arch, cache, cfg) in enumerate(specs):
        kw = dict(slots=args.slots, max_len=args.max_len, scheduler=args.scheduler,
                  placement="auto", engine_id=f"{arch}:{cache}#{i}", device=args.device)
        if cache == "paged":
            per_seq = -(-args.max_len // args.block_size)
            kw.update(num_blocks=args.blocks or per_seq * args.slots,
                      block_size=args.block_size, chunk=args.chunk)
        elif cache == "recurrent":
            kw.update(chunk=args.chunk)
        eng = Engine(cfg, cache=cache, **kw)
        eng.inject_params(params_by_arch.get(arch))
        params_by_arch.setdefault(arch, eng.params)
        engines.append((eng, arch))

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, specs[rid % len(specs)][2].vocab_size,
                            size=(args.prompt_len,)).astype(np.int32)
               for rid in range(args.requests)]

    chaos = args.fault_rate > 0 or args.kill_after > 0
    outputs, failed, m, forced, undrained = _run_phase(
        "baseline" if chaos else "cluster", engines, specs, prompts, args)
    ok = True
    if failed:
        print(f"[cluster] ERROR: requests failed without faults: {failed}", file=sys.stderr)
        ok = False

    if chaos and ok:
        plan = FaultPlan(
            seed=args.fault_seed, frame_fault_rate=args.fault_rate,
            fault_kinds=tuple(k.strip() for k in args.fault_kinds.split(",") if k.strip()),
            kill_at={engines[0][0].engine_id: args.kill_after} if args.kill_after else {})
        c_out, c_failed, m, forced, undrained = _run_phase(
            "chaos", engines, specs, prompts, args, injector=FaultInjector(plan),
            snapshot_every=args.snapshot_every)
        if c_failed:
            print(f"[chaos] ERROR: requests terminally failed: {c_failed}", file=sys.stderr)
            ok = False
        if undrained:
            print("[chaos] ERROR: cluster did not drain", file=sys.stderr)
            ok = False
        mismatched = [rid for rid in outputs if c_out.get(rid) != outputs[rid]]
        if mismatched:
            print(f"[chaos] ERROR: outputs diverged from the noise-free baseline for "
                  f"rids {mismatched}", file=sys.stderr)
            ok = False
        if args.kill_after and m["faults"]["failovers"] == 0:
            print("[chaos] ERROR: --kill-after was set but no failover happened",
                  file=sys.stderr)
            ok = False
        if ok:
            print(f"[chaos] outputs identical to the baseline across {len(outputs)} "
                  f"requests (injected={m['faults']['injected']['injected']}, "
                  f"recovered={m['faults']['requests_recovered']})")

    if args.metrics_json:
        print(json.dumps(m, default=str, indent=2))
    if args.migrate_after and m["totals"]["migrations"] == 0:
        print("[cluster] ERROR: --migrate-after was set but no migration happened "
              "(no compatible replica pair?)", file=sys.stderr)
        ok = False
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
