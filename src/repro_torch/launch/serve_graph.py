"""Graph launcher: serve draft -> verify speculation DAGs, check exactness.

The port of ``repro/launch/serve_graph.py``, with the same flags and
``--device``:

  # engine pair, ngram draft, k=2, smoke configs on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.serve_graph --device cpu --k 2

  # llama3.2-1b drafting for a granite-class target (the smokes share a
  # vocabulary of 256):
  PYTHONPATH=src python -m repro_torch.launch.serve_graph --device cpu --draft model --k 4

  # router tier: two target replicas, affinity placement, frame edges:
  PYTHONPATH=src python -m repro_torch.launch.serve_graph --device cpu --tier router --k 2

  # full configs on the card (a model draft must share the target's
  # vocabulary, e.g. --target-arch llama3.2-1b):
  PYTHONPATH=src python -m repro_torch.launch.serve_graph --full --target-arch llama3.2-1b

Every request is served twice: target-only greedy decode on a reference
engine (the baseline), then as a ``fabric.graph`` draft -> verify DAG
(``repro_torch.fabric.graph``). The launcher exits **1 unless every
speculated output is identical to its baseline**: speculation may change
only *where* compute runs and how many target steps it takes, never one
emitted token. Per-request speculation stats (acceptance rate, target
steps per token) and, on the router tier, node placements and edge
counters are printed as JSON. Engines are the port's paged ``Engine`` on
``--device`` (``cuda`` by default; it raises without a card).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from repro_torch.cluster import Replica, Router
from repro_torch.configs.registry import ARCHS, get_config, get_smoke
from repro_torch.engine import Engine, Request
from repro_torch.fabric.graph import SpeculativeDecoder


def _mk_engine(arch, engine_id, *, smoke, device, params=None, **kw):
    cfg = get_smoke(arch) if smoke else get_config(arch)
    eng = Engine(cfg, cache="paged", engine_id=engine_id, device=device, **kw)
    eng.load_params(params)
    return cfg, eng


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--k", type=int, default=2, help="draft length per speculation round")
    p.add_argument("--draft", choices=("ngram", "model"), default="ngram")
    p.add_argument("--tier", choices=("engine", "router"), default="engine")
    p.add_argument("--target-arch", default="granite-20b", choices=sorted(ARCHS))
    p.add_argument("--draft-arch", default="llama3.2-1b", choices=sorted(ARCHS))
    p.add_argument("--requests", type=int, default=2)
    p.add_argument("--prompt-len", type=int, default=6)
    p.add_argument("--max-new", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--full", action="store_true",
                   help="production configs instead of smoke configs")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    smoke = not args.full

    eng_kw = dict(slots=3, max_len=64, num_blocks=32, block_size=4,
                  chunk=max(4, args.k + 1), smoke=smoke, device=args.device)
    tcfg, ref = _mk_engine(args.target_arch, "ref", **eng_kw)
    _, t1 = _mk_engine(args.target_arch, "t1", params=ref.params, **eng_kw)

    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, tcfg.vocab_size, size=(args.prompt_len,)).astype(np.int32)
               for _ in range(args.requests)]

    baselines = []
    for rid, prompt in enumerate(prompts):
        h = ref.submit(Request(rid=1000 + rid, prompt=prompt, max_new_tokens=args.max_new))
        baselines.append(list(h.tokens()))

    router = None
    if args.tier == "engine":
        if args.draft == "model":
            _, draft_eng = _mk_engine(args.draft_arch, "d1", **eng_kw)
            dec = SpeculativeDecoder(target=t1, draft=draft_eng, k=args.k)
        else:
            dec = SpeculativeDecoder(target=t1, k=args.k)
    else:
        _, t2 = _mk_engine(args.target_arch, "t2", params=ref.params, **eng_kw)
        replicas = [Replica(t1, model=args.target_arch), Replica(t2, model=args.target_arch)]
        draft_model = None
        if args.draft == "model":
            _, draft_eng = _mk_engine(args.draft_arch, "d1", **eng_kw)
            replicas.append(Replica(draft_eng, model=args.draft_arch))
            draft_model = args.draft_arch
        router = Router(replicas)
        dec = SpeculativeDecoder(router=router, target_model=args.target_arch,
                                 draft_model=draft_model, k=args.k)

    t0 = time.perf_counter()
    outputs = [list(dec.submit(prompt, args.max_new).tokens()) for prompt in prompts]
    dt = time.perf_counter() - t0

    divergent = [i for i, (got, want) in enumerate(zip(outputs, baselines)) if got != want]
    report = {
        "tier": args.tier, "draft": dec.draft_mode, "k": args.k,
        "requests": args.requests, "max_new": args.max_new, "device": args.device,
        "seconds": round(dt, 3),
        "bitwise_identical": not divergent,
        "divergent_requests": divergent,
        "speculation": dec.metrics(),
    }
    if router is not None:
        rm = router.metrics()["router"]
        report["node_placements"] = rm["node_placements"]
        report["edges"] = {k: rm[k] for k in ("edge_frames", "edge_bytes",
                                              "edge_retransmits", "edge_local_hits")}
    print(json.dumps(report, indent=2, default=str))
    if divergent:
        print(f"DIVERGENCE: speculated output != target-only greedy for requests "
              f"{divergent}", file=sys.stderr)
        return 1
    steps = [r["target_steps_per_token"] for r in report["speculation"]["requests"]]
    print(f"OK: {args.requests} requests bitwise identical; target steps/token "
          f"{min(steps):.2f}..{max(steps):.2f} (baseline 1.0)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
