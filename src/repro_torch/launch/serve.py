"""Serving launcher: the paged, recurrent or slots engine with pluggable
schedulers.

  # on the card, full-width llama3.2-1b with random bf16 weights:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --slots 8 --max-len 1024 --blocks 160 --chunk 32 --requests 12 \
      --prompt-len 256 --max-new 32

  # on the card, full-width olmoe-1b-7b (64 experts, top-8) likewise:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
      --slots 8 --max-len 1024 --blocks 128 --chunk 32 --requests 12 \
      --prompt-len 256 --max-new 32

  # on the card, full-width mamba-130m on the recurrent backend (--cache
  # auto picks it for an SSM stack):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba-130m \
      --slots 32 --chunk 32 --requests 48 --prompt-len 256 --max-new 32

  # on the card, full-width gemma3-4b on the slots backend: prompts past
  # 2,048 tokens prefill through the flash-attention kernel:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \
      --cache slots --slots 8 --max-len 4224 --requests 8 --prompt-len 4000 \
      --max-new 32

  # on the card, full-width deepseek-v2-lite-16b (MLA, 64 experts top-6
  # plus 2 shared; --cache auto picks slots for an MLA stack): prompts past
  # 2,048 tokens prefill through flash attention at q/k 192 and v 128, the
  # routed experts run through moe_jam:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b \
      --slots 8 --max-len 4224 --requests 8 --prompt-len 4000 --max-new 32

  # on the card, full-width xlstm-1.3b (42 mLSTM + 6 sLSTM layers; --cache
  # auto picks the recurrent backend; the recurrences run no kernel):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \
      --slots 4 --chunk 16 --requests 8 --prompt-len 96 --max-new 16

  # on the card, full-width hymba-1.5b (attention and an SSM in every block;
  # --cache auto picks slots): prompts past 2,048 tokens prefill through
  # flash attention, every block's SSM through the selective scan:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
      --slots 8 --max-len 4224 --requests 8 --prompt-len 4000 --max-new 32

  # qwen2-vl-72b's 80 layers (145 GB in bf16) do not fit one card; its
  # smoke on the CPU (--cache auto picks slots for an mrope stack):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-72b \
      --smoke --device cpu --max-len 64 --prompt-len 20

  # hubert-xlarge is an encoder: it has no decode path, and the CLI refuses
  # it (its entry point is runtime.steps.make_prefill_step).

  # on the CPU, a smoke config through the plain versions of the kernels:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --smoke --device cpu --requests 4 --stream
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba-130m \
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \
      --smoke --device cpu --cache slots --max-len 64 --prompt-len 20
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b \
      --smoke --device cpu --max-len 64 --prompt-len 20
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
      --smoke --device cpu --max-len 64 --prompt-len 20
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.configs.registry import ARCHS, get_config, get_smoke
from repro_torch.engine import Engine, Request


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", choices=sorted(ARCHS), required=True)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--cache", choices=("auto", "paged", "recurrent", "slots"),
                   default="auto",
                   help="sequence-state backend; auto: paged for GQA stacks, "
                        "slots for MLA, mrope and hybrid attention + SSM ones, "
                        "recurrent for SSM and xLSTM ones; slots: one "
                        "contiguous max_len row per slot (every ported stack)")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max-len", type=int, default=256)
    p.add_argument("--blocks", type=int, default=0,
                   help="paged pool size in blocks (0 => slots*max_len/2 worth "
                        "of tokens, at least one max_len sequence)")
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--chunk", type=int, default=8,
                   help="prefill tokens per request per tick")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--scheduler", choices=("fifo", "priority", "sjf"),
                   default="fifo",
                   help="priority: requests get priority rid %% 3 so the "
                        "reordering is visible")
    p.add_argument("--stream", action="store_true",
                   help="consume per-request token streams (handle.tokens()) "
                        "instead of run_until_drained")
    p.add_argument("--paged-kernel", choices=("auto", "cuda", "ref"),
                   default="auto",
                   help="every kernel of the steps (paged attention, the MoE "
                        "expert FFN, the selective scan, flash attention): the "
                        "CUDA kernels, their plain PyTorch versions, or auto "
                        "(cuda on the card, ref on the CPU)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights and of the prompts")
    p.add_argument("--metrics-json", action="store_true",
                   help="print the final Engine.metrics() dict as JSON")
    args = p.parse_args()

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if cfg.is_encoder:
        raise SystemExit(f"{args.arch} is encoder-only: no decode path")
    max_blocks_per_seq = -(-args.max_len // args.block_size)
    num_blocks = args.blocks or max(
        max_blocks_per_seq, (args.slots * args.max_len // 2) // args.block_size)
    engine = Engine(cfg, device=args.device, cache=args.cache, slots=args.slots,
                    max_len=args.max_len, num_blocks=num_blocks,
                    block_size=args.block_size, chunk=args.chunk,
                    scheduler=args.scheduler, kernel=args.paged_kernel)
    engine.load_params(seed=args.seed)

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    handles = []
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=(args.prompt_len,)).astype(np.int32)
        handles.append(engine.submit(Request(rid, prompt, max_new_tokens=args.max_new,
                                             priority=rid % 3)))
    if args.stream:
        for h in handles:
            toks = list(h.tokens())
            print(f"[stream] req {h.rid} (prio {h.req.priority}): "
                  f"{toks[:8]}{'...' if len(toks) > 8 else ''}")
        done = engine.completed
    else:
        done = engine.run_until_drained()
    dt = time.perf_counter() - t0

    m = engine.metrics()
    total_tokens = sum(len(r.out_tokens) for r in done)
    tag = f"[serve:{engine.cache_kind}"
    print(f"{tag}/{args.scheduler}] {len(done)}/{args.requests} requests, "
          f"{total_tokens} tokens in {dt:.2f}s ({total_tokens / dt:.1f} tok/s, "
          f"{engine.ticks} ticks, {m['preemptions']} preemptions) on {engine.device}")
    print(f"{tag}] admission order: {engine.admission_log}")
    if engine.cache_kind == "paged":
        state = (f"live-token fraction last={m['live_token_fraction']:.3f} "
                 f"mean={m['live_token_fraction_mean']:.3f}")
    elif engine.cache_kind == "recurrent":
        state = f"state bytes per slot={m['state_bytes_per_slot']}"
    else:
        state = f"shared cache length={engine.cache['length']}"
    print(f"{tag}] kernels={m['kernel']} launches={m['kernel_launches']} {state}")
    for r in done[:3]:
        print(f"  req {r.rid}: {r.out_tokens[:8]}...")
    if args.metrics_json:
        print(json.dumps(m, default=str, indent=2))


if __name__ == "__main__":
    main()
