"""Training launcher (the port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --smoke \
      --steps 3 --batch 4 --seq 64 --device cpu

``--smoke`` takes the reduced config. The step runs on ``--device``
(default ``cuda``; without a card pass ``--device cpu``). The JAX
launcher's ``--multi-pod`` (a mesh over pods) and ``--transport`` (the MoE
jam transport) wait for the port's mesh (ROADMAP A14) and for MoE training
on the card (A13's MoE half). Prints the JAX launcher's ``[train] done:``
line.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs.base import SHAPES, OptimizerConfig, RunConfig
from repro_torch.configs.registry import ARCHS, get_config, get_smoke
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", choices=sorted(ARCHS), required=True)
    p.add_argument("--shape", choices=sorted(SHAPES), default="train_4k")
    p.add_argument("--smoke", action="store_true", help="the reduced config")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=None, help="global batch override")
    p.add_argument("--seq", type=int, default=None, help="seq-len override")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--checkpoint-dir",
                   default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    shape = SHAPES[args.shape]
    if args.seq:
        shape = dataclasses.replace(shape, seq_len=args.seq)
    if args.batch:
        shape = dataclasses.replace(shape, global_batch=args.batch)
    run = RunConfig(
        model=cfg, shape=shape,
        optimizer=OptimizerConfig(lr=args.lr, total_steps=args.steps,
                                  warmup_steps=max(1, args.steps // 10)),
        checkpoint_dir=args.checkpoint_dir)
    tcfg = TrainerConfig(steps=args.steps, log_every=args.log_every,
                         checkpoint_every=args.checkpoint_every)
    stats = Trainer(cfg, run, tcfg=tcfg, device=args.device).train()
    print(f"[train] done: {stats.steps} steps, "
          f"loss={stats.final_metrics.get('loss', float('nan')):.4f}, "
          f"p50={stats.p50_s*1e3:.1f}ms p99.9={stats.p999_s*1e3:.1f}ms "
          f"restarts={stats.restarts}")


if __name__ == "__main__":
    main()
