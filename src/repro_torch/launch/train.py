"""Training launcher (the port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --smoke \
      --steps 3 --batch 4 --seq 64 --device cpu

``--smoke`` takes the reduced config. The step runs on ``--device``
(default ``cuda``; without a card pass ``--device cpu``). On one H100,
olmoe-1b-7b trains at full width with its stack cut to what the card
holds (``--layers``; 7 of 16 in ``chip_smoke.py``):

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \
      --layers 7 --batch 2 --steps 4

and the state and hybrid stacks train at full width and depth, through
the selective scan's forward and backward kernels:

  PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \
      --batch 2 --steps 4

``--transport`` is the JAX launcher's MoE jam transport override:
``local`` (and the default) run the single-device path, the only one the
port has; ``injected`` and ``auto`` move tokens or weights between devices
and wait for the port's mesh (ROADMAP A14), as does the JAX launcher's
``--multi-pod``. Prints the JAX launcher's ``[train] done:`` line.
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
    p.add_argument("--transport", default=None, choices=("local", "injected", "auto"),
                   help="MoE jam transport override")
    p.add_argument("--layers", type=int, default=None,
                   help="cut the stack to this many layers (full width)")
    args = p.parse_args(argv)

    if args.transport not in (None, "local"):
        raise NotImplementedError(
            f"--transport {args.transport} moves MoE tokens or weights between devices: "
            "the port has one device until ROADMAP item A14 ports the jam transports")
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
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
