"""End-to-end driver of the PyTorch/CUDA port: train a ~120M-param MoE LM.

The port's counterpart of ``examples/train_moe.py``: the same scaled-down
OLMoE-family config (``moe-demo``: 8 experts, top-2, capacity factor 1.5)
and flags, through the port's production stack (data pipeline, AdamW,
fault-tolerant trainer, async checkpoints). On the card every MoE layer's
expert FFN runs the moe_jam kernels, forward and backward; with ``--device
cpu`` their plain versions run. The JAX example's jam transport moves
tokens between devices: the port has one device (ROADMAP A14), so its MoE
layers take the single-device path.

Run:  PYTHONPATH=src python examples/train_moe_torch.py --steps 300
(``--device cpu --d-model 64 --layers 2 --steps 3 --batch 4 --seq 32``
for a quick pass without a card.)
"""
import argparse
import math
import os
import tempfile

from repro_torch.configs.base import (AttentionConfig, ModelConfig, MoEConfig,
                                      OptimizerConfig, RunConfig, ShapeConfig)
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def model_config(d_model: int, layers: int) -> ModelConfig:
    return ModelConfig(
        name="moe-demo",
        family="moe",
        num_layers=layers,
        d_model=d_model,
        d_ff=0,
        vocab_size=16384,
        attention=AttentionConfig(num_heads=8, num_kv_heads=4,
                                  head_dim=d_model // 8),
        moe=MoEConfig(num_experts=8, top_k=2, expert_ff=2 * d_model,
                      capacity_factor=1.5, transport="local"),
        remat="none",
    )


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--d-model", type=int, default=512)
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_train_moe"))
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    cfg = model_config(args.d_model, args.layers)
    print(f"[train_moe] {cfg.param_count()/1e6:.1f}M params "
          f"({cfg.active_param_count()/1e6:.1f}M active/token), "
          f"{args.steps} steps @ batch={args.batch} seq={args.seq}")

    run = RunConfig(
        model=cfg,
        shape=ShapeConfig("demo", args.seq, args.batch, "train"),
        optimizer=OptimizerConfig(lr=6e-4, total_steps=args.steps,
                                  warmup_steps=max(1, args.steps // 20)),
        checkpoint_dir=args.ckpt)
    trainer = Trainer(cfg, run, device=args.device,
                      tcfg=TrainerConfig(steps=args.steps,
                                         log_every=max(1, args.steps // 20),
                                         checkpoint_every=100))
    stats = trainer.train()
    print(f"[train_moe] done: loss {stats.final_metrics['loss']:.4f} "
          f"(uniform would be {math.log(cfg.vocab_size):.2f}), "
          f"p50 step {stats.p50_s*1e3:.0f} ms")


if __name__ == "__main__":
    main()
