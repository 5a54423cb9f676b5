"""Learning-rate schedules, as float32 tensor arithmetic on the step's
device (no host sync inside a train step)."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import OptimizerConfig


def warmup_cosine(step: torch.Tensor, cfg: OptimizerConfig,
                  min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to cfg.lr over warmup_steps, cosine decay to
    min_frac*lr at total_steps, flat afterwards. ``step``: a 0-d integer
    tensor; returns a 0-d float32 tensor on its device."""
    s = step.to(torch.float32)
    warm = max(1.0, float(cfg.warmup_steps))
    total = max(warm + 1.0, float(cfg.total_steps))
    warm_lr = cfg.lr * s / warm
    prog = ((s - warm) / (total - warm)).clamp(0.0, 1.0)
    cos_lr = cfg.lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warm, warm_lr, cos_lr)
