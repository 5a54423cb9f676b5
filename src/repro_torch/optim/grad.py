"""Gradient transforms: the global-norm clip and int8 wire compression with
error feedback (symmetric per-tensor scale), as in ``repro/optim/grad.py``.
The compressed data-parallel reduce (``compressed_psum``) needs a
data-parallel axis and waits for the port's mesh (ROADMAP A14)."""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import tree


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    sums = [x.to(torch.float32).square().sum() for x in tree.leaves(grads)]
    return torch.stack(sums).sum().sqrt()


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """Scale every leaf by ``min(1, max_norm / (norm + 1e-6))``, in place;
    returns ``(grads, norm)``."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for g in tree.leaves(grads):
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.to(torch.float32) * scale)
    return grads, norm


def compress_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization -> (q, scale)."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def init_error_feedback(grads) -> Any:
    """Zero float32 residuals shaped as ``grads``."""
    return tree.map_(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                     grads)
