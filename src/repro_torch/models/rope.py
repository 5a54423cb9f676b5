"""Rotary position embeddings: standard and partial (``rotary_pct``)."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, rotary_pct: float = 1.0,
               device=None) -> torch.Tensor:
    """Inverse frequencies (float32) for the rotated sub-dimension."""
    rot_dim = int(head_dim * rotary_pct)
    rot_dim -= rot_dim % 2
    if rot_dim == 0:
        return torch.zeros((0,), dtype=torch.float32, device=device)
    exponent = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device) / rot_dim
    return 1.0 / (theta ** exponent)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rotary_pct: float = 1.0) -> torch.Tensor:
    """Apply RoPE. x: (..., S, H, D); positions: broadcastable to (..., S).

    Angles and the rotation run in float32; the rotated part is cast back
    to ``x.dtype`` and the unrotated tail passes through."""
    inv = rope_freqs(x.shape[-1], theta, rotary_pct, device=x.device)
    rot_dim = 2 * inv.shape[0]
    if rot_dim == 0:
        return x
    ang = positions[..., :, None].float() * inv          # (..., S, rot/2)
    ang = torch.cat([ang, ang], dim=-1)                   # (..., S, rot)
    cos = torch.cos(ang)[..., :, None, :]                 # (..., S, 1, rot)
    sin = torch.sin(ang)[..., :, None, :]
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    x_f = x_rot.float()
    out = x_f * cos + _rotate_half(x_f) * sin
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)
