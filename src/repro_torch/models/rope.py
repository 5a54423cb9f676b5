"""Rotary position embeddings: standard, partial (``rotary_pct``) and
M-RoPE (qwen2-vl's three position streams)."""
from __future__ import annotations

from typing import Optional, Tuple

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


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl): three position streams (t, h, w).

    x: (B, S, H, D); positions_3d: (3, B, S). ``sections`` splits the D/2
    frequency slots among (t, h, w) in order; each slot's angle takes its
    stream's position. Angles and the rotation run in float32, and the
    result is cast back to ``x.dtype``. When the three streams hold the
    same (text) positions this is ``apply_rope`` over the whole head."""
    inv = rope_freqs(x.shape[-1], theta, 1.0, device=x.device)    # (D/2,)
    assert sum(sections) == inv.shape[0], (sections, inv.shape[0])
    stream = torch.repeat_interleave(torch.arange(len(sections), device=x.device),
                                     torch.tensor(sections, device=x.device))
    pos = positions_3d.float()[stream]                            # (D/2, B, S)
    ang = pos.permute(1, 2, 0) * inv                              # (B, S, D/2)
    ang = torch.cat([ang, ang], dim=-1)                           # (B, S, D)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x_f = x.float()
    return (x_f * cos + _rotate_half(x_f) * sin).to(x.dtype)


def text_mrope_positions(batch: int, seq: int, offset: Optional[torch.Tensor] = None,
                         device=None) -> torch.Tensor:
    """(3, B, S) int32 position ids whose three streams share the text
    positions ``arange(seq)`` (plus ``offset`` (B,) per row)."""
    p = torch.arange(seq, dtype=torch.int32, device=device)[None, :].repeat(batch, 1)
    if offset is not None:
        p = p + offset[:, None].to(device=p.device, dtype=torch.int32)
    return p[None].expand(3, batch, seq)
