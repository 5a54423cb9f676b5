"""Plain PyTorch version of flash attention: materialized scores.

The port of ``repro/kernels/flash_attention/ref.py::mha_ref``: GQA
attention with causal and sliding-window masking over the whole ``(S, T)``
score matrix, scores and softmax in float32, the probabilities rounded to
``v``'s dtype before ``P.V``. The CPU path uses it, and ``chip_smoke.py``
holds the CUDA kernel against it on the card.

A query row that sees no key at all (only possible with a ``q_offset`` or
window that puts every key out of reach; never on the model's path) gets
the mean of ``v`` here and zero from the kernels, the TPU one and the CUDA
one alike. Tests keep such rows out.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0 ** 30  # large-but-finite: keeps fully-masked rows NaN-free


def visible_mask(s: int, t: int, *, causal: bool, window: Optional[int],
                 q_offset: int = 0, device=None) -> torch.Tensor:
    """(s, t) bool: query ``i`` (absolute position ``i + q_offset``) sees key
    ``j`` when ``j <= i + q_offset`` (causal) and ``i + q_offset - j <
    window`` (sliding window)."""
    q_pos = torch.arange(s, device=device) + q_offset
    rel = q_pos[:, None] - torch.arange(t, device=device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        mask &= rel >= 0
    if window is not None:
        mask &= rel < window
    return mask


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, window: Optional[int] = None,
            q_offset: int = 0, scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, S, D); k: (B, Hkv, T, D); v: (B, Hkv, T, Dv), Hq % Hkv ==
    0 (GQA: query head ``h`` reads kv head ``h // (Hq // Hkv)``).
    ``q_offset``: absolute position of ``q[:, :, 0]``. Returns (B, Hq, S,
    Dv) in ``q.dtype``."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    kx = k.repeat_interleave(g, dim=1)
    vx = v.repeat_interleave(g, dim=1)
    scores = torch.einsum("bhsd,bhtd->bhst", q.float(), kx.float()) * scale
    mask = visible_mask(s, t, causal=causal, window=window, q_offset=q_offset,
                        device=q.device)
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.exp(scores - scores.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhst,bhtd->bhsd", probs.to(v.dtype), vx)
    return out.to(q.dtype)
