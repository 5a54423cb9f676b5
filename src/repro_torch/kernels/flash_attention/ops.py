"""Public wrapper of flash attention.

``flash_attention`` has the JAX op's signature, ``(B, Hq, S, D) x (B, Hkv,
T, D) x (B, Hkv, T, Dv) -> (B, Hq, S, Dv)`` with ``causal``, ``window``,
``q_offset`` and ``scale``, plus ``kernel``: ``auto`` launches the CUDA kernel on CUDA
tensors and takes the plain version on CPU tensors; ``cuda`` on the CPU
raises (``loader.resolve_kernel``, the rule every kernel of the port
follows). There is no fallback from one to the other.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import (LAUNCHES, design,
                                                        flash_attention_cuda, key_tile,
                                                        tile_counts)
from repro_torch.kernels.flash_attention.ref import mha_ref
from repro_torch.kernels.loader import resolve_kernel


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, scale: Optional[float] = None,
                    kernel: str = "auto") -> torch.Tensor:
    """(B,Hq,S,D) x (B,Hkv,T,D) x (B,Hkv,T,Dv) -> (B,Hq,S,Dv): the CUDA
    kernel or its plain version (``mha_ref``)."""
    fn = flash_attention_cuda if resolve_kernel(kernel, q.device) == "cuda" else mha_ref
    return fn(q, k, v, causal=causal, window=window, q_offset=q_offset, scale=scale)


def compare(out: torch.Tensor, ref: torch.Tensor, *, tol: float = 2e-2):
    """Hold ``out`` against ``ref`` (both (B, H, S, D)): each element may
    differ by ``tol * (rms + |ref|)``, where ``rms`` is the root mean square
    of its (batch, head, position) row of ``ref``. Both outputs are bf16,
    and the kernel rounds the unnormalized ``p`` to bf16 before ``P.V``
    where the plain version rounds the normalized probabilities, so an
    element may move by a few bf16 steps of its row's scale. Returns
    ``(max |out - ref|, max |out - ref| / allowed, elements over the
    limit)``; a non-finite element counts as over."""
    a, b = out.float(), ref.float()
    err = (a - b).abs()
    allowed = tol * (b.pow(2).mean(-1, keepdim=True).sqrt() + b.abs())
    bad = int((~(err <= allowed)).sum())
    worst = float(torch.where(err == 0, 0.0, err / allowed.clamp_min(1e-30)).max())
    return float(err.max()), worst, bad


__all__ = ["LAUNCHES", "compare", "design", "flash_attention", "flash_attention_cuda",
           "key_tile", "mha_ref", "tile_counts"]
