"""Public wrapper of flash attention.

``flash_attention`` has the JAX op's signature, ``(B, Hq, S, D) x (B, Hkv,
T, D) x (B, Hkv, T, Dv) -> (B, Hq, S, Dv)`` with ``causal``, ``window``,
``q_offset`` and ``scale``, plus ``kernel``: ``auto`` launches the CUDA kernel on CUDA
tensors and takes the plain version on CPU tensors; ``cuda`` on the CPU
raises (``loader.resolve_kernel``, the rule every kernel of the port
follows). There is no fallback from one to the other.

Under grad (grad mode on and an input that requires it) the kernel route
runs ``FlashAttentionFn``: the forward kernel, which also writes each
row's log-sum-exp, and the backward kernel (``flash_attention_bwd.cu``)
for dq, dk and dv. The plain route is differentiated by autograd through
``mha_ref``, which the CPU tests compare the kernel's gradient with.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import (BWD_HEAD_DIMS, BWD_LAUNCHES,
                                                        LAUNCHES, check_bwd_head_dim, design,
                                                        flash_attention_bwd_cuda,
                                                        flash_attention_cuda,
                                                        flash_attention_lse_cuda, key_tile,
                                                        tile_counts)
from repro_torch.kernels.flash_attention.ref import mha_ref
from repro_torch.kernels.loader import needs_grad, resolve_kernel


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with a gradient: the forward kernel, keeping ``out``
    and each row's log-sum-exp, and the backward kernel for dq, dk, dv."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale):
        check_bwd_head_dim(q, v)               # refuse before the forward runs
        out, lse = flash_attention_lse_cuda(q, k, v, causal=causal, window=window,
                                            q_offset=q_offset, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = dict(causal=causal, window=window, q_offset=q_offset, scale=scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, dout, lse, **ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, scale: Optional[float] = None,
                    kernel: str = "auto") -> torch.Tensor:
    """(B,Hq,S,D) x (B,Hkv,T,D) x (B,Hkv,T,Dv) -> (B,Hq,S,Dv): the CUDA
    kernel (through ``FlashAttentionFn`` under grad) or its plain version
    (``mha_ref``)."""
    kw = dict(causal=causal, window=window, q_offset=q_offset, scale=scale)
    if resolve_kernel(kernel, q.device) != "cuda":
        return mha_ref(q, k, v, **kw)
    if needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, window, q_offset, scale)
    return flash_attention_cuda(q, k, v, **kw)


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


__all__ = ["BWD_HEAD_DIMS", "BWD_LAUNCHES", "FlashAttentionFn", "LAUNCHES", "compare",
           "design", "flash_attention", "flash_attention_bwd_cuda", "flash_attention_cuda",
           "flash_attention_lse_cuda", "key_tile", "mha_ref", "tile_counts"]
