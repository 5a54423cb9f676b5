"""Public wrapper, kernel resolution and the traffic model for paged attention.

``paged_attention`` has ``paged_attention_ref``'s signature, so the two are
interchangeable in ``models.attention.gqa_paged_attention``. On CUDA
tensors it launches the CUDA kernel (or raises); it takes the plain
version only for tensors on the CPU. There is no fallback from one to the
other.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels.loader import KERNEL_KINDS, resolve_kernel
from repro_torch.kernels.paged_attention.kernel import LAUNCHES, paged_attention_cuda
from repro_torch.kernels.paged_attention.ref import (paged_attention_ref,
                                                     paged_attention_split_ref,
                                                     split_plan)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                    block_tables: torch.Tensor, starts: torch.Tensor,
                    n_valid: torch.Tensor, *, block_size: int,
                    window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """(B,C,H,D) x pool -> (B,C,H,D): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    fn = paged_attention_cuda if q.is_cuda else paged_attention_ref
    return fn(q, k_pool, v_pool, block_tables, starts, n_valid,
              block_size=block_size, window=window, scale=scale)


def compare_valid(out: torch.Tensor, ref: torch.Tensor, n_valid: torch.Tensor,
                  *, tol: float = 2e-2):
    """Hold ``out`` against ``ref`` (both (B, C, H, D)) on valid columns
    ``c < n_valid``; the rest is garbage by contract.

    Each element may differ by ``tol * (min(rms, 1) + |ref|)``, where
    ``rms`` is the root mean square of its (request, column, head) row of
    ``ref``. bf16 rounding scales with the row, so a long row, whose output
    is an average over many keys and small, is held as tightly as a short
    one; the cap keeps the limit within ``atol = rtol = tol``.
    Returns ``(max |out - ref|, max |out - ref| / allowed, elements over
    the limit)``; a non-finite element counts as over."""
    valid = (torch.arange(out.shape[1], device=out.device)[None, :]
             < n_valid[:, None])[:, :, None, None]
    a, b = out.float(), ref.float()
    err = torch.where(valid, (a - b).abs(), 0.0)
    rms = b.pow(2).mean(-1, keepdim=True).sqrt().clamp(max=1.0)
    allowed = tol * (rms + b.abs())
    bad = (valid & ~(err <= allowed)).sum().item()
    worst = torch.where(valid, err / allowed.clamp_min(1e-30), 0.0).max().item()
    return err.max().item(), worst, bad


def modeled_hbm_bytes(seq_lens: Sequence[int], *, block_size: int,
                      max_blocks: int, kv_heads: int, head_dim: int,
                      dtype_bytes: int = 2, kernel: str = "cuda") -> int:
    """Modeled KV bytes *read* by one attention step (k + v).

    ref:  the gathered logical view is batch-uniform and bounded by the
          longest live sequence (block-rounded, clamped to
          ``[block_size, max_blocks * block_size]``) and is read twice:
          once gathering it out of the pool, once scoring the copy.
    cuda: each request's live positions are read once, up to its
          ``seq_len`` (the kernel finds each position's row through the
          table, so it reads no row of a block past the sequence's end):
          ``seq_len`` rows per request. The TPU kernel reads whole blocks.
    """
    row = kv_heads * head_dim * dtype_bytes * 2          # one k row + v row
    lens = [int(s) for s in seq_lens]
    if kernel == "ref":
        longest = max(lens, default=0)
        t = min(max(-(-longest // block_size), 1) * block_size,
                max_blocks * block_size)
        return 2 * len(lens) * t * row
    return sum(lens) * row


__all__ = ["KERNEL_KINDS", "LAUNCHES", "compare_valid", "modeled_hbm_bytes",
           "paged_attention", "paged_attention_cuda", "paged_attention_ref",
           "paged_attention_split_ref", "resolve_kernel", "split_plan"]
