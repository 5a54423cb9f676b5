"""Plain PyTorch version of paged attention: gather, then dense masked softmax.

The port of ``repro/kernels/paged_attention/ref.py``. It materializes each
request's logical ``(T, K, D)`` view and masks most of it away; it runs
eagerly, so ``T`` is always bounded by the longest live sequence rounded
up to ``block_size``. The CPU path uses it, and ``chip_smoke.py`` holds the
CUDA kernel against it on the card.

One addition to the JAX oracle: a table entry inside a row's live range
that names no pool block (``-1``, or an id ``>= N_blocks``) is masked
here, as the CUDA kernel masks it (the JAX oracle reads the clamped block
there). The engine never produces such an entry — it grows a request's
blocks before the step that needs them — so the two agree on every table
the engine builds.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.kvcache import PagedKVCache

NEG_INF = -2.0 ** 30  # large-but-finite: keeps fully-masked rows NaN-free


def paged_attention_ref(
    q: torch.Tensor,                   # (B, C, H, D)
    k_pool: torch.Tensor,              # (N_blocks, block_size, K, D)
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,        # (B, M) int32, -1 = unallocated
    starts: torch.Tensor,              # (B,) int32
    n_valid: torch.Tensor,             # (B,) int32
    *,
    block_size: int,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Dense paged attention against the gathered logical view.

    Returns (B, C, H, D) in ``q.dtype``. Columns ``>= n_valid[b]`` produce
    garbage the caller discards (same contract as the kernel)."""
    B, C, H, D = q.shape
    K = k_pool.shape[2]
    G = H // K
    scale = scale if scale is not None else D ** -0.5
    dev = q.device

    seq_end = starts + n_valid
    k_all, v_all, max_resident = PagedKVCache(k_pool, v_pool, block_size).gather(
        block_tables, seq_lens=seq_end)
    T = max(max_resident, block_size)
    k_all, v_all = k_all[:, :T], v_all[:, :T]

    positions = starts[:, None] + torch.arange(C, dtype=torch.int32, device=dev)[None, :]
    kv_pos = torch.arange(T, dtype=torch.int32, device=dev)
    rel = positions[:, :, None] - kv_pos[None, None, :]           # (B, C, T)
    mask = rel >= 0                                                # causal
    if window is not None:
        mask &= rel < window
    # never read past the tokens resident after this step's writes (keeps
    # stale pool rows from reused blocks out of even discarded columns)
    mask &= kv_pos[None, None, :] < seq_end[:, None, None]
    blk = block_tables[:, torch.div(kv_pos, block_size, rounding_mode="floor").long()]
    mask &= ((blk >= 0) & (blk < k_pool.shape[0]))[:, None, :]
    mask = mask[:, None, None, :, :]                               # (B,1,1,C,T)

    qg = q.reshape(B, C, K, G, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                          k_all.to(q.dtype).float()) * scale
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(q.dtype), v_all.to(q.dtype))
    return out.reshape(B, C, H, D)
