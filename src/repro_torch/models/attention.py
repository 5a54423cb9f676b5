"""Paged GQA attention (serving: block-table cache, decode + chunked prefill).

Weights keep the JAX package's layouts: ``wq`` (d, H, D), ``wk``/``wv``
(d, K, D), ``wo`` (H, D, d).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.configs.base import AttentionConfig
from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                 paged_attention_ref,
                                                 resolve_kernel)
from repro_torch.models.common import ParamBuilder
from repro_torch.models.kvcache import PagedKVCache, PagedLayout
from repro_torch.models.rope import apply_rope


def init_gqa(b: ParamBuilder, d_model: int, a: AttentionConfig) -> None:
    b.param("wq", (d_model, a.num_heads, a.head_dim))
    b.param("wk", (d_model, a.num_kv_heads, a.head_dim))
    b.param("wv", (d_model, a.num_kv_heads, a.head_dim))
    b.param("wo", (a.num_heads, a.head_dim, d_model), fan_in=a.num_heads * a.head_dim)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul on the flattened weight."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).view(*x.shape[:-1], h, k)


def gqa_paged_attention(
    params,
    x: torch.Tensor,                       # (B, C, d): C-token chunk per slot
    a: AttentionConfig,
    *,
    cache: PagedKVCache,
    layout: PagedLayout,
    window=None,
    kernel="auto",
) -> Tuple[torch.Tensor, PagedKVCache]:
    """One serving step through a paged cache.

    Each row is one request slot advancing ``n_valid`` tokens from absolute
    position ``starts``. New k/v are written into the pool in place through
    the block table; scores then run through the CUDA kernel
    (``kernel="cuda"``) or the plain gather-then-dense version (``"ref"``);
    ``"auto"`` picks by the tensors' device. ``kernel`` may also be a
    callable with ``paged_attention_ref``'s signature. Columns beyond
    ``n_valid`` are garbage the caller discards; their writes are dropped.
    """
    if a.mrope:
        raise ValueError("paged serving does not support mrope archs")
    B, C, d = x.shape
    H, D = a.num_heads, a.head_dim
    positions = layout.token_positions(C)                    # (B, C)

    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if a.rotary_pct > 0:
        q = apply_rope(q, positions, a.rope_theta, a.rotary_pct)
        k = apply_rope(k, positions, a.rope_theta, a.rotary_pct)

    cache = cache.write(k, v, layout)
    if callable(kernel):
        fn = kernel
    else:
        kind = resolve_kernel(kernel, x.device)
        fn = paged_attention_cuda if kind == "cuda" else paged_attention_ref
    out = fn(q.to(x.dtype).contiguous(), cache.k_pool, cache.v_pool,
             layout.block_tables, layout.starts, layout.n_valid,
             block_size=layout.block_size, window=window,
             scale=1.0 / math.sqrt(D))
    y = out.reshape(B, C, H * D) @ params["wo"].reshape(H * D, d)
    return y, cache
