"""GQA attention: contiguous (prefill, decode over a ``KVCache``, no cache)
and paged (serving: block-table cache, decode + chunked prefill); and MLA
(deepseek-v2): contiguous over an ``MLACache``, decode absorbed into the
compressed cache.

Weights keep the JAX package's layouts: ``wq`` (d, H, D), ``wk``/``wv``
(d, K, D), ``wo`` (H, D, d); MLA's ``wq`` (d, H, dn + dr), ``w_dkv`` (d,
r + dr), ``kv_norm`` (r,), ``w_uk`` (r, H, dn), ``w_uv`` (r, H, dv), ``wo``
(H, dv, d). Softmax runs in float32; inputs and outputs stay in the
compute dtype.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import AttentionConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import visible_mask
from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                 paged_attention_ref,
                                                 resolve_kernel)
from repro_torch.models.common import ParamBuilder, rms_norm
from repro_torch.models.kvcache import KVCache, MLACache, PagedKVCache, PagedLayout
from repro_torch.models.rope import apply_mrope, apply_rope

NEG_INF = -2.0 ** 30  # large-but-finite: keeps fully-masked rows NaN-free

# A prefill (or a forward with no cache) whose (S x S) score matrix per
# (batch, head) has more elements than this takes the flash path: the CUDA
# kernel on the card, its plain version on the CPU. At or below it, plain
# ``_sdpa``. The JAX package's threshold (``repro/models/attention.py``),
# where the same split sends long sequences to ``_sdpa_chunked``, its
# flash formulation; the two branches round differently, so the port
# keeps the split where the JAX package has it.
CHUNK_THRESHOLD = 1 << 22


def init_gqa(b: ParamBuilder, d_model: int, a: AttentionConfig) -> None:
    b.param("wq", (d_model, a.num_heads, a.head_dim))
    b.param("wk", (d_model, a.num_kv_heads, a.head_dim))
    b.param("wv", (d_model, a.num_kv_heads, a.head_dim))
    b.param("wo", (a.num_heads, a.head_dim, d_model), fan_in=a.num_heads * a.head_dim)


def init_mla(b: ParamBuilder, d_model: int, a: AttentionConfig) -> None:
    b.param("wq", (d_model, a.num_heads, a.qk_nope_head_dim + a.qk_rope_head_dim))
    b.param("w_dkv", (d_model, a.kv_lora_rank + a.qk_rope_head_dim))
    b.param("kv_norm", (a.kv_lora_rank,), init="zeros")
    b.param("w_uk", (a.kv_lora_rank, a.num_heads, a.qk_nope_head_dim))
    b.param("w_uv", (a.kv_lora_rank, a.num_heads, a.v_head_dim))
    b.param("wo", (a.num_heads, a.v_head_dim, d_model), fan_in=a.num_heads * a.v_head_dim)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul on the flattened weight."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).view(*x.shape[:-1], h, k)


def _use_chunked(s: int, t: int) -> bool:
    return s > 1 and s * t > CHUNK_THRESHOLD


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """q: (B,S,K,G,D) grouped; k, v: (B,T,K,D); mask broadcastable to
    (B,K,G,S,T). Float32 scores and softmax, probabilities cast to v's
    dtype before ``P.V``. Returns (B,S,K,G,D)."""
    scores = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)


def gqa_attention(
    params,
    x: torch.Tensor,                       # (B, S, d)
    a: AttentionConfig,
    *,
    causal: bool = True,
    window: Optional[int] = None,          # sliding window (None = full)
    cache: Optional[KVCache] = None,
    kernel: str = "auto",
    mrope_positions: Optional[torch.Tensor] = None,   # (3, B, S)
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """GQA attention at positions ``arange(S) + cache.length`` (0 without a
    cache). An mrope arch rotates q and k by ``mrope_positions`` (3, B, S),
    or, when it is None, by those positions in all three streams (text
    positions). Three branches, the JAX package's:

    * prefill into a cache (S > 1): append k/v, attend over the new
      tokens alone;
    * decode (a cache, S == 1): append, then attend over all ``max_len``
      cache rows, masked by absolute position (rows between a row's own
      tokens and ``length`` are visible to it, as in the JAX package);
    * no cache: attend over the tokens.

    A prefill or cacheless pass above ``CHUNK_THRESHOLD`` takes flash
    attention (``kernel``: ``"cuda"``, ``"ref"`` or ``"auto"``); the rest
    is plain ``_sdpa``. The flash branch masks by ``i - j`` alone (the
    JAX package's canonical positions), whatever the rotary positions.
    The cache is updated in place."""
    B, S, d = x.shape
    H, K, D = a.num_heads, a.num_kv_heads, a.head_dim
    G = H // K
    offset = cache.length if cache is not None else 0
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :] + offset

    q = _project(x, params["wq"])                            # (B,S,H,D)
    k = _project(x, params["wk"])                            # (B,S,K,D)
    v = _project(x, params["wv"])
    if a.mrope:
        mpos = (positions[None].expand(3, B, S) if mrope_positions is None
                else mrope_positions)
        q = apply_mrope(q, mpos, a.rope_theta, a.mrope_sections)
        k = apply_mrope(k, mpos, a.rope_theta, a.mrope_sections)
    elif a.rotary_pct > 0:
        q = apply_rope(q, positions, a.rope_theta, a.rotary_pct)
        k = apply_rope(k, positions, a.rope_theta, a.rotary_pct)
    q, k, v = q.to(x.dtype), k.to(x.dtype), v.to(x.dtype)
    scale = 1.0 / math.sqrt(D)

    new_cache = None
    if cache is not None:
        new_cache = cache.append(k, v)
    if cache is not None and S == 1:
        # decode: dense scores over every cache row (B,K,G,1,T)
        rel = positions[:, :, None] - torch.arange(new_cache.max_len, device=x.device)
        mask = rel >= 0
        if window is not None:
            mask &= rel < window
        out = _sdpa(q.view(B, S, K, G, D), new_cache.k.to(x.dtype),
                    new_cache.v.to(x.dtype), mask[:, None, None], scale)
    elif _use_chunked(S, S):
        # canonical positions: the mask depends on i - j alone
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              causal=causal, window=window, scale=scale,
                              kernel=kernel).transpose(1, 2)
    else:
        mask = None
        if causal or window is not None:
            mask = visible_mask(S, S, causal=causal, window=window, device=x.device)
        out = _sdpa(q.view(B, S, K, G, D), k, v, mask, scale)
    y = out.reshape(B, S, H * D) @ params["wo"].reshape(H * D, d)
    return y, new_cache


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


def mla_attention(
    params,
    x: torch.Tensor,                       # (B, S, d)
    a: AttentionConfig,
    *,
    causal: bool = True,
    cache: Optional[MLACache] = None,
    norm_eps: float = 1e-6,
    kernel: str = "auto",
) -> Tuple[torch.Tensor, Optional[MLACache]]:
    """MLA attention at positions ``arange(S) + cache.length`` (0 without a
    cache). The JAX package's three branches:

    * absorbed decode (a cache, S == 1): append the compressed latent and
      rope key, fold ``w_uk`` into the query and score it against every
      ``max_len`` row of ``c_kv`` plus ``q_rope . k_rope``, masked by
      absolute position (the shared lockstep length), then ``ctx . w_uv``.
      The two score products run in the compute dtype straight from the
      cache (float32 accumulation; the JAX package also keeps float32
      outputs, here they are rounded to the compute dtype) and the softmax
      in float32: the cache is never copied to float32;
    * full-rank prefill (a cache, S > 1) or no cache, at or below
      ``CHUNK_THRESHOLD``: ``k_nope`` and ``v`` expanded from ``c_kv``,
      float32 scores of the new tokens alone, causal;
    * the same above the threshold: ``[q_nope | q_rope]`` against
      ``[k_nope | k_rope]`` (the rope key broadcast over the heads) at
      width dn + dr, ``v`` at width dv, through flash attention
      (``kernel``: the CUDA kernel's (192, 128) instance on the card, its
      plain version on the CPU), where the JAX package runs
      ``_sdpa_chunked``.

    The cache is updated in place."""
    B, S, d = x.shape
    H = a.num_heads
    dn, dr, dv, r = a.qk_nope_head_dim, a.qk_rope_head_dim, a.v_head_dim, a.kv_lora_rank
    offset = cache.length if cache is not None else 0
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :] + offset

    q = _project(x, params["wq"])                            # (B,S,H,dn+dr)
    q_nope, q_rope = q[..., :dn], apply_rope(q[..., dn:], positions, a.rope_theta)
    ckr = x @ params["w_dkv"]                                # (B,S,r+dr)
    c_kv = rms_norm(ckr[..., :r], params["kv_norm"], norm_eps)
    k_rope = apply_rope(ckr[..., None, r:], positions, a.rope_theta)[:, :, 0]   # (B,S,dr)
    scale = 1.0 / math.sqrt(dn + dr)

    new_cache = None
    if cache is not None:
        new_cache = cache.append(c_kv, k_rope)
    if cache is not None and S == 1:
        c_all = new_cache.c_kv.to(x.dtype)                   # (B,T,r)
        kr_all = new_cache.k_rope.to(x.dtype)                # (B,T,dr)
        T = new_cache.max_len
        q_abs = torch.einsum("bshn,rhn->bshr", q_nope, params["w_uk"])
        # (B,H,T): one query row per head
        scores = (q_abs[:, 0] @ c_all.transpose(1, 2)).float()
        scores += (q_rope[:, 0] @ kr_all.transpose(1, 2)).float()
        rel = positions[:, :, None] - torch.arange(T, device=x.device)
        probs = torch.softmax(scores.mul_(scale).masked_fill_(~(rel >= 0), NEG_INF), dim=-1)
        ctx = probs.to(x.dtype) @ c_all                      # (B,H,r)
        out = torch.einsum("bhr,rhv->bhv", ctx, params["w_uv"])[:, None]   # (B,1,H,dv)
    else:
        k_nope = _project(c_kv, params["w_uk"])              # (B,S,H,dn)
        v = _project(c_kv, params["w_uv"])                   # (B,S,H,dv)
        if _use_chunked(S, S):
            q_cat = torch.cat([q_nope, q_rope], dim=-1)
            k_cat = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, dr)], dim=-1)
            out = flash_attention(q_cat.transpose(1, 2), k_cat.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal, scale=scale,
                                  kernel=kernel).transpose(1, 2)
        else:
            scores = torch.einsum("bshn,bthn->bhst", q_nope.float(), k_nope.float())
            scores += torch.einsum("bshr,btr->bhst", q_rope.float(), k_rope.float())
            scores = scores * scale
            if causal:
                mask = visible_mask(S, S, causal=True, window=None, device=x.device)
                scores = scores.masked_fill(~mask, NEG_INF)
            probs = torch.softmax(scores, dim=-1)
            out = torch.einsum("bhst,bthv->bshv", probs.to(v.dtype), v)
    y = out.reshape(B, S, H * dv) @ params["wo"].reshape(H * dv, d)
    return y, new_cache
