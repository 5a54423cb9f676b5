"""Decoder block assembly for the serving paths.

The plain-GQA block types ``attn_full`` and ``attn_local`` (sliding
window) and the GQA MoE block ``attn_moe`` run on the paged path and on
the contiguous path (the slots backend's ``KVCache``, or no cache); the
MLA blocks ``mla_dense`` and ``mla_moe`` (deepseek-v2) on the contiguous
path, over an ``MLACache``. The recurrent path has the pure selective-SSM
block ``ssm`` (mamba). xLSTM blocks come with ROADMAP item A9 and hybrid
ones with A10.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import ParamBuilder, rms_norm
from repro_torch.models.kvcache import (KVCache, MLACache, PagedKVCache, PagedLayout,
                                        RecurrentLayout)

# Block types whose cache is plain GQA k/v and whose paged path is ported.
PAGED_BLOCK_TYPES = ("attn_full", "attn_local", "attn_moe")
# Block types whose contiguous path (KVCache or MLACache rows, or no cache)
# is ported.
CONTIGUOUS_BLOCK_TYPES = ("attn_full", "attn_local", "attn_moe", "mla_dense", "mla_moe")
# Block types whose per-request state is constant-size (conv history +
# recurrent state) and whose recurrent path is ported.
RECURRENT_BLOCK_TYPES = ("ssm",)


def _check(bt: str) -> None:
    ported = CONTIGUOUS_BLOCK_TYPES + RECURRENT_BLOCK_TYPES
    if bt not in ported:
        raise ValueError(f"block type {bt!r} is not ported: the port serves {ported} "
                         "(ROADMAP items A9 and A10 bring the rest)")


def _check_paged(bt: str) -> None:
    if bt not in PAGED_BLOCK_TYPES:
        raise ValueError(f"paged serving supports block types {PAGED_BLOCK_TYPES}, "
                         f"got {bt!r}: use cache='recurrent' for this arch")


def _check_contiguous(bt: str) -> None:
    if bt not in CONTIGUOUS_BLOCK_TYPES:
        raise ValueError(f"the contiguous path supports block types "
                         f"{CONTIGUOUS_BLOCK_TYPES}, got {bt!r}: use cache='paged' or "
                         "'recurrent' for this arch")


def _check_recurrent(bt: str) -> None:
    if bt not in RECURRENT_BLOCK_TYPES:
        raise ValueError(f"block type {bt!r} has no recurrent serving path: only "
                         f"{RECURRENT_BLOCK_TYPES} carry constant-size state here; use "
                         "cache='paged' for this arch")


def init_block(b: ParamBuilder, bt: str, cfg: ModelConfig) -> None:
    _check(bt)
    d = cfg.d_model
    b.param("ln1", (d,), init="zeros")
    if bt == "ssm":
        # norm -> SSM residual, plus an MLP residual when the arch has one
        ssm_mod.init_ssm(b.scope("ssm"), d, cfg.ssm)
        if cfg.d_ff:
            b.param("ln2", (d,), init="zeros")
            mlp_mod.init_mlp(b.scope("mlp"), d, cfg.d_ff, cfg.mlp_gated)
        return
    b.param("ln2", (d,), init="zeros")
    if bt.startswith("mla"):
        attn.init_mla(b.scope("attn"), d, cfg.attention)
    else:
        attn.init_gqa(b.scope("attn"), d, cfg.attention)
    if bt.endswith("_moe"):
        moe_mod.init_moe(b.scope("moe"), d, cfg.moe)
    else:
        mlp_mod.init_mlp(b.scope("mlp"), d, cfg.d_ff, cfg.mlp_gated)


def init_block_cache(bt: str, cfg: ModelConfig, batch: int, max_len: int,
                     dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """One layer's rows of the slots backend's contiguous cache, zeros:
    ``{"k", "v"}`` of (batch, max_len, K, D), or for an MLA block
    ``{"c_kv", "k_rope"}`` of (batch, max_len, r) and (batch, max_len,
    dr)."""
    _check_contiguous(bt)
    a = cfg.attention
    if bt.startswith("mla"):
        return {"c_kv": torch.zeros((batch, max_len, a.kv_lora_rank), dtype=dtype,
                                    device=device),
                "k_rope": torch.zeros((batch, max_len, a.qk_rope_head_dim), dtype=dtype,
                                      device=device)}
    shape = (batch, max_len, a.num_kv_heads, a.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_block_cache(bt: str, cfg: ModelConfig, num_blocks: int,
                           block_size: int, dtype=torch.bfloat16,
                           device=None) -> Dict[str, Any]:
    _check_paged(bt)
    a = cfg.attention
    shape = (num_blocks, block_size, a.num_kv_heads, a.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_recurrent_block_cache(bt: str, cfg: ModelConfig, batch: int,
                               dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """``{"conv", "state"}`` rows for ``batch`` slots: the conv history in
    ``dtype``, the state in float32."""
    _check_recurrent(bt)
    return ssm_mod.ssm_init_cache(cfg.d_model, cfg.ssm, batch, dtype, device)


def apply_block_recurrent(bt: str, params, x: torch.Tensor, cfg: ModelConfig,
                          cache: Dict[str, Any], recurrent: RecurrentLayout,
                          kernel: str = "auto") -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Pre-norm residual SSM block over per-slot state: the SSM advances
    each row over its valid prefix (``recurrent.n_valid``), then the MLP
    residual when ``cfg.d_ff`` (mamba has none). ``kernel`` selects the
    scan. Returns ``(x, cache)``, the cache a new ``{"conv", "state"}``."""
    _check_recurrent(bt)
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    y, cache = ssm_mod.ssm_forward(params["ssm"], h, cfg.ssm, cache=cache,
                                   valid=recurrent.token_valid(x.shape[1]),
                                   kernel=kernel)
    x = x + y
    if cfg.d_ff:
        h2 = rms_norm(x, params["ln2"], cfg.norm_eps)
        x = x + mlp_mod.mlp(params["mlp"], h2, cfg.act, cfg.mlp_gated)
    return x, cache


def apply_block(bt: str, params, x: torch.Tensor, cfg: ModelConfig,
                cache: Optional[Dict[str, Any]], length: int, kernel: str = "auto"
                ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]], Union[torch.Tensor, float]]:
    """Pre-norm residual block on the contiguous path: attention over the
    layer's rows holding ``length`` tokens (or over the tokens alone when
    ``cache`` is None), GQA over ``{"k", "v"}`` or MLA over ``{"c_kv",
    "k_rope"}``, then the MLP, or the MoE FFN for ``*_moe``. ``attn_local``
    attends within ``sliding_window``. ``kernel`` selects every kernel of
    the block (flash attention for long prefills, the MoE expert FFN) or
    their plain versions. Returns ``(x, cache, aux)``, ``aux`` as
    ``apply_block_paged`` gives it; the rows are updated in place.

    The MoE FFN routes every token with no token mask, as the JAX
    package's contiguous block does: on the slots backend an idle slot's
    decode row routes and takes expert capacity too."""
    _check_contiguous(bt)
    a = cfg.attention
    causal = not cfg.is_encoder
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    if bt.startswith("mla"):
        mc = None if cache is None else MLACache(cache["c_kv"], cache["k_rope"], length)
        y_attn, mc = attn.mla_attention(params["attn"], h, a, causal=causal, cache=mc,
                                        norm_eps=cfg.norm_eps, kernel=kernel)
        new_cache = None if mc is None else {"c_kv": mc.c_kv, "k_rope": mc.k_rope}
    else:
        window = a.sliding_window if bt.endswith("_local") else None
        kv = None if cache is None else KVCache(cache["k"], cache["v"], length)
        y_attn, kv = attn.gqa_attention(params["attn"], h, a, causal=causal,
                                        window=window, cache=kv, kernel=kernel)
        new_cache = None if kv is None else {"k": kv.k, "v": kv.v}
    x = x + y_attn
    h2 = rms_norm(x, params["ln2"], cfg.norm_eps)
    if bt.endswith("_moe"):
        y_ffn, aux = moe_mod.moe_ffn(params["moe"], h2, cfg.moe, cfg.act, kernel=kernel)
    else:
        y_ffn = mlp_mod.mlp(params["mlp"], h2, cfg.act, cfg.mlp_gated)
        aux = 0.0
    return x + y_ffn, new_cache, aux


def apply_block_paged(bt: str, params, x: torch.Tensor, cfg: ModelConfig,
                      cache: Dict[str, Any], paged: PagedLayout,
                      paged_kernel: str = "auto"
                      ) -> Tuple[torch.Tensor, Dict[str, Any], Union[torch.Tensor, float]]:
    """Pre-norm residual block: GQA attention through the block pool, then
    the MLP, or the MoE FFN for ``attn_moe``. ``attn_local`` attends within
    ``sliding_window``. ``paged_kernel`` selects every kernel of the block
    (``"auto"``, ``"cuda"`` or ``"ref"``). Returns ``(x, cache, aux)``,
    ``aux`` being the MoE router losses: a float32 scalar tensor, or the
    float 0.0 for a dense block (nothing is launched for it)."""
    _check_paged(bt)
    a = cfg.attention
    window = a.sliding_window if bt.endswith("_local") else None
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    pkv = PagedKVCache(cache["k"], cache["v"], paged.block_size)
    y_attn, pkv = attn.gqa_paged_attention(params["attn"], h, a, cache=pkv,
                                           layout=paged, window=window,
                                           kernel=paged_kernel)
    x = x + y_attn
    h2 = rms_norm(x, params["ln2"], cfg.norm_eps)
    if bt.endswith("_moe"):
        # padding columns are masked out of routing, so they cannot take
        # expert capacity from real tokens
        y_ffn, aux = moe_mod.moe_ffn(params["moe"], h2, cfg.moe, cfg.act,
                                     token_mask=paged.token_valid(x.shape[1]),
                                     kernel=paged_kernel)
    else:
        y_ffn = mlp_mod.mlp(params["mlp"], h2, cfg.act, cfg.mlp_gated)
        aux = 0.0
    return x + y_ffn, {"k": pkv.k_pool, "v": pkv.v_pool}, aux
