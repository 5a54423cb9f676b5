"""Decoder block assembly for the serving paths.

The plain-GQA block types ``attn_full`` and ``attn_local`` (sliding
window) and the GQA MoE block ``attn_moe`` run on the paged path and on
the contiguous path (the slots backend's ``KVCache``, or no cache); the
MLA blocks ``mla_dense`` and ``mla_moe`` (deepseek-v2) on the contiguous
path, over an ``MLACache``. The state blocks ``ssm`` (mamba), ``mlstm``
and ``slstm`` (xLSTM) run on the recurrent path, each row gated to its
valid prefix, and on the contiguous path with no gate. The hybrid blocks
``hybrid_local`` and ``hybrid_full`` (hymba: GQA attention and an SSM in
parallel on the same normed input, mean-fused) run on the contiguous
path. On the contiguous path an encoder's blocks attend without the
causal mask, and an mrope arch's rotate by three position streams.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.common import ParamBuilder, rms_norm
from repro_torch.models.kvcache import (KVCache, MLACache, PagedKVCache, PagedLayout,
                                        RecurrentLayout)

# Block types whose cache is plain GQA k/v and whose paged path is ported.
PAGED_BLOCK_TYPES = ("attn_full", "attn_local", "attn_moe")
# Block types whose per-request state is constant-size (conv history +
# recurrent state) and whose recurrent path is ported.
RECURRENT_BLOCK_TYPES = ("mlstm", "slstm", "ssm")
# Block types whose contiguous path (KVCache or MLACache rows, state rows,
# or no cache) is ported.
CONTIGUOUS_BLOCK_TYPES = ("attn_full", "attn_local", "attn_moe", "mla_dense", "mla_moe",
                          "hybrid_local", "hybrid_full") + RECURRENT_BLOCK_TYPES


def _check(bt: str) -> None:
    if bt not in CONTIGUOUS_BLOCK_TYPES:
        raise ValueError(f"unknown block type {bt!r}: the port serves "
                         f"{CONTIGUOUS_BLOCK_TYPES}")


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
    if bt == "mlstm":
        xlstm_mod.init_mlstm(b.scope("mlstm"), d, cfg.xlstm)
        return
    if bt == "slstm":
        xlstm_mod.init_slstm(b.scope("slstm"), d, cfg.xlstm)
        return
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
    if bt.startswith("hybrid"):
        ssm_mod.init_ssm(b.scope("ssm"), d, cfg.ssm)
    if bt.endswith("_moe"):
        moe_mod.init_moe(b.scope("moe"), d, cfg.moe)
    else:
        mlp_mod.init_mlp(b.scope("mlp"), d, cfg.d_ff, cfg.mlp_gated)


def _state_cache(bt: str, cfg: ModelConfig, batch: int, dtype, device) -> Dict[str, Any]:
    """A state block's rows, the JAX package's dicts: ``{"conv", "state"}``
    (ssm), ``{"conv", "state", "n", "m"}`` (mlstm) or ``{"state", "c", "n",
    "m"}`` (slstm); conv history in ``dtype``, the rest float32."""
    if bt == "mlstm":
        return xlstm_mod.mlstm_init_cache(cfg.d_model, cfg.xlstm, batch, dtype, device)
    if bt == "slstm":
        return xlstm_mod.slstm_init_cache(cfg.d_model, cfg.xlstm, batch, device)
    return ssm_mod.ssm_init_cache(cfg.d_model, cfg.ssm, batch, dtype, device)


def init_block_cache(bt: str, cfg: ModelConfig, batch: int, max_len: int,
                     dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """One layer's rows of the slots backend's contiguous cache, zeros
    (``m`` and ``n`` of the xLSTM blocks at their initial values): ``{"k",
    "v"}`` of (batch, max_len, K, D), or for an MLA block ``{"c_kv",
    "k_rope"}`` of (batch, max_len, r) and (batch, max_len, dr); a state
    block's rows as ``init_recurrent_block_cache`` gives them; a hybrid
    block's ``{"k", "v", "conv", "state"}``."""
    _check_contiguous(bt)
    if bt in RECURRENT_BLOCK_TYPES:
        return _state_cache(bt, cfg, batch, dtype, device)
    a = cfg.attention
    if bt.startswith("mla"):
        return {"c_kv": torch.zeros((batch, max_len, a.kv_lora_rank), dtype=dtype,
                                    device=device),
                "k_rope": torch.zeros((batch, max_len, a.qk_rope_head_dim), dtype=dtype,
                                      device=device)}
    shape = (batch, max_len, a.num_kv_heads, a.head_dim)
    c = {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device)}
    if bt.startswith("hybrid"):
        c.update(_state_cache("ssm", cfg, batch, dtype, device))
    return c


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
    """A state block's rows for ``batch`` slots (``_state_cache``): the conv
    history in ``dtype``, the state float32."""
    _check_recurrent(bt)
    return _state_cache(bt, cfg, batch, dtype, device)


def _apply_state_block(bt: str, params, x: torch.Tensor, cfg: ModelConfig,
                       cache: Optional[Dict[str, Any]], valid: Optional[torch.Tensor],
                       kernel: str) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Pre-norm residual state block: mLSTM, sLSTM, or the SSM (then the
    MLP residual when ``cfg.d_ff``; mamba has none), each advancing over
    the valid prefix of each row (``valid`` (B, S), or None for every
    column). ``kernel`` selects the SSM's scan; the xLSTM recurrences have
    no kernel. Returns ``(x, cache)``, the cache new."""
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    if bt == "mlstm":
        y, cache = xlstm_mod.mlstm_forward(params["mlstm"], h, cfg.xlstm, cache=cache,
                                           valid=valid)
        return x + y, cache
    if bt == "slstm":
        y, cache = xlstm_mod.slstm_forward(params["slstm"], h, cfg.xlstm, cache=cache,
                                           valid=valid)
        return x + y, cache
    y, cache = ssm_mod.ssm_forward(params["ssm"], h, cfg.ssm, cache=cache, valid=valid,
                                   kernel=kernel)
    x = x + y
    if cfg.d_ff:
        h2 = rms_norm(x, params["ln2"], cfg.norm_eps)
        x = x + mlp_mod.mlp(params["mlp"], h2, cfg.act, cfg.mlp_gated)
    return x, cache


def apply_block_recurrent(bt: str, params, x: torch.Tensor, cfg: ModelConfig,
                          cache: Dict[str, Any], recurrent: RecurrentLayout,
                          kernel: str = "auto") -> Tuple[torch.Tensor, Dict[str, Any]]:
    """A state block over per-slot state: each row advances over its valid
    prefix (``recurrent.n_valid``). ``kernel`` selects the SSM's scan.
    Returns ``(x, cache)``, the cache new."""
    _check_recurrent(bt)
    return _apply_state_block(bt, params, x, cfg, cache,
                              recurrent.token_valid(x.shape[1]), kernel)


def apply_block(bt: str, params, x: torch.Tensor, cfg: ModelConfig,
                cache: Optional[Dict[str, Any]], length: int, kernel: str = "auto",
                mrope_positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]], Union[torch.Tensor, float]]:
    """Pre-norm residual block on the contiguous path: attention over the
    layer's rows holding ``length`` tokens (or over the tokens alone when
    ``cache`` is None), GQA over ``{"k", "v"}`` or MLA over ``{"c_kv",
    "k_rope"}``, then the MLP, or the MoE FFN for ``*_moe``. ``*_local``
    attends within ``sliding_window``. A hybrid block runs the SSM on the
    same normed input beside the attention, from its ``{"conv", "state"}``
    rows, and adds the mean of the two; a state block (ssm, mlstm, slstm)
    advances every row over every column (no valid gate, as the JAX
    package's contiguous block runs it). An encoder (``cfg.is_encoder``)
    attends without the causal mask; an mrope arch's GQA attention rotates
    by ``mrope_positions`` (3, B, S), text positions when None. ``kernel``
    selects every kernel of the block (flash attention for long prefills, the MoE expert FFN, the
    selective scan) or their plain versions. Returns ``(x, cache, aux)``,
    ``aux`` as ``apply_block_paged`` gives it; attention rows are updated in
    place, state rows returned new.

    The MoE FFN routes every token with no token mask, as the JAX
    package's contiguous block does: on the slots backend an idle slot's
    decode row routes and takes expert capacity too, and an idle slot's
    state advances over its decode column."""
    _check_contiguous(bt)
    if bt in RECURRENT_BLOCK_TYPES:
        x, cache = _apply_state_block(bt, params, x, cfg, cache, None, kernel)
        return x, cache, 0.0
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
                                        window=window, cache=kv, kernel=kernel,
                                        mrope_positions=mrope_positions)
        new_cache = None if kv is None else {"k": kv.k, "v": kv.v}
    if bt.startswith("hybrid"):
        sc = None if cache is None else {"conv": cache["conv"], "state": cache["state"]}
        y_ssm, sc = ssm_mod.ssm_forward(params["ssm"], h, cfg.ssm, cache=sc, kernel=kernel)
        # hymba: the mean of the parallel attention and mamba heads
        y_attn = 0.5 * (y_attn + y_ssm)
        if sc is not None:
            new_cache.update(sc)
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
