"""The LM model: layer plan -> per-layer blocks -> logits (paged serving path).

The JAX package stacks the layers of each repeated-pattern group and scans
over them; it unrolls the loop on the paged path. The port keeps one
parameter dict per layer, in ``flat_block_types`` order, and always runs
the loop unrolled.

Entry points:
  init_params(cfg, generator, device)              -> params
  init_paged_cache(cfg, num_blocks, block_size)    -> cache
  forward(cfg, params, tokens, cache=, paged=)     -> (logits, cache, aux)
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, strict_fp32
from repro_torch.models import blocks as blocks_mod
from repro_torch.models.common import ParamBuilder, rms_norm, softcap
from repro_torch.models.kvcache import PagedLayout


def layer_plan(cfg: ModelConfig) -> List[Tuple[Tuple[str, ...], int]]:
    """[(pattern, repeats), ...] covering cfg.num_layers in order: the JAX
    package's plan for plain attention and GQA MoE stacks (the bridge reads
    its group structure). MLA stacks are ROADMAP item A7, recurrent and
    hybrid ones A9 and A10."""
    a = cfg.attention
    if a is None or cfg.xlstm is not None or cfg.ssm is not None or cfg.parallel_ssm_attn:
        raise NotImplementedError(f"{cfg.name}: recurrent and hybrid stacks are not "
                                  "ported (ROADMAP items A9-A10)")
    L = cfg.num_layers
    if cfg.family == "moe":
        if a.kind == "mla":
            raise NotImplementedError(f"{cfg.name}: the MLA blocks mla_dense/mla_moe "
                                      "are ROADMAP item A7")
        first = cfg.moe.first_dense_layers
        groups = [(("attn_full",), first)] if first else []
        groups.append((("attn_moe",), L - first))
        return groups
    if a.local_global_ratio:
        cyc = ("attn_local",) * a.local_global_ratio + ("attn_full",)
        n = L // len(cyc)
        groups = [(cyc, n)]
        if L - n * len(cyc):
            groups.append((("attn_local",) * (L - n * len(cyc)), 1))
        return groups
    return [(("attn_full",), L)]


def flat_block_types(cfg: ModelConfig) -> List[str]:
    out: List[str] = []
    for pattern, r in layer_plan(cfg):
        out.extend(list(pattern) * r)
    return out


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None, dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Random parameters with the JAX ``init_params`` shapes and stds.

    ``generator`` must live on ``device`` (default: a generator seeded with
    0). ``device`` defaults to ``cuda`` and raises without a card."""
    strict_fp32()
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    b = ParamBuilder(generator, dev, dtype)
    b.param("embed", (cfg.vocab_size, cfg.d_model))
    if not cfg.tie_embeddings:
        b.param("head", (cfg.d_model, cfg.vocab_size))
    b.param("final_norm", (cfg.d_model,), init="zeros")
    layers = []
    for bt in flat_block_types(cfg):
        lb = ParamBuilder(generator, dev, dtype)
        blocks_mod.init_block(lb, bt, cfg)
        layers.append(lb.params)
    b.params["layers"] = layers
    return b.params


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """One (num_blocks, block_size, K, D) k/v pool per layer. One logical
    block id indexes the same slot in every layer's pool, so the scheduler
    keeps one block table per request."""
    return {"layers": [blocks_mod.init_paged_block_cache(
        bt, cfg, num_blocks, block_size, dtype, device)
        for bt in flat_block_types(cfg)]}


def _cast(tree, dtype: torch.dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if tree.dtype in (torch.float32, torch.bfloat16):
        return tree.to(dtype)
    return tree


def forward(
    cfg: ModelConfig,
    params: Dict[str, Any],
    tokens: torch.Tensor,                       # (B, S) int
    *,
    cache: Dict[str, Any],
    paged: PagedLayout,
    paged_kernel: str = "auto",                 # "auto" | "cuda" | "ref"
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, Dict[str, Any], Union[torch.Tensor, float]]:
    """Paged serving forward: float32 logits (B, S, V), the cache, whose
    pools are updated in place, and the MoE router losses summed over the
    layers (a float32 scalar tensor; the float 0.0 for a dense stack). ``paged_kernel`` selects every
    kernel of the path: paged attention and the MoE expert FFN. The
    dense/contiguous forward comes with ROADMAP item A7."""
    if paged is None or cache is None:
        raise NotImplementedError("the port's forward runs the paged path only; "
                                  "the contiguous path is ROADMAP item A7")
    strict_fp32()
    x = params["embed"].to(compute_dtype)[tokens.long()]
    # the JAX package rounds sqrt(d_model) to the compute dtype first
    x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=compute_dtype))
    new_layers = []
    aux = 0.0
    for bt, lp, lc in zip(flat_block_types(cfg), params["layers"], cache["layers"]):
        x, lc, a = blocks_mod.apply_block_paged(bt, _cast(lp, compute_dtype), x, cfg,
                                                lc, paged, paged_kernel)
        new_layers.append(lc)
        aux = aux + a
    x = rms_norm(x, params["final_norm"].to(compute_dtype), cfg.norm_eps)
    head = (params["embed"].to(compute_dtype).t() if cfg.tie_embeddings
            else params["head"].to(compute_dtype))
    logits = softcap((x @ head).float(), cfg.final_logit_softcap)
    return logits, {"layers": new_layers}, aux
