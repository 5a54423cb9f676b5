"""The LM model: layer plan -> per-layer blocks -> logits (serving paths).

The JAX package stacks the layers of each repeated-pattern group and scans
over them; it unrolls the loop on the paged path and at decode, and scans
at prefill and for pure-recurrent stacks. The port keeps one parameter
dict per layer, in ``flat_block_types`` order, and always runs the loop
unrolled (scan and unrolled loop round differently in bf16; the tests
measure the margin).

Entry points:
  init_params(cfg, generator, device)               -> params
  abstract_params(cfg)                              -> params on ``meta``
  init_cache(cfg, batch, max_len)                   -> cache (contiguous)
  init_paged_cache(cfg, num_blocks, block_size)     -> cache
  init_recurrent_cache(cfg, slots)                  -> cache
  forward(cfg, params, tokens)                      -> (logits, None, aux)
  forward(cfg, params, tokens, frontend_feats=, mrope_positions=)
                                                    -> (logits, None, aux)
  forward(cfg, params, tokens, cache=)              -> (logits, cache, aux)
  forward(cfg, params, tokens, cache=, paged=)      -> (logits, cache, aux)
  forward(cfg, params, tokens, cache=, recurrent=)  -> (logits, cache, aux)
  decode_step(cfg, params, cache, token)            -> (logits, cache)
  loss_fn(cfg, params, batch)                       -> (loss, metrics)

With grad enabled, a parameter that requires grad and ``cfg.remat ==
"full"``, each block of the cacheless forward runs under
``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint`` of the
scanned layer body): its activations are recomputed in the backward pass
instead of kept.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, strict_fp32
from repro_torch.models import blocks as blocks_mod
from repro_torch.models.common import ParamBuilder, rms_norm, softcap
from repro_torch.models.kvcache import PagedLayout, RecurrentLayout


def layer_plan(cfg: ModelConfig) -> List[Tuple[Tuple[str, ...], int]]:
    """[(pattern, repeats), ...] covering cfg.num_layers in order: the JAX
    package's plan for xLSTM stacks (``slstm_every - 1`` mLSTM blocks and
    one sLSTM, then the remainder as mLSTM), pure-SSM stacks, MoE stacks
    (GQA or MLA), hybrid attention + SSM stacks (``local_global_ratio``
    ``hybrid_local`` blocks and one ``hybrid_full``, then the remainder as
    local) and plain attention (the bridge reads its group structure)."""
    L = cfg.num_layers
    if cfg.xlstm is not None:
        k = cfg.xlstm.slstm_every
        if k and L >= k:
            groups = [(("mlstm",) * (k - 1) + ("slstm",), L // k)]
            if L % k:
                groups.append((("mlstm",) * (L % k), 1))
            return groups
        return [(("mlstm",), L)]
    if cfg.ssm is not None and cfg.attention is None:
        return [(("ssm",), L)]
    a = cfg.attention
    if cfg.family == "moe":
        dense_bt, moe_bt = ("mla_dense", "mla_moe") if a.kind == "mla" else (
            "attn_full", "attn_moe")
        first = cfg.moe.first_dense_layers
        groups = [((dense_bt,), first)] if first else []
        groups.append(((moe_bt,), L - first))
        return groups
    local, full = (("hybrid_local", "hybrid_full") if cfg.parallel_ssm_attn
                   else ("attn_local", "attn_full"))
    if a.local_global_ratio:
        cyc = (local,) * a.local_global_ratio + (full,)
        n = L // len(cyc)
        groups = [(cyc, n)]
        if L - n * len(cyc):
            groups.append(((local,) * (L - n * len(cyc)), 1))
        return groups
    return [((full,), L)]


def flat_block_types(cfg: ModelConfig) -> List[str]:
    out: List[str] = []
    for pattern, r in layer_plan(cfg):
        out.extend(list(pattern) * r)
    return out


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None, dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Random parameters with the JAX ``init_params`` shapes and stds
    (``frontend_proj`` (feature_dim, d_model) for a frontend whose features
    are not d_model wide).

    ``generator`` must live on ``device`` (default: a generator seeded with
    0). ``device`` defaults to ``cuda`` and raises without a card."""
    strict_fp32()
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return _build_params(cfg, generator, dev, dtype)


def abstract_params(cfg: ModelConfig) -> Dict[str, Any]:
    """``init_params``'s tree as float32 ``meta`` tensors (shapes, no
    values): the template a checkpoint restores into."""
    return _build_params(cfg, None, torch.device("meta"), torch.float32)


def _build_params(cfg, generator, dev, dtype) -> Dict[str, Any]:
    b = ParamBuilder(generator, dev, dtype)
    b.param("embed", (cfg.vocab_size, cfg.d_model))
    if cfg.frontend.kind != "none" and cfg.frontend.feature_dim != cfg.d_model:
        b.param("frontend_proj", (cfg.frontend.feature_dim, cfg.d_model))
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


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> Dict[str, Any]:
    """The contiguous cache: one ``{"k", "v"}`` of (batch, max_len, K, D)
    per layer (``{"c_kv", "k_rope"}`` for an MLA layer, the state rows of
    ``init_recurrent_cache`` for a state layer, ``{"k", "v", "conv",
    "state"}`` for a hybrid one), and one ``length`` (a host int) shared by
    every row."""
    return {"length": 0,
            "layers": [blocks_mod.init_block_cache(bt, cfg, batch, max_len, dtype, device)
                       for bt in flat_block_types(cfg)]}


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """One (num_blocks, block_size, K, D) k/v pool per layer. One logical
    block id indexes the same slot in every layer's pool, so the scheduler
    keeps one block table per request."""
    return {"layers": [blocks_mod.init_paged_block_cache(
        bt, cfg, num_blocks, block_size, dtype, device)
        for bt in flat_block_types(cfg)]}


def init_recurrent_cache(cfg: ModelConfig, slots: int, dtype=torch.bfloat16,
                         device=None) -> Dict[str, Any]:
    """One state dict per layer, ``slots`` rows each (``{"conv", "state"}``
    for an SSM layer, ``{"conv", "state", "n", "m"}`` for an mLSTM one,
    ``{"state", "c", "n", "m"}`` for an sLSTM one): the conv history in
    ``dtype``, the rest float32. Constant-size in the sequence length;
    per-request positions live in the engine."""
    return {"layers": [blocks_mod.init_recurrent_block_cache(bt, cfg, slots, dtype, device)
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
    cache: Optional[Dict[str, Any]] = None,
    paged: Optional[PagedLayout] = None,
    recurrent: Optional[RecurrentLayout] = None,
    paged_kernel: str = "auto",                 # "auto" | "cuda" | "ref"
    compute_dtype: torch.dtype = torch.bfloat16,
    last_only: bool = False,
    frontend_feats: Optional[torch.Tensor] = None,   # audio (B, T, f) / vlm (B, P, d)
    mrope_positions: Optional[torch.Tensor] = None,  # (3, B, S)
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]], Union[torch.Tensor, float]]:
    """Forward over a paged pool (``paged=``), over per-slot recurrent
    state (``recurrent=``), over a contiguous cache (``cache=`` from
    ``init_cache``: tokens at positions ``length ..``, the new cache counts
    ``length + S``), or with no cache: float32 logits (B, S, V), the cache,
    and the MoE router losses summed over the layers (a float32 scalar
    tensor; the float 0.0 for a stack without MoE). Paged pools and
    contiguous caches are updated in place; the recurrent cache is
    returned new. ``last_only`` applies the head to the last position
    alone (logits (B, 1, V)), all a prefill reads. ``paged_kernel``
    selects every kernel of the path: paged attention and the MoE expert
    FFN, the selective scan, or flash attention, the MoE expert FFN and the
    selective scan (the xLSTM recurrences have none).

    Frontends, as in the JAX package: for ``audio_frames`` the input is
    ``frontend_feats @ frontend_proj`` in the compute dtype and ``tokens``
    is ignored; for ``vision_patches`` the scaled token embeddings are
    overwritten by ``frontend_feats`` (B, P, d) at positions ``[0, P)``.
    An mrope arch's attention rotates by ``mrope_positions`` (3, B, S), or
    by text positions when it is None."""
    if paged is not None and recurrent is not None:
        raise ValueError("pass one of paged= and recurrent=")
    if (paged is not None or recurrent is not None) and cache is None:
        raise ValueError("the paged and recurrent paths need their cache")
    strict_fp32()
    if cfg.frontend.kind == "audio_frames":
        x = frontend_feats.to(compute_dtype) @ params["frontend_proj"].to(compute_dtype)
    else:
        x = params["embed"].to(compute_dtype)[tokens.long()]
        # the JAX package rounds sqrt(d_model) to the compute dtype first
        x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=compute_dtype))
        if cfg.frontend.kind == "vision_patches" and frontend_feats is not None:
            # the image's patch embeddings over the first P positions
            x[:, :frontend_feats.shape[1]] = frontend_feats.to(compute_dtype)
    seq = x.shape[1]
    contiguous = paged is None and recurrent is None
    length = cache["length"] if contiguous and cache is not None else 0
    caches = cache["layers"] if cache is not None else [None] * cfg.num_layers
    new_layers = []
    aux = 0.0
    remat = (cfg.remat == "full" and cache is None and contiguous and torch.is_grad_enabled()
             and any(t.requires_grad for t in tree.leaves(params)))
    for bt, lp, lc in zip(flat_block_types(cfg), params["layers"], caches):
        lp = _cast(lp, compute_dtype)
        if recurrent is not None:
            x, lc = blocks_mod.apply_block_recurrent(bt, lp, x, cfg, lc, recurrent,
                                                     paged_kernel)
        elif paged is not None:
            x, lc, a = blocks_mod.apply_block_paged(bt, lp, x, cfg, lc, paged,
                                                    paged_kernel)
            aux = aux + a
        elif remat:
            x, lc, a = checkpoint(_remat_block, bt, lp, x, cfg, paged_kernel,
                                  mrope_positions, use_reentrant=False)
            aux = aux + a
        else:
            x, lc, a = blocks_mod.apply_block(bt, lp, x, cfg, lc, length, paged_kernel,
                                              mrope_positions)
            aux = aux + a
        new_layers.append(lc)
    if last_only:
        x = x[:, -1:]
    x = rms_norm(x, params["final_norm"].to(compute_dtype), cfg.norm_eps)
    head = (params["embed"].to(compute_dtype).t() if cfg.tie_embeddings
            else params["head"].to(compute_dtype))
    logits = softcap((x @ head).float(), cfg.final_logit_softcap)
    if cache is None:
        return logits, None, aux
    new_cache = {"layers": new_layers}
    if contiguous:
        new_cache["length"] = length + seq
    return logits, new_cache, aux


def _remat_block(bt, lp, x, cfg, kernel, mrope_positions):
    return blocks_mod.apply_block(bt, lp, x, cfg, None, 0, kernel, mrope_positions)


def decode_step(cfg: ModelConfig, params: Dict[str, Any], cache: Dict[str, Any],
                token: torch.Tensor, *, kernel: str = "auto",
                compute_dtype: torch.dtype = torch.bfloat16,
                mrope_positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One-token decode over a contiguous cache: token (B, 1) (and an mrope
    arch's positions (3, B, 1)) -> (logits (B, 1, V), new cache)."""
    logits, cache, _ = forward(cfg, params, token, cache=cache, paged_kernel=kernel,
                               compute_dtype=compute_dtype, mrope_positions=mrope_positions)
    return logits, cache


def loss_fn(cfg: ModelConfig, params: Dict[str, Any], batch: Dict[str, torch.Tensor], *,
            kernel: str = "auto", compute_dtype: torch.dtype = torch.bfloat16
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy (decoder) or masked-frame cross-entropy
    (encoder, no shift), plus the MoE router losses, as the JAX package's
    ``loss_fn``. batch: {tokens (B, S), labels (B, S), [features],
    [mrope_positions]}. Labels outside ``[0, V)`` are masked out. Returns
    ``(loss, {"ce", "aux", "tokens"})``, 0-d float32 tensors. ``kernel``
    selects flash attention's kernel (and its backward) or the plain
    version past ``models.attention.CHUNK_THRESHOLD``."""
    logits, _, aux = forward(cfg, params, batch["tokens"], paged_kernel=kernel,
                             compute_dtype=compute_dtype,
                             frontend_feats=batch.get("features"),
                             mrope_positions=batch.get("mrope_positions"))
    labels = batch["labels"].long()
    if not cfg.is_encoder:
        logits = logits[:, :-1]
        labels = labels[:, 1:]
    logp = F.log_softmax(logits, dim=-1)
    n_cls = logits.shape[-1]
    mask = (labels >= 0) & (labels < n_cls)
    ce = -torch.gather(logp, -1, labels.clamp(0, n_cls - 1)[..., None])[..., 0]
    ce = torch.where(mask, ce, 0.0)
    denom = mask.sum().clamp(min=1)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=logits.device)
    ce_mean = ce.sum() / denom
    return ce_mean + aux, {"ce": ce_mean, "aux": aux, "tokens": denom.to(torch.float32)}
