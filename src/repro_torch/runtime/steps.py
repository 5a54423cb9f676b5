"""The train step and the serve steps, on one device.

``make_train_step`` is the JAX package's: gradient accumulation over
micro-batches, the global-norm clip, the warmup-cosine schedule and AdamW,
with ``remat="full"`` recomputing each block in the backward pass.

The serve steps: the paged step (block-pool cache, dense
and MoE GQA stacks) and the recurrent step (per-slot constant-size state,
SSM and xLSTM stacks), each serving decode and chunked prefill in one
fixed shape; and the slots backend's two steps over the contiguous cache
(GQA or MLA, dense or MoE, state and hybrid blocks, mrope stacks), the
one-request prefill and the one-token decode of every slot. The prefill
step is also an encoder's entry point: logits for every frame, no
cache. Each bundle's
``meta["kernels"]`` names the kernels its stack can launch, derived from
its block types. Every bundle
owns a ``Fabric`` (``meta["fabric"]``, as in the JAX package's
``_bundle_fabric``): the Engine registers its steps on it and invokes them
through ``fabric.call``. Mesh lowering is ROADMAP A14."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.device import resolve_device, strict_fp32
from repro_torch.fabric import Fabric
from repro_torch.kernels import flash_attention, moe_jam, paged_attention, ssm_scan
from repro_torch.kernels.loader import resolve_kernel
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks as blocks_mod
from repro_torch.models import model as model_lib
from repro_torch.models.kvcache import PagedLayout, RecurrentLayout
from repro_torch.optim import (AdamWState, adamw_update, clip_by_global_norm,
                               warmup_cosine)


# the launch counter of every kernel a step can run
LAUNCH_COUNTERS = {"paged_attention": paged_attention.LAUNCHES,
                   "moe_jam": moe_jam.LAUNCHES,
                   "ssm_scan": ssm_scan.LAUNCHES,
                   "flash_attention": flash_attention.LAUNCHES,
                   "flash_attention_bwd": flash_attention.BWD_LAUNCHES,
                   "moe_jam_bwd": moe_jam.BWD_LAUNCHES,
                   "ssm_scan_bwd": ssm_scan.BWD_LAUNCHES}
# the kernels a train step can launch, each with its backward kernel
TRAIN_KERNELS = {"flash_attention": "flash_attention_bwd", "moe_jam": "moe_jam_bwd",
                 "ssm_scan": "ssm_scan_bwd"}


@dataclasses.dataclass
class StepBundle:
    fn: Callable
    meta: Dict[str, Any]


def train_refusal(cfg: ModelConfig, seq_len: int) -> Optional[str]:
    """Why the card cannot train ``cfg`` at ``seq_len`` yet (None: it can).
    A kernel with no backward would return an output autograd does not
    see; its wrapper raises at the first step, and this names the reason
    before it."""
    for bt in sorted(set(model_lib.flat_block_types(cfg))):
        if bt in ("mlstm", "slstm"):
            return f"block {bt!r}: xLSTM training on the card is one of A13's later halves"
    a = cfg.attention
    if a is not None and attn_mod._use_chunked(seq_len, seq_len):
        d, dv = ((a.qk_nope_head_dim + a.qk_rope_head_dim, a.v_head_dim) if a.kind == "mla"
                 else (a.head_dim, a.head_dim))
        if d != dv or d not in flash_attention.BWD_HEAD_DIMS:
            return (f"flash attention's backward kernel has no instance at q/k {d}, v {dv} "
                    f"(it has {flash_attention.BWD_HEAD_DIMS}): A13's later halves")
    return None


def make_train_step(cfg: ModelConfig, run: RunConfig, *, kernel: str = "auto", device=None,
                    compute_dtype: torch.dtype = torch.bfloat16) -> StepBundle:
    """One optimizer step, as the JAX package's train step.

    fn(params, opt, batch) -> (params, opt, metrics). ``params``: float32
    masters (``models.model.init_params``); ``opt``: ``AdamWState``; both
    updated in place and returned. ``batch``: the global batch
    (``data.synthetic_batch``'s fields as tensors on the device), split into
    ``run.optimizer.accum_steps`` micro-batches of consecutive rows (the
    batch dim of ``mrope_positions`` is 1). Each micro-batch's gradients
    (float32, ``torch.autograd.grad`` of ``models.model.loss_fn``) are
    summed and divided by the count; then ``clip_by_global_norm``,
    ``warmup_cosine`` at the step before the update and ``adamw_update``.
    ``metrics``: 0-d tensors ``ce`` and ``aux`` (micro-batch means),
    ``tokens`` (summed), ``loss`` (the mean of the micro-batch losses),
    ``grad_norm`` (before the clip) and ``lr``.

    ``kernel`` selects flash attention's kernels (forward and backward) or
    the plain version past ``models.attention.CHUNK_THRESHOLD``, the MoE
    expert FFN's (``moe_jam`` and its backward) and the selective scan's
    (``ssm_scan`` and its backward); on a card a stack that
    would reach a kernel with no backward is refused here
    (``train_refusal``). ``meta["kernels"]`` names the kernels a step can
    launch."""
    dev = resolve_device(device)
    kind = resolve_kernel(kernel, dev)
    if kind == "cuda":
        why = train_refusal(cfg, run.shape.seq_len)
        if why is not None:
            raise NotImplementedError(f"cannot train {cfg.name} on the card: {why}")
    ocfg = run.optimizer
    accum = max(1, ocfg.accum_steps)
    kernels = tuple(name for k in _stack_kernels(cfg) if k in TRAIN_KERNELS
                    for name in (k, TRAIN_KERNELS[k]))

    def split(batch):
        rows = batch["tokens"].shape[0]
        if rows % accum:
            raise ValueError(f"a batch of {rows} rows does not split into {accum} micro-batches")
        mb = rows // accum
        return [{k: (v[:, i * mb:(i + 1) * mb] if k == "mrope_positions"
                     else v[i * mb:(i + 1) * mb]) for k, v in batch.items()}
                for i in range(accum)]

    def train_step(params, opt: AdamWState, batch):
        strict_fp32()
        leaves = tree.leaves(params)
        gsum, loss_sum, msum = None, None, None
        try:
            with torch.enable_grad():
                for leaf in leaves:
                    leaf.requires_grad_(True)
                for mb in split(batch):
                    loss, metrics = model_lib.loss_fn(cfg, params, mb, kernel=kind,
                                                      compute_dtype=compute_dtype)
                    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
                    grads = [torch.zeros_like(p) if g is None else g.to(torch.float32)
                             for p, g in zip(leaves, grads)]
                    metrics = {k: v.detach() for k, v in metrics.items()}
                    if gsum is None:
                        gsum, loss_sum, msum = grads, loss.detach(), metrics
                    else:
                        torch._foreach_add_(gsum, grads)
                        loss_sum = loss_sum + loss.detach()
                        msum = {k: msum[k] + metrics[k] for k in msum}
                    del grads, loss
        finally:
            for leaf in leaves:
                leaf.requires_grad_(False)
        if accum > 1:
            torch._foreach_div_(gsum, float(accum))
            loss_sum = loss_sum / accum
            msum = dict(msum, ce=msum["ce"] / accum, aux=msum["aux"] / accum)
        grads, gnorm = clip_by_global_norm(tree.unflatten(params, gsum), ocfg.grad_clip)
        lr = warmup_cosine(opt.step, ocfg)
        params, opt = adamw_update(grads, opt, params, lr, ocfg)
        return params, opt, dict(msum, loss=loss_sum, grad_norm=gnorm, lr=lr)

    return StepBundle(fn=train_step, meta=dict(
        kind="train", kernel=kind, device=dev, accum=accum, kernels=kernels,
        fabric=Fabric(name="steps.train")))


def make_step(cfg: ModelConfig, run: RunConfig, batch_override: Optional[int] = None, *,
              kernel: str = "auto", device=None,
              compute_dtype: torch.dtype = torch.bfloat16) -> StepBundle:
    """The step of ``run.shape.kind``: ``train`` (``make_train_step``),
    ``prefill`` (``make_prefill_step`` into a cache of the shape's length)
    or ``decode`` (``make_serve_step`` over the batch's slots)."""
    kind = run.shape.kind
    kw = dict(kernel=kernel, device=device, compute_dtype=compute_dtype)
    if kind == "train":
        return make_train_step(cfg, run, **kw)
    if kind == "prefill":
        return make_prefill_step(cfg, max_len=run.shape.seq_len, **kw)
    if kind == "decode":
        return make_serve_step(cfg, slots=batch_override or run.shape.global_batch, **kw)
    raise ValueError(kind)


def make_paged_serve_step(cfg: ModelConfig, *, slots: int, chunk: int,
                          num_blocks: int, block_size: int,
                          max_blocks_per_seq: int, kernel: str = "auto",
                          emit: str = "last", device=None,
                          compute_dtype: torch.dtype = torch.bfloat16) -> StepBundle:
    """One step through the paged pool for ``slots`` request rows.

    fn(params, cache, tokens (slots, chunk), block_tables (slots,
    max_blocks_per_seq), starts (slots,), n_valid (slots,)) ->
    (next_token, cache). ``next_token`` (slots,) is the greedy argmax at
    each row's last valid column (``max(n_valid - 1, 0)``); rows mid-prefill
    get a token the scheduler ignores. ``emit="all"`` returns the argmax at
    every column, (slots, chunk). The pools are updated in place.

    ``kernel`` selects every kernel of the step (paged attention and the
    MoE expert FFN); ``meta["paged_kernel"]`` (and ``meta["kernel"]``)
    holds the resolved kind. The
    MoE router losses are dropped.
    ``meta["nonfinite_logits"]`` is a device counter of rows (with
    ``n_valid > 0``) whose emitted logits held a NaN or an infinity; it is
    read without a per-step sync. ``meta["kernels"]`` names the kernels
    the step can launch (keys of ``LAUNCH_COUNTERS``).
    """
    if cfg.is_encoder:
        raise ValueError("encoder-only arch has no decode step")
    if emit not in ("last", "all"):
        raise ValueError(f"emit must be 'last' or 'all', got {emit!r}")
    dev = resolve_device(device)
    paged_kernel = resolve_kernel(kernel, dev)
    nonfinite = torch.zeros((), dtype=torch.int64, device=dev)

    @torch.no_grad()
    def paged_step(params, cache, tokens, block_tables, starts, n_valid):
        layout = PagedLayout(block_tables, starts, n_valid, block_size)
        logits, cache, _ = model_lib.forward(cfg, params, tokens, cache=cache,
                                             paged=layout, paged_kernel=paged_kernel,
                                             compute_dtype=compute_dtype)
        if emit == "all":
            bad = ~torch.isfinite(logits).all(-1) & layout.token_valid(logits.shape[1])
            nonfinite.add_(bad.sum())
            return torch.argmax(logits, dim=-1).to(torch.int32), cache
        return _last_valid(logits, n_valid, nonfinite), cache

    return StepBundle(fn=paged_step, meta=dict(
        kind="paged_decode" if emit == "last" else "paged_verify",
        block_size=block_size, num_blocks=num_blocks, chunk=chunk, slots=slots,
        max_blocks_per_seq=max_blocks_per_seq, paged_kernel=paged_kernel,
        kernel=paged_kernel, emit=emit, device=dev, nonfinite_logits=nonfinite,
        kernels=("paged_attention", "moe_jam"), fabric=Fabric(name="steps.paged_decode")))


def _last_valid(logits: torch.Tensor, n_valid: torch.Tensor,
                nonfinite: torch.Tensor) -> torch.Tensor:
    """Greedy token at each row's last valid column ``max(n_valid - 1, 0)``;
    counts rows with ``n_valid > 0`` whose logits there are not finite."""
    last = (n_valid.long() - 1).clamp(min=0)
    last_logits = logits[torch.arange(logits.shape[0], device=logits.device), last]
    bad = ~torch.isfinite(last_logits).all(-1) & (n_valid > 0)
    nonfinite.add_(bad.sum())
    return torch.argmax(last_logits, dim=-1).to(torch.int32)


def make_recurrent_serve_step(cfg: ModelConfig, *, slots: int, chunk: int,
                              kernel: str = "auto", device=None,
                              compute_dtype: torch.dtype = torch.bfloat16) -> StepBundle:
    """One step through per-slot recurrent state for ``slots`` request rows.

    fn(params, cache, tokens (slots, chunk), starts (slots,), n_valid
    (slots,)) -> (next_token (slots,), new cache). The paged step's
    contract minus block tables: rows carry a valid-prefix token layout
    and every state update at an invalid column is gated off inside the
    scan, so each row's result is what it would be with its tokens alone,
    whatever slot it sits in and whatever the other rows hold. The cache is
    O(slots) whatever the sequence lengths.

    ``kernel`` selects the selective scan; ``meta["kernel"]`` holds the
    resolved kind, ``meta["nonfinite_logits"]`` counts rows with
    non-finite emitted logits, as in the paged step. ``meta["kernels"]``
    is ``("ssm_scan",)`` for a stack with SSM blocks and empty for an xLSTM
    one, whose recurrences launch no kernel.
    """
    if cfg.is_encoder:
        raise ValueError("encoder-only arch has no decode step")
    bad = sorted(set(model_lib.flat_block_types(cfg)) - set(blocks_mod.RECURRENT_BLOCK_TYPES))
    if bad:
        raise ValueError(f"recurrent serving supports block types "
                         f"{blocks_mod.RECURRENT_BLOCK_TYPES}, got {bad}: these carry "
                         "seq-sized KV state; use cache='paged' for this arch")
    dev = resolve_device(device)
    kind = resolve_kernel(kernel, dev)
    nonfinite = torch.zeros((), dtype=torch.int64, device=dev)

    @torch.no_grad()
    def recurrent_step(params, cache, tokens, starts, n_valid):
        layout = RecurrentLayout(starts, n_valid)
        logits, cache, _ = model_lib.forward(cfg, params, tokens, cache=cache,
                                             recurrent=layout, paged_kernel=kind,
                                             compute_dtype=compute_dtype)
        return _last_valid(logits, n_valid, nonfinite), cache

    return StepBundle(fn=recurrent_step, meta=dict(
        kind="recurrent_decode", chunk=chunk, slots=slots, kernel=kind, device=dev,
        nonfinite_logits=nonfinite, kernels=_stack_kernels(cfg),
        fabric=Fabric(name="steps.recurrent_decode")))


def _stack_kernels(cfg: ModelConfig) -> tuple:
    """The kernels a stack's blocks can launch: flash attention where a
    block attends (on the contiguous path, for a long prefill), the
    selective scan where a block holds an SSM, the MoE expert FFN where a
    block is MoE."""
    types = set(model_lib.flat_block_types(cfg))
    uses = {"flash_attention": any(bt.startswith(("attn", "mla", "hybrid")) for bt in types),
            "ssm_scan": any(bt == "ssm" or bt.startswith("hybrid") for bt in types),
            "moe_jam": any(bt.endswith("_moe") for bt in types)}
    return tuple(name for name, used in uses.items() if used)


def _contiguous_kernels(cfg: ModelConfig, decode: bool = True) -> tuple:
    """The kernels a slots step can launch (``_stack_kernels``), after
    checking that every block type has a contiguous path and, for a decode
    step, that the arch has one."""
    if decode and cfg.is_encoder:
        raise ValueError("encoder-only arch has no decode step")
    bad = sorted(set(model_lib.flat_block_types(cfg)) - set(blocks_mod.CONTIGUOUS_BLOCK_TYPES))
    if bad:
        raise ValueError(f"the slots backend supports block types "
                         f"{blocks_mod.CONTIGUOUS_BLOCK_TYPES}, got {bad}")
    return _stack_kernels(cfg)


def make_prefill_step(cfg: ModelConfig, *, max_len: int, kernel: str = "auto",
                      device=None, compute_dtype: torch.dtype = torch.bfloat16) -> StepBundle:
    """A batch's prefill into a fresh contiguous cache of ``max_len``, in the
    compute dtype, as the JAX package's prefill step.

    fn(params, tokens (B, L), frontend_feats=None, mrope_positions=None)
    -> (logits (B, V) float32 at the last position, filled cache holding L
    tokens). The head runs on the last position alone: it is all the JAX
    package's prefill step returns and all the Engine reads.
    ``frontend_feats`` are a vision arch's patch embeddings (B, P, d),
    spliced over the first P positions, and ``mrope_positions`` (3, B, L)
    its rotary positions (text positions when None). For an encoder
    (``cfg.is_encoder``) ``frontend_feats`` are its frame features (B, L,
    f), ``tokens`` only set the shape (as in the JAX package, which reads
    none of them), no cache is built (``max_len`` is unused) and fn
    returns (logits (B, L, V) float32 for every frame, None). ``kernel``
    selects flash attention's kernel or its plain version for a prompt
    past ``models.attention.CHUNK_THRESHOLD``, the MoE expert FFN's and
    the selective scan's.
    """
    kernels = _contiguous_kernels(cfg, decode=False)
    dev = resolve_device(device)
    kind = resolve_kernel(kernel, dev)

    @torch.no_grad()
    def prefill_step(params, tokens, frontend_feats=None, mrope_positions=None):
        cache = None if cfg.is_encoder else model_lib.init_cache(
            cfg, tokens.shape[0], max_len, dtype=compute_dtype, device=dev)
        logits, cache, _ = model_lib.forward(cfg, params, tokens, cache=cache,
                                             paged_kernel=kind, compute_dtype=compute_dtype,
                                             last_only=not cfg.is_encoder,
                                             frontend_feats=frontend_feats,
                                             mrope_positions=mrope_positions)
        if cfg.is_encoder:
            return logits, None
        return logits[:, -1], cache

    return StepBundle(fn=prefill_step, meta=dict(
        kind="prefill", max_len=max_len, kernel=kind, device=dev,
        kernels=kernels, fabric=Fabric(name="steps.prefill")))


def make_serve_step(cfg: ModelConfig, *, slots: int, kernel: str = "auto", device=None,
                    compute_dtype: torch.dtype = torch.bfloat16) -> StepBundle:
    """One decode token for every slot over the contiguous cache.

    fn(params, cache, token (slots, 1)) -> (next_token (slots, 1), cache
    holding one token more). Every row decodes at the cache's one shared
    ``length`` and attends over all ``max_len`` rows, masked by that
    position (the JAX package's lockstep: exact only for slots whose
    prompts end at the same position); an mrope stack takes that position
    in all three streams, (3, slots, 1), as the JAX engine's slots tick
    builds it. The cache is updated in place.
    ``meta["nonfinite_logits"]`` counts rows whose logits held a NaN or an
    infinity; ``kernel`` selects the MoE expert FFN's kernel and the
    selective scan's, or their plain versions (attention over one query
    runs no kernel: plain ``_sdpa``, or MLA's absorbed scores)."""
    kernels = _contiguous_kernels(cfg)
    dev = resolve_device(device)
    kind = resolve_kernel(kernel, dev)
    nonfinite = torch.zeros((), dtype=torch.int64, device=dev)

    mrope = cfg.attention is not None and cfg.attention.mrope

    @torch.no_grad()
    def serve_step(params, cache, token):
        mpos = None
        if mrope:
            mpos = torch.full((3, token.shape[0], 1), cache["length"], dtype=torch.int32,
                              device=token.device)
        logits, cache = model_lib.decode_step(cfg, params, cache, token, kernel=kind,
                                              compute_dtype=compute_dtype, mrope_positions=mpos)
        last = logits[:, -1]
        nonfinite.add_((~torch.isfinite(last).all(-1)).sum())
        return torch.argmax(last, dim=-1).to(torch.int32)[:, None], cache

    return StepBundle(fn=serve_step, meta=dict(
        kind="decode", slots=slots, kernel=kind, device=dev, nonfinite_logits=nonfinite,
        kernels=kernels, fabric=Fabric(name="steps.decode")))
