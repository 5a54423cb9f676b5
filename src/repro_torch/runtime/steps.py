"""The paged serve step: block-pool cache, decode and chunked prefill in one
fixed shape, on one device, for dense and MoE GQA stacks. Mesh and fabric
lowering are later slices (ROADMAP A11/A14)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import moe_jam, paged_attention
from repro_torch.kernels.loader import resolve_kernel
from repro_torch.models import model as model_lib
from repro_torch.models.kvcache import PagedLayout


# the launch counter of every kernel a step can run
LAUNCH_COUNTERS = {"paged_attention": paged_attention.LAUNCHES,
                   "moe_jam": moe_jam.LAUNCHES}


@dataclasses.dataclass
class StepBundle:
    fn: Callable
    meta: Dict[str, Any]


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
    MoE expert FFN); ``meta["paged_kernel"]`` holds the resolved kind. The
    MoE router losses are dropped.
    ``meta["nonfinite_logits"]`` is a device counter of rows (with
    ``n_valid > 0``) whose emitted logits held a NaN or an infinity; it is
    read without a per-step sync.
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
        last = (n_valid.long() - 1).clamp(min=0)
        last_logits = logits[torch.arange(logits.shape[0], device=logits.device), last]
        bad = ~torch.isfinite(last_logits).all(-1) & (n_valid > 0)
        nonfinite.add_(bad.sum())
        return torch.argmax(last_logits, dim=-1).to(torch.int32), cache

    return StepBundle(fn=paged_step, meta=dict(
        kind="paged_decode" if emit == "last" else "paged_verify",
        block_size=block_size, num_blocks=num_blocks, chunk=chunk, slots=slots,
        max_blocks_per_seq=max_blocks_per_seq, paged_kernel=paged_kernel,
        emit=emit, device=dev, nonfinite_logits=nonfinite))
