"""Mixture-of-experts FFN: router, capacity math, and the single-device path.

The port of ``repro/models/moe.py``. ``moe_ffn`` keeps the JAX package's
``transport`` seam, through which the multi-device jam transports move
tokens or weights; on one device there is no transport (ROADMAP item A14
ports them), and the capacity-bucketed path runs: route, bucket, the
expert FFN over the ``(E, C, d)`` buckets, gather and combine. The expert
FFN is the moe_jam kernel's wrapper (the CUDA kernel on the card, its plain
version on the CPU), not an einsum.

Semantics kept exactly, because they decide which assignments are dropped:
capacity comes from all ``B * S`` columns, padding included; the rank of an
assignment is its place among the assignments to its expert in the
token-major, k-minor order (the JAX package's exclusive cumsum; a stable
sort here); masked tokens route to expert id ``E``, which consumes no
capacity.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.kernels.moe_jam import moe_jam_ffn
from repro_torch.models.common import ParamBuilder, act_fn


class RouteResult(NamedTuple):
    expert_ids: torch.Tensor   # (N, k) int32
    gates: torch.Tensor        # (N, k) f32, normalized over k
    aux_loss: torch.Tensor     # () load-balance aux
    z_loss: torch.Tensor       # () router z-loss


def init_moe(b: ParamBuilder, d_model: int, m: MoEConfig) -> None:
    b.param("router", (d_model, m.num_experts))
    e = m.num_experts
    b.param("w_gate", (e, d_model, m.expert_ff), fan_in=d_model)
    b.param("w_up", (e, d_model, m.expert_ff), fan_in=d_model)
    b.param("w_down", (e, m.expert_ff, d_model), fan_in=m.expert_ff)
    if m.num_shared > 0:
        ff = (m.shared_ff or m.expert_ff) * m.num_shared
        b.param("ws_gate", (d_model, ff))
        b.param("ws_up", (d_model, ff))
        b.param("ws_down", (ff, d_model))


def route_topk(x: torch.Tensor, router_w: torch.Tensor, m: MoEConfig) -> RouteResult:
    """x: (N, d) -> top-k routing with Switch-style aux losses (float32 math).

    ``jax.lax.top_k`` orders equal probabilities by the lower expert id;
    ``torch.topk`` promises no order, so a stable descending sort picks
    the same experts at an exact tie."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[:, :m.top_k], ids[:, :m.top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    e = m.num_experts
    f = F.one_hot(ids[:, 0], e).float().mean(0)             # primary expert
    p = probs.mean(0)
    aux = e * torch.sum(f * p) * m.router_aux_coef
    z = torch.logsumexp(logits, dim=-1).square().mean() * m.router_z_coef
    return RouteResult(ids.to(torch.int32), gates, aux, z)


def expert_capacity(n_tokens: int, m: MoEConfig) -> int:
    """Per-expert capacity, padded to a multiple of 8 (at least 8)."""
    c = math.ceil(n_tokens * m.top_k * m.capacity_factor / m.num_experts)
    return max(8, -(-c // 8) * 8)


def build_dispatch(ids: torch.Tensor, n_experts: int, capacity: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Capacity-bucketed dispatch plan.

    Returns (slot (N,k) int32 in [0, E*C] — E*C is the drop slot,
             keep (N,k) bool, position-in-expert rank (N,k) int32).

    The rank of an assignment is the number of earlier assignments (in the
    token-major, k-minor order) to the same expert, as the JAX package's
    exclusive cumsum over a one-hot gives it. Here it comes from a stable
    sort of the flat ids instead: an assignment's position in the sorted
    order less the first position of its expert, in O(N k log(N k)) and
    never an (N k, E) tensor. An id equal to ``n_experts`` (a masked token)
    has an all-zero one-hot row in the JAX form: rank 0, kept, and slot
    ``E*C``, the drop slot."""
    n, k = ids.shape
    flat = ids.reshape(-1).to(torch.int32)                     # (N*k,)
    sorted_ids, order = torch.sort(flat, stable=True)
    first = torch.searchsorted(sorted_ids, sorted_ids)         # of each one's expert
    pos = torch.arange(flat.numel(), dtype=torch.int64, device=ids.device)
    rank = torch.empty_like(flat)
    rank[order] = (pos - first).to(torch.int32)
    rank = torch.where(flat == n_experts, 0, rank).reshape(n, k)
    keep = rank < capacity
    slot = torch.where(keep, ids.to(torch.int32) * capacity + rank,
                       torch.full_like(rank, n_experts * capacity))
    return slot, keep, rank


def moe_ffn_oracle(params, x: torch.Tensor, m: MoEConfig, act: str = "silu",
                   capacity: Optional[int] = None,
                   token_mask: Optional[torch.Tensor] = None,
                   kernel: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-bucketed single-device MoE. x: (B, S, d) -> (out, aux + z).

    ``token_mask`` (B, S) bool marks real tokens: masked-out tokens (paged
    serving's padding columns) route to the drop slot with zero gates, so
    they consume no expert capacity and contribute nothing. ``kernel``
    picks the expert FFN (``moe_jam_ffn``'s rule)."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    n = xf.shape[0]
    e = m.num_experts
    r = route_topk(xf, params["router"], m)
    ids, gates = r.expert_ids, r.gates
    if token_mask is not None:
        tm = token_mask.reshape(-1)
        ids = torch.where(tm[:, None], ids, torch.full_like(ids, e))
        gates = gates * tm[:, None]
    c = capacity or expert_capacity(n, m)
    slot, keep, _ = build_dispatch(ids, e, c)
    flat_slot = slot.reshape(-1).long()
    # the buffer's last row takes every dropped and masked assignment, and
    # is cut off: no sync to the host, the rows left are unique
    buf = torch.zeros((e * c + 1, d), dtype=x.dtype, device=x.device)
    buf[flat_slot] = xf.repeat_interleave(m.top_k, dim=0)
    # the dispatch fills each expert's rows 0, 1, ... in order: its kept
    # count tells the kernel which rows are empty
    counts = torch.zeros(e + 1, dtype=torch.int64, device=x.device)
    counts.scatter_add_(0, ids.reshape(-1).long(), torch.ones_like(flat_slot))
    counts = counts[:e].clamp(max=c).to(torch.int32)
    out_buf = moe_jam_ffn(buf[:-1].view(e, c, d), params["w_gate"], params["w_up"],
                          params["w_down"], act, counts=counts, kernel=kernel)
    out_buf = torch.cat([out_buf.reshape(-1, d), out_buf.new_zeros((1, d))])
    gathered = out_buf[flat_slot].reshape(n, m.top_k, d)
    w = (gates * keep).to(x.dtype)
    y = torch.einsum("nkd,nk->nd", gathered, w)
    if m.num_shared > 0:
        g = xf @ params["ws_gate"]
        u = xf @ params["ws_up"]
        y = y + (act_fn(act)(g) * u) @ params["ws_down"]
    return y.reshape(b, s, d), r.aux_loss + r.z_loss


MoETransport = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def moe_ffn(params, x: torch.Tensor, m: MoEConfig, act: str = "silu",
            transport: Optional[MoETransport] = None,
            token_mask: Optional[torch.Tensor] = None,
            kernel: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN with the JAX package's transport seam. ``transport=None`` is
    the single-device path; a transport raises, since none exists on one
    device (ROADMAP item A14 ports the multi-device jam transports)."""
    if transport is not None:
        raise NotImplementedError("MoE jam transports need several devices: "
                                  "ROADMAP item A14 ports them")
    return moe_ffn_oracle(params, x, m, act, token_mask=token_mask, kernel=kernel)
