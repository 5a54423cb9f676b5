"""Plain PyTorch versions of paged attention: gather, then dense masked softmax.

``paged_attention_ref`` is the port of ``repro/kernels/paged_attention/ref.py``.
It materializes each request's logical ``(T, K, D)`` view and masks most
of it away; it runs eagerly, so ``T`` is always bounded by the longest live
sequence rounded up to ``block_size``. The CPU path uses it, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.

``paged_attention_split_ref`` is the CUDA kernel's split-K form in plain
PyTorch (used by the tests only): per split of ``split_plan``'s keys, a
partial ``(m, l, acc)``, merged by the log-sum-exp rule. ``split_plan``
is how both the kernel's wrapper and the tests cut the table into splits.

One addition to the JAX oracle: a table entry inside a row's live range
that names no pool block (``-1``, or an id ``>= N_blocks``) is masked
here, as the CUDA kernel masks it (the JAX oracle reads the clamped block
there). The engine never produces such an entry — it grows a request's
blocks before the step that needs them — so the two agree on every table
the engine builds.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models.kvcache import PagedKVCache

NEG_INF = -2.0 ** 30  # large-but-finite: keeps fully-masked rows NaN-free
M_INIT = -1e30        # the running max's start, as the TPU kernel's
KEYS_PER_SPLIT = 128  # keys a split aims at: 8 blocks of 16
MAX_SPLITS = 32       # the kernel's merge gives each split one lane


class SplitPlan(NamedTuple):
    keys_per_split: int
    n_splits: int


def split_plan(max_blocks: int, block_size: int,
               keys_per_split: Optional[int] = None) -> SplitPlan:
    """How the CUDA kernel cuts a table of ``max_blocks * block_size`` keys:
    split ``s`` owns the keys ``[s * kps, (s + 1) * kps)``. By default
    ``kps`` is the whole blocks that make ``KEYS_PER_SPLIT`` keys (the
    engine's 64 blocks of 16: 8 splits of 128), grown to whole blocks of
    ``max_blocks / MAX_SPLITS`` for wider tables. It depends on the
    table's width alone, so the wrapper reads nothing of the step's
    lengths on the host. ``keys_per_split`` overrides it."""
    width = max_blocks * block_size
    if width <= 0 or block_size <= 0:
        raise ValueError(f"a table of {max_blocks} blocks of {block_size} has no keys")
    kps = keys_per_split
    if kps is None:
        kps = block_size * -(-KEYS_PER_SPLIT // block_size)
        if -(-width // kps) > MAX_SPLITS:
            kps = block_size * -(-max_blocks // MAX_SPLITS)
    if kps < 1 or -(-width // kps) > MAX_SPLITS:
        raise ValueError(f"{kps} keys per split cut {width} keys into more than "
                         f"{MAX_SPLITS} splits")
    return SplitPlan(kps, -(-width // kps))


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


def paged_attention_split_ref(
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
    keys_per_split: Optional[int] = None,
) -> torch.Tensor:
    """The CUDA kernel's split-K computation, in plain PyTorch.

    Each request reads its live key range ``[kv_lo, kv_hi)``: from the
    block holding the window's lower edge for the chunk's first column (0
    without a window) to ``min(seq_end, M * bs)``. Split ``s`` of
    ``split_plan`` takes the keys of that range in ``[s * kps, (s + 1) *
    kps)``: scores ``q.k * scale`` in float32, ``-2^30`` where masked
    (causal, window, a table entry that names no pool block), ``-inf``
    outside the live range; ``m_s = max(-1e30, max s)``, ``p = exp(s -
    m_s)``, ``l_s = sum p`` unrounded, ``acc_s = sum p.v`` with ``p``
    rounded to ``v``'s dtype and the V row of a table hole zero. The
    partials merge by ``m = max m_s``, ``w_s = exp(m_s - m)`` over the
    splits with ``l_s > 0``, ``out = sum w_s acc_s / max(sum w_s l_s,
    1e-30)``.

    Wherever a column sees a key this equals ``paged_attention_ref`` up to
    rounding. A column that sees no key (its own key in a table hole, the
    rest out of reach) gets the mean of the V rows of its request's live
    range, holes counting as zero rows: every key there scores ``-2^30``
    and ``p = 1``. Columns ``>= n_valid`` are zeros. Returns (B, C, H, D) in
    ``q.dtype``."""
    B, C, H, D = q.shape
    N, bs, K, _ = k_pool.shape
    G = H // K
    M = block_tables.shape[1]
    T = M * bs
    kps, n_splits = split_plan(M, bs, keys_per_split)
    scale = scale if scale is not None else D ** -0.5
    dev = q.device

    starts, n_valid = starts.long(), n_valid.long()
    seq_end = starts + n_valid
    last = torch.div(seq_end + bs - 1, bs, rounding_mode="floor") - 1
    lo_blk = torch.zeros_like(starts)
    if window is not None:
        x = starts - (window - 1)
        lo_blk = torch.minimum(torch.where(x > 0, torch.div(x, bs, rounding_mode="floor"), 0),
                               last)
    kv_lo = torch.where(seq_end > 0, lo_blk * bs, 0)
    kv_hi = torch.where(seq_end > 0, seq_end.clamp(max=T), 0)

    pos = torch.arange(T, device=dev)
    blk = block_tables.long()[:, torch.div(pos, bs, rounding_mode="floor")]   # (B, T)
    present = (blk >= 0) & (blk < N)
    live = (pos[None] >= kv_lo[:, None]) & (pos[None] < kv_hi[:, None])
    rows = blk.clamp(0, N - 1) * bs + pos % bs
    k = k_pool.reshape(N * bs, K, D)[rows]                                   # (B, T, K, D)
    v = torch.where((present & live)[:, :, None, None], v_pool.reshape(N * bs, K, D)[rows],
                    torch.zeros((), dtype=v_pool.dtype, device=dev))

    qpos = starts[:, None] + torch.arange(C, device=dev)[None]               # (B, C)
    rel = qpos[:, :, None] - pos[None, None]                                 # (B, C, T)
    visible = (rel >= 0) & present[:, None]
    if window is not None:
        visible &= rel < window
    s = torch.einsum("bckgd,btkd->bkgct", q.reshape(B, C, K, G, D).float(), k.float()) * scale
    s = s.masked_fill(~visible[:, None, None], NEG_INF)
    s = s.masked_fill(~live[:, None, None, None], float("-inf"))

    pad = n_splits * kps - T
    s = torch.nn.functional.pad(s, (0, pad), value=float("-inf"))
    s = s.reshape(B, K, G, C, n_splits, kps)
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)).reshape(B, n_splits, kps, K, D)
    m_s = s.amax(-1).clamp_min(M_INIT)                                       # (B,K,G,C,S)
    p = torch.exp(s - m_s[..., None])
    l_s = p.sum(-1)
    acc_s = torch.einsum("bkgcst,bstkd->bkgcsd", p.to(v_pool.dtype).float(), v.float())

    used = l_s > 0
    m = torch.where(used, m_s, float("-inf")).amax(-1, keepdim=True)
    w = torch.where(used, torch.exp(m_s - m), 0.0)
    l = (l_s * w).sum(-1)
    acc = (acc_s * w[..., None]).sum(-2)
    out = acc / l.clamp_min(1e-30)[..., None]                                # (B,K,G,C,D)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, C, H, D)
    cols = torch.arange(C, device=dev)[None] < n_valid[:, None]
    return torch.where(cols[:, :, None, None], out, 0.0).to(q.dtype)
