"""Load and launch the CUDA paged-attention kernel.

``csrc/paged_attention.cu`` has a plain C interface; ``kernels.loader``
builds it with ``nvcc`` at first use and loads it with ``ctypes``.
Nothing is built or loaded when this module is imported. The kernel splits
each request's keys over CTAs (``ref.split_plan``) and merges the splits'
partials in a second pass; the wrapper allocates their scratch.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import loader
from repro_torch.kernels.paged_attention.ref import split_plan

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
LAUNCHES = loader.LaunchCounter()
_fn = None


def _load():
    global _fn
    if _fn is None:
        fn = loader.load(SOURCE).paged_attention_bf16
        # q, k_pool, v_pool, tables, starts, n_valid, out, part_ml,
        # part_acc; B, C, H, K, D, bs, M, N, window, kps, n_splits; scale;
        # stream
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 11
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k_pool, v_pool, block_tables, starts, n_valid, block_size, window):
    tensors = dict(q=q, k_pool=k_pool, v_pool=v_pool, block_tables=block_tables,
                   starts=starts, n_valid=n_valid)
    for name, t in tensors.items():
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 4:
            raise ValueError(f"{name} must be contiguous and start 4-byte aligned")
    for name in ("q", "k_pool", "v_pool"):
        if tensors[name].dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {tensors[name].dtype}")
    for name in ("block_tables", "starts", "n_valid"):
        if tensors[name].dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {tensors[name].dtype}")
    if q.dim() != 4 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"want q (B,C,H,D) and equal pools (N,bs,K,D), got "
                         f"{tuple(q.shape)}, {tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    B, C, H, D = q.shape
    N, bs, K, Dk = k_pool.shape
    if bs != block_size or Dk != D or K == 0 or H % K:
        raise ValueError(f"pool {tuple(k_pool.shape)} does not fit q {tuple(q.shape)} "
                         f"with block_size={block_size}")
    if D % 2 or not 2 <= D <= 256:
        raise ValueError(f"head_dim must be even and <= 256, got {D}")
    if (block_tables.dim() != 2 or block_tables.shape[0] != B
            or block_tables.shape[1] == 0
            or starts.shape != (B,) or n_valid.shape != (B,)):
        raise ValueError(f"tables {tuple(block_tables.shape)}, starts "
                         f"{tuple(starts.shape)}, n_valid {tuple(n_valid.shape)} "
                         f"do not fit batch {B}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")


def paged_attention_cuda(
    q: torch.Tensor,                   # (B, C, H, D) bf16
    k_pool: torch.Tensor,              # (N_blocks, block_size, K, D) bf16
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,        # (B, M) int32, -1 = unallocated
    starts: torch.Tensor,              # (B,) int32
    n_valid: torch.Tensor,             # (B,) int32
    *,
    block_size: int,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Launch the kernel on the current stream, its keys cut by
    ``split_plan``. Returns (B, C, H, D) bf16; columns ``>= n_valid`` are
    zeros. Raises on inputs the kernel does not take and on a refused
    launch."""
    return _launch(q, k_pool, v_pool, block_tables, starts, n_valid, block_size, window,
                   scale, None)


def _launch(q, k_pool, v_pool, block_tables, starts, n_valid, block_size, window, scale,
            keys_per_split):
    """``paged_attention_cuda`` with ``split_plan``'s cut overridden by
    ``keys_per_split`` when it is not None (the bench's sweep and the card
    tests of every split count)."""
    loader.refuse_grad("paged_attention", "the paged path serves only; training runs "
                       "the contiguous forward", q, k_pool, v_pool)
    _check(q, k_pool, v_pool, block_tables, starts, n_valid, block_size, window)
    B, C, H, D = q.shape
    N, _, K, _ = k_pool.shape
    M = block_tables.shape[1]
    kps, n_splits = split_plan(M, block_size, keys_per_split)
    out = torch.empty_like(q)
    rows = (n_splits, B, K, H // K * C)
    part_ml = torch.empty((*rows, 2), dtype=torch.float32, device=q.device)
    part_acc = torch.empty((*rows, D), dtype=torch.float32, device=q.device)
    scale = scale if scale is not None else D ** -0.5
    fn = _load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                block_tables.data_ptr(), starts.data_ptr(), n_valid.data_ptr(),
                out.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr(), B, C, H, K, D,
                block_size, M, N, window or 0, kps, n_splits, scale, stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: cudaError {rc}")
    LAUNCHES.count += 1
    return out
