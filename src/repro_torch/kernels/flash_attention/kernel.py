"""Load and launch the CUDA flash-attention kernel.

``csrc/flash_attention.cu`` has a plain C interface; ``kernels.loader``
builds it with ``nvcc`` at first use and loads it with ``ctypes``. Nothing
is built or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import loader

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
LAUNCHES = loader.LaunchCounter()
# the C interface's design codes (flash_design)
DESIGN_NAMES = {1: "mma v1", 2: "tma-wgmma v2"}
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = loader.load(SOURCE)
        # q, k, v, out, strides; B, Hkv, S, T, G, D, Dv, causal, window,
        # q_offset; scale; tiles; stream
        lib.flash_attention_bf16.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 10
            + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
        lib.flash_attention_bf16.restype = ctypes.c_int
        for fn in (lib.flash_design, lib.flash_key_tile):
            fn.argtypes = [ctypes.c_int, ctypes.c_int]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def design(head_dim: int, v_dim: Optional[int] = None) -> Optional[str]:
    """The design the kernel runs with q and k of width ``head_dim`` and v
    of width ``v_dim`` (default: ``head_dim``), as its C interface chooses
    it (by the two widths alone), or None where it has no instance. Builds
    the kernel at first use, so it needs ``nvcc``."""
    v_dim = head_dim if v_dim is None else v_dim
    return DESIGN_NAMES.get(_load().flash_design(head_dim, v_dim))


def key_tile(head_dim: int, v_dim: Optional[int] = None) -> int:
    """The keys per kv tile of that design (0 where there is none)."""
    v_dim = head_dim if v_dim is None else v_dim
    return _load().flash_key_tile(head_dim, v_dim)


def _check(q, k, v, window):
    for name, t in dict(q=q, k=k, v=v).items():
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, H, S, D), got {tuple(t.shape)}")
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name} must have unit stride along D, other strides that "
                             f"are multiples of 8 and a 16-byte aligned start (it moves "
                             f"in 16-byte chunks); got strides {t.stride()}")
    B, Hq, S, D = q.shape
    if k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    Hkv, Dv = k.shape[1], v.shape[3]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"query heads {Hq} must be a multiple of kv heads {Hkv}")
    if design(D, Dv) is None:
        raise ValueError(f"head dim {D} with v width {Dv} has no instance in the kernel")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: Optional[int] = None,
                         q_offset: int = 0, scale: Optional[float] = None) -> torch.Tensor:
    """Launch the kernel on the current stream: q (B, Hq, S, D), k (B, Hkv,
    T, D), v (B, Hkv, T, Dv), bf16, any strides with unit stride along the
    last dim (so (B, S, H, D) projections pass as permuted views). Returns
    (B, Hq, S, Dv) bf16 laid out as ``q`` is. Raises on inputs the kernel
    does not take (a (D, Dv) pair with no instance included) and on a
    refused launch."""
    return _launch(q, k, v, causal, window, q_offset, scale, None)


def tile_counts(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool = True, window: Optional[int] = None,
                q_offset: int = 0, scale: Optional[float] = None) -> dict:
    """One launch of the kernel that counts, on the device, the kv tiles it
    visits and those that take the per-element mask (per CTA for v1, which
    masks every tile, per warpgroup of 64 rows for v2). Returns
    ``dict(design, visited, masked)``."""
    tiles = torch.zeros(2, dtype=torch.int64, device=q.device)
    _launch(q, k, v, causal, window, q_offset, scale, tiles)
    visited, masked = tiles.tolist()
    return dict(design=design(q.shape[-1], v.shape[-1]), visited=visited, masked=masked)


def _launch(q, k, v, causal, window, q_offset, scale, tiles):
    _check(q, k, v, window)
    B, Hq, S, D = q.shape
    Hkv, T, Dv = k.shape[1], k.shape[2], v.shape[3]
    # (B, Hq, S, Dv) in q's order of dims (its layout when q is dense)
    order = sorted(range(3), key=lambda i: -q.stride(i)) + [3]
    out = q.new_empty([(B, Hq, S, Dv)[i] for i in order]).permute(
        *[order.index(i) for i in range(4)])
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    scale = scale if scale is not None else D ** -0.5
    fn = _load().flash_attention_bf16
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
                B, Hkv, S, T, Hq // Hkv, D, Dv, int(causal), window or 0, q_offset,
                float(scale), None if tiles is None else tiles.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {rc}")
    LAUNCHES.count += 1
    return out
