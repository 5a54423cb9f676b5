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
HEAD_DIMS = (16, 64, 80, 128, 256)     # the D the kernel is instantiated for
_fn = None


def _load():
    global _fn
    if _fn is None:
        fn = loader.load(SOURCE).flash_attention_bf16
        # q, k, v, out, strides; B, Hkv, S, T, G, D, causal, window, q_offset;
        # scale; stream
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


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
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    Hkv = k.shape[1]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"query heads {Hq} must be a multiple of kv heads {Hkv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in the kernel's instances {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: Optional[int] = None,
                         q_offset: int = 0, scale: Optional[float] = None) -> torch.Tensor:
    """Launch the kernel on the current stream: q (B, Hq, S, D), k, v (B, Hkv,
    T, D), bf16, any strides with unit stride along D (so (B, S, H, D)
    projections pass as permuted views). Returns (B, Hq, S, D) bf16 laid out
    as ``q`` is. Raises on inputs the kernel does not take and on a refused
    launch."""
    _check(q, k, v, window)
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    out = torch.empty_like(q)                # q's layout when q is dense, else contiguous
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    scale = scale if scale is not None else D ** -0.5
    fn = _load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
                B, Hkv, S, T, Hq // Hkv, D, int(causal), window or 0, q_offset,
                float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {rc}")
    LAUNCHES.count += 1
    return out
