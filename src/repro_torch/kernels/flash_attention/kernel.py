"""Load and launch the CUDA flash-attention kernels: the forward and, for
training, its gradient.

``csrc/flash_attention.cu`` (the forward, which also writes each row's
log-sum-exp when asked) and ``csrc/flash_attention_bwd.cu`` (dq, dk, dv)
have plain C interfaces; ``kernels.loader`` builds each with ``nvcc`` at
first use and loads it with ``ctypes``. Nothing is built or loaded when
this module is imported. The outputs are written through raw pointers,
which autograd does not see: ``flash_attention_cuda`` refuses to run
under grad, and ``ops.FlashAttentionFn`` pairs the forward with its
backward.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import loader

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BWD_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention_bwd.cu"
LAUNCHES = loader.LaunchCounter()
BWD_LAUNCHES = loader.LaunchCounter()
# the C interface's design codes (flash_design)
DESIGN_NAMES = {2: "tma-wgmma v2"}
# the head widths (q, k and v of one width) the backward has instances for,
# and its design (both widths)
BWD_HEAD_DIMS = (64, 128)
BWD_DESIGN = "tma-wgmma v2"
_lib = None
_bwd_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = loader.load(SOURCE)
        # q, k, v, out, lse, strides; B, Hkv, S, T, G, D, Dv, causal, window,
        # q_offset; scale; tiles; stream
        lib.flash_attention_bf16.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 10
            + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
        lib.flash_attention_bf16.restype = ctypes.c_int
        for fn in (lib.flash_design, lib.flash_key_tile):
            fn.argtypes = [ctypes.c_int, ctypes.c_int]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _load_bwd():
    global _bwd_lib
    if _bwd_lib is None:
        lib = loader.load(BWD_SOURCE)
        # q, k, v, out, dout, lse, delta, dq, dk, dv, strides; B, Hkv, S, T,
        # G, D, causal, window, q_offset; scale; stream
        lib.flash_attention_bwd_bf16.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_attention_bwd_bf16.restype = ctypes.c_int
        _bwd_lib = lib
    return _bwd_lib


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
    refused launch, and under grad: ``ops.flash_attention`` differentiates
    it through ``FlashAttentionFn``."""
    if loader.needs_grad(q, k, v):
        raise NotImplementedError(
            "flash_attention_cuda returns an output autograd does not see; under grad "
            "call kernels.flash_attention.flash_attention, which runs FlashAttentionFn")
    return _launch(q, k, v, causal, window, q_offset, scale, None)[0]


def flash_attention_lse_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             causal: bool = True, window: Optional[int] = None,
                             q_offset: int = 0, scale: Optional[float] = None):
    """The forward as ``flash_attention_cuda`` (no grad check: the caller
    is ``FlashAttentionFn.forward``), also returning each row's
    log-sum-exp of its scaled scores, float32 (B, Hq, S): ``(out, lse)``."""
    B, Hq, S, _ = q.shape
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    return _launch(q, k, v, causal, window, q_offset, scale, None, lse)


def tile_counts(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool = True, window: Optional[int] = None,
                q_offset: int = 0, scale: Optional[float] = None) -> dict:
    """One launch of the kernel that counts, on the device, the kv tiles it
    visits and those that take the per-element mask, per warpgroup of 64
    rows. Returns ``dict(design, visited, masked)``."""
    tiles = torch.zeros(2, dtype=torch.int64, device=q.device)
    with torch.no_grad():
        _launch(q, k, v, causal, window, q_offset, scale, tiles)
    visited, masked = tiles.tolist()
    return dict(design=design(q.shape[-1], v.shape[-1]), visited=visited, masked=masked)


def _like(t: torch.Tensor, shape) -> torch.Tensor:
    """An empty tensor of ``shape`` (4-D) in ``t``'s order of the first
    three dims (its layout when ``t`` is dense, e.g. a (B, S, H, D)
    projection seen as (B, H, S, D)), dense along the last."""
    order = sorted(range(3), key=lambda i: -t.stride(i)) + [3]
    return t.new_empty([shape[i] for i in order]).permute(*[order.index(i) for i in range(4)])


def _launch(q, k, v, causal, window, q_offset, scale, tiles, lse=None):
    _check(q, k, v, window)
    B, Hq, S, D = q.shape
    Hkv, T, Dv = k.shape[1], k.shape[2], v.shape[3]
    out = _like(q, (B, Hq, S, Dv))
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    scale = scale if scale is not None else D ** -0.5
    fn = _load().flash_attention_bf16
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), strides,
                B, Hkv, S, T, Hq // Hkv, D, Dv, int(causal), window or 0, q_offset,
                float(scale), None if tiles is None else tiles.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {rc}")
    LAUNCHES.count += 1
    return out, lse


def _unit_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where the kernels take its layout (unit stride along
    D, other strides multiples of 8, 16-byte aligned), else a dense copy."""
    if t.stride(-1) == 1 and not any(s % 8 for s in t.stride()[:3]) and t.data_ptr() % 16 == 0:
        return t
    return t.contiguous()


def check_bwd_head_dim(q: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ``ValueError`` where the backward has no instance for the
    widths of q and v."""
    D, Dv = q.shape[-1], v.shape[-1]
    if D != Dv or D not in BWD_HEAD_DIMS:
        raise ValueError(
            f"flash attention's backward kernel has instances for q, k and v of one width "
            f"in {BWD_HEAD_DIMS}, got q/k {D} and v {Dv}: training at these widths on the "
            "card (MLA's (192, 128), hubert's 80, gemma's 256, the smokes' 16) comes in "
            "A13's later halves")


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True, window: Optional[int] = None,
                             q_offset: int = 0, scale: Optional[float] = None):
    """The gradient of the forward: q (B, Hq, S, D), k and v (B, Hkv, T,
    D), the forward's ``out`` and ``lse`` (``flash_attention_lse_cuda``)
    and ``dout``, the gradient of ``out``. Returns ``(dq, dk, dv)`` bf16,
    each laid out as its input is, summed in float32 by one thread each
    (deterministic). Raises on a width with no instance (``BWD_HEAD_DIMS``),
    on inputs the kernel does not take and on a refused launch."""
    check_bwd_head_dim(q, v)
    _check(q, k, v, window)
    dout = _unit_rows(dout)
    for name, t in dict(out=out, dout=dout).items():
        if t.dtype != torch.bfloat16 or t.shape != q.shape or t.device != q.device:
            raise ValueError(f"{name} must be bf16 {tuple(q.shape)} on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if lse.dtype != torch.float32 or lse.shape != q.shape[:3] or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32 {tuple(q.shape[:3])}")
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    dq, dk, dv = _like(q, q.shape), _like(k, k.shape), _like(v, v.shape)
    delta = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(
        *(s for t in (q, k, v, out, dout, dq, dk, dv) for s in t.stride()[:3]))
    scale = scale if scale is not None else D ** -0.5
    fn = _load_bwd().flash_attention_bwd_bf16
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), strides, B, Hkv, S, T, Hq // Hkv, D, int(causal), window or 0,
                q_offset, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed: cudaError {rc}")
    BWD_LAUNCHES.count += 1
    return dq, dk, dv
