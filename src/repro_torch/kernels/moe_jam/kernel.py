"""Load and launch the CUDA moe_jam expert-FFN kernels: the forward and its
gradient.

``csrc/moe_jam.cu`` and ``csrc/moe_jam_bwd.cu`` have plain C interfaces;
``kernels.loader`` builds each with ``nvcc`` at first use and loads it with
``ctypes``. One call of ``moe_jam_ffn_cuda`` launches its two passes
(gate/up into a bf16 ``h`` scratch, then down), each a persistent weight
stream (TMA into a 5-stage ring, wgmma), and counts once; one call of
``moe_jam_ffn_bwd_cuda`` launches the backward's three passes (h, dG, dU;
dx; the three weight gradients), each of persistent CTAs fed by TMA and
running wgmma, and counts once in ``BWD_LAUNCHES``. Both sources include
``csrc/moe_jam.cuh``. Nothing is built or loaded when this module is
imported.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import loader

SOURCE = Path(__file__).resolve().parent / "csrc" / "moe_jam.cu"
BWD_SOURCE = Path(__file__).resolve().parent / "csrc" / "moe_jam_bwd.cu"
LAUNCHES = loader.LaunchCounter()
BWD_LAUNCHES = loader.LaunchCounter()
ACTS = {"silu": 0, "gelu": 1}
TILE = 32                 # D and F must be multiples of it
DESIGN = "v2: persistent TMA weight stream, wgmma m64n128"
BWD_DESIGN = ("v2: three persistent TMA + wgmma passes, two consumer warpgroups on 128 rows "
              "(act: dH parked in shared memory, then G and U; dx; dw: all three gradients, "
              "stored by TMA)")
_fn = None
_bwd_fn = None


def _load():
    global _fn
    if _fn is None:
        fn = loader.load(SOURCE).moe_jam_bf16
        # x, w_gate, w_up, w_down, counts, h, out; E, C, D, F, act; stream
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _load_bwd():
    global _bwd_fn
    if _bwd_fn is None:
        fn = loader.load(BWD_SOURCE).moe_jam_bwd_bf16
        # x, w_gate, w_up, w_down, dy, counts, h, dg, du, dx, dw_gate, dw_up,
        # dw_down; E, C, D, F, act; stream
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def _check(x, w_gate, w_up, w_down, counts, act):
    tensors = dict(x=x, w_gate=w_gate, w_up=w_up, w_down=w_down)
    if counts is not None:
        tensors["counts"] = counts
    for name, t in tensors.items():
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for name in ("x", "w_gate", "w_up", "w_down"):
        if tensors[name].dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {tensors[name].dtype}")
    if x.dim() != 3:
        raise ValueError(f"want x (E, C, D), got {tuple(x.shape)}")
    E, C, D = x.shape
    F = w_gate.shape[-1] if w_gate.dim() == 3 else -1
    if (w_gate.shape != (E, D, F) or w_up.shape != (E, D, F)
            or w_down.shape != (E, F, D)):
        raise ValueError(f"weights {tuple(w_gate.shape)}, {tuple(w_up.shape)}, "
                         f"{tuple(w_down.shape)} do not fit x {tuple(x.shape)}")
    if min(E, C, D, F) <= 0 or D % TILE or F % TILE:
        raise ValueError(f"need E, C > 0 and D, F multiples of {TILE}, got "
                         f"E={E} C={C} D={D} F={F}")
    if counts is not None and (counts.dtype != torch.int32 or counts.shape != (E,)):
        raise ValueError(f"counts must be int32 (E,), got {counts.dtype} "
                         f"{tuple(counts.shape)}")
    if act not in ACTS:
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")


def moe_jam_ffn_cuda(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                     w_down: torch.Tensor, act: str = "silu", *,
                     counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel on the current stream. Returns (E, C, D) bf16, with
    zeros in the rows at or past ``counts``. Raises on inputs the kernel
    does not take and on a refused launch, and under grad:
    ``ops.moe_jam_ffn`` differentiates it through ``MoeJamFn``."""
    if loader.needs_grad(x, w_gate, w_up, w_down):
        raise NotImplementedError(
            "moe_jam_ffn_cuda returns an output autograd does not see; under grad "
            "call kernels.moe_jam.moe_jam_ffn, which runs MoeJamFn")
    _check(x, w_gate, w_up, w_down, counts, act)
    E, C, D = x.shape
    F = w_gate.shape[-1]
    h = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    fn = _load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
                counts.data_ptr() if counts is not None else None, h.data_ptr(),
                out.data_ptr(), E, C, D, F, ACTS[act], stream)
    if rc != 0:
        raise RuntimeError(f"moe_jam kernel launch failed: cudaError {rc}")
    LAUNCHES.count += 1
    return out


def moe_jam_ffn_bwd_cuda(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                         w_down: torch.Tensor, dy: torch.Tensor, act: str = "silu", *,
                         counts: Optional[torch.Tensor] = None):
    """The gradient of the forward given ``dy`` (E, C, D), the gradient of
    its output, on the current stream: ``(dx, dw_gate, dw_up, dw_down)``
    bf16, shaped as ``x`` and the weights, each element summed in float32
    by one thread (deterministic); rows of dx at or past ``counts`` are
    zeros and an expert with no kept row gets zero weight gradients
    (``ref.moe_jam_ffn_bwd_ref`` states the formula). Raises on inputs the
    kernel does not take and on a refused launch."""
    _check(x, w_gate, w_up, w_down, counts, act)
    if dy.device != x.device or dy.dtype != torch.bfloat16 or dy.shape != x.shape:
        raise ValueError(f"dy must be bf16 {tuple(x.shape)} on {x.device}, got {dy.dtype} "
                         f"{tuple(dy.shape)} on {dy.device}")
    if not dy.is_contiguous() or dy.data_ptr() % 16:
        raise ValueError("dy must be contiguous and 16-byte aligned")
    E, C, D = x.shape
    F = w_gate.shape[-1]
    h, dg, du = (torch.empty((E, C, F), dtype=x.dtype, device=x.device) for _ in range(3))
    dx = torch.empty_like(x)
    dw_gate, dw_up, dw_down = (torch.empty_like(w) for w in (w_gate, w_up, w_down))
    fn = _load_bwd()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
                dy.data_ptr(), counts.data_ptr() if counts is not None else None,
                h.data_ptr(), dg.data_ptr(), du.data_ptr(), dx.data_ptr(), dw_gate.data_ptr(),
                dw_up.data_ptr(), dw_down.data_ptr(), E, C, D, F, ACTS[act], stream)
    if rc != 0:
        raise RuntimeError(f"moe_jam backward kernel launch failed: cudaError {rc}")
    BWD_LAUNCHES.count += 1
    return dx, dw_gate, dw_up, dw_down
