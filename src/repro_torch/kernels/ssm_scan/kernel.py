"""Load and launch the CUDA selective-scan kernel.

``csrc/ssm_scan.cu`` has a plain C interface; ``kernels.loader`` builds it
with ``nvcc`` at first use and loads it with ``ctypes``. Nothing is built
or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import loader

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssm_scan.cu"
LAUNCHES = loader.LaunchCounter()
STATE_DIMS = (4, 8, 16)          # the N the kernel is instantiated for
DESIGN = ("v2: N/4 lanes a channel pair, longest rows first, 8-step stages in a 4-slot "
          "ring, ex2.approx")
ROUTES = ("direct", "tma")       # the C interface's route codes, in order
_fn = None


def _load():
    global _fn
    if _fn is None:
        fn = loader.load(SOURCE).ssm_scan_bf16
        # dt, x, b, c, a, h0, n_valid, y, h_last; B, S, I, N, route; stream
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(dt, b, c, x, a, h0, n_valid):
    tensors = dict(dt=dt, b=b, c=c, x=x, a=a, h0=h0, n_valid=n_valid)
    for name, t in tensors.items():
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("dt", "b", "c", "x"):
        if tensors[name].dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {tensors[name].dtype}")
    for name in ("a", "h0"):
        if tensors[name].dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {tensors[name].dtype}")
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (it moves as float4)")
    if n_valid.dtype != torch.int32:
        raise ValueError(f"n_valid must be int32, got {n_valid.dtype}")
    if x.dim() != 3 or b.dim() != 3:
        raise ValueError(f"want x (B, S, I) and b (B, S, N), got {tuple(x.shape)}, "
                         f"{tuple(b.shape)}")
    B, S, I = x.shape
    N = b.shape[-1]
    if (dt.shape != x.shape or b.shape != (B, S, N) or c.shape != (B, S, N)
            or a.shape != (I, N) or h0.shape != (B, I, N) or n_valid.shape != (B,)):
        raise ValueError(f"dt {tuple(dt.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)}, "
                         f"a {tuple(a.shape)}, h0 {tuple(h0.shape)}, n_valid "
                         f"{tuple(n_valid.shape)} do not fit x {tuple(x.shape)}")
    if min(B, S, I) <= 0 or N not in STATE_DIMS:
        raise ValueError(f"need B, S, I > 0 and N in {STATE_DIMS}, got B={B} S={S} "
                         f"I={I} N={N}")
    if B > 65535:
        raise ValueError(f"at most 65535 rows (the grid's y), got B={B}")


def scan_route(dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor, x: torch.Tensor) -> str:
    """The route the kernel takes for these inputs: ``tma`` where its TMA
    maps can take them (N 8 or 16, so a step of b is a multiple of 16
    bytes; I a multiple of 8, so a step of dt and x is; dt, x, b and c on
    16-byte boundaries), else ``direct`` (the CTA's threads load each
    stage themselves)."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (dt, x, b, c))
    return "tma" if b.shape[-1] in (8, 16) and x.shape[-1] % 8 == 0 and aligned else "direct"


def ssm_scan_cuda(dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                  x: torch.Tensor, a: torch.Tensor,
                  h0: Optional[torch.Tensor] = None,
                  n_valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream. Returns (y (B, S, I) bf16,
    zero at columns ``>= n_valid``; h_last (B, I, N) f32). ``h0`` None is
    zeros, ``n_valid`` None every column. Raises on inputs the kernel does
    not take and on a refused launch, and under grad (its backward is
    A13's third half)."""
    loader.refuse_grad("ssm_scan", "SSM and hybrid training on the card is A13's "
                       "third half", dt, b, c, x, a, h0)
    B, S, I = x.shape
    N = b.shape[-1]
    if h0 is None:
        h0 = torch.zeros((B, I, N), dtype=torch.float32, device=x.device)
    if n_valid is None:
        n_valid = torch.full((B,), S, dtype=torch.int32, device=x.device)
    _check(dt, b, c, x, a, h0, n_valid)
    y = torch.empty_like(x)
    h_last = torch.empty_like(h0)
    fn = _load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(dt.data_ptr(), x.data_ptr(), b.data_ptr(), c.data_ptr(), a.data_ptr(),
                h0.data_ptr(), n_valid.data_ptr(), y.data_ptr(), h_last.data_ptr(),
                B, S, I, N, ROUTES.index(scan_route(dt, b, c, x)), stream)
    if rc != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: cudaError {rc}")
    LAUNCHES.count += 1
    return y, h_last
