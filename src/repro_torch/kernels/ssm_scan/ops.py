"""Public wrapper of the selective scan.

``ssm_scan`` has the signature of the plain version, plus ``kernel``:
``auto`` launches the CUDA kernel on CUDA tensors and takes the plain
version on CPU tensors; ``cuda`` on the CPU raises (``loader.resolve_kernel``,
the rule every kernel of the port follows). There is no fallback from one
to the other.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.loader import resolve_kernel
from repro_torch.kernels.ssm_scan.kernel import LAUNCHES, STATE_DIMS, ssm_scan_cuda
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref


def ssm_scan(dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor, x: torch.Tensor,
             a: torch.Tensor, h0: Optional[torch.Tensor] = None,
             n_valid: Optional[torch.Tensor] = None, *,
             kernel: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan gated to each row's valid prefix -> (y, h_last)."""
    fn = ssm_scan_cuda if resolve_kernel(kernel, x.device) == "cuda" else ssm_scan_ref
    return fn(dt, b, c, x, a, h0, n_valid)


def compare(y: torch.Tensor, h_last: torch.Tensor, y_ref: torch.Tensor,
            h_ref: torch.Tensor, n_valid: torch.Tensor, *, y_tol: float = 1e-2,
            h_tol: float = 1e-4):
    """Hold a scan's output against the plain version's.

    ``y`` on valid columns only (``t < n_valid``): each element within
    ``y_tol * (rms + |ref|)``, ``rms`` the root mean square of its (row,
    column) over the channels. Both round the same float32 sum, taken in
    other orders and with or without fused multiply-adds, to bf16, so an
    element may land on the neighbouring bf16 value, at most 2^-7 of
    ``|ref|``. ``h_last`` (float32) at every row within ``h_tol * (1 +
    |ref|)``; a row with ``n_valid == 0`` must equal ``h0`` exactly, which
    the caller checks. Returns ``(max |y - ref| on valid columns, max |h -
    ref|, largest share of the allowed error, elements over it)``; a
    non-finite element counts as over."""
    valid = torch.arange(y.shape[1], device=y.device)[None, :] < n_valid[:, None]
    a, r = y.float(), y_ref.float()
    err_y = (a - r).abs()
    allow_y = y_tol * (r.pow(2).mean(-1, keepdim=True).sqrt() + r.abs())
    err_h = (h_last - h_ref).abs()
    allow_h = h_tol * (1 + h_ref.abs())
    vy = valid[:, :, None].expand_as(err_y)
    bad = int((~(err_y <= allow_y) & vy).sum()) + int((~(err_h <= allow_h)).sum())
    share_y = torch.where(vy & (err_y > 0), err_y / allow_y.clamp_min(1e-30), 0.0)
    worst = max(float(share_y.max()), float((err_h / allow_h).max()))
    max_y = float(torch.where(vy, err_y, 0.0).max())
    return max_y, float(err_h.max()), worst, bad


__all__ = ["LAUNCHES", "STATE_DIMS", "compare", "ssm_scan", "ssm_scan_cuda", "ssm_scan_ref"]
