"""Public wrapper of the selective scan.

``ssm_scan`` has the signature of the plain version, plus ``kernel``:
``auto`` launches the CUDA kernel on CUDA tensors and takes the plain
version on CPU tensors; ``cuda`` on the CPU raises (``loader.resolve_kernel``,
the rule every kernel of the port follows). There is no fallback from one
to the other.

Under grad (grad mode on and an input that requires it) the kernel route
runs ``SsmScanFn``: the forward kernel's training instance
(``ssm_scan_train_cuda``), which also saves the state entering every chunk of 32 columns, then the backward
kernel (``ssm_scan_bwd.cu``) from those states. The plain route is
differentiated by autograd through ``ssm_scan_ref``, which the CPU tests
hold ``ssm_scan_bwd_ref``, the backward kernel's yardstick, against.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.loader import needs_grad, resolve_kernel
from repro_torch.kernels.ssm_scan.kernel import (BWD_LAUNCHES, LAUNCHES, STATE_DIMS,
                                                 ssm_scan_bwd_cuda, ssm_scan_cuda,
                                                 ssm_scan_train_cuda)
from repro_torch.kernels.ssm_scan.ref import (ssm_scan_bwd_ref, ssm_scan_chunk_states,
                                              ssm_scan_ref)


class SsmScanFn(torch.autograd.Function):
    """The selective scan with a gradient: the forward kernel's training
    instance, keeping its inputs, ``n_valid`` and the chunk states, and
    the backward kernel for the gradients of dt, b, c, x, a and h0."""

    @staticmethod
    def forward(ctx, dt, b, c, x, a, h0, n_valid):
        y, h_last, states = ssm_scan_train_cuda(dt, b, c, x, a, h0, n_valid)
        ctx.save_for_backward(dt, b, c, x, a, n_valid, states)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        dt, b, c, x, a, n_valid, states = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        grads = ssm_scan_bwd_cuda(dt, b, c, x, a, states, dy, n_valid,
                                  None if dh_last is None else dh_last.contiguous())
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)), None)


def ssm_scan(dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor, x: torch.Tensor,
             a: torch.Tensor, h0: Optional[torch.Tensor] = None,
             n_valid: Optional[torch.Tensor] = None, *,
             kernel: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan gated to each row's valid prefix -> (y, h_last): the
    CUDA kernel (through ``SsmScanFn`` under grad) or its plain version."""
    if resolve_kernel(kernel, x.device) != "cuda":
        return ssm_scan_ref(dt, b, c, x, a, h0, n_valid)
    if needs_grad(dt, b, c, x, a, h0):
        return SsmScanFn.apply(dt, b, c, x, a, h0, n_valid)
    return ssm_scan_cuda(dt, b, c, x, a, h0, n_valid)


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


GRAD_NAMES = ("ddt", "db", "dc", "dx", "da", "dh0")
# the backward's tolerances (``compare_bwd``), which the card tests and
# chip_smoke.py hold it to
BWD_TOL, BWD_VS_PLAIN, BWD_F32_REL = 2e-2, 1.5, 1e-4


def compare_bwd(got, plain, f32, n_valid: Optional[torch.Tensor] = None):
    """Hold the backward's gradients ``got`` (ddt, db, dc, dx, da, dh0)
    against the plain version on the same inputs (``plain``) and on them
    cast to float32 (``f32``).

    Each gradient: max |got - plain| within ``BWD_TOL`` x max |plain| (a
    bf16 output of the same float32 sum in another order lands on the
    neighbouring bf16 value at most, 2^-7 of it), and its relative L2
    error against float32 within ``BWD_VS_PLAIN`` x the plain bf16 path's
    for the bf16 outputs (both round the same sums to bf16) and within
    ``BWD_F32_REL`` for da and dh0: the plain path computes those in
    float32 from the same values, so its error there is 0, and the
    kernel's ex2.approx (2^-22 relative an exponential) and its order of
    sums leave ~1e-6. A gradient that is zero in float32 must be exact zeros;
    so must ddt, dx, db and dc at columns ``>= n_valid``. Returns
    (``{name: stats}``, the names that fail)."""
    stats, bad = {}, []
    gated = None
    if n_valid is not None:
        gated = torch.arange(got[0].shape[1], device=got[0].device)[None, :] >= n_valid[:, None]
    for name, k, p_, f in zip(GRAD_NAMES, got, plain, f32):
        kf, pf = k.float(), p_.float()
        ref_max, ref_norm = float(pf.abs().max()), float(f.norm())
        e_k = float((kf - f).norm()) / ref_norm if ref_norm else float((kf != 0).any())
        e_p = float((pf - f).norm()) / ref_norm if ref_norm else 0.0
        st = dict(max_abs_err=float((kf - pf).abs().max()), max_abs=ref_max, l2_kernel=e_k,
                  l2_plain=e_p, finite=bool(torch.isfinite(kf).all()), gated_nonzero=0)
        if gated is not None and name in ("ddt", "db", "dc", "dx"):
            st["gated_nonzero"] = int((kf[gated] != 0).sum())
        limit = BWD_VS_PLAIN * e_p if k.dtype != torch.float32 else BWD_F32_REL
        if (not st["finite"] or not st["max_abs_err"] <= BWD_TOL * ref_max or st["gated_nonzero"]
                or not (e_k <= limit if ref_norm else e_k == 0)):
            bad.append(name)
        stats[name] = st
    return stats, bad


__all__ = ["BWD_F32_REL", "BWD_LAUNCHES", "BWD_TOL", "BWD_VS_PLAIN", "LAUNCHES", "STATE_DIMS",
           "SsmScanFn", "compare", "compare_bwd", "ssm_scan", "ssm_scan_bwd_cuda",
           "ssm_scan_bwd_ref", "ssm_scan_chunk_states", "ssm_scan_cuda", "ssm_scan_ref",
           "ssm_scan_train_cuda"]
