"""Public wrapper of the moe_jam expert FFN.

``moe_jam_ffn`` has the signature of the plain version, plus ``kernel``:
``auto`` launches the CUDA kernel on CUDA tensors and takes the plain
version on CPU tensors; ``cuda`` on the CPU raises (``loader.resolve_kernel``,
the rule every kernel of the port follows). There is no fallback from one
to the other.

Under grad (grad mode on and an input that requires it) the kernel route
runs ``MoeJamFn``: the forward kernel, then the backward kernel
(``moe_jam_bwd.cu``) for dx and the three weight gradients. The plain
route is differentiated by autograd through ``moe_jam_ffn_ref``, which the
CPU tests hold ``moe_jam_ffn_bwd_ref``, the backward kernel's yardstick,
against.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.loader import needs_grad, resolve_kernel
from repro_torch.kernels.moe_jam.kernel import (BWD_LAUNCHES, LAUNCHES, moe_jam_ffn_bwd_cuda,
                                                moe_jam_ffn_cuda)
from repro_torch.kernels.moe_jam.ref import moe_jam_ffn_bwd_ref, moe_jam_ffn_ref


class MoeJamFn(torch.autograd.Function):
    """The expert FFN with a gradient: the forward kernel, keeping its
    inputs and ``counts``, and the backward kernel for dx and the weight
    gradients."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up, w_down, act, counts):
        out = moe_jam_ffn_cuda(x, w_gate, w_up, w_down, act, counts=counts)
        ctx.save_for_backward(x, w_gate, w_up, w_down, counts)
        ctx.act = act
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w_gate, w_up, w_down, counts = ctx.saved_tensors
        grads = moe_jam_ffn_bwd_cuda(x, w_gate, w_up, w_down, dy.contiguous(), ctx.act,
                                     counts=counts)
        return (*grads, None, None)


def moe_jam_ffn(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor, act: str = "silu", *,
                counts: Optional[torch.Tensor] = None,
                kernel: str = "auto") -> torch.Tensor:
    """(E, C, D) buckets through each expert's gated FFN -> (E, C, D): the
    CUDA kernel (through ``MoeJamFn`` under grad) or its plain version."""
    if resolve_kernel(kernel, x.device) != "cuda":
        return moe_jam_ffn_ref(x, w_gate, w_up, w_down, act, counts=counts)
    if needs_grad(x, w_gate, w_up, w_down):
        return MoeJamFn.apply(x, w_gate, w_up, w_down, act, counts)
    return moe_jam_ffn_cuda(x, w_gate, w_up, w_down, act, counts=counts)


def compare(out: torch.Tensor, ref: torch.Tensor, *, tol: float = 1e-2):
    """Hold ``out`` against ``ref`` (both (E, C, D)): each element may
    differ by ``tol * (rms + |ref|)``, where ``rms`` is the root mean square
    of its (expert, row) row of ``ref``. Both round ``h`` and the output to
    bf16 after float32 sums of the same products in other orders, so an
    output may land on the neighbouring bf16 value, at most 2^-7 of
    ``|ref|``; an empty row (rms 0) must match exactly. Returns ``(max
    |out - ref|, max |out - ref| / allowed, elements over the limit)``; a
    non-finite element counts as over."""
    a, b = out.float(), ref.float()
    err = (a - b).abs()
    allowed = tol * (b.pow(2).mean(-1, keepdim=True).sqrt() + b.abs())
    bad = int((~(err <= allowed)).sum())
    worst = float(torch.where(err == 0, 0.0, err / allowed.clamp_min(1e-30)).max())
    return float(err.max()), worst, bad


__all__ = ["BWD_LAUNCHES", "LAUNCHES", "MoeJamFn", "compare", "moe_jam_ffn",
           "moe_jam_ffn_bwd_cuda", "moe_jam_ffn_bwd_ref", "moe_jam_ffn_cuda", "moe_jam_ffn_ref"]
