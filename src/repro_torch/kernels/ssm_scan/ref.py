"""Plain PyTorch version of the selective scan, gated per row.

The port of ``repro/kernels/ssm_scan/ref.py::selective_scan_ref`` with the
``valid`` gate of ``repro/models/ssm.py::ssm_forward`` folded in as a
valid-prefix length per row:

    h_t = exp(dt_t * a) * h_{t-1} + (dt_t * x_t) b_t      for t < n_valid[b]
    y_t = h_t . c_t

State and arithmetic in float32. ``h_last`` is the state after column
``n_valid[b] - 1`` (``h0`` itself where ``n_valid[b] == 0``); ``y`` is
``x.dtype`` and zero at the columns ``t >= n_valid[b]``, which are garbage
by contract and which the CUDA kernel writes as zeros. The CPU path uses
this version, and ``chip_smoke.py`` holds the kernel against it on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssm_scan_ref(dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                 x: torch.Tensor, a: torch.Tensor,
                 h0: Optional[torch.Tensor] = None,
                 n_valid: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt/x (B, S, I); b/c (B, S, N); a (I, N); h0 (B, I, N) f32 or None
    (zeros); n_valid (B,) int or None (every column valid).

    Returns (y (B, S, I) in x.dtype, h_last (B, I, N) f32)."""
    B, S, I = x.shape
    N = b.shape[-1]
    h = (torch.zeros((B, I, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    a = a.float()
    ys = []
    for t in range(S):
        dt_t = dt[:, t].float()                                   # (B, I)
        da = torch.exp(dt_t[:, :, None] * a[None])                # (B, I, N)
        dbx = (dt_t * x[:, t].float())[:, :, None] * b[:, t].float()[:, None, :]
        h_up = da * h + dbx
        if n_valid is not None:
            h_up = torch.where((t < n_valid)[:, None, None], h_up, h)
        h = h_up
        ys.append(torch.einsum("bin,bn->bi", h, c[:, t].float()))
    y = torch.stack(ys, dim=1)
    if n_valid is not None:
        valid = torch.arange(S, device=x.device)[None, :] < n_valid[:, None]
        y = torch.where(valid[:, :, None], y, 0.0)
    return y.to(x.dtype), h
