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

Each column is the affine map ``h -> exp(dt_t a) h + (dt_t x_t) b_t`` (an
invalid column the identity ``(1, 0)``). ``ssm_scan_ref`` takes the state
after every column at once, as the composition of the maps up to it, by a
Hillis-Steele prefix scan in ceil(log2 S) passes between two buffers, a
block of channels at a time (at most ``BLOCK_ELEMS`` float32 elements a
buffer), so a prefill of thousands of tokens launches a few hundred
operations a layer, not several a column. ``ssm_scan_loop`` is the same
recurrence a column at a time, as written above; the two round in other
orders (relative differences of a few float32 ulps).

Under grad (grad mode on and an input that requires it) the passes build
new tensors, which autograd can differentiate; serving, under
``no_grad``, keeps the two buffers and their in-place updates.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.loader import needs_grad

# float32 elements in one of the prefix scan's four (B, S, channels, N)
# buffers: 64 MB each
BLOCK_ELEMS = 1 << 24


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
    grad = needs_grad(dt, b, c, x, a, h0)
    y = torch.empty((B, S, I), dtype=torch.float32, device=x.device)
    h_last = torch.empty((B, I, N), dtype=torch.float32, device=x.device)
    invalid = None
    if n_valid is not None:
        invalid = (torch.arange(S, device=x.device)[None, :] >= n_valid[:, None])[..., None, None]
    b_f, c_f = b.float()[:, :, None, :], c.float()
    width = max(1, BLOCK_ELEMS // (B * S * N))
    for i0 in range(0, I, width):
        ch = slice(i0, i0 + width)
        dt_f = dt[:, :, ch].float()
        decay = torch.exp(dt_f[..., None] * a[ch].float())              # (B, S, w, N)
        inp = (dt_f * x[:, :, ch].float())[..., None] * b_f
        if grad:
            if invalid is not None:
                decay = decay.masked_fill(invalid, 1.0)
                inp = inp.masked_fill(invalid, 0.0)
            # inclusive prefix composition: column t's map after the one
            # ending at t - d
            d = 1
            while d < S:
                step = torch.addcmul(inp[:, d:], decay[:, d:], inp[:, :-d])
                inp = torch.cat([inp[:, :d], step], 1)
                decay = torch.cat([decay[:, :d], decay[:, d:] * decay[:, :-d]], 1)
                d *= 2
            if h0 is not None:
                inp = torch.addcmul(inp, decay, h0[:, None, ch].float())
        else:
            if invalid is not None:
                decay.masked_fill_(invalid, 1.0)
                inp.masked_fill_(invalid, 0.0)
            # the same passes between two buffers (a pass reads what it
            # replaces)
            inp2, decay2 = torch.empty_like(inp), torch.empty_like(decay)
            d = 1
            while d < S:
                inp2[:, :d] = inp[:, :d]
                torch.addcmul(inp[:, d:], decay[:, d:], inp[:, :-d], out=inp2[:, d:])
                decay2[:, :d] = decay[:, :d]
                torch.mul(decay[:, d:], decay[:, :-d], out=decay2[:, d:])
                inp, inp2, decay, decay2 = inp2, inp, decay2, decay
                d *= 2
            del inp2, decay2
            if h0 is not None:
                inp.addcmul_(decay, h0[:, None, ch].float())
        y[:, :, ch] = torch.einsum("bsin,bsn->bsi", inp, c_f)
        h_last[:, ch] = inp[:, -1]
        del inp, decay
    if invalid is not None:
        y.masked_fill_(invalid[..., 0], 0.0)
    return y.to(x.dtype), h_last


def ssm_scan_loop(dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                  x: torch.Tensor, a: torch.Tensor,
                  h0: Optional[torch.Tensor] = None,
                  n_valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ssm_scan_ref``'s function a column at a time, as the recurrence
    is written above: a yardstick for the prefix scan's rounding and
    time."""
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
