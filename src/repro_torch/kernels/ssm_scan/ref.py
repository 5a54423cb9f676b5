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

``ssm_scan_chunk_states`` is the plain version of the training forward's
extra output, the state entering each chunk of ``CHUNK`` columns, and
``ssm_scan_bwd_ref`` the plain version of the backward kernel: the
reverse recurrence written out (see its docstring), a column at a time,
from those states. They are the CUDA kernels' yardsticks (the tests and
``chip_smoke.py``); the CPU path differentiates ``ssm_scan_ref`` by
autograd instead.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.loader import needs_grad

# float32 elements in one of the prefix scan's four (B, S, channels, N)
# buffers, and in one of the backward's (B, CHUNK, channels, N) chunk
# buffers: 64 MB each, so every channel of a training micro-batch (2 rows,
# up to 3,200 channels at N 16: 13 MB) goes in one backward block
BLOCK_ELEMS = 1 << 24
# columns between two saved states (the kernels' kChunk)
CHUNK = 32


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


def ssm_scan_chunk_states(dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                          x: torch.Tensor, a: torch.Tensor,
                          h0: Optional[torch.Tensor] = None,
                          n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The state entering each chunk of ``CHUNK`` columns, (B, ceil(S /
    CHUNK), I, N) float32: ``h0`` (zeros if None) for the first, then
    ``ssm_scan_ref``'s ``h_last`` over each chunk from the one before (a
    chunk at or past ``n_valid`` passes its state through)."""
    B, S, I = x.shape
    N = b.shape[-1]
    h = (torch.zeros((B, I, N), dtype=torch.float32, device=x.device) if h0 is None
         else h0.float())
    out = []
    for t0 in range(0, S, CHUNK):
        out.append(h)
        cols = slice(t0, t0 + CHUNK)
        nv = None if n_valid is None else (n_valid.long() - t0).clamp(0, CHUNK)
        h = ssm_scan_ref(dt[:, cols], b[:, cols], c[:, cols], x[:, cols], a, h, nv)[1]
    return torch.stack(out, dim=1)


def ssm_scan_bwd_ref(dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                     x: torch.Tensor, a: torch.Tensor, dy: torch.Tensor,
                     h0: Optional[torch.Tensor] = None,
                     n_valid: Optional[torch.Tensor] = None,
                     dh_last: Optional[torch.Tensor] = None, *,
                     states: Optional[torch.Tensor] = None):
    """The gradient of ``ssm_scan_ref`` given ``dy`` (B, S, I), the gradient
    of ``y``, and ``dh_last`` (B, I, N), that of ``h_last`` (None: zero).

    For each row and channel, with ``da_t = exp(dt_t a)`` and ``g`` the
    gradient of the state, carried backwards from ``dh_last``:

        g     += dy_t c_t
        dc_t  += h_t dy_t                    (summed over channels)
        s      = sum_n g b_t
        dx_t   = dt_t s
        ddt_t  = x_t s + sum_n g h_{t-1} a da_t
        db_t  += g dt_t x_t                  (summed over channels)
        da    += g h_{t-1} dt_t da_t         (summed over columns and rows)
        g     *= da_t

    and ``dh0 = g`` at the end; a column ``t >= n_valid`` passes ``g``
    through and has zero gradients. In float32, the chunks of ``CHUNK``
    columns last to first, a block of channels at a time: each chunk's
    states recomputed from its start state (``states``, the training
    forward's; ``ssm_scan_chunk_states`` where None), a column at a time,
    then ``g`` a column at a time backwards; the sums over a chunk's
    columns at once. Returns ``(ddt, db, dc, dx, da, dh0)`` in the
    inputs' order: ddt, db, dc, dx in the dtypes of dt, b, c, x; da (I, N)
    and dh0 (B, I, N) float32."""
    B, S, I = x.shape
    N = b.shape[-1]
    dev, f32 = x.device, torch.float32
    if states is None:
        states = ssm_scan_chunk_states(dt, b, c, x, a, h0, n_valid)
    valid = torch.ones((B, S), dtype=torch.bool, device=dev)
    if n_valid is not None:
        valid = torch.arange(S, device=dev)[None, :] < n_valid[:, None]
    vf = valid.to(f32)[:, :, None]
    # dt and dy zero at gated columns: their decay is 1, their input 0, and
    # every product with dt or dy vanishes
    dt_all, dy_all = dt.float() * vf, dy.float() * vf
    x_all, b_all, c_all = x.float(), b.float(), c.float()
    ddt = torch.empty((B, S, I), dtype=f32, device=dev)
    dx = torch.empty_like(ddt)
    db = torch.zeros((B, S, N), dtype=f32, device=dev)
    dc = torch.zeros_like(db)
    da = torch.empty((I, N), dtype=f32, device=dev)
    dh0 = torch.empty((B, I, N), dtype=f32, device=dev)
    width = max(1, BLOCK_ELEMS // (B * CHUNK * N))
    for i0 in range(0, I, width):
        ch = slice(i0, i0 + width)
        af = a[ch].float()
        g = (torch.zeros((B, af.shape[0], N), dtype=f32, device=dev) if dh_last is None
             else dh_last[:, ch].float())
        da_blk = torch.zeros_like(af)
        for k in reversed(range(states.shape[1])):
            cols = slice(k * CHUNK, min(S, (k + 1) * CHUNK))
            dtk, xk, dyk = dt_all[:, cols, ch], x_all[:, cols, ch], dy_all[:, cols, ch]
            bk, ck = b_all[:, cols, None, :], c_all[:, cols, None, :]
            decay = torch.exp(dtk[..., None] * af)                  # (B, L, w, N)
            inp = (dtk * xk)[..., None] * bk
            L = decay.shape[1]
            hs = torch.empty((B, L + 1) + g.shape[1:], dtype=f32, device=dev)
            hs[:, 0] = states[:, k, ch]
            for j in range(L):                                      # h_j from h_{j-1}
                torch.addcmul(inp[:, j], decay[:, j], hs[:, j], out=hs[:, j + 1])
            gs = torch.empty_like(decay)
            dyc = dyk[..., None] * ck
            for j in reversed(range(L)):                            # g of h_j, then of h_{j-1}
                torch.add(g, dyc[:, j], out=gs[:, j])
                g = gs[:, j] * decay[:, j]
            s = (gs * bk).sum(-1)                                   # (B, L, w)
            w = gs * hs[:, :-1] * decay
            ddt[:, cols, ch] = xk * s + (w * af).sum(-1)
            dx[:, cols, ch] = dtk * s
            db[:, cols] += torch.einsum("blin,bli->bln", gs, dtk * xk)
            dc[:, cols] += torch.einsum("blin,bli->bln", hs[:, 1:], dyk)
            da_blk += torch.einsum("blin,bli->in", w, dtk)
        da[ch] = da_blk
        dh0[:, ch] = g
    ddt.mul_(vf)
    return (ddt.to(dt.dtype), db.to(b.dtype), dc.to(c.dtype), dx.to(x.dtype), da, dh0)
