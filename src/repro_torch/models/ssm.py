"""Mamba-style selective SSM block (the port of ``repro/models/ssm.py``).

``ssm_forward`` runs the block over a chunk of tokens from a carried
``(conv, state)`` cache: in projection, depthwise causal conv, the
selective scan (the ``ssm_scan`` kernel), the ``d_skip`` and ``silu(z)``
gate, out projection. With ``valid`` (a valid prefix per row, the serving
layout) the conv history and the state advance over each row's real
tokens only, so a row's result is what it would be with its tokens alone.
Parameters keep the JAX layouts and are cast by the caller; the rounding
points are the JAX function's.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.models.common import ParamBuilder


def dt_rank(d_model: int, s: SSMConfig) -> int:
    return s.dt_rank or -(-d_model // 16)


def init_ssm(b: ParamBuilder, d_model: int, s: SSMConfig) -> None:
    inner = s.expand * d_model
    r = dt_rank(d_model, s)
    b.param("in_proj", (d_model, 2 * inner))
    b.param("conv_w", (s.conv_width, inner))
    b.param("conv_b", (inner,), init="zeros")
    b.param("x_proj", (inner, r + 2 * s.state_dim))
    b.param("dt_proj", (r, inner), fan_in=r)
    b.param("dt_bias", (inner,), init="zeros")
    b.param("a_log", (inner, s.state_dim), init="ones")
    b.param("d_skip", (inner,), init="ones")
    b.param("out_proj", (inner, d_model), fan_in=inner)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 history: Optional[torch.Tensor] = None,
                 n_valid: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x (B, S, C); w (W, C). Returns (out,
    new_history (B, W-1, C)).

    With ``n_valid`` (B,) row b's real tokens are columns ``[0,
    n_valid[b])`` and its new history is the last W-1 of (history ++ those
    tokens), not the tail of the padded chunk."""
    width = w.shape[0]
    if history is None:
        history = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype,
                              device=x.device)
    xp = torch.cat([history, x], dim=1)                      # (B, S+W-1, C)
    S = x.shape[1]
    out = sum(xp[:, i:i + S, :] * w[i] for i in range(width)) + b
    if n_valid is None:
        new_hist = xp[:, xp.shape[1] - (width - 1):, :]
    else:
        idx = (n_valid.long()[:, None]
               + torch.arange(width - 1, device=x.device)[None, :])
        new_hist = torch.gather(xp, 1, idx[:, :, None].expand(-1, -1, xp.shape[2]))
    return out, new_hist


def ssm_forward(params: Dict[str, torch.Tensor], x: torch.Tensor, s: SSMConfig, *,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                valid: Optional[torch.Tensor] = None,
                kernel: str = "auto"
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x (B, S, d) -> (B, S, d), and the new ``{"conv", "state"}`` cache
    when ``cache`` is given (its conv history kept in the cache's dtype,
    the state float32).

    ``valid`` (B, S) bool must be a valid prefix per row (the serving
    layout): the scan and the conv history advance only over real columns.
    ``kernel`` selects the scan: ``auto``, ``cuda`` or ``ref``."""
    B, S, d = x.shape
    inner = s.expand * d
    r = dt_rank(d, s)

    xz = x @ params["in_proj"]
    x_in, z = xz[..., :inner], xz[..., inner:]
    hist = cache["conv"] if cache is not None else None
    n_valid = valid.sum(dim=1).to(torch.int32) if valid is not None else None
    x_c, new_hist = _causal_conv(x_in, params["conv_w"], params["conv_b"], hist,
                                 n_valid=n_valid)
    x_c = F.silu(x_c)

    proj = x_c @ params["x_proj"]
    dt_in = proj[..., :r]
    b_in = proj[..., r:r + s.state_dim].contiguous()                  # (B, S, N)
    c_in = proj[..., r + s.state_dim:].contiguous()                   # (B, S, N)
    dt = F.softplus(dt_in @ params["dt_proj"] + params["dt_bias"])    # (B, S, I)
    # from the parameter after the caller's cast to the compute dtype
    a = -torch.exp(params["a_log"].float())                          # (I, N)

    h0 = cache["state"] if cache is not None else None
    y, h_last = ssm_scan(dt, b_in, c_in, x_c, a, h0, n_valid, kernel=kernel)
    y = y.to(x.dtype)
    y = y + x_c * params["d_skip"]
    y = y * F.silu(z)
    out = y @ params["out_proj"]

    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_hist.to(cache["conv"].dtype), "state": h_last}
    return out, new_cache


def ssm_init_cache(d_model: int, s: SSMConfig, batch: int, dtype=torch.bfloat16,
                   device=None) -> Dict[str, torch.Tensor]:
    """Zero conv history (B, W-1, inner) in ``dtype``; zero state
    (B, inner, N) in float32."""
    inner = s.expand * d_model
    return {
        "conv": torch.zeros((batch, s.conv_width - 1, inner), dtype=dtype, device=device),
        "state": torch.zeros((batch, inner, s.state_dim), dtype=torch.float32,
                             device=device),
    }
