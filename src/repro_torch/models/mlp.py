"""Dense FFN: gated (SwiGLU-style) and classic 2-matrix MLP."""
from __future__ import annotations

import torch

from repro_torch.models.common import ParamBuilder, act_fn


def init_mlp(b: ParamBuilder, d_model: int, d_ff: int, gated: bool = True) -> None:
    if gated:
        b.param("w_gate", (d_model, d_ff))
    b.param("w_up", (d_model, d_ff))
    b.param("w_down", (d_ff, d_model))


def mlp(params, x: torch.Tensor, act: str = "silu", gated: bool = True) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d); weights in the JAX layouts (d, f)/(f, d)."""
    up = x @ params["w_up"]
    if gated:
        h = act_fn(act)(x @ params["w_gate"]) * up
    else:
        h = act_fn(act)(up)
    return h @ params["w_down"]
