"""Shared model primitives: norms, soft-cap, activations, parameter builder.

Parameters are plain nested dicts of tensors, in the JAX package's layouts
(``repro/models/common.py``), so weights convert between the two packages
without transposition (``repro_torch.bridge``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32, scaled by ``1 + scale`` (the JAX package's
    convention; HF Llama scales by ``scale`` alone)."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return x
    return torch.tanh(x / cap) * cap


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


class ParamBuilder:
    """Draws parameters into a nested dict under name scopes.

    ``param`` uses the shapes and standard deviations of the JAX package's
    ``ParamBuilder.param``: normal(0, 1/sqrt(fan_in)) with ``fan_in`` the
    first dim (the last for vectors), or zeros, or ones. Values come from one
    ``torch.Generator``; they are not the JAX package's random bits.
    """

    def __init__(self, generator: torch.Generator, device: torch.device,
                 dtype: torch.dtype = torch.float32):
        self.generator = generator
        self.device = device
        self.dtype = dtype
        self.params: Dict[str, Any] = {}

    def scope(self, name: str) -> "ParamBuilder":
        child = ParamBuilder(self.generator, self.device, self.dtype)
        self.params[name] = child.params
        return child

    def param(self, name: str, shape: Tuple[int, ...], init: str = "normal",
              fan_in: Optional[int] = None) -> torch.Tensor:
        if self.device.type == "meta":       # shapes and dtypes alone
            val = torch.empty(shape, dtype=self.dtype, device=self.device)
        elif init == "zeros":
            val = torch.zeros(shape, dtype=self.dtype, device=self.device)
        elif init == "ones":
            val = torch.ones(shape, dtype=self.dtype, device=self.device)
        else:
            fi = fan_in if fan_in is not None else (shape[0] if len(shape) > 1 else shape[-1])
            std = 1.0 / math.sqrt(max(1, fi))
            val = torch.randn(shape, generator=self.generator, dtype=torch.float32,
                              device=self.device).mul_(std).to(self.dtype)
        self.params[name] = val
        return val
