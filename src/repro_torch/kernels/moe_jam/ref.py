"""Plain PyTorch versions of the moe_jam expert FFN and of its gradient.

The port of ``repro/kernels/moe_jam/ref.py::expert_ffn_ref``: the gate and
up products accumulate in float32, ``h = act(g) * u`` is rounded to
``x.dtype`` once, the down product accumulates in float32 and the output
is ``x.dtype``. The CPU path uses it, and ``chip_smoke.py`` holds the CUDA
kernel against it on the card.

One addition: ``counts`` (E,) marks how many capacity rows of each expert
hold a token (the dispatch fills rows 0, 1, ... in order); output rows at
or past it are zeros, as the kernel writes them. On a bucket whose empty
rows are zero, as the dispatch builds it, that is what the function gives
there anyway.

``moe_jam_ffn_bwd_ref`` states the formula of the backward kernel
(``csrc/moe_jam_bwd.cu``) and is its yardstick on the card: on the CPU,
autograd differentiates ``moe_jam_ffn_ref`` instead, and the tests hold the
two together.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.common import act_fn

_GELU_K0, _GELU_K1 = 0.7978845608028654, 0.044715     # sqrt(2 / pi); the tanh form's cubic


def moe_jam_ffn_ref(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                    w_down: torch.Tensor, act: str = "silu", *,
                    counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (E, C, D); w_gate/w_up (E, D, F); w_down (E, F, D) -> (E, C, D)."""
    xf = x.float()
    g = torch.bmm(xf, w_gate.float())
    u = torch.bmm(xf, w_up.float())
    h = (act_fn(act)(g) * u).to(x.dtype)
    y = torch.bmm(h.float(), w_down.float()).to(x.dtype)
    if counts is not None:
        rows = torch.arange(x.shape[1], device=x.device)
        y = y * (rows[None, :] < counts[:, None]).to(y.dtype)[:, :, None]
    return y


def _act_and_grad(g: torch.Tensor, act: str):
    """(act(g), act'(g)) in g's dtype: silu, or gelu in its tanh form."""
    if act == "silu":
        s = torch.sigmoid(g)
        return g * s, s * (1 + g * (1 - s))
    if act == "gelu":
        t = torch.tanh(_GELU_K0 * (g + _GELU_K1 * g ** 3))
        return (0.5 * g * (1 + t),
                0.5 * (1 + t) + 0.5 * g * (1 - t * t) * _GELU_K0 * (1 + 3 * _GELU_K1 * g * g))
    raise ValueError(f"act must be 'silu' or 'gelu', got {act!r}")


def moe_jam_ffn_bwd_ref(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                        w_down: torch.Tensor, dy: torch.Tensor, act: str = "silu", *,
                        counts: Optional[torch.Tensor] = None):
    """The gradient of ``moe_jam_ffn_ref`` given ``dy`` (E, C, D), the
    gradient of its output: ``(dx, dw_gate, dw_up, dw_down)``, each in
    ``x.dtype``. ``g = x Wg`` and ``u = x Wu`` are recomputed in float32;
    ``dh = dy Wd^T``; ``h = act(g) u`` rounded to ``x.dtype`` as the
    forward rounds it; ``dg = dh u act'(g)`` and ``du = dh act(g)`` each
    rounded to ``x.dtype`` once; ``dx = dg Wg^T + du Wu^T``, ``dWg = x^T
    dg``, ``dWu = x^T du``, ``dWd = h^T dy``, every product summed in
    float32. Rows at or past ``counts`` are constant zeros in the forward:
    they contribute nothing (x and dy there are never read into a sum), dx
    there is 0, and an expert with no kept row has exact-zero weight
    gradients."""
    xf, dyf = x.float(), dy.float()
    if counts is not None:
        kept = (torch.arange(x.shape[1], device=x.device)[None, :]
                < counts[:, None].long())[:, :, None]
        xf = torch.where(kept, xf, 0.0)
        dyf = torch.where(kept, dyf, 0.0)
    wg, wu, wd = w_gate.float(), w_up.float(), w_down.float()
    g = torch.bmm(xf, wg)
    u = torch.bmm(xf, wu)
    a, da = _act_and_grad(g, act)
    h = (a * u).to(x.dtype).float()
    dh = torch.bmm(dyf, wd.transpose(1, 2))
    dg = (dh * u * da).to(x.dtype).float()
    du = (dh * a).to(x.dtype).float()
    dx = torch.bmm(dg, wg.transpose(1, 2)) + torch.bmm(du, wu.transpose(1, 2))
    xt = xf.transpose(1, 2)
    return (dx.to(x.dtype), torch.bmm(xt, dg).to(x.dtype), torch.bmm(xt, du).to(x.dtype),
            torch.bmm(h.transpose(1, 2), dyf).to(x.dtype))
