"""Plain PyTorch version of the moe_jam expert FFN.

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
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.common import act_fn


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
