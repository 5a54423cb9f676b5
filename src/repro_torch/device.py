"""Device resolution for the port's entry points.

Entry points default to the card. Without one they raise: a CPU run is
something the caller asks for (``device="cpu"``), never a fallback.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device with no card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    return dev


def strict_fp32() -> None:
    """Keep float32 matmuls and convolutions in full float32 (no TF32).

    PyTorch's default keeps matmuls in float32 but sends convolutions
    through cuDNN in TF32; the port states and sets both."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
