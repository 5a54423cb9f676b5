"""Device timing and roofline bounds of the port's kernels, on one card.

``chip_smoke.py`` and each kernel's ``bench.py`` time a kernel, its plain
version and a library yardstick with these helpers, and bound it by the
bytes and operations its input needs. Only meaningful on a CUDA card.
"""
from __future__ import annotations

import subprocess
from typing import Optional

import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12            # H100 SXM float32 peak outside the tensor cores
# 132 SMs, 16 exponentials per SM per clock on the SFUs, 1.98 GHz boost
# clock (data sheet); a floor beside the bound, which does not count it
SFU_EXP_PER_S = 132 * 16 * 1.98e9


def card_name() -> str:
    """``nvidia-smi``'s name and power limit of the first card, else the
    name PyTorch reports."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    lines = smi.stdout.strip().splitlines() if smi.returncode == 0 else []
    if lines:
        return lines[0]
    return f"{torch.cuda.get_device_name(0)}, power limit unknown (nvidia-smi rc={smi.returncode})"


def bound_ms(work: dict):
    """(bound in ms, "bytes" or "operations"): the larger of the bytes over
    HBM3's rate and the operations over their peak: ``flops`` (bf16, on
    the tensor cores) and ``f32_flops`` (float32, on the CUDA cores)."""
    t_bytes = work["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = (work.get("flops", 0) / BF16_FLOPS_PER_S
             + work.get("f32_flops", 0) / F32_FLOPS_PER_S) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sfu_ms(work: dict) -> float:
    """The least time the SFUs take for ``work``'s exponentials (``exps``):
    a floor beside ``bound_ms``, which counts bytes and flops alone."""
    return work["exps"] / SFU_EXP_PER_S * 1e3


def flush_l2(flush: torch.Tensor) -> None:
    """Overwrite the L2 cache: write the first half of ``flush`` (from
    ``l2_flush_buffer``), then read the second half, so the lines the write
    left dirty are written back to device memory here and not inside the
    next timed launch."""
    half = flush.numel() // 2
    flush[:half].zero_()
    flush[half:].view(torch.int32).amax()


def timed_ms(fn, iters: int, flush: Optional[torch.Tensor]) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, each timed with
    CUDA events after the L2 cache was overwritten (``flush_l2``;
    ``flush=None``: warm, nothing overwritten). A device-side spin before
    each start event keeps the card busy while the host enqueues the call,
    so a launch shorter than its Python call overhead is timed as the
    kernel, not as the host's gap."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        if flush is not None:
            flush_l2(flush)
        torch.cuda._sleep(1_000_000)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def floor_ms(flush: Optional[torch.Tensor], iters: int = 200) -> float:
    """``timed_ms`` of a one-element ``fill_``: what the timer reads for a
    launch that does next to no work, the floor under every kernel time."""
    one = torch.zeros(1, device=flush.device if flush is not None else "cuda")
    return timed_ms(lambda: one.fill_(1.0), iters, flush)


def kernel_ms(call, flush: torch.Tensor, kernels: dict, iters: int = 20) -> dict:
    """Mean device time (ms) per call of each kernel that ``call`` launches,
    ``{label: ms}`` for ``kernels`` = ``{label: a substring of the kernel's
    name}``, over ``iters`` calls with the L2 cache overwritten before each
    (``flush_l2``), read from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush_l2(flush)
            call()
        torch.cuda.synchronize()
    return {label: e.device_time_total / e.count / 1e3 for e in prof.key_averages()
            for label, name in kernels.items() if name in e.key}


def l2_flush_buffer(device) -> torch.Tensor:
    """Two halves of 64 MiB, each larger than the 50 MB L2 (``flush_l2``)."""
    return torch.empty(2 * 64 * 2 ** 20, dtype=torch.uint8, device=device)
