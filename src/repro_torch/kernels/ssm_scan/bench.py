"""Engine-shaped inputs and the work count of the selective scan.

``chip_smoke.py`` takes its ssm_scan check from here. Run as a module on a
machine with a CUDA card, it times the kernel and its plain version (the
L2 cache flushed before every launch) against the bound at the shape
mamba-130m's serving engine gives it (32 slots x chunk 32 x 1536 channels,
N 16), with three fills: full prefill (every row 32 valid columns), decode
(every row 1) and the check's mixed rows; each fill also with x copied 2
bytes off a 16-byte boundary, which sends it down the direct route
(``direct_ms``):

    PYTHONPATH=src python -m repro_torch.kernels.ssm_scan.bench
"""
from __future__ import annotations

import json

import numpy as np
import torch

from repro_torch.kernels.timing import (bound_ms, card_name, floor_ms, l2_flush_buffer,
                                        sfu_ms, timed_ms)

# mamba-130m in the serving engine of chip_smoke.py: 32 slots, chunk 32,
# inner 1536 (expand 2 x d_model 768), state 16
SLOTS, CHUNK, INNER, STATE = 32, 32, 1536, 16


def check_n_valid() -> np.ndarray:
    """Valid columns per row: 0, 1, 7, 31 and 32 among the rest drawn from
    0..32 (numpy seed 0), shuffled."""
    rng = np.random.default_rng(0)
    nv = np.concatenate([[0, 1, 7, CHUNK - 1, CHUNK],
                         rng.integers(0, CHUNK + 1, size=SLOTS - 5)])
    return rng.permutation(nv).astype(np.int32)


def check_inputs(device, n_valid: np.ndarray, *, inner: int = INNER, state: int = STATE,
                 steps: int = CHUNK):
    """(dt, b, c, x, a, h0, n_valid) at the engine's shape (``len(n_valid)``
    rows of ``steps`` columns) on ``device``, from numpy seed 1: dt softplus
    of normals, x, b, c normal, all bf16; a = -exp(bf16 of normal * 0.3)
    float32, as the model takes it from its bf16 ``a_log``; h0 normal
    float32."""
    rng = np.random.default_rng(1)
    B, S = len(n_valid), steps

    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)

    dt = bf16(np.log1p(np.exp(rng.standard_normal((B, S, inner)))))
    x = bf16(rng.standard_normal((B, S, inner)))
    b = bf16(rng.standard_normal((B, S, state)))
    c = bf16(rng.standard_normal((B, S, state)))
    a = -torch.exp(bf16(rng.standard_normal((inner, state)) * 0.3).float())
    h0 = torch.from_numpy(rng.standard_normal((B, inner, state)).astype(np.float32)).to(device)
    return dt, b, c, x, a, h0, torch.from_numpy(n_valid).to(device)


def needed_work(n_valid: np.ndarray, *, inner: int = INNER, state: int = STATE) -> dict:
    """The bytes and operations the scan needs on this input, for its bound.

    Bytes, each once: dt and x read and y written (bf16) at the valid
    columns only (the rest are garbage by contract), b and c (bf16) at the
    valid columns, a (f32), h0 read and h_last written (f32) for every row,
    n_valid (int32). Float32 operations per valid (column, channel): dt * x,
    and per state element dt * a, its exp, the decay product, the input
    product and sum, and c's product and sum (8 N + 1 in all)."""
    cols = int(np.asarray(n_valid, np.int64).sum())
    rows = len(n_valid)
    nbytes = (3 * cols * inner * 2 + 2 * cols * state * 2 + inner * state * 4
              + 2 * rows * inner * state * 4 + 4 * rows)
    return dict(bytes=nbytes, state_bytes=2 * rows * inner * state * 4, cols=cols,
                f32_flops=cols * inner * (8 * state + 1), exps=cols * inner * state)


def main() -> int:
    from repro_torch.kernels.ssm_scan.kernel import DESIGN, scan_route
    from repro_torch.kernels.ssm_scan.ops import ssm_scan_cuda, ssm_scan_ref

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card: this times the CUDA kernel")
    dev = torch.device("cuda")
    fills = {"full": np.full(SLOTS, CHUNK, np.int32), "decode": np.ones(SLOTS, np.int32),
             "check": check_n_valid()}
    flush = l2_flush_buffer(dev)
    rows = []
    for name, nv in fills.items():
        args = check_inputs(dev, nv)
        x = args[3]
        off = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:].view(x.shape)
        off.copy_(x)
        shifted = (*args[:3], off, *args[4:])
        work = needed_work(nv)
        bound, by = bound_ms(work)
        rows.append(dict(
            fill=name, valid_columns=work["cols"], bytes=work["bytes"], bound_ms=bound,
            bound_by=by, sfu_exp_ms=sfu_ms(work),
            design=f"{DESIGN}, route {scan_route(*args[:4])}",
            ms=timed_ms(lambda: ssm_scan_cuda(*args), 200, flush),
            direct_ms=timed_ms(lambda: ssm_scan_cuda(*shifted), 200, flush),
            direct_route=scan_route(*shifted[:4]),
            plain_ms=timed_ms(lambda: ssm_scan_ref(*args), 10, flush)))
        r = rows[-1]
        print(f"[bench] ssm_scan {name}: {r['valid_columns']} valid columns of "
              f"{SLOTS * CHUNK}: kernel {r['ms']:.4f} ms ({r['direct_ms']:.4f} on x 2 bytes off, "
              f"route {r['direct_route']}), plain {r['plain_ms']:.4f} ms, bound {bound:.4f} ms "
              f"({by}; {work['bytes']} bytes), exponentials on the SFUs "
              f"{r['sfu_exp_ms']:.4f} ms; {r['design']}", flush=True)
    floor = floor_ms(flush)
    print(f"[bench] timer floor (a one-element fill_): {floor:.4f} ms", flush=True)
    print(json.dumps({"card": card_name(), "floor_ms": floor, "ssm_scan": rows}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
