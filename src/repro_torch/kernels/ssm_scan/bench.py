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

It also holds the backward's (B4b) check inputs, work count and launches
(``BWD_CASES``, ``bwd_inputs``, ``needed_bwd_work``, ``BWD_PASSES``), which
``chip_smoke.py`` times the backward on. With ``--bwd`` it times the
backward alone at ``BWD_CASES`` (mean of 20 calls, the L2 flushed before
each, and each launch by ``torch.profiler``), holds it against the plain
version under ``compare_bwd`` and a second launch's bits, and prints one
JSON line; it needs only ``ssm_scan_train_cuda``, ``ssm_scan_bwd_cuda``,
``ssm_scan_bwd_ref`` and ``compare_bwd``, so it also times an older
checkout's backward (``scripts/bench_in_turns.py``):

    PYTHONPATH=src python -m repro_torch.kernels.ssm_scan.bench --bwd
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.kernels.timing import (bound_ms, card_name, floor_ms, l2_flush_buffer,
                                        sfu_ms, timed_ms)

# mamba-130m in the serving engine of chip_smoke.py: 32 slots, chunk 32,
# inner 1536 (expand 2 x d_model 768), state 16
SLOTS, CHUNK, INNER, STATE = 32, 32, 1536, 16
# the backward's check inputs: (rows, columns, channels, N, ragged, x 2
# bytes off a 16-byte boundary). The training micro-batches of mamba-130m
# and hymba-1.5b (2 x 4,096 tokens; every column valid, h0 and dh_last
# None, as the model runs it), then an engine-like ragged batch (0, 1,
# chunk edges and full among 32 rows of 96 columns; h0 and dh_last given)
# at N 16, at N 8 with x off 16 bytes (the forward's direct route) and at
# N 4 (direct)
BWD_CASES = {"mamba-130m train": (2, 4096, 1536, 16, False, False),
             "hymba-1.5b train": (2, 4096, 3200, 16, False, False),
             "engine ragged N 16": (32, 96, 1536, 16, True, False),
             "engine ragged N 8 direct": (32, 96, 1536, 8, True, True),
             "engine ragged N 4": (32, 96, 1536, 4, True, False)}
# a dependent step of the backward's chains: the recompute's FMA (4
# cycles), then g's FMA and its decay's FMUL (4 each), at the 1.98 GHz
# boost clock: a floor beside the bound
CHAIN_CYCLES, CLOCK_HZ = 12, 1.98e9
# the backward's stage: the steps pass 3 recomputes into registers at once
# (kSteps in ssm_scan.cuh)
BWD_STAGE = 8
# the backward's launches, by the kernel names torch.profiler reports
BWD_PASSES = {"local": "ssm_scan_bwd_local", "carry": "ssm_scan_bwd_carry",
              "grads": "ssm_scan_bwd_kernel", "fold": "ssm_scan_bwd_fold"}


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


def bwd_n_valid(rows: int, cols: int, ragged: bool) -> np.ndarray:
    """Valid columns per row: every one, or 0, 1, 31, 32, 33, 95 and
    ``cols`` among the rest drawn from 0..cols (numpy seed 0), shuffled."""
    if not ragged:
        return np.full(rows, cols, np.int32)
    rng = np.random.default_rng(0)
    edges = [0, 1, 31, 32, 33, cols - 1, cols]
    nv = np.concatenate([edges, rng.integers(0, cols + 1, size=rows - len(edges))])
    return rng.permutation(nv).astype(np.int32)


def bwd_inputs(device, name: str):
    """``BWD_CASES[name]``'s inputs on ``device``: (dt, b, c, x, a, h0,
    n_valid, dy, dh_last) from ``check_inputs`` (numpy seed 1) and, for dy
    and dh_last, normals from numpy seed 2 (dy bf16). A training case has
    h0, n_valid and dh_last None; an off case has x copied 2 bytes off a
    16-byte boundary."""
    rows, cols, inner, state, ragged, off = BWD_CASES[name]
    nv = bwd_n_valid(rows, cols, ragged)
    dt, b, c, x, a, h0, n_valid = check_inputs(device, nv, inner=inner, state=state, steps=cols)
    if off:
        shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=device)[1:].view(x.shape)
        x = shifted.copy_(x)
    rng = np.random.default_rng(2)
    dy = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)).to(
        device=device, dtype=torch.bfloat16)
    dh_last = torch.from_numpy(rng.standard_normal(h0.shape).astype(np.float32)).to(device)
    if not ragged:
        return dt, b, c, x, a, None, None, dy, None
    return dt, b, c, x, a, h0, n_valid, dy, dh_last


def needed_bwd_work(n_valid: np.ndarray, *, inner: int, state: int,
                    dh_last: bool = True) -> dict:
    """The bytes and operations the scan's gradient needs on this input, and
    the exponentials and dependent steps of the backward's design (v2).

    Bytes, each once: dt, x and dy read and ddt and dx written (bf16) at the
    valid columns; b and c read and db and dc written (bf16) at the valid
    columns; a read and da written (f32); h0 read and dh0 written (f32)
    for every row, and dh_last read where given; n_valid. Float32
    operations per valid (column, channel, state element), each product
    counted once: the recompute's five (dt a, its exp, the decay product,
    the input product and sum), then the product and sum of each of g's
    dy c, dc's h dy, s's g b and db's g (dt x), q = g h da (two products,
    shared by the ddt term and da), the ddt term's q a and da's q dt (a
    product and a sum each), and g's decay: 20; per valid (column,
    channel) dt x, dx = dt s, and ddt's product and sum: 4.

    ``exps``: the exponentials v2 takes, per valid (column, channel, state
    element) of a chunk of ``len`` valid columns: one in the local carry
    (pass 1), one in the recompute of each stage and one in its reverse
    step (pass 3), and one for each column before the chunk's last
    ``BWD_STAGE``-step stage in pass 3's sweep; ``sfu_ms`` turns them into
    the SFUs' floor.
    ``chain_steps``: v2's longest dependent chain, the longest row's
    longest chunk walked by pass 1 (``len`` steps), by pass 3's sweep to
    its last stage, its recompute and its reverse, plus the carry's walk
    over the row's valid chunks (one step each)."""
    nv = np.asarray(n_valid, np.int64)
    cols, rows = int(nv.sum()), len(nv)
    state_bytes = (2 + int(dh_last)) * rows * inner * state * 4
    nbytes = (5 * cols * inner * 2 + 4 * cols * state * 2 + 2 * inner * state * 4
              + state_bytes + 4 * rows)
    # each row's chunks: full ones and a partial last one
    full, tail = nv // CHUNK, nv % CHUNK

    def before_last_stage(n):               # columns before a chunk's last stage
        return np.where(n > 0, (n - 1) // BWD_STAGE * BWD_STAGE, 0)

    per_row = 3 * nv + full * before_last_stage(CHUNK) + before_last_stage(tail)
    longest = np.minimum(nv, CHUNK)
    chain = 3 * longest + before_last_stage(longest) + -(-nv // CHUNK)
    return dict(bytes=nbytes, state_bytes=state_bytes, cols=cols,
                f32_flops=cols * inner * (20 * state + 4),
                exps=int(per_row.sum()) * inner * state,
                chain_steps=int(chain.max()) if rows else 0)


def chain_ms(work: dict) -> float:
    """The dependent chain's floor: ``chain_steps`` x ``CHAIN_CYCLES`` at
    ``CLOCK_HZ``, in ms."""
    return work["chain_steps"] * CHAIN_CYCLES / CLOCK_HZ * 1e3


def bwd_main() -> int:
    """``--bwd``: the backward at every ``BWD_CASES`` case, one JSON line."""
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.kernels.ssm_scan.kernel import BWD_DESIGN
    from repro_torch.kernels.timing import kernel_ms

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card: this times the CUDA kernel")
    dev = torch.device("cuda")
    flush = l2_flush_buffer(dev)
    rows = []
    for name in BWD_CASES:
        dt, b, c, x, a, h0, n_valid, dy, dh_last = bwd_inputs(dev, name)
        states = ss.ssm_scan_train_cuda(dt, b, c, x, a, h0, n_valid)[2]

        def call():
            return ss.ssm_scan_bwd_cuda(dt, b, c, x, a, states, dy, n_valid, dh_last)

        one, two = call(), call()
        same = all(torch.equal(p.view(torch.int16 if p.dtype == torch.bfloat16 else torch.int32),
                               q.view(torch.int16 if q.dtype == torch.bfloat16 else torch.int32))
                   for p, q in zip(one, two))
        del two
        plain = ss.ssm_scan_bwd_ref(dt, b, c, x, a, dy, h0, n_valid, dh_last)
        f32 = ss.ssm_scan_bwd_ref(dt.float(), b.float(), c.float(), x.float(), a, dy.float(),
                                  h0, n_valid, dh_last)
        _, bad = ss.compare_bwd(one, plain, f32, n_valid)
        del one, plain, f32
        rows.append(dict(case=name, ms=timed_ms(call, 20, flush),
                         passes_ms=kernel_ms(call, flush, BWD_PASSES, iters=5), bad=bad,
                         deterministic=same))
        print(f"[bench] ssm_scan_bwd {name}: {rows[-1]}", flush=True)
        del dt, b, c, x, a, h0, n_valid, dy, dh_last, states
        torch.cuda.empty_cache()
    print(json.dumps({"card": card_name(), "design": BWD_DESIGN, "ssm_scan_bwd": rows}),
          flush=True)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--bwd", action="store_true",
                        help="time the backward (B4b) at BWD_CASES instead")
    if parser.parse_args(argv).bwd:
        return bwd_main()
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
