"""Engine-shaped buckets, the yardstick and the work count of the moe_jam FFN.

``chip_smoke.py`` takes its moe_jam check from here. Run as a module on a
machine with a CUDA card, it prints the kernel's design and times the
kernel, its plain version and the yardstick at the engine's bucket shape
with three fills (``fills``), each beside its bound: every row kept (a
full prefill step), the check input (empty, partial and full experts),
and a decode step's (8 tokens, top-8); then at deepseek-v2-lite-16b's
buckets on the slots engine (``DEEPSEEK``: 64 experts of 2048 x 1408,
top-6), a decode tick of 8 slots (capacity 8) and a 4,096-token prefill
(capacity 480), routed uniformly (``deepseek_counts``); then the training
shapes (``TRAIN``): the forward, the backward kernel, the plain backward
(autograd through ``moe_jam_ffn_ref`` in bf16) and the library's
(autograd through three ``bmm``, forward + backward less the forward),
each beside its bound, at olmoe-1b-7b's micro-batch of 2 x 4,096 tokens
(capacity 1,280) and deepseek-v2-lite-16b's 4,096-token one (capacity
480):

    PYTHONPATH=src python -m repro_torch.kernels.moe_jam.bench
"""
from __future__ import annotations

import json

import numpy as np
import torch

from repro_torch.kernels.timing import (bound_ms, card_name, kernel_ms, l2_flush_buffer,
                                        timed_ms)

# olmoe-1b-7b's buckets in the serving engine of chip_smoke.py: 64 experts,
# capacity 40 (8 slots x chunk 32 = 256 columns, top-8, factor 1.25),
# d_model 2048, expert_ff 1024
EXPERTS, CAPACITY, D_MODEL, D_FF = 64, 40, 2048, 1024
# deepseek-v2-lite-16b's experts and routing; its buckets on the slots
# engine: capacity 8 at a decode tick of 8 slots, 480 at a 4,096-token
# prefill (top-6, factor 1.25): tokens -> capacity
DEEPSEEK = dict(experts=64, d_model=2048, d_ff=1408, top_k=6)
DEEPSEEK_FILLS = {"decode": (8, 8), "prefill": (4096, 480)}
# the training shapes: a micro-batch's tokens routed uniformly top-k over
# the experts (``train_counts``), at the capacity ``expert_capacity`` gives
# them (factor 1.25): olmoe-1b-7b's 2 x 4,096 tokens top-8 and
# deepseek-v2-lite-16b's 4,096 top-6; name -> (experts, d_model, d_ff,
# top_k, tokens, capacity)
TRAIN = {"olmoe-1b-7b train": (64, 2048, 1024, 8, 8192, 1280),
         "deepseek-v2-lite-16b train": (64, 2048, 1408, 6, 4096, 480)}
# the kernel's two passes, by the name of the kernel each launches
PASSES = {"gate_up": "moe_stream_kernel<true>", "down": "moe_stream_kernel<false>"}
# the backward's passes, one launch each (dw: all three weight gradients),
# by the name of the kernel each launches
BWD_PASSES = {"act": "moe_bwd_act", "dx": "moe_bwd_dx", "dw": "moe_bwd_dw"}


def check_counts() -> np.ndarray:
    """Kept rows per expert: a quarter empty, a quarter full, the rest
    partial (1 .. CAPACITY - 1), in a shuffled order (numpy seed 0)."""
    rng = np.random.default_rng(0)
    q = EXPERTS // 4
    counts = np.concatenate([np.zeros(q), np.full(q, CAPACITY),
                             rng.integers(1, CAPACITY, size=EXPERTS - 2 * q)])
    return rng.permutation(counts).astype(np.int32)


def fills() -> dict:
    """Kept rows per expert of the three bench fills: ``full`` (every row),
    ``check`` (``check_counts``) and ``decode`` (8 tokens to 8 distinct
    experts each, numpy seed 3)."""
    rng = np.random.default_rng(3)
    decode = np.bincount(np.concatenate([rng.permutation(EXPERTS)[:8] for _ in range(8)]),
                         minlength=EXPERTS).astype(np.int32)
    return {"full": np.full(EXPERTS, CAPACITY, np.int32), "check": check_counts(),
            "decode": decode}


def deepseek_counts(tokens: int, capacity: int, seed: int = 4) -> np.ndarray:
    """Kept rows per expert when ``tokens`` tokens each pick ``top_k``
    distinct experts uniformly (numpy ``seed``), at most ``capacity``."""
    return train_counts(tokens, DEEPSEEK["experts"], DEEPSEEK["top_k"], capacity, seed)


def train_counts(tokens: int, experts: int, top_k: int, capacity: int,
                 seed: int = 4) -> np.ndarray:
    """Kept rows per expert when ``tokens`` tokens each pick ``top_k``
    distinct of ``experts`` uniformly (numpy ``seed``), at most
    ``capacity``."""
    rng = np.random.default_rng(seed)
    picks = np.argsort(rng.random((tokens, experts)), axis=1)[:, :top_k]
    return np.minimum(np.bincount(picks.ravel(), minlength=experts),
                      capacity).astype(np.int32)


def check_inputs(device, counts: np.ndarray, shape=(EXPERTS, CAPACITY, D_MODEL, D_FF)):
    """(x, w_gate, w_up, w_down, counts) at the bucket ``shape`` (E, C, D,
    F; default the engine's) on ``device``, bf16 and int32: x from numpy
    seed 1, the weights drawn on ``device`` from seed 1. Rows of x at or
    past each expert's count are zero, as the dispatch leaves them; weights
    have the init's std 1/sqrt(fan_in), x the post-norm scale."""
    E, C, D, F = shape
    rng = np.random.default_rng(1)
    gen = torch.Generator(device=device).manual_seed(1)

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=device) * std).to(torch.bfloat16)

    x = torch.from_numpy(rng.standard_normal((E, C, D), dtype=np.float32)).to(
        device=device, dtype=torch.bfloat16)
    x *= (torch.arange(C)[None, :, None]
          < torch.from_numpy(counts).long()[:, None, None]).to(device, torch.bfloat16)
    w_gate = normal((E, D, F), D ** -0.5)
    w_up = normal((E, D, F), D ** -0.5)
    w_down = normal((E, F, D), F ** -0.5)
    return x, w_gate, w_up, w_down, torch.from_numpy(counts).to(device)


def needed_work(counts: np.ndarray, *, d_model: int, d_ff: int) -> dict:
    """The bytes and operations the expert FFN needs on this input, for its
    bound: the weights of every expert that holds a kept row, the kept rows
    of x and of the output (bf16), and the counts (int32), each once;
    flops: gate, up and down, 2 * d_model * d_ff each, per kept row."""
    counts = np.asarray(counts, np.int64)
    busy = int((counts > 0).sum())
    rows = int(counts.sum())
    weight_bytes = busy * 3 * d_model * d_ff * 2
    nbytes = weight_bytes + 2 * rows * d_model * 2 + 4 * len(counts)
    return dict(bytes=nbytes, weight_bytes=weight_bytes, rows=rows, experts=busy,
                flops=rows * 3 * 2 * d_model * d_ff)


def needed_bwd_work(counts: np.ndarray, *, capacity: int, d_model: int, d_ff: int) -> dict:
    """The bytes and operations the backward needs on this input, for its
    bound: the weights of every expert that holds a kept row read once,
    every expert's three weight gradients and the whole dx (E, C, D)
    written once (zeros included), the kept rows of x and dy read once and
    the counts; flops: eight products (G and U recomputed, dH, dx's two,
    the three weight gradients), 2 * d_model * d_ff each, per kept row.

    ``passes`` holds each pass's own work, named as ``BWD_PASSES``, with
    what passes between them counted where it is written and read: ``act``
    (three products) reads the busy experts' weights and the kept rows of
    x and dy and writes h, dG and dU for them; ``dx`` (two) reads dG, dU
    and w_gate, w_up and writes the whole dx; ``dw`` (three) reads x, dy,
    h, dG and dU over the kept rows and writes every expert's three weight
    gradients; each reads the counts."""
    counts = np.asarray(counts, np.int64)
    experts = len(counts)
    busy = int((counts > 0).sum())
    rows = int(counts.sum())
    matrix = d_model * d_ff * 2                      # one expert's weight, bf16
    rows_d, rows_f = rows * d_model * 2, rows * d_ff * 2   # kept rows of an (E, C, D) / (E, C, F)
    dx_bytes = experts * capacity * d_model * 2
    product = 2 * rows * d_model * d_ff
    weight_bytes = busy * 3 * matrix
    nbytes = weight_bytes + experts * 3 * matrix + dx_bytes + 2 * rows_d + 4 * experts
    passes = {
        "act": dict(flops=3 * product,
                    bytes=weight_bytes + 2 * rows_d + 3 * rows_f + 4 * experts),
        "dx": dict(flops=2 * product,
                   bytes=busy * 2 * matrix + 2 * rows_f + dx_bytes + 4 * experts),
        "dw": dict(flops=3 * product,
                   bytes=2 * rows_d + 3 * rows_f + experts * 3 * matrix + 4 * experts),
    }
    return dict(bytes=nbytes, weight_bytes=weight_bytes, rows=rows, experts=busy,
                flops=8 * product, passes=passes)


def bwd_inputs(device, counts: np.ndarray, shape):
    """``check_inputs`` at ``shape`` and a dy (E, C, D) bf16 from numpy
    seed 2 over every row, rows past counts included (the backward never
    reads them into a sum)."""
    x, wg, wu, wd, cnt = check_inputs(device, counts, shape)
    dy = torch.from_numpy(np.random.default_rng(2).standard_normal(
        tuple(x.shape), dtype=np.float32)).to(device=device, dtype=torch.bfloat16)
    return x, wg, wu, wd, dy, cnt


def bwd_yardstick(x, w_gate, w_up, w_down, dy):
    """``(forward, both)``: callables computing ``yardstick`` (three bf16
    ``bmm``) forward, and forward + backward by autograd against ``dy``:
    their difference is the library's backward time (the port never calls
    it)."""
    ins = [t.detach().requires_grad_(True) for t in (x, w_gate, w_up, w_down)]

    def forward():
        with torch.no_grad():
            return yardstick(*ins)

    def both():
        return torch.autograd.grad(yardstick(*ins), ins, dy)

    return forward, both


def plain_bwd(x, w_gate, w_up, w_down, dy, counts):
    """A callable: autograd through ``moe_jam_ffn_ref`` on these inputs
    (forward + backward), the plain version's time."""
    from repro_torch.kernels.moe_jam.ref import moe_jam_ffn_ref

    ins = [t.detach().requires_grad_(True) for t in (x, w_gate, w_up, w_down)]
    return lambda: torch.autograd.grad(moe_jam_ffn_ref(*ins, counts=counts), ins, dy)


def yardstick(x, w_gate, w_up, w_down):
    """The same function (silu) by three bf16 ``torch.bmm`` calls: a library
    time to stand beside the kernel's (the port never calls it)."""
    g = torch.nn.functional.silu(torch.bmm(x, w_gate))
    return torch.bmm(g * torch.bmm(x, w_up), w_down)


def time_train_shape(dev, flush, name: str) -> dict:
    """The forward, the backward kernel, the plain backward and the
    library's at one ``TRAIN`` shape, each beside its bound (L2 flushed
    before every launch)."""
    from repro_torch.kernels.moe_jam.ops import moe_jam_ffn_bwd_cuda, moe_jam_ffn_cuda

    e, d, f, k, tokens, c = TRAIN[name]
    counts = train_counts(tokens, e, k, c)
    x, wg, wu, wd, dy, cnt = bwd_inputs(dev, counts, (e, c, d, f))
    fwd_work = needed_work(counts, d_model=d, d_ff=f)
    bwd_work = needed_bwd_work(counts, capacity=c, d_model=d, d_ff=f)
    lib_fwd, lib_both = bwd_yardstick(x, wg, wu, wd, dy)
    r = dict(shape=(e, c, d, f), kept_rows=bwd_work["rows"], experts=bwd_work["experts"],
             fwd_ms=timed_ms(lambda: moe_jam_ffn_cuda(x, wg, wu, wd, counts=cnt), 10, flush),
             fwd_bound=bound_ms(fwd_work),
             ms=timed_ms(lambda: moe_jam_ffn_bwd_cuda(x, wg, wu, wd, dy, counts=cnt), 10,
                         flush),
             bound=bound_ms(bwd_work),
             plain_ms=timed_ms(plain_bwd(x, wg, wu, wd, dy, cnt), 3, flush),
             library_ms=timed_ms(lib_both, 10, flush) - timed_ms(lib_fwd, 10, flush),
             passes_ms=kernel_ms(lambda: moe_jam_ffn_bwd_cuda(x, wg, wu, wd, dy, counts=cnt),
                                 flush, BWD_PASSES, iters=3),
             passes_bound={k: bound_ms(w) for k, w in bwd_work["passes"].items()})
    return r


def main() -> int:
    from repro_torch.kernels.moe_jam.kernel import BWD_DESIGN, DESIGN
    from repro_torch.kernels.moe_jam.ops import moe_jam_ffn_cuda, moe_jam_ffn_ref

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card: this times the CUDA kernel")
    dev = torch.device("cuda")
    card = card_name()
    print(f"[bench] moe_jam design {DESIGN!r} on {card}", flush=True)
    flush = l2_flush_buffer(dev)
    rows = []
    ds = DEEPSEEK
    cases = [(name, counts, (EXPERTS, CAPACITY, D_MODEL, D_FF))
             for name, counts in fills().items()]
    cases += [(f"deepseek {name} (C {c})", deepseek_counts(n, c),
               (ds["experts"], c, ds["d_model"], ds["d_ff"]))
              for name, (n, c) in DEEPSEEK_FILLS.items()]
    for name, counts, shape in cases:
        x, wg, wu, wd, cnt = check_inputs(dev, counts, shape)
        work = needed_work(counts, d_model=shape[2], d_ff=shape[3])
        bound, by = bound_ms(work)
        rows.append(dict(
            fill=name, kept_rows=work["rows"], experts=work["experts"], bound_ms=bound,
            bound_by=by,
            ms=timed_ms(lambda: moe_jam_ffn_cuda(x, wg, wu, wd, counts=cnt), 50, flush),
            plain_ms=timed_ms(lambda: moe_jam_ffn_ref(x, wg, wu, wd, counts=cnt), 5, flush),
            library_ms=timed_ms(lambda: yardstick(x, wg, wu, wd), 50, flush),
            passes_ms=kernel_ms(lambda: moe_jam_ffn_cuda(x, wg, wu, wd, counts=cnt), flush,
                                PASSES)))
        del x, wg, wu, wd, cnt
        r = rows[-1]
        print(f"[bench] moe_jam {name}: {r['kept_rows']} kept rows in {r['experts']} "
              f"experts: kernel {r['ms']:.4f} ms (passes, profiler: "
              + ", ".join(f"{k} {v:.4f}" for k, v in r["passes_ms"].items())
              + f"), plain {r['plain_ms']:.4f} ms, 3 x bmm {r['library_ms']:.4f} ms, bound "
              f"{bound:.4f} ms ({by}), weights at "
              f"{work['weight_bytes'] / r['ms'] / 1e9:.3f} TB/s", flush=True)
    train = {}
    for name in TRAIN:
        r = train[name] = time_train_shape(dev, flush, name)
        print(f"[bench] moe_jam {name} {r['shape']}: {r['kept_rows']} kept rows; forward "
              f"{r['fwd_ms']:.4f} ms (bound {r['fwd_bound'][0]:.4f}, {r['fwd_bound'][1]}); "
              f"backward ({BWD_DESIGN}) {r['ms']:.4f} ms (passes, profiler, each beside "
              "its own bound: "
              + ", ".join(f"{k} {v:.4f} (bound {r['passes_bound'][k][0]:.4f}, "
                          f"{r['passes_bound'][k][1]})" for k, v in r["passes_ms"].items())
              + f"), bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), plain {r['plain_ms']:.4f} "
              f"ms, 3 x bmm by autograd less forward {r['library_ms']:.4f} ms", flush=True)
    print(json.dumps({"card": card, "design": DESIGN, "bwd_design": BWD_DESIGN,
                      "moe_jam": rows, "train": train}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
