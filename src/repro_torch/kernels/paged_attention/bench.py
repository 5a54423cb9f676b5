"""Engine-shaped inputs and the work count of paged attention.

``chip_smoke.py`` takes its kernel check from here. Run as a module on a
machine with a CUDA card, it profiles the kernel on the same input: the
whole input, then each row alone (the other rows idle), so it shows which
row a launch waits for; then the whole input cut into 1, 2, 4, 8 and 16
splits and into ``split_plan``'s, at llama3.2-1b's and olmoe-1b-7b's
heads, so the split size is a measured choice:

    PYTHONPATH=src python -m repro_torch.kernels.paged_attention.bench
"""
from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.timing import card_name, l2_flush_buffer, timed_ms

# the serving engine's geometry in chip_smoke.py: 8 slots, chunk 32, 32/8
# heads of 64, block 16, max_len 1024 (64 table entries), 128 pool blocks
SLOTS, CHUNK, HEADS, KV_HEADS, HEAD_DIM = 8, 32, 32, 8, 64
BLOCK, MAX_BLOCKS, NUM_BLOCKS = 16, 64, 128


def check_inputs(device, *, heads: int = HEADS, kv_heads: int = KV_HEADS,
                 head_dim: int = HEAD_DIM):
    """(q, k_pool, v_pool, block_tables, starts, n_valid), bf16 / int32 on
    ``device``, from a numpy seed; llama3.2-1b's heads by default (olmoe's
    are ``heads=kv_heads=16, head_dim=128``). Rows: prefill from 0, first
    decode, idle, long-resident decode, a deep prefill chunk, two rows
    sharing a reused block (stale rows past seq_end), and a chunk ending at
    the table's end. Table entries past each row's live blocks are -1; inside
    live ranges, entries that name no pool block (-1, and ids >= the pool's
    size) sit before each chunk, so every valid column still sees its own
    key, and one of them lies inside a window of 128."""
    B, C, H, K, D, M, N = SLOTS, CHUNK, heads, kv_heads, head_dim, MAX_BLOCKS, NUM_BLOCKS
    rng = np.random.default_rng(7)
    starts = np.asarray([0, 0, 0, 900, 480, 200, 37, 1000], np.int32)
    n_valid = np.asarray([C, 1, 0, 1, C, 1, 17, 24], np.int32)
    tables = np.stack([rng.permutation(N)[:M] for _ in range(B)]).astype(np.int32)
    seq_end = starts + n_valid
    tables[5, (seq_end[5] - 1) // BLOCK] = tables[6, (seq_end[6] - 1) // BLOCK]
    for b in range(B):
        tables[b, -(-int(seq_end[b]) // BLOCK):] = -1
    tables[3, 10], tables[3, 50] = -1, N + 5     # decode at 900: block 50 is in the window
    tables[4, 3] = -1
    tables[7, 40] = N
    q = rng.normal(size=(B, C, H, D)).astype(np.float32)
    kp = rng.normal(size=(N, BLOCK, K, D)).astype(np.float32)
    vp = rng.normal(size=(N, BLOCK, K, D)).astype(np.float32)
    bf = lambda a: torch.from_numpy(a).to(device, torch.bfloat16)
    i32 = lambda a: torch.from_numpy(a).to(device)
    return bf(q), bf(kp), bf(vp), i32(tables), i32(starts), i32(n_valid)


def needed_work(tables, starts, n_valid, *, num_blocks: int, block_size: int,
                heads: int, kv_heads: int, head_dim: int,
                window: Optional[int] = None) -> dict:
    """The bytes and operations paged attention needs on this input (numpy
    arrays), for its bound: each input read once and the output written
    once, counting only what the valid columns use.

    * q and out: the valid columns' rows, bf16;
    * k and v: each live position some valid column sees, whose table
      entry names a pool block, once (bf16);
    * the table entries of those positions' blocks, starts and n_valid;
    * flops: Q.K and P.V, 2 * head_dim each, per query head per visible
      key of every valid column."""
    bs, D = block_size, head_dim
    kv_rows = blocks = keys = 0
    for tab, s, n in zip(tables, starts.tolist(), n_valid.tolist()):
        if n <= 0:
            continue
        end = s + n
        lo = 0 if window is None else max(0, s - window + 1)
        pos = np.arange(end)
        blk = tab[pos // bs]
        present = (blk >= 0) & (blk < num_blocks) & (pos >= lo)
        kv_rows += int(present.sum())
        blocks += len(np.unique(pos[lo:] // bs))
        seen = np.concatenate([[0], np.cumsum(present)])
        for c in range(n):
            qp = s + c
            first = 0 if window is None else max(0, qp - window + 1)
            keys += int(seen[qp + 1] - seen[first])
    q_rows = int(np.maximum(n_valid, 0).sum()) * heads
    nbytes = (2 * q_rows * D * 2                     # q in, out
              + 2 * kv_rows * kv_heads * D * 2       # k, v
              + 4 * blocks + 4 * 2 * len(starts))    # table entries, starts, n_valid
    return dict(bytes=nbytes, kv_bytes=2 * kv_rows * kv_heads * D * 2,
                flops=4 * D * heads * keys, keys=keys)


SPLIT_COUNTS = (1, 2, 4, 8, 16)
SPLIT_HEADS = {"llama3.2-1b": (HEADS, KV_HEADS, HEAD_DIM), "olmoe-1b-7b": (16, 16, 128)}


def main() -> int:
    from repro_torch.kernels.paged_attention.kernel import _launch
    from repro_torch.kernels.paged_attention.ops import paged_attention_cuda, split_plan

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card: this profiles the CUDA kernel")
    dev = torch.device("cuda")
    card = card_name()
    args = check_inputs(dev)
    q, kp, vp, tables, starts, n_valid = args
    flush = l2_flush_buffer(dev)
    call = lambda a: paged_attention_cuda(*a, block_size=BLOCK)
    rows = [dict(start=None, n_valid=None, ms=timed_ms(lambda: call(args), 200, flush))]
    for b in range(SLOTS):
        nv1 = torch.zeros_like(n_valid)
        nv1[b] = n_valid[b]
        one = (q, kp, vp, tables, starts, nv1)
        rows.append(dict(start=int(starts[b]), n_valid=int(n_valid[b]),
                         ms=timed_ms(lambda one=one: call(one), 50, flush)))
    for r in rows:
        what = "all rows" if r["start"] is None else f"row {r['start']}+{r['n_valid']} alone"
        print(f"[bench] paged_attention {what}: {r['ms']:.4f} ms", flush=True)
    plan = split_plan(MAX_BLOCKS, BLOCK)
    splits = []
    for arch, (h, kv, d) in SPLIT_HEADS.items():
        a = check_inputs(dev, heads=h, kv_heads=kv, head_dim=d)
        for n in sorted(set(SPLIT_COUNTS) | {plan.n_splits}):
            kps = BLOCK * -(-MAX_BLOCKS // n)
            ms = timed_ms(lambda: _launch(*a, BLOCK, None, None, kps), 200, flush)
            splits.append(dict(heads=arch, n_splits=n, keys_per_split=kps, ms=ms,
                               plan=kps == plan.keys_per_split))
            print(f"[bench] paged_attention {arch} ({h}/{kv} x {d}) in {n} splits of {kps} "
                  f"keys{' (the plan)' if splits[-1]['plan'] else ''}: {ms:.4f} ms", flush=True)
    print(json.dumps({"card": card, "paged_attention_ms": rows, "splits": splits}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
