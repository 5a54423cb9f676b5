#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases (any failure exits non-zero; with no card it fails at once):

1. device: the card's name, count, and ``nvidia-smi`` name/power limit;
2. build: compile every kernel of the path from ``src/`` (``nvcc``) and print
   ptxas's register / shared-memory / spill report;
3. kernel vs plain: call each kernel's wrapper at the engine's shapes on
   the card and hold it against its plain PyTorch version (stated
   tolerance, valid columns only; the tables hold entries that name no
   pool block inside live ranges); time kernel, plain version and one
   PyTorch library call (a yardstick the port never calls), each with the
   L2 cache flushed before every launch, as the serving loop finds it;
   compute the bound from the bytes and operations this input needs;
4. end to end: a full-width ``llama3.2-1b`` paged ``Engine`` (16 layers,
   random bf16 weights from a seed) serves 12 requests with preemption;
   launch counts are read around exactly that run; the same step inputs
   are then replayed through ``kernel="ref"`` for greedy agreement, and
   one step's logits are compared on identical inputs;
5. the last line: ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# the engine's geometry (and the kernel check's shapes). With this traffic a
# 160-block pool peaks at 159 blocks and never preempts; 128 blocks preempt
# twice (the schedule depends on lengths only, not on the weights)
SLOTS, CHUNK, BLOCK, MAX_LEN, NUM_BLOCKS = 8, 32, 16, 1024, 128
N_REQUESTS, PROMPT_LO, PROMPT_HI, MAX_NEW, SEED = 12, 64, 384, 32, 0
# kernel vs plain, per element: |kernel - plain| <= 2e-2 * (min(1, rms of
# the element's (request, column, head) row) + |plain|). bf16 output, and p
# rounded to bf16 before P.V at different points in the two versions
KERNEL_TOL = 2e-2
LOGIT_ATOL = 2e-2                  # logits ~0.13 std at this init; bf16 x 16 layers


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def check_kernel(torch, ops, bench, dev):
    """Phase 3 for the paged-attention kernel; returns its JSON entry
    (without ``launches``)."""
    args = bench.check_inputs(dev)
    q, kp, vp, tables, starts, n_valid = args
    max_err = 0.0
    for w in (None, 128):
        out = ops.paged_attention(*args, block_size=BLOCK, window=w)
        ref = ops.paged_attention_ref(*args, block_size=BLOCK, window=w)
        torch.cuda.synchronize()
        if not torch.isfinite(out.float()).all():
            raise AssertionError(f"kernel output has NaN/inf (window={w})")
        err, worst, bad = ops.compare_valid(out, ref, n_valid, tol=KERNEL_TOL)
        log(f"[kernel] paged_attention window={w}: max |kernel - plain| on valid "
            f"columns = {err:.3e}, largest share of the allowed error {worst:.3f} "
            f"({bad} elements over {KERNEL_TOL} x (min(1, row rms) + |plain|))")
        if bad:
            raise AssertionError(f"kernel disagrees with the plain version (window={w})")
        max_err = max(max_err, err)

    B, C, H, D = q.shape
    K = kp.shape[2]
    flush = bench.l2_flush_buffer(dev)
    ms = bench.timed_ms(lambda: ops.paged_attention(*args, block_size=BLOCK), 200, flush)
    plain_ms = bench.timed_ms(lambda: ops.paged_attention_ref(*args, block_size=BLOCK),
                              20, flush)
    # yardstick: SDPA on the pre-gathered dense view with the same mask
    # (the gather is excluded from its time)
    from repro_torch.models.kvcache import PagedKVCache
    seq_end = starts + n_valid
    kd, vd, t = PagedKVCache(kp, vp, BLOCK).gather(tables, seq_lens=seq_end)
    kd = kd[:, :t].permute(0, 2, 1, 3).repeat_interleave(H // K, dim=1).contiguous()
    vd = vd[:, :t].permute(0, 2, 1, 3).repeat_interleave(H // K, dim=1).contiguous()
    qd = q.permute(0, 2, 1, 3).contiguous()
    qpos = starts[:, None] + torch.arange(C, device=dev)[None, :]
    kpos = torch.arange(t, device=dev)
    blk = tables[:, kpos // BLOCK]
    mask = ((kpos[None, None, :] <= qpos[:, :, None])
            & (kpos[None, None, :] < seq_end[:, None, None])
            & ((blk >= 0) & (blk < kp.shape[0]))[:, None, :])[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = bench.timed_ms(lambda: sdpa(qd, kd, vd, attn_mask=mask), 200, flush)
    del flush

    work = bench.needed_work(tables.cpu().numpy(), starts.cpu().numpy(),
                             n_valid.cpu().numpy(), num_blocks=kp.shape[0],
                             block_size=BLOCK, heads=H, kv_heads=K, head_dim=D)
    bound, bound_by = bench.bound_ms(work)
    log(f"[kernel] paged_attention timing (L2 flushed per launch): kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, SDPA on pre-gathered view {library_ms:.4f} ms; "
        f"needed bytes {work['bytes']} ({work['kv_bytes']} K/V) -> "
        f"{work['bytes'] / bench.HBM_BYTES_PER_S * 1e3:.5f} ms at 3.35 TB/s; "
        f"{work['flops']} flops over {work['keys']} visible keys -> "
        f"{work['flops'] / bench.BF16_FLOPS_PER_S * 1e3:.5f} ms at 989 TFLOP/s")
    return {
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:108",
        "launches": None, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": library_ms,
    }


def serve(torch, dev, kernel_mod):
    """Phase 4: the full-width engine; returns (engine, step records, summary)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.engine import Engine, Request

    cfg = get_config("llama3.2-1b")
    engine = Engine(cfg, device=dev, cache="paged", kernel="auto", slots=SLOTS,
                    max_len=MAX_LEN, num_blocks=NUM_BLOCKS, block_size=BLOCK,
                    chunk=CHUNK)
    t0 = time.perf_counter()
    engine.load_params(seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(engine.params))
    log(f"[e2e] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.attention.num_heads}/{cfg.attention.num_kv_heads} heads, "
        f"vocab {cfg.vocab_size}, {n_params} bf16 params drawn in "
        f"{time.perf_counter() - t0:.1f}s; paged_kernel={engine.paged_kernel}")
    if engine.paged_kernel != "cuda":
        raise AssertionError(f"auto resolved to {engine.paged_kernel!r} on the card")

    rng = np.random.default_rng(SEED)
    for rid in range(N_REQUESTS):
        n = int(rng.integers(PROMPT_LO, PROMPT_HI + 1))
        engine.submit(Request(rid, rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32),
                              max_new_tokens=MAX_NEW))

    records = []
    inner = engine.bundle.fn

    def recording(params, cache, tokens, tables, starts, n_valid):
        out = inner(params, cache, tokens, tables, starts, n_valid)
        records.append((tokens.clone(), tables.clone(), starts.clone(),
                        n_valid.clone(), out[0].clone()))
        return out

    engine.bundle.fn = recording
    step_s = []
    kernel_mod.LAUNCHES.reset()
    t0 = time.perf_counter()
    while engine.pending():
        steps_before = engine.steps
        t = time.perf_counter()
        engine.tick()
        if engine.steps > steps_before:
            step_s.append(time.perf_counter() - t)
        if engine.ticks > 2000:
            raise AssertionError("engine did not drain in 2000 ticks")
    wall = time.perf_counter() - t0
    launches = kernel_mod.LAUNCHES.count
    engine.bundle.fn = inner
    m = engine.metrics()
    tokens = sum(len(r.out_tokens) for r in engine.completed)
    summary = dict(requests=len(engine.completed), tokens=tokens, wall_s=wall,
                   tokens_per_s=tokens / wall, steps=engine.steps, ticks=engine.ticks,
                   step_p50_ms=float(np.median(step_s)) * 1e3,
                   step_p90_ms=float(np.percentile(step_s, 90)) * 1e3,
                   preemptions=m["preemptions"], launches=launches,
                   engine_launches=m["kernel_launches"],
                   nonfinite_logits=m["nonfinite_logits"],
                   peak_used_blocks=m["peak_used_blocks"],
                   live_token_fraction_mean=m["live_token_fraction_mean"],
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"[e2e] {json.dumps(summary)}")
    if len(engine.completed) != N_REQUESTS or any(
            len(r.out_tokens) != MAX_NEW for r in engine.completed):
        raise AssertionError("not every request completed with all its tokens")
    if launches != cfg.num_layers * engine.steps or launches != m["kernel_launches"]:
        raise AssertionError(f"{launches} kernel launches for {engine.steps} steps "
                             f"of {cfg.num_layers} layers")
    if m["nonfinite_logits"]:
        raise AssertionError(f"{m['nonfinite_logits']} emitted rows had non-finite logits")
    if m["preemptions"] < 1:
        raise AssertionError("the pool did not force a preemption")
    return engine, records, summary


def replay(torch, dev, engine, records):
    """Replay the recorded step inputs through kernel="ref" on the card:
    greedy agreement per emitted-or-prefill row, and one mixed step's logits
    on identical inputs (cloned cache) through both kernels."""
    from repro_torch.models import model as model_lib
    from repro_torch.models.kvcache import PagedLayout
    from repro_torch.runtime.steps import make_paged_serve_step

    cfg = engine.cfg
    ref_step = make_paged_serve_step(
        cfg, slots=SLOTS, chunk=CHUNK, num_blocks=NUM_BLOCKS, block_size=BLOCK,
        max_blocks_per_seq=engine.max_blocks_per_seq, kernel="ref", device=dev).fn
    cache = model_lib.init_paged_cache(cfg, NUM_BLOCKS, BLOCK, device=dev)
    # the logits check takes the step with the most prefill and decode rows
    mixed = max(range(len(records)), key=lambda i: (
        int(((records[i][3] > 1).sum() > 0) and ((records[i][3] == 1).sum() > 0)),
        int(records[i][3].sum())))
    agree = total = 0
    first = None
    logit_err = None
    for i, (tok, tab, st, nv, want) in enumerate(records):
        if i == mixed:
            outs = []
            for kind in ("cuda", "ref"):
                c = {"layers": [{k: v.clone() for k, v in lc.items()}
                                for lc in cache["layers"]]}
                with torch.no_grad():
                    lg, _ = model_lib.forward(cfg, engine.params, tok, cache=c,
                                              paged=PagedLayout(tab, st, nv, BLOCK),
                                              paged_kernel=kind)
                outs.append(lg)
            valid = torch.arange(CHUNK, device=dev)[None, :] < nv[:, None]
            if not torch.isfinite(outs[0][valid]).all():
                raise AssertionError("non-finite logits through the kernel")
            logit_err = (outs[0][valid] - outs[1][valid]).abs().max().item()
            scale = outs[1][valid].abs().max().item()
            log(f"[replay] step {i} (n_valid {nv.tolist()}): max |logits cuda - ref| "
                f"= {logit_err:.3e} on valid columns (max |logit| {scale:.3f}, "
                f"atol {LOGIT_ATOL})")
        got, cache = ref_step(engine.params, cache, tok, tab, st, nv)
        rows = (nv > 0).nonzero().squeeze(1).tolist()
        g, w = got.tolist(), want.tolist()
        for r in rows:
            total += 1
            if g[r] == w[r]:
                agree += 1
            elif first is None:
                first = (i, r)
    log(f"[replay] greedy agreement cuda vs ref on {len(records)} recorded steps: "
        f"{agree}/{total} rows ({agree / max(total, 1):.4f}); first divergence "
        f"(step, slot) = {first}")
    if logit_err is None or logit_err > LOGIT_ATOL:
        raise AssertionError(f"logits disagree: {logit_err} > {LOGIT_ATOL}")
    return dict(agree=agree, rows=total, first_divergence=first, logit_err=logit_err)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        return fail(f"{src / 'repro_torch'} not found: run from a checkout of the repo")
    sys.path.insert(0, str(src))
    from repro_torch.kernels.paged_attention import bench, ops
    from repro_torch.kernels.paged_attention import kernel as kernel_mod

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else f"{name}, power limit unknown (nvidia-smi rc={smi.returncode})"
    log(f"[device] {name} x{count}; torch {torch.__version__} cuda {torch.version.cuda}; {card}")

    t0 = time.perf_counter()
    lib = kernel_mod.build()
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.1f}s")
    report = lib.with_suffix(".log")
    for line in (report.read_text().splitlines() if report.exists() else []):
        if line.strip():
            log(f"[build] {line.strip()}")

    if (bench.SLOTS, bench.CHUNK, bench.BLOCK, bench.NUM_BLOCKS,
            bench.MAX_BLOCKS * bench.BLOCK) != (SLOTS, CHUNK, BLOCK, NUM_BLOCKS, MAX_LEN):
        raise AssertionError("the kernel check's shapes are not the engine's")
    entry = check_kernel(torch, ops, bench, dev)
    engine, records, summary = serve(torch, dev, kernel_mod)
    entry["launches"] = summary["launches"]
    rep = replay(torch, dev, engine, records)
    log(f"[e2e] {summary['tokens']} tokens in {summary['wall_s']:.2f}s = "
        f"{summary['tokens_per_s']:.1f} tokens/s, step p50 {summary['step_p50_ms']:.2f} ms, "
        f"{summary['steps']} steps, {summary['preemptions']} preemptions, greedy agreement "
        f"{rep['agree']}/{rep['rows']} on {name} ({card})")

    print(card, flush=True)
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:                       # report, then exit non-zero
        import traceback
        traceback.print_exc()
        sys.exit(fail(f"{type(exc).__name__}: {exc}"))
