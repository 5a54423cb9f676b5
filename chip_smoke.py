#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving paths on one CUDA card and check them.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases (any failure exits non-zero; with no card it fails at once; each
phase prints the seconds it took):

1. device: the card's name, count, and ``nvidia-smi`` name/power limit;
2. build: compile every kernel of both paths from ``src/`` (one ``nvcc``
   per source, all started together) and print ptxas's register /
   shared-memory / spill report;
3. kernel vs plain: call each kernel's wrapper at its path's shapes on the
   card and hold it against its plain PyTorch version (stated tolerance):
   paged attention at llama3.2-1b's heads (32/8 of 64) and at
   olmoe-1b-7b's (16/16 of 128), valid columns only, the tables holding
   entries that name no pool block inside live ranges; the moe_jam expert
   FFN at olmoe's buckets (64 experts x 40 rows x 2048, F 1024) with empty,
   partial and full experts. Each is timed (kernel, plain version, and one
   PyTorch library yardstick the port never calls) with the L2 cache
   flushed before every launch, as the serving loop finds it, and bounded
   by the bytes and operations this input needs;
4. end to end, ``llama3.2-1b``: a full-width paged ``Engine`` (16 layers,
   random bf16 weights from a seed) serves 12 requests with preemption;
   launch counts are read around exactly that run; the same step inputs
   are then replayed through ``kernel="ref"`` for greedy agreement, and
   one step's logits are compared on identical inputs;
5. end to end, ``olmoe-1b-7b``: the same for a full-width MoE engine (16
   layers, 64 experts, top-8, 6.9 B random bf16 parameters) on the same
   12 requests; every layer runs both kernels, so each kernel's launches
   must be 16 x steps;
6. the last line: ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import sys
import time
from pathlib import Path

import numpy as np

# the engine's geometry (and the kernel checks' shapes). With this traffic a
# 160-block pool peaks at 159 blocks and never preempts; 128 blocks preempt
# twice (the schedule depends on lengths only, not on the weights)
SLOTS, CHUNK, BLOCK, MAX_LEN, NUM_BLOCKS = 8, 32, 16, 1024, 128
N_REQUESTS, PROMPT_LO, PROMPT_HI, MAX_NEW, SEED = 12, 64, 384, 32, 0
ARCHS = ("llama3.2-1b", "olmoe-1b-7b")
# paged attention vs plain, per element: |kernel - plain| <= 2e-2 * (min(1,
# rms of the element's (request, column, head) row) + |plain|). bf16
# output, and p rounded to bf16 before P.V at different points
KERNEL_TOL = 2e-2
# moe_jam vs plain, per element: |kernel - plain| <= 1e-2 * (rms of the
# element's (expert, row) output row + |plain|) (``moe_jam.compare``): an
# output may land on the neighbouring bf16 value, at most 2^-7 of |plain|;
# empty rows must be exact zeros
MOE_TOL = 1e-2
# the replayed mixed step, on identical inputs. llama: every valid row's
# max over the vocab of |logit cuda - logit ref| within 2e-2 (logits ~0.13
# std at this init, tied head; bf16 x 16 layers). olmoe: its router turns
# bf16 noise into discrete changes (a token at a near-tie of its 8th and
# 9th expert takes the other one in some layer, and its request's later
# tokens see it through attention), so both bf16 paths are held against
# the plain path in float32 instead: the kernel path's median and mean row
# error (max |logit - logit_f32| over the vocab) within 1.5x the plain
# bf16 path's
LOGITS = {"llama3.2-1b": dict(atol=2e-2), "olmoe-1b-7b": dict(vs_f32=1.5)}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


class Phase:
    """Prints the seconds a phase took."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        log(f"[phase] {self.name}: {time.perf_counter() - self.t0:.1f}s")


def check_paged(torch, dev, *, arch, heads, kv_heads, head_dim):
    """Phase 3 for paged attention at one path's heads; returns its JSON
    entry (without ``launches``)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import timing
    from repro_torch.kernels.paged_attention import bench

    args = bench.check_inputs(dev, heads=heads, kv_heads=kv_heads, head_dim=head_dim)
    q, kp, vp, tables, starts, n_valid = args
    max_err = 0.0
    for w in (None, 128):
        out = pa.paged_attention(*args, block_size=BLOCK, window=w)
        ref = pa.paged_attention_ref(*args, block_size=BLOCK, window=w)
        torch.cuda.synchronize()
        if not torch.isfinite(out.float()).all():
            raise AssertionError(f"kernel output has NaN/inf (window={w})")
        err, worst, bad = pa.compare_valid(out, ref, n_valid, tol=KERNEL_TOL)
        log(f"[kernel] paged_attention {heads}/{kv_heads}x{head_dim} window={w}: max "
            f"|kernel - plain| on valid columns = {err:.3e}, largest share of the "
            f"allowed error {worst:.3f} ({bad} elements over {KERNEL_TOL} x "
            f"(min(1, row rms) + |plain|))")
        if bad:
            raise AssertionError(f"kernel disagrees with the plain version (window={w})")
        max_err = max(max_err, err)

    B, C, H, D = q.shape
    K = kp.shape[2]
    flush = timing.l2_flush_buffer(dev)
    ms = timing.timed_ms(lambda: pa.paged_attention(*args, block_size=BLOCK), 200, flush)
    plain_ms = timing.timed_ms(lambda: pa.paged_attention_ref(*args, block_size=BLOCK),
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
    library_ms = timing.timed_ms(lambda: sdpa(qd, kd, vd, attn_mask=mask), 200, flush)
    del flush

    work = bench.needed_work(tables.cpu().numpy(), starts.cpu().numpy(),
                             n_valid.cpu().numpy(), num_blocks=kp.shape[0],
                             block_size=BLOCK, heads=H, kv_heads=K, head_dim=D)
    bound, bound_by = timing.bound_ms(work)
    log(f"[kernel] paged_attention {heads}/{kv_heads}x{head_dim} timing (L2 flushed per "
        f"launch): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA on pre-gathered view "
        f"{library_ms:.4f} ms; needed bytes {work['bytes']} ({work['kv_bytes']} K/V) -> "
        f"{work['bytes'] / timing.HBM_BYTES_PER_S * 1e3:.5f} ms at 3.35 TB/s; "
        f"{work['flops']} flops over {work['keys']} visible keys -> "
        f"{work['flops'] / timing.BF16_FLOPS_PER_S * 1e3:.5f} ms at 989 TFLOP/s")
    return {
        "name": "paged_attention", "route": "cuda", "path": arch,
        "source": "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:108",
        "launches": None, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": library_ms,
    }


def check_moe_jam(torch, dev, cfg):
    """Phase 3 for the moe_jam expert FFN at olmoe's bucket shape; returns
    its JSON entry (without ``launches``)."""
    from repro_torch.kernels import moe_jam as mj
    from repro_torch.kernels import timing
    from repro_torch.kernels.moe_jam import bench as mbench
    from repro_torch.models.moe import expert_capacity

    m = cfg.moe
    shape = (m.num_experts, expert_capacity(SLOTS * CHUNK, m), cfg.d_model, m.expert_ff)
    if shape != (mbench.EXPERTS, mbench.CAPACITY, mbench.D_MODEL, mbench.D_FF):
        raise AssertionError(f"the moe_jam check's shape is not the engine's {shape}")
    counts_np = mbench.check_counts()
    x, wg, wu, wd, counts = mbench.check_inputs(dev, counts_np)
    log(f"[kernel] moe_jam input: {tuple(x.shape)} buckets, kept rows per expert "
        f"{counts_np.tolist()}")
    out = mj.moe_jam_ffn(x, wg, wu, wd, "silu", counts=counts)
    ref = mj.moe_jam_ffn_ref(x, wg, wu, wd, "silu", counts=counts)
    torch.cuda.synchronize()
    max_err, worst, bad = mj.compare(out, ref, tol=MOE_TOL)
    empty = ~(torch.arange(x.shape[1], device=dev)[None, :] < counts[:, None])
    nonzero_empty = int((out[empty] != 0).sum())
    log(f"[kernel] moe_jam silu: max |kernel - plain| = {max_err:.3e}, largest share of "
        f"the allowed error {worst:.3f} ({bad} elements over {MOE_TOL} x (row rms + "
        f"|plain|)); {nonzero_empty} non-zero elements in empty rows")
    if bad or nonzero_empty:
        raise AssertionError("moe_jam disagrees with the plain version")

    flush = timing.l2_flush_buffer(dev)
    ms = timing.timed_ms(lambda: mj.moe_jam_ffn_cuda(x, wg, wu, wd, counts=counts), 50, flush)
    plain_ms = timing.timed_ms(lambda: mj.moe_jam_ffn_ref(x, wg, wu, wd, counts=counts),
                               10, flush)
    library_ms = timing.timed_ms(lambda: mbench.yardstick(x, wg, wu, wd), 50, flush)
    del flush, x, wg, wu, wd
    work = mbench.needed_work(counts_np, d_model=cfg.d_model, d_ff=m.expert_ff)
    bound, bound_by = timing.bound_ms(work)
    log(f"[kernel] moe_jam timing (L2 flushed per launch): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, 3 x bmm + act {library_ms:.4f} ms; needed bytes "
        f"{work['bytes']} ({work['weight_bytes']} weights of {work['experts']} experts, "
        f"{work['rows']} kept rows) -> {work['bytes'] / timing.HBM_BYTES_PER_S * 1e3:.5f} "
        f"ms at 3.35 TB/s; {work['flops']} flops -> "
        f"{work['flops'] / timing.BF16_FLOPS_PER_S * 1e3:.5f} ms at 989 TFLOP/s")
    return {
        "name": "moe_jam", "route": "cuda", "path": cfg.name,
        "source": "src/repro_torch/kernels/moe_jam/csrc/moe_jam.cu",
        "replaces": "src/repro/kernels/moe_jam/kernel.py:62",
        "launches": None, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": library_ms,
    }


def serve(torch, dev, arch):
    """Phase 4/5: the full-width engine; returns (engine, step records,
    summary)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.engine import Engine, Request
    from repro_torch.models.model import flat_block_types
    from repro_torch.runtime.steps import LAUNCH_COUNTERS

    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    engine = Engine(cfg, device=dev, cache="auto", kernel="auto", slots=SLOTS,
                    max_len=MAX_LEN, num_blocks=NUM_BLOCKS, block_size=BLOCK,
                    chunk=CHUNK)
    t0 = time.perf_counter()
    engine.load_params(seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(engine.params))
    a = cfg.attention
    moe = (f", {cfg.moe.num_experts} experts top-{cfg.moe.top_k} of {cfg.moe.expert_ff}"
           if cfg.moe else "")
    log(f"[e2e] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{a.num_heads}/{a.num_kv_heads} heads of {a.head_dim}{moe}, vocab "
        f"{cfg.vocab_size}, {n_params} bf16 params drawn in "
        f"{time.perf_counter() - t0:.1f}s; cache={engine.cache_kind}, "
        f"kernels={engine.paged_kernel}")
    if engine.paged_kernel != "cuda" or engine.cache_kind != "paged":
        raise AssertionError(f"auto resolved to {engine.paged_kernel!r} / "
                             f"{engine.cache_kind!r} on the card")
    # launches each kernel makes per step on this path
    per_step = {"paged_attention": cfg.num_layers,
                "moe_jam": sum(bt.endswith("_moe") for bt in flat_block_types(cfg))}

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
    for counter in LAUNCH_COUNTERS.values():
        counter.reset()
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
    launches = {name: c.count for name, c in LAUNCH_COUNTERS.items()}
    engine.bundle.fn = inner
    m = engine.metrics()
    tokens = sum(len(r.out_tokens) for r in engine.completed)
    summary = dict(arch=arch, requests=len(engine.completed), tokens=tokens, wall_s=wall,
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
    for name, n in per_step.items():
        if launches[name] != n * engine.steps or launches[name] != m["kernel_launches"][name]:
            raise AssertionError(f"{launches[name]} {name} launches for {engine.steps} "
                                 f"steps of {n} layers that run it")
    if m["nonfinite_logits"]:
        raise AssertionError(f"{m['nonfinite_logits']} emitted rows had non-finite logits")
    if m["preemptions"] < 1:
        raise AssertionError("the pool did not force a preemption")
    return engine, records, summary


def replay(torch, dev, engine, records):
    """Replay the recorded step inputs through kernel="ref" on the card:
    greedy agreement per emitted-or-prefill row, and one mixed step's logits
    on identical inputs (``_mixed_step``)."""
    from repro_torch.models import model as model_lib
    from repro_torch.runtime.steps import make_paged_serve_step

    cfg = engine.cfg
    rule = LOGITS[cfg.name]
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
    logit = None
    for i, (tok, tab, st, nv, want) in enumerate(records):
        if i == mixed:
            logit = _mixed_step(torch, dev, engine, cache, i, tok, tab, st, nv, rule)
        got, cache = ref_step(engine.params, cache, tok, tab, st, nv)
        rows = (nv > 0).nonzero().squeeze(1).tolist()
        g, w = got.tolist(), want.tolist()
        for r in rows:
            total += 1
            if g[r] == w[r]:
                agree += 1
            elif first is None:
                first = (i, r)
    log(f"[replay] {cfg.name} greedy agreement cuda vs ref on {len(records)} recorded "
        f"steps: {agree}/{total} rows ({agree / max(total, 1):.4f}); first divergence "
        f"(step, slot) = {first}")
    if logit is None or not logit["ok"]:
        raise AssertionError(f"logits disagree: {logit}")
    return dict(agree=agree, rows=total, first_divergence=first, logits=logit)


def _mixed_step(torch, dev, engine, cache, i, tok, tab, st, nv, rule):
    """One step's logits on identical inputs (cloned cache) through the
    kernels and the plain versions in bf16, and for a ``vs_f32`` rule the
    plain versions in float32; returns the numbers and ``ok``."""
    from repro_torch.models import model as model_lib
    from repro_torch.models.kvcache import PagedLayout

    runs = [("cuda", torch.bfloat16), ("ref", torch.bfloat16)]
    if "vs_f32" in rule:
        runs.append(("ref", torch.float32))
    valid = torch.arange(CHUNK, device=dev)[None, :] < nv[:, None]
    outs = []
    for kind, dtype in runs:
        c = {"layers": [{k: v.clone() for k, v in lc.items()} for lc in cache["layers"]]}
        with torch.no_grad():
            lg, _, _ = model_lib.forward(engine.cfg, engine.params, tok, cache=c,
                                         paged=PagedLayout(tab, st, nv, BLOCK),
                                         paged_kernel=kind, compute_dtype=dtype)
        outs.append(lg[valid])
        del c
    if not torch.isfinite(outs[0]).all():
        raise AssertionError("non-finite logits through the kernels")
    rows = int(valid.sum())
    head = (f"[replay] step {i} (n_valid {nv.tolist()}), {rows} valid rows, max |logit| "
            f"{outs[1].abs().max().item():.3f}")
    if "atol" in rule:
        err = (outs[0] - outs[1]).abs().amax(-1)
        out = dict(step=i, rows=rows, max_err=err.max().item(),
                   agree=int((err <= rule["atol"]).sum()))
        out["ok"] = out["agree"] == rows
        log(f"{head}: max |logits cuda - ref| = {out['max_err']:.3e}; rows within atol "
            f"{rule['atol']}: {out['agree']}/{rows}")
        return out
    f32 = outs[2]
    err_c = (outs[0] - f32).abs().amax(-1)
    err_r = (outs[1] - f32).abs().amax(-1)
    out = dict(step=i, rows=rows,
               median_cuda=err_c.median().item(), median_ref=err_r.median().item(),
               mean_cuda=err_c.mean().item(), mean_ref=err_r.mean().item(),
               max_cuda=err_c.max().item(), max_ref=err_r.max().item(),
               max_cuda_vs_ref=(outs[0] - outs[1]).abs().max().item(),
               argmax_cuda=int((outs[0].argmax(-1) == f32.argmax(-1)).sum()),
               argmax_ref=int((outs[1].argmax(-1) == f32.argmax(-1)).sum()))
    k = rule["vs_f32"]
    out["ok"] = (out["median_cuda"] <= k * out["median_ref"]
                 and out["mean_cuda"] <= k * out["mean_ref"])
    log(f"{head}: row error max |logit - logit_f32| of the kernels' bf16 path: median "
        f"{out['median_cuda']:.4f}, mean {out['mean_cuda']:.4f}, max {out['max_cuda']:.4f}; "
        f"of the plain bf16 path: median {out['median_ref']:.4f}, mean "
        f"{out['mean_ref']:.4f}, max {out['max_ref']:.4f} (kernel path within {k}x of it "
        f"required); argmax equal to float32's: {out['argmax_cuda']}/{rows} kernels, "
        f"{out['argmax_ref']}/{rows} plain; max |cuda - ref| {out['max_cuda_vs_ref']:.4f}")
    return out


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
    from repro_torch.configs.registry import get_config
    from repro_torch.device import strict_fp32
    from repro_torch.kernels import loader, timing
    from repro_torch.kernels.moe_jam import kernel as mj_kernel
    from repro_torch.kernels.paged_attention import bench
    from repro_torch.kernels.paged_attention import kernel as pa_kernel

    t_start = time.perf_counter()
    strict_fp32()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = timing.card_name()
    log(f"[device] {name} x{count}; torch {torch.__version__} cuda {torch.version.cuda}; {card}")

    with Phase("build"):
        libs = loader.build_all([pa_kernel.SOURCE, mj_kernel.SOURCE])
        for lib in libs.values():
            log(f"[build] {lib.name}")
            report = lib.with_suffix(".log")
            for line in (report.read_text().splitlines() if report.exists() else []):
                if line.strip():
                    log(f"[build] {line.strip()}")

    if (bench.SLOTS, bench.CHUNK, bench.BLOCK, bench.NUM_BLOCKS,
            bench.MAX_BLOCKS * bench.BLOCK) != (SLOTS, CHUNK, BLOCK, NUM_BLOCKS, MAX_LEN):
        raise AssertionError("the kernel check's shapes are not the engine's")
    entries = {}
    with Phase("kernel vs plain"):
        for arch in ARCHS:
            a = get_config(arch).attention
            entries[("paged_attention", arch)] = check_paged(
                torch, dev, arch=arch, heads=a.num_heads, kv_heads=a.num_kv_heads,
                head_dim=a.head_dim)
        entries[("moe_jam", "olmoe-1b-7b")] = check_moe_jam(torch, dev,
                                                            get_config("olmoe-1b-7b"))
        torch.cuda.empty_cache()

    for arch in ARCHS:
        with Phase(f"end to end {arch}"):
            engine, records, summary = serve(torch, dev, arch)
            rep = replay(torch, dev, engine, records)
            for (kname, path), entry in entries.items():
                if path == arch:
                    entry["launches"] = summary["launches"][kname]
            log(f"[e2e] {arch}: {summary['tokens']} tokens in {summary['wall_s']:.2f}s = "
                f"{summary['tokens_per_s']:.1f} tokens/s, step p50 "
                f"{summary['step_p50_ms']:.2f} ms, {summary['steps']} steps, "
                f"{summary['preemptions']} preemptions, peak "
                f"{summary['peak_mem_gb']:.2f} GB, greedy agreement "
                f"{rep['agree']}/{rep['rows']} on {name} ({card})")
            del engine, records
            gc.collect()              # request handles and the engine form cycles
            torch.cuda.empty_cache()
    log(f"[phase] total: {time.perf_counter() - t_start:.1f}s")

    print(card, flush=True)
    print(json.dumps({"kernels": list(entries.values())}), flush=True)
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
