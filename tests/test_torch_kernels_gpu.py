"""The port's CUDA kernels on the card (marker ``gpu``; they skip without one).

These tests import no JAX, so they run on a machine that has only the
port's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

* the paged-attention kernel against its plain version over table holes
  (past the live blocks, and inside the live range: -1 and ids past the
  pool), reused blocks, n_valid in {0, 1, C}, window on/off, block sizes,
  group sizes and head dims (16, 64, 66, 128 at G = 1 as olmoe-1b-7b has
  it, 256), valid columns only; each element within 2e-2 * (min(1, its
  row's rms) + |plain|) (bf16 output; p rounded to bf16 before P.V), never
  looser than atol = rtol = 2e-2; rows of 1,000+ keys over many splits
  with and without a window of 128, decode-only and prefill-only batches,
  the olmoe-1b-7b heads (16/16 x 128), every split count from 1 to 32,
  two launches that must give the same bits (the splits' scratch carries
  nothing from one call to the next), and a column that sees no key
  against the split form in plain PyTorch;
* the moe_jam expert-FFN kernel against its plain version at the smoke's
  and the serving engine's bucket shapes and at uneven ones (C not a
  multiple of 16, C = 65 and 130 past one and two 64-row tiles, D and F
  96 and 160, one expert), silu and gelu, with empty, partial and full
  experts and without counts; the engine shape under the bench's three
  fills; x rows past counts filled with NaN (kept rows as on the zeroed
  bucket, rows past counts exact zeros); each element within
  1e-2 * (rms of its (expert, row) output row + |plain|) (bf16 output of
  the same float32 sums in another order: the neighbouring bf16 value at
  most), empty rows exactly zero;
* the selective-scan kernel against its plain version with channels not a
  multiple of its 64-channel tile (130, 200, 1,600), N 4, 8 and 16, 1, 9
  and 40 steps (a ragged 8-step stage, more stages than the ring's 4
  slots), n_valid 0 / 1 / partial / full, on both routes (TMA, and
  direct where a map cannot take the shape or a base is off 16 bytes):
  ``y`` on valid columns within 1e-2 * (rms of its (row, column) +
  |plain|) (the same float32 sum, with and without fused multiply-adds,
  rounded to bf16), zeros past n_valid, ``h_last`` within 1e-4 * (1 +
  |plain|), ``h0`` bit for bit on empty rows; a second launch from the
  first one's ``h_last`` equals one launch over both chunks, bit for bit,
  on both routes; the slots backend's single-row prefill (1 x 2,113 and
  4,096 tokens x 1,536 and 3,200 channels, N 16, no valid gate, h0 None);
  mamba's and hymba's smokes on the slots engine through the kernels;
* the ring put kernel against its plain version, exactly (integers): 1,
  2, 3 and 8 ranks, shifts 1, 2, n - 1 and n + 1, 1 frame to 20,000
  (53 chunks of 48 KiB, several to a cluster), WFE and poll, stashed (with
  and without the fused sum) and not; spins 0 where the plain version
  says 0, in [1, 2^20) where its poll finds the SIG word, and exactly
  2^20 on every rank when the last frame's SIG word is zeroed; the fused
  sum over USR widths 1 to 8,192;
* the Server-Side Sum and Indirect Put kernels against their plain
  versions, exactly (integers): N of 1, 33 and 1000, USR widths 1, 15,
  16, 64 and 1024 at an offset that is and one that is not 16-byte
  aligned, sums that wrap; the sum's two routes (wide: a CTA a frame;
  scalar) at USR offsets 0, 12 and 13, widths 0, 1, 3, 4, 16, 17, 32, 64,
  128, 300 and 8,192, N of 1, 7, 255 and 2^20 + 3, and frames 4 bytes off
  a 16-byte boundary; keys at
  int32's extremes and negative, tables of 1 row (every frame on one
  row), 7 and 4096 rows, heap bases 0, -5
  and 2^31 - 1; collision-heavy puts (every frame on one row, all rows
  distinct, two rows in turn, one table row, one frame) at heap bases 0,
  slots - 1 and +-(2^31 - 1), bit for bit; 2^20 frames with hot keys,
  twice, equal shards (determinism under the claim's atomics) and no
  scratch beyond the claim table; the frame path's fabric on the card
  against the same fabric on the CPU;
* the flash-attention kernel against its plain version over head dims
  16, 80, 128 and 256, 1, 2, 8 and 48 query heads per kv head, 1, 33 and
  2,113 positions, each causal, with a window of 17, at q_offset 7 and
  bidirectional, strided (the model's layout) and contiguous; at D 256
  G 2, 127, 129 and 4,096 positions with a window of 1,024 at q_offset 7
  and without, strided and contiguous; the design at each head dim it
  serves (v2, TMA + wgmma, at 16, 64, 80, 128 and 256); hymba-1.5b's heads
  (25 over 5 of 64, G 5) at 2,113 and 4,096 positions, causal, with its
  window of 1,024 and without; each
  element within 2e-2 * (rms of its (batch, head, position) row + |plain|)
  (bf16 outputs; the kernel rounds the unnormalized p to bf16 before P.V,
  the plain version the normalized probabilities);
* flash attention at MLA's separate widths (q and k of 192, v of 128,
  deepseek-v2-lite-16b's full-rank prefill): 1, 65, 2,113 and 4,096
  positions, 1 and 2 query heads per kv head, causal, from q_offset 7 and
  bidirectional, strided and contiguous, output (B, Hq, S, 128); the
  wrapper refuses a (D, Dv) pair with no instance; moe_jam at deepseek's
  buckets (64 experts of 2048 x 1408, top-6) at capacity 8 and 480;
* the wrappers' input checks;
* the smoke engines through the kernels against the same engines through
  the plain versions: identical schedule, one launch of each kernel per
  layer per step (per layer per long prefill for the slots engine; for
  the MLA engine also moe_jam per MoE layer per prefill and decode tick;
  for the mamba and hymba smokes on slots the scan per state layer per
  prefill and decode tick);
* flash at qwen2-vl-72b's heads (64/8 of 128, G 8, causal) and
  hubert-xlarge's encoder (16 heads of 80, no causal mask, every tile
  visited, none masked) over 4,096 keys, and at hubert's heads over 129
  and 4,096 frames, strided and dense; qwen's smoke on ``Engine(cache="auto")``
  and a vision prefill (patches spliced, 3-D positions), and hubert's
  smoke through the prefill step, each through the kernel (threshold
  lowered) and through the plain version;
* live migration on the card: two paged llama smoke replicas and two
  recurrent mamba ones behind the ``Router``, a request moved mid-prefill
  and one in decode, tokens identical to a solo run;
* draft -> verify speculation (ngram, k 2 and 4) on a paged llama smoke
  engine through the kernel, tokens identical to target-only decode, the
  kernel launched once a layer per step and per verify step;
* flash attention's backward kernel against autograd through the plain
  version in float32 at D 64 and 128, G 1, 4 and 8, 77 and 1,111
  positions, causal, windowed, from q_offset 7 and bidirectional (rms
  error within 1.5x the plain bf16 path's, max within 2e-2 of max |grad|);
  two launches bit for bit equal; the forward's log-sum-exp against
  ``logsumexp`` of the plain scores (every instance) with the output
  unchanged; widths with no backward instance refused; the wrappers of
  paged attention, moe_jam and the scan (and ``flash_attention_cuda``
  itself) refusing grad, ``make_train_step`` refusing on the card xlstm and
  gemma3's smoke at 4,096 tokens (flash at D 16 has no backward instance);
  two train steps of a 2-layer D 64 config on the card (bf16,
  flash kernels) against the same steps on the CPU in float32;
* the moe_jam backward kernel (dx and the three weight gradients) against
  its plain version on the same bf16 inputs (``moe_jam.compare``'s form,
  ``MOE_BWD_TOL`` for dx, ``MOE_DW_TOL`` for the weights) and against
  float32 (relative L2 error within ``BWD_VS_PLAIN`` x the plain bf16
  path's), silu and gelu, at the
  forward's uneven shapes, deepseek-v2-lite-16b's F 1,408 and olmoe's
  engine buckets, with empty, partial and full experts: dx rows past
  counts exactly zero, an empty expert's weight gradients exactly zero,
  NaN in x and dy past counts never reaching a sum; two launches bit for
  bit equal; ``moe_jam_ffn`` under grad through ``MoeJamFn`` (one launch
  of each kernel, the backward's gradients those of the autograd graph);
  two train steps of the olmoe smoke on the card (both MoE kernels)
  against the same steps on the CPU in float32;
* the selective scan's backward kernel (ddt, db, dc, dx, da, dh0 from the
  training forward's chunk states) against its plain version on the same
  bf16 inputs and on them cast to float32 (``ssm_scan.compare_bwd``: each
  gradient within 2e-2 of its max |grad| of the plain version, its L2
  error against float32 within 1.5x the plain bf16 path's for the bf16
  outputs and 1e-4 for da and dh0) at S 1, 7, 8, 9, 33 and 4,096, I not a
  multiple of 64, N 4, 8 and 16, ragged n_valid with 0 and 1, on both of
  the forward's routes; gated columns exact zeros; the training forward's
  y and h_last bit for bit the serving forward's; two launches bit for
  bit equal; ``ssm_scan`` under grad through ``SsmScanFn`` (one launch of
  each kernel, the backward's gradients those of the autograd graph); two
  train steps of the mamba and hymba smokes (N widened to 16, remat
  full) on the card against the same steps on the CPU in float32.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_smoke
from repro_torch.engine import Engine, Request
from repro_torch.core.message import FrameSpec, pack_frames
from repro_torch.kernels import mailbox, moe_jam, ssm_scan
from repro_torch.kernels.paged_attention import kernel as paged_kernel
from repro_torch.kernels.paged_attention import (LAUNCHES, compare_valid,
                                                 paged_attention,
                                                 paged_attention_cuda,
                                                 paged_attention_ref,
                                                 paged_attention_split_ref)

BF16_TOL = 2e-2
MOE_TOL = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _case(rng, *, bs, B, C, K, G, D, M):
    N = B * M + 2
    starts = rng.integers(0, M * bs - C + 1, size=B).astype(np.int32)
    starts[0] = 0
    n_valid = rng.choice([0, 1, C], size=B).astype(np.int32)
    tables = rng.integers(0, N, size=(B, M)).astype(np.int32)     # reuse allowed
    for b in range(B):
        tables[b, -(-int(starts[b] + n_valid[b]) // bs):] = -1
        if starts[b] >= 2 * bs:      # inside the live range, before the chunk
            tables[b, 0], tables[b, 1] = -1, N + 1
    q = rng.normal(size=(B, C, K * G, D)).astype(np.float32)
    kp = rng.normal(size=(N, bs, K, D)).astype(np.float32)
    vp = rng.normal(size=(N, bs, K, D)).astype(np.float32)
    return q, kp, vp, tables, starts, n_valid


def _on(dev, arrays):
    q, kp, vp, tb, st, nv = (torch.from_numpy(a).to(dev) for a in arrays)
    return (q.to(torch.bfloat16), kp.to(torch.bfloat16), vp.to(torch.bfloat16),
            tb, st, nv)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("bs,G,D,C", [(4, 1, 16, 4), (16, 4, 64, 32), (8, 2, 256, 8),
                                      (16, 4, 66, 3), (5, 8, 64, 9), (16, 1, 128, 32)])
def test_kernel_matches_plain_version(cuda, bs, G, D, C, window):
    args = _on(cuda, _case(np.random.default_rng(bs * G + D), bs=bs, B=5, C=C, K=2,
                           G=G, D=D, M=6))
    before = LAUNCHES.count
    got = paged_attention(*args, block_size=bs, window=window)
    want = paged_attention_ref(*args, block_size=bs, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES.count == before + 1
    assert torch.isfinite(got.float()).all()
    err, worst, bad = compare_valid(got, want, args[5], tol=BF16_TOL)
    assert bad == 0, (err, worst)
    valid = (torch.arange(C, device=cuda)[None, :] < args[5][:, None])[:, :, None, None]
    # columns past n_valid are written as zeros, not left uninitialized
    assert (torch.where(valid, 0.0, got.float()) == 0).all()


def _long_rows(rng, *, kind, H, K, D, B=6, C=32, bs=16, M=80):
    """Requests of up to 1,280 keys (M * bs) in splits of 128: ``mixed``
    prefill chunks and decode rows deep into the table, ``decode`` rows
    only (n_valid 1, one idle), ``prefill`` chunks only; holes (-1, an id
    past the pool) inside the live ranges, before each chunk."""
    N = B * M + 3
    if kind == "decode":
        starts = np.asarray([1100, 999, 0, 1278, 640, 5], np.int32)[:B]
        n_valid = np.asarray([1, 1, 1, 1, 0, 1], np.int32)[:B]
    elif kind == "prefill":
        starts = np.asarray([1000, 0, 1248, 480, 129, 700], np.int32)[:B]
        n_valid = np.asarray([C, C, C, 17, C, 5], np.int32)[:B]
    else:
        starts = np.asarray([1200, 0, 1023, 900, 37, 1248], np.int32)[:B]
        n_valid = np.asarray([1, C, 1, 24, 0, C], np.int32)[:B]
    tables = np.stack([rng.permutation(N)[:M] for _ in range(B)]).astype(np.int32)
    for b in range(B):
        tables[b, -(-int(starts[b] + n_valid[b]) // bs):] = -1
        if starts[b] >= 400:
            tables[b, 3], tables[b, (int(starts[b]) - 60) // bs] = -1, N + 2
    q = rng.normal(size=(B, C, H, D)).astype(np.float32)
    kp = rng.normal(size=(N, bs, K, D)).astype(np.float32)
    vp = rng.normal(size=(N, bs, K, D)).astype(np.float32)
    return q, kp, vp, tables, starts, n_valid


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 128])
@pytest.mark.parametrize("heads", [(32, 8, 64), (16, 16, 128)])
@pytest.mark.parametrize("kind", ["mixed", "decode", "prefill"])
def test_kernel_long_rows_over_many_splits(cuda, kind, heads, window):
    """llama3.2-1b's and olmoe-1b-7b's heads, rows of 1,000+ keys over the
    10 splits of a 1,280-key table, against the plain version."""
    H, K, D = heads
    args = _on(cuda, _long_rows(np.random.default_rng(H + D), kind=kind, H=H, K=K, D=D))
    before = LAUNCHES.count
    got = paged_attention(*args, block_size=16, window=window)
    want = paged_attention_ref(*args, block_size=16, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES.count == before + 1
    assert torch.isfinite(got.float()).all()
    err, worst, bad = compare_valid(got, want, args[5], tol=BF16_TOL)
    assert bad == 0, (err, worst)
    valid = (torch.arange(args[0].shape[1], device=cuda)[None, :]
             < args[5][:, None])[:, :, None, None]
    assert (torch.where(valid, 0.0, got.float()) == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("kps", [1280, 640, 256, 128, 80, 48, 40])
def test_kernel_every_split_count(cuda, kps):
    """1, 2, 5, 10, 16, 27 and 32 splits (splits that end inside a block,
    and inside a 32-key ring tile) give the plain version's result."""
    args = _on(cuda, _long_rows(np.random.default_rng(kps), kind="mixed", H=8, K=2, D=64))
    got = paged_kernel._launch(*args, 16, 128, None, kps)
    want = paged_attention_ref(*args, block_size=16, window=128)
    torch.cuda.synchronize()
    err, worst, bad = compare_valid(got, want, args[5], tol=BF16_TOL)
    assert bad == 0, (kps, err, worst)


@pytest.mark.gpu
def test_kernel_twice_gives_the_same_bits(cuda):
    """The splits' partials live in scratch that the wrapper allocates per
    call: a second launch on the same inputs, after a call on other inputs
    that filled the allocator's blocks with other partials, is bit for bit
    the first."""
    rng = np.random.default_rng(11)
    args = _on(cuda, _long_rows(rng, kind="mixed", H=32, K=8, D=64))
    other = _on(cuda, _long_rows(rng, kind="prefill", H=32, K=8, D=64))
    first = paged_attention(*args, block_size=16)
    paged_attention(*other, block_size=16)
    second = paged_attention(*args, block_size=16)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_kernel_row_that_sees_no_key(cuda):
    """A column whose own key lies in a table hole and whose window of 1
    reaches no other key gets the mean of its live range's V rows, holes
    counting as zero rows, as the split form in plain PyTorch says (and
    v4 gave); its neighbour sees its key."""
    rng = np.random.default_rng(3)
    q, kp, vp, tb, _, _ = _long_rows(rng, kind="mixed", H=4, K=1, D=64)
    tb = np.stack([rng.permutation(kp.shape[0])[:tb.shape[1]] for _ in tb]).astype(np.int32)
    st = np.full(6, 207, np.int32)
    nv = np.full(6, 2, np.int32)
    tb[:, 208 // 16:] = -1                      # the column at 208 is in a hole
    args = _on(cuda, (q, kp, vp, tb, st, nv))
    for kps in (None, 1280):
        got = paged_kernel._launch(*args, 16, 1, None, kps)
        want = paged_attention_split_ref(*args, block_size=16, window=1, keys_per_split=kps)
        torch.cuda.synchronize()
        err, worst, bad = compare_valid(got, want, args[5], tol=BF16_TOL)
        assert bad == 0, (kps, err, worst)


@pytest.mark.gpu
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    args = _on(cuda, _case(np.random.default_rng(0), bs=4, B=2, C=2, K=1, G=2, D=16, M=3))
    with pytest.raises(ValueError, match="bfloat16"):
        paged_attention_cuda(args[0].float(), *args[1:], block_size=4)
    with pytest.raises(ValueError, match="int32"):
        paged_attention_cuda(*args[:3], args[3].long(), *args[4:], block_size=4)
    with pytest.raises(ValueError, match="does not fit"):
        paged_attention_cuda(*args, block_size=8)
    with pytest.raises(ValueError, match="contiguous"):
        paged_attention_cuda(args[0].transpose(1, 2), *args[1:], block_size=4)


@pytest.mark.gpu
def test_smoke_engine_through_kernel(cuda):
    cfg = get_smoke("llama3.2-1b")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=(10,)).astype(np.int32) for _ in range(3)]
    runs = {}
    for kernel in ("cuda", "ref"):
        e = Engine(cfg, device=cuda, kernel=kernel, slots=2, max_len=32, num_blocks=10,
                   block_size=4, chunk=4)
        e.load_params(seed=0)
        for rid, p in enumerate(prompts):
            e.submit(Request(rid, p, max_new_tokens=14))
        e.run_until_drained()
        m = e.metrics()
        runs[kernel] = (e.admission_log, e.ticks, e.preempt_count, m)
    (log_c, ticks_c, pre_c, m_c), (log_r, ticks_r, pre_r, m_r) = runs["cuda"], runs["ref"]
    assert (log_c, ticks_c, pre_c) == (log_r, ticks_r, pre_r) and pre_c >= 1
    assert m_c["kernel_launches"] == {"paged_attention": cfg.num_layers * m_c["steps"],
                                      "moe_jam": 0}
    assert m_r["kernel_launches"] == {"paged_attention": 0, "moe_jam": 0}
    assert m_c["nonfinite_logits"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("arch,geom,plen", [
    ("llama3.2-1b", dict(cache="paged", slots=2, max_len=32, num_blocks=16, block_size=4,
                         chunk=4), 11),
    ("mamba-130m", dict(cache="recurrent", slots=2, max_len=48, chunk=4), 7)])
def test_migration_on_the_card_matches_solo(cuda, arch, geom, plen):
    """Two replicas on the card (one weight tree) behind the Router: a
    request migrated mid-prefill (after 1 tick) and one in decode (after 4)
    emit the tokens of their solo run on a third engine, and both
    replicas' steps launch their kernel once a layer a step."""
    from repro_torch.cluster import Replica, Router

    cfg = get_smoke(arch)
    kname = "paged_attention" if geom["cache"] == "paged" else "ssm_scan"
    engines = []
    for i in range(3):
        e = Engine(cfg, device=cuda, kernel="cuda", engine_id=f"gpu-{i}", **geom)
        e.inject_params(engines[0].params if engines else None, seed=0)
        engines.append(e)
    solo, a, b = engines
    rng = np.random.default_rng(7)
    for rid, ticks in enumerate((1, 4)):
        prompt = rng.integers(0, cfg.vocab_size, size=(plen,)).astype(np.int32)
        for e in engines:
            e.restart()
        want = solo.submit(Request(rid, prompt, max_new_tokens=6)).result().out_tokens
        router = Router([Replica(a), Replica(b)])
        h = router.submit(Request(rid, prompt, max_new_tokens=6))
        for _ in range(ticks):
            router.tick()
        router.migrate(rid, b.engine_id)
        router.run_until_drained()
        assert h.req.out_tokens == want
        mig = router.migrations[0]
        assert mig["state_bytes"] > 0 and (mig["pos"] < plen) == (ticks == 1)
    for e in (a, b):
        m = e.metrics()
        assert m["kernel_launches"][kname] == cfg.num_layers * m["steps"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2, 4])
def test_speculation_on_the_card_matches_target_only(cuda, k):
    """Draft -> verify speculation (ngram) on a paged llama smoke engine
    through the CUDA paged-attention kernel emits the tokens of target-only
    greedy decode on a second engine with the same weights; the target's
    kernel launches once a layer per step and per verify step."""
    from repro_torch.fabric.graph import SpeculativeDecoder

    cfg = get_smoke("llama3.2-1b")
    geom = dict(cache="paged", slots=3, max_len=64, num_blocks=32, block_size=4, chunk=6)
    base = Engine(cfg, device=cuda, kernel="cuda", engine_id="gpu-base", **geom)
    base.load_params(seed=0)
    target = Engine(cfg, device=cuda, kernel="cuda", engine_id="gpu-target", **geom)
    target.load_params(base.params)
    rng = np.random.default_rng(11)
    for rid in range(3):
        prompt = rng.integers(0, cfg.vocab_size, size=(5 + 4 * rid,)).astype(np.int32)
        want = base.submit(Request(rid, prompt, max_new_tokens=12)).result().out_tokens
        dec = SpeculativeDecoder(target=target, k=k)
        assert list(dec.submit(prompt, 12).tokens()) == want
        assert dec.tasks[0].stats.target_verify_steps <= 12
    m = target.metrics()
    assert m["verify_steps"] > 0 and "engine.paged_verify" in m["fabric"]["functions"]
    assert m["kernel_launches"]["paged_attention"] == cfg.num_layers * (
        m["steps"] + m["verify_steps"])
    assert m["nonfinite_logits"] == 0


def _moe_case(rng, e, c, d, f, fill):
    if fill == "none":
        counts = None
    else:
        counts = rng.integers(1, c, size=e)
        counts[0], counts[-1] = 0, c                 # an empty and a full expert
        if e > 3:
            counts[1] = min(17, c)                    # ends inside a 16-row group
    x = rng.normal(size=(e, c, d)).astype(np.float32)
    if counts is not None:
        x *= (np.arange(c)[None, :] < counts[:, None])[:, :, None]
    ws = [rng.normal(size=shape).astype(np.float32) / np.sqrt(shape[1])
          for shape in ((e, d, f), (e, d, f), (e, f, d))]
    return x, ws, counts


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("fill", ["mixed", "none"])
@pytest.mark.parametrize("e,c,d,f", [(8, 8, 64, 32), (3, 24, 64, 96), (4, 70, 96, 64),
                                     (64, 40, 2048, 1024), (3, 65, 64, 32),
                                     (5, 130, 96, 160), (3, 40, 160, 96), (1, 24, 64, 96)])
def test_moe_jam_kernel_matches_plain_version(cuda, e, c, d, f, fill, act):
    x, ws, counts = _moe_case(np.random.default_rng(e * c + f), e, c, d, f, fill)
    bf = lambda a: torch.from_numpy(a).to(cuda, torch.bfloat16)
    xt, wg, wu, wd = bf(x), *map(bf, ws)
    cnt = None if counts is None else torch.from_numpy(counts.astype(np.int32)).to(cuda)
    before = moe_jam.LAUNCHES.count
    got = moe_jam.moe_jam_ffn(xt, wg, wu, wd, act, counts=cnt)
    want = moe_jam.moe_jam_ffn_ref(xt, wg, wu, wd, act, counts=cnt)
    torch.cuda.synchronize()
    assert moe_jam.LAUNCHES.count == before + 1
    assert got.shape == (e, c, d) and got.dtype == torch.bfloat16
    err, worst, bad = moe_jam.compare(got, want, tol=MOE_TOL)
    assert bad == 0, (err, worst)
    if cnt is not None:
        empty = ~(torch.arange(c, device=cuda)[None, :] < cnt[:, None].long())
        assert (got[empty] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("fill", ["full", "check", "decode"])
def test_moe_jam_kernel_engine_shape_bench_fills(cuda, fill):
    from repro_torch.kernels.moe_jam import bench

    counts = bench.fills()[fill]
    x, wg, wu, wd, cnt = bench.check_inputs(cuda, counts)
    got = moe_jam.moe_jam_ffn(x, wg, wu, wd, counts=cnt)
    want = moe_jam.moe_jam_ffn_ref(x, wg, wu, wd, counts=cnt)
    torch.cuda.synchronize()
    err, worst, bad = moe_jam.compare(got, want, tol=MOE_TOL)
    assert bad == 0, (err, worst)
    empty = ~(torch.arange(x.shape[1], device=cuda)[None, :] < cnt[:, None].long())
    assert (got[empty] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("e,c,d,f", [(64, 40, 2048, 1024), (5, 130, 96, 160)])
def test_moe_jam_kernel_ignores_rows_past_counts(cuda, e, c, d, f):
    """x rows past counts hold NaN: kept rows equal the plain version on the
    bucket with those rows zeroed, and rows past counts are exact zeros."""
    x, ws, counts = _moe_case(np.random.default_rng(e + c), e, c, d, f, "mixed")
    bf = lambda a: torch.from_numpy(a).to(cuda, torch.bfloat16)
    xt, wg, wu, wd = bf(x), *map(bf, ws)
    cnt = torch.from_numpy(counts.astype(np.int32)).to(cuda)
    empty = ~(torch.arange(c, device=cuda)[None, :] < cnt[:, None].long())
    got = moe_jam.moe_jam_ffn(xt.masked_fill(empty[:, :, None], float("nan")), wg, wu, wd,
                              counts=cnt)
    want = moe_jam.moe_jam_ffn_ref(xt, wg, wu, wd, counts=cnt)
    torch.cuda.synchronize()
    err, worst, bad = moe_jam.compare(got, want, tol=MOE_TOL)
    assert bad == 0, (err, worst)
    assert (got[empty] == 0).all() and torch.isfinite(got).all()


@pytest.mark.gpu
def test_moe_jam_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, ws, counts = _moe_case(np.random.default_rng(0), 2, 8, 64, 32, "mixed")
    bf = lambda a: torch.from_numpy(a).to(cuda, torch.bfloat16)
    xt, wg, wu, wd = bf(x), *map(bf, ws)
    cnt = torch.from_numpy(counts.astype(np.int32)).to(cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        moe_jam.moe_jam_ffn_cuda(xt.float(), wg, wu, wd)
    with pytest.raises(ValueError, match="int32"):
        moe_jam.moe_jam_ffn_cuda(xt, wg, wu, wd, counts=cnt.long())
    with pytest.raises(ValueError, match="do not fit"):
        moe_jam.moe_jam_ffn_cuda(xt, wg, wu, wd.transpose(1, 2).contiguous())
    with pytest.raises(ValueError, match="multiples of 32"):
        moe_jam.moe_jam_ffn_cuda(xt[:, :, :48].contiguous(), wg[:, :48].contiguous(),
                                 wu[:, :48].contiguous(), wd[:, :, :48].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        moe_jam.moe_jam_ffn_cuda(xt.transpose(0, 1), wg, wu, wd)
    with pytest.raises(ValueError, match="act must be"):
        moe_jam.moe_jam_ffn_cuda(xt, wg, wu, wd, "relu")


@pytest.mark.gpu
def test_olmoe_smoke_engine_through_kernels(cuda):
    cfg = get_smoke("olmoe-1b-7b")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, size=(10,)).astype(np.int32) for _ in range(3)]
    runs = {}
    for kernel in ("cuda", "ref"):
        e = Engine(cfg, device=cuda, kernel=kernel, slots=2, max_len=32, num_blocks=10,
                   block_size=4, chunk=4)
        e.load_params(seed=0)
        for rid, p in enumerate(prompts):
            e.submit(Request(rid, p, max_new_tokens=14))
        e.run_until_drained()
        runs[kernel] = (e.admission_log, e.ticks, e.preempt_count, e.metrics())
    (log_c, ticks_c, pre_c, m_c), (log_r, ticks_r, pre_r, m_r) = runs["cuda"], runs["ref"]
    assert (log_c, ticks_c, pre_c) == (log_r, ticks_r, pre_r) and pre_c >= 1
    n = cfg.num_layers * m_c["steps"]
    assert m_c["kernel_launches"] == {"paged_attention": n, "moe_jam": n}
    assert m_r["kernel_launches"] == {"paged_attention": 0, "moe_jam": 0}
    assert m_c["nonfinite_logits"] == 0


def _scan_case(rng, dev, b, s, i, n):
    """Engine-like scan inputs on ``dev``: dt softplus of normals, x/b/c
    bf16, a = -exp(bf16 of normal * 0.3) f32, h0 random f32."""
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
    dt = bf(np.log1p(np.exp(rng.standard_normal((b, s, i)))))
    x, bb, cc = bf(rng.standard_normal((b, s, i))), bf(rng.standard_normal((b, s, n))), \
        bf(rng.standard_normal((b, s, n)))
    a = -torch.exp(bf(rng.standard_normal((i, n)) * 0.3).float())
    h0 = torch.from_numpy(rng.standard_normal((b, i, n)).astype(np.float32)).to(dev)
    return dt, bb, cc, x, a, h0


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,i,n", [(5, 32, 1536, 16), (5, 9, 200, 4), (5, 40, 130, 8),
                                     (3, 1, 96, 16)])
def test_ssm_scan_kernel_matches_plain_version(cuda, b, s, i, n):
    args = _scan_case(np.random.default_rng(b * s + i), cuda, b, s, i, n)
    n_valid = torch.tensor([0, 1, s, max(s // 2, 1), s][:b], dtype=torch.int32, device=cuda)
    before = ssm_scan.LAUNCHES.count
    y, h = ssm_scan.ssm_scan(*args, n_valid=n_valid)
    yr, hr = ssm_scan.ssm_scan_ref(*args, n_valid=n_valid)
    torch.cuda.synchronize()
    assert ssm_scan.LAUNCHES.count == before + 1
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    max_y, max_h, worst, bad = ssm_scan.compare(y, h, yr, hr, n_valid)
    assert bad == 0, (max_y, max_h, worst)
    valid = torch.arange(s, device=cuda)[None, :] < n_valid[:, None]
    assert (torch.where(valid[:, :, None], 0.0, y.float()) == 0).all()
    empty = n_valid == 0
    assert torch.equal(h[empty], args[5][empty])


@pytest.mark.gpu
def test_ssm_scan_kernel_continues_from_its_own_state(cuda):
    dt, bb, cc, x, a, h0 = _scan_case(np.random.default_rng(1), cuda, 4, 24, 300, 16)
    y, h = ssm_scan.ssm_scan_cuda(dt, bb, cc, x, a, h0)
    halves = [t[:, :10].contiguous() for t in (dt, bb, cc, x)], \
        [t[:, 10:].contiguous() for t in (dt, bb, cc, x)]
    y1, h1 = ssm_scan.ssm_scan_cuda(*halves[0], a, h0)
    y2, h2 = ssm_scan.ssm_scan_cuda(*halves[1], a, h1)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([y1, y2], dim=1), y) and torch.equal(h2, h)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 9, 40])
@pytest.mark.parametrize("n", [4, 8, 16])
@pytest.mark.parametrize("i", [130, 200, 1600])
def test_ssm_scan_kernel_at_tile_and_stage_edges(cuda, i, n, s):
    """Channels past the last 64-channel tile, one step, a ragged 8-step
    stage and prefixes over more stages than the ring has slots, with
    n_valid 0, 1, partial and full in one batch, on the route the shape
    takes (TMA at I 200 and 1600 with N 8 and 16, direct otherwise)."""
    from repro_torch.kernels.ssm_scan.kernel import scan_route

    args = _scan_case(np.random.default_rng(i + n + s), cuda, 4, s, i, n)
    n_valid = torch.tensor([0, 1, max(s - 3, 1), s], dtype=torch.int32, device=cuda)
    assert scan_route(*args[:4]) == ("tma" if n > 4 and i % 8 == 0 else "direct")
    y, h = ssm_scan.ssm_scan_cuda(*args, n_valid)
    yr, hr = ssm_scan.ssm_scan_ref(*args, n_valid)
    torch.cuda.synchronize()
    max_y, max_h, worst, bad = ssm_scan.compare(y, h, yr, hr, n_valid)
    assert bad == 0, (max_y, max_h, worst)
    valid = torch.arange(s, device=cuda)[None, :] < n_valid[:, None]
    assert (torch.where(valid[:, :, None], 0.0, y.float()) == 0).all()
    assert torch.equal(h[0], args[5][0])


@pytest.mark.gpu
@pytest.mark.parametrize("s", [2113, 4096])
@pytest.mark.parametrize("i", [1536, 3200])
def test_ssm_scan_single_row_prefill_without_valid_gate(cuda, i, s):
    """The slots backend's prefill shape: one row, a prompt of up to 4,096
    tokens, mamba-130m's 1,536 and hymba-1.5b's 3,200 channels, N 16,
    ``n_valid`` None (every column) and ``h0`` None (zeros) as the
    contiguous path passes them, on the TMA route; then from the first
    launch's state over a second chunk."""
    from repro_torch.kernels.ssm_scan.kernel import scan_route

    dt, bb, cc, x, a, _ = _scan_case(np.random.default_rng(i + s), cuda, 1, s, i, 16)
    assert scan_route(dt, bb, cc, x) == "tma"
    full = torch.full((1,), s, dtype=torch.int32, device=cuda)
    before = ssm_scan.LAUNCHES.count
    y, h = ssm_scan.ssm_scan(dt, bb, cc, x, a)
    yr, hr = ssm_scan.ssm_scan_ref(dt, bb, cc, x, a)
    y2, h2 = ssm_scan.ssm_scan(dt[:, :9], bb[:, :9], cc[:, :9], x[:, :9], a, h)
    yr2, hr2 = ssm_scan.ssm_scan_ref(dt[:, :9], bb[:, :9], cc[:, :9], x[:, :9], a, hr)
    torch.cuda.synchronize()
    assert ssm_scan.LAUNCHES.count == before + 2
    for got, want, n in (((y, h), (yr, hr), full), ((y2, h2), (yr2, hr2), full.clamp(max=9))):
        max_y, max_h, worst, bad = ssm_scan.compare(*got, *want, n)
        assert bad == 0, (max_y, max_h, worst)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [32, 33])
def test_ssm_scan_kernel_ranks_rows_up_to_a_warp(cuda, b):
    """Up to 32 rows the CTAs take the rows longest first (ties in row
    order), past 32 in row order: both agree with the plain version."""
    args = _scan_case(np.random.default_rng(b), cuda, b, 20, 256, 16)
    n_valid = torch.from_numpy(np.random.default_rng(b).integers(0, 21, size=b)
                               .astype(np.int32)).to(cuda)
    n_valid[:3] = torch.tensor([20, 20, 0], dtype=torch.int32)
    y, h = ssm_scan.ssm_scan_cuda(*args, n_valid)
    yr, hr = ssm_scan.ssm_scan_ref(*args, n_valid)
    torch.cuda.synchronize()
    assert ssm_scan.compare(y, h, yr, hr, n_valid)[3] == 0
    valid = torch.arange(20, device=cuda)[None, :] < n_valid[:, None]
    assert (torch.where(valid[:, :, None], 0.0, y.float()) == 0).all()
    empty = n_valid == 0
    assert torch.equal(h[empty], args[5][empty])


@pytest.mark.gpu
def test_ssm_scan_direct_route_on_an_unaligned_base(cuda):
    """x 2 bytes off a 16-byte boundary sends the engine's shape down the
    direct route; it agrees with the plain version and with the TMA
    route."""
    from repro_torch.kernels.ssm_scan.kernel import scan_route

    dt, bb, cc, x, a, h0 = _scan_case(np.random.default_rng(3), cuda, 6, 32, 1536, 16)
    n_valid = torch.tensor([0, 1, 7, 31, 32, 20], dtype=torch.int32, device=cuda)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)[1:].view(x.shape)
    shifted.copy_(x)
    assert scan_route(dt, bb, cc, shifted) == "direct" and scan_route(dt, bb, cc, x) == "tma"
    y, h = ssm_scan.ssm_scan_cuda(dt, bb, cc, shifted, a, h0, n_valid)
    yt, ht = ssm_scan.ssm_scan_cuda(dt, bb, cc, x, a, h0, n_valid)
    yr, hr = ssm_scan.ssm_scan_ref(dt, bb, cc, x, a, h0, n_valid)
    torch.cuda.synchronize()
    assert ssm_scan.compare(y, h, yr, hr, n_valid)[3] == 0
    assert torch.equal(y, yt) and torch.equal(h, ht)


@pytest.mark.gpu
def test_ssm_scan_tma_route_continues_from_its_own_state(cuda):
    """A 40-step scan split after 10 and after 17 steps (stage boundaries
    of the halves fall elsewhere than the whole one's) equals the whole
    scan bit for bit on the TMA route."""
    from repro_torch.kernels.ssm_scan.kernel import scan_route

    dt, bb, cc, x, a, h0 = _scan_case(np.random.default_rng(2), cuda, 3, 40, 1536, 16)
    assert scan_route(dt, bb, cc, x) == "tma"
    y, h = ssm_scan.ssm_scan_cuda(dt, bb, cc, x, a, h0)
    for cut in (10, 17):
        first = [t[:, :cut].contiguous() for t in (dt, bb, cc, x)]
        rest = [t[:, cut:].contiguous() for t in (dt, bb, cc, x)]
        y1, h1 = ssm_scan.ssm_scan_cuda(*first, a, h0)
        y2, h2 = ssm_scan.ssm_scan_cuda(*rest, a, h1)
        torch.cuda.synchronize()
        assert torch.equal(torch.cat([y1, y2], dim=1), y) and torch.equal(h2, h), cut


@pytest.mark.gpu
def test_ssm_scan_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    dt, bb, cc, x, a, h0 = _scan_case(np.random.default_rng(0), cuda, 2, 4, 64, 4)
    nv = torch.tensor([4, 1], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        ssm_scan.ssm_scan_cuda(dt.float(), bb, cc, x, a, h0, nv)
    with pytest.raises(ValueError, match="float32"):
        ssm_scan.ssm_scan_cuda(dt, bb, cc, x, a.bfloat16(), h0, nv)
    with pytest.raises(ValueError, match="int32"):
        ssm_scan.ssm_scan_cuda(dt, bb, cc, x, a, h0, nv.long())
    with pytest.raises(ValueError, match="do not fit"):
        ssm_scan.ssm_scan_cuda(dt, bb, cc, x, a[:32].contiguous(), h0, nv)
    with pytest.raises(ValueError, match="N in"):
        ssm_scan.ssm_scan_cuda(dt, bb[..., :3].contiguous(), cc[..., :3].contiguous(), x,
                               a[:, :3].contiguous(), h0[..., :3].contiguous(), nv)
    with pytest.raises(ValueError, match="contiguous"):
        ssm_scan.ssm_scan_cuda(dt, bb, cc, x.transpose(0, 1), a, h0, nv)
    with pytest.raises(ValueError, match="aligned"):
        ssm_scan.ssm_scan_cuda(dt, bb, cc, x, a, torch.empty(2 * 64 * 4 + 1, device=cuda)[1:]
                               .view(2, 64, 4), nv)


@pytest.mark.gpu
def test_mamba_smoke_engine_through_kernel(cuda):
    cfg = get_smoke("mamba-130m")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32) for n in (4, 5, 7)]
    runs = {}
    for kernel in ("cuda", "ref"):
        e = Engine(cfg, device=cuda, cache="auto", kernel=kernel, slots=2, max_len=48,
                   chunk=4)
        e.load_params(seed=0)
        for rid, p in enumerate(prompts):
            e.submit(Request(rid, p, max_new_tokens=6))
        e.tick()
        e.tick()
        e.preempt(next(x.req.rid for x in e.slot_entry if x is not None))
        e.run_until_drained()
        runs[kernel] = (e.admission_log, e.ticks, e.preempt_count, e.metrics())
    (log_c, ticks_c, pre_c, m_c), (log_r, ticks_r, pre_r, m_r) = runs["cuda"], runs["ref"]
    assert (log_c, ticks_c, pre_c) == (log_r, ticks_r, pre_r) and pre_c >= 1
    assert m_c["engine"]["cache"] == "recurrent"
    assert m_c["kernel_launches"] == {"ssm_scan": cfg.num_layers * m_c["steps"]}
    assert m_r["kernel_launches"] == {"ssm_scan": 0}
    assert m_c["snapshots_restored"] == m_c["snapshots_taken"] == 1
    assert m_c["nonfinite_logits"] == 0


def _mailbox_frames(rng, dev, n, spec):
    usr = rng.integers(-2 ** 31, 2 ** 31, size=(n, spec.payload_words),
                       dtype=np.int64).astype(np.int32)
    usr[:, 0] = rng.integers(-50, 50, size=n)
    usr[:min(n, 3), 0] = [-2 ** 31, 2 ** 31 - 1, -7][:min(n, 3)]
    usr[0, :] = 2 ** 31 - 1                              # its sum wraps
    return pack_frames(spec, func_id=0, payload_words=torch.from_numpy(usr).to(dev))


@pytest.mark.gpu
@pytest.mark.parametrize("pw", [1, 15, 16, 64, 1024])
@pytest.mark.parametrize("n,got_slots", [(1, 4), (33, 3), (1000, 5)])
def test_mailbox_kernels_match_plain_versions(cuda, n, got_slots, pw):
    rng = np.random.default_rng(n * pw + got_slots)
    spec = FrameSpec(got_slots=got_slots, state_words=0, payload_words=pw)
    off = spec.offsets()["usr"]                       # 12 (48 B), 11 or 13 words
    frames = _mailbox_frames(rng, cuda, n, spec)
    sums = mailbox.am_server_sum(frames, spec, kernel="cuda")
    torch.cuda.synchronize()
    assert torch.equal(sums, mailbox.server_sum_ref(frames, off, pw))
    for slots in (1, 7, 4096):
        for base in (0, -5, 2 ** 31 - 1):
            table = torch.from_numpy(rng.integers(-9, 9, size=(slots, 2)).astype(np.int32)).to(cuda)
            heap = torch.from_numpy(rng.integers(-9, 9, size=(slots, pw - 1))
                                    .astype(np.int32)).to(cuda)
            t_ref, h_ref = table.clone(), heap.clone()
            got = torch.tensor([base, 1, 2, 3], dtype=torch.int32, device=cuda)
            before = mailbox.PUT_LAUNCHES.count
            out = mailbox.am_indirect_put(frames, table, heap, got, spec, kernel="cuda")
            assert out[0] is table and out[1] is heap
            assert mailbox.PUT_LAUNCHES.count == before + 1
            mailbox.indirect_put_ref(frames, t_ref, h_ref, off, pw, base)
            torch.cuda.synchronize()
            assert torch.equal(table, t_ref), (slots, base)
            assert torch.equal(heap, h_ref), (slots, base)


PUT_COLLISIONS = ["one_row", "distinct", "alternate", "slots1", "n1"]


def _collision_frames(rng, dev, kind, n=3000, slots=4096):
    """Indirect Put frames whose keys collide as ``kind`` says (the CPU
    parity tests' cases, larger): every frame on one row, all rows
    distinct, two rows in turn, a table of one row, one frame."""
    spec = FrameSpec(got_slots=4, state_words=0, payload_words=16)
    slots = 1 if kind == "slots1" else slots
    n = 1 if kind == "n1" else n
    usr = rng.integers(-2 ** 31, 2 ** 31, size=(n, 16), dtype=np.int64).astype(np.int32)
    wraps = slots * rng.integers(-3, 4, size=n)
    if kind == "one_row":
        usr[:, 0] = 7 % slots + wraps
    elif kind == "distinct":
        usr[:, 0] = rng.permutation(slots)[:n] + wraps
    elif kind == "alternate":
        usr[:, 0] = 1 + np.arange(n) % 2 + wraps
    return spec, pack_frames(spec, func_id=0, payload_words=torch.from_numpy(usr).to(dev)), slots


def _put_both(frames, spec, slots, base, rng, dev):
    """(kernel's (table, heap), plain version's) from the same random shard."""
    pw = spec.payload_words
    table = torch.from_numpy(rng.integers(-9, 9, size=(slots, 2)).astype(np.int32)).to(dev)
    heap = torch.from_numpy(rng.integers(-9, 9, size=(slots, pw - 1)).astype(np.int32)).to(dev)
    t_ref, h_ref = table.clone(), heap.clone()
    got = torch.tensor([base, 1, 2, 3], dtype=torch.int32, device=dev)
    mailbox.am_indirect_put(frames, table, heap, got, spec, kernel="cuda")
    mailbox.indirect_put_ref(frames, t_ref, h_ref, spec.offsets()["usr"], pw, base)
    torch.cuda.synchronize()
    return (table, heap), (t_ref, h_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("base", [0, 4095, 2 ** 31 - 1, -(2 ** 31 - 1)])
@pytest.mark.parametrize("kind", PUT_COLLISIONS)
def test_indirect_put_kernel_collisions_bit_for_bit(cuda, kind, base):
    rng = np.random.default_rng(PUT_COLLISIONS.index(kind))
    spec, frames, slots = _collision_frames(rng, cuda, kind)
    (table, heap), (t_ref, h_ref) = _put_both(frames, spec, slots, base, rng, cuda)
    assert torch.equal(table, t_ref) and torch.equal(heap, h_ref)


@pytest.mark.gpu
def test_indirect_put_kernel_hot_keys_deterministic(cuda):
    """2^20 frames, 10% from 1,024 hot keys, into a 2^24-row shard: two
    launches on equal shards leave equal shards, equal to the plain
    version's; the call's scratch is the claim table, sized by the frames."""
    from repro_torch.kernels.mailbox import bench
    from repro_torch.kernels.mailbox.kernel import claim_entries

    spec, slots, n = bench.SPEC, 1 << 24, 1 << 20
    frames = pack_frames(spec, func_id=0, payload_words=torch.from_numpy(
        bench.put_payloads(np.random.default_rng(7), n)).to(cuda))
    shards = []
    for _ in range(2):
        shards.append((torch.zeros((slots, 2), dtype=torch.int32, device=cuda),
                       torch.zeros((slots, 15), dtype=torch.int32, device=cuda)))
    got = torch.tensor([bench.HEAP_BASE, 0, 0, 0], dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    for table, heap in shards:
        mailbox.am_indirect_put(frames, table, heap, got, spec, kernel="cuda")
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - held <= 9 * claim_entries(n, slots) + 2 ** 20
    t_ref, h_ref = torch.zeros_like(shards[0][0]), torch.zeros_like(shards[0][1])
    mailbox.indirect_put_ref(frames, t_ref, h_ref, spec.offsets()["usr"], 16, bench.HEAP_BASE)
    for table, heap in shards:
        assert torch.equal(table, t_ref) and torch.equal(heap, h_ref)


def _sum_frames(dev, n, usr_off, pw, *, shift=0, seed=0):
    """(n, W) int32 frames uniform over int32 (so sums wrap), W the
    smallest multiple of 16 words past the USR words; ``shift`` words put
    the base that far off a 16-byte boundary."""
    w = -(-(usr_off + pw + 1) // 16) * 16
    rng = np.random.default_rng(seed)
    flat = torch.empty(n * w + 4, dtype=torch.int32, device=dev)
    frames = flat[shift:shift + n * w].view(n, w)
    frames.copy_(torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, size=(n, w),
                                               dtype=np.int64).astype(np.int32)))
    return frames


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 7, 255])
@pytest.mark.parametrize("pw", [0, 1, 3, 4, 16, 17, 32, 64, 128, 300, 8192])
@pytest.mark.parametrize("usr_off", [0, 12, 13])
def test_server_sum_routes_bit_for_bit(cuda, usr_off, pw, n):
    """Both routes of the Server-Side Sum against the plain version, bit
    for bit: the wide route (a CTA a frame: calls this small) at offsets
    and widths of 4 words, the scalar route at offset 13, widths 0, 1, 3
    and 17, and on every case on a copy of the frames 4 bytes off a
    16-byte boundary."""
    from repro_torch.kernels.mailbox.kernel import sum_route

    frames = _sum_frames(cuda, n, usr_off, pw, seed=n + pw)
    off = _sum_frames(cuda, n, usr_off, pw, shift=1)
    off.copy_(frames)
    want = "wide" if usr_off % 4 == 0 and pw % 4 == 0 and pw >= 4 else "scalar"
    assert sum_route(frames, usr_off, pw) == want and sum_route(off, usr_off, pw) == "scalar"
    before = mailbox.SUM_LAUNCHES.count
    sums = mailbox.server_sum_cuda(frames, usr_off, pw)
    scalar = mailbox.server_sum_cuda(off, usr_off, pw)
    torch.cuda.synchronize()
    assert mailbox.SUM_LAUNCHES.count == before + 2
    assert torch.equal(sums, mailbox.server_sum_ref(frames, usr_off, pw))
    assert torch.equal(scalar, sums)


@pytest.mark.gpu
@pytest.mark.parametrize("usr_off,pw", [(0, 16), (12, 16), (13, 16), (0, 32), (12, 64),
                                        (0, 128), (12, 300)])
def test_server_sum_routes_past_a_million_frames(cuda, usr_off, pw):
    """2^20 + 3 frames (a last round of 3, far more rounds than CTAs; the
    scalar route at 16 and 32 lanes a frame, the wide route at 300 words),
    bit for bit against the plain version."""
    from repro_torch.kernels.mailbox.kernel import sum_route

    frames = _sum_frames(cuda, 2 ** 20 + 3, usr_off, pw, seed=pw)
    assert sum_route(frames, usr_off, pw) == ("wide" if pw > 128 else "scalar")
    sums = mailbox.server_sum_cuda(frames, usr_off, pw)
    torch.cuda.synchronize()
    assert torch.equal(sums, mailbox.server_sum_ref(frames, usr_off, pw))


@pytest.mark.gpu
@pytest.mark.parametrize("pw", [16, 64])
def test_server_sum_scalar_route_off_a_16_byte_base(cuda, pw):
    """Frames whose base is 4 bytes off a 16-byte boundary take the scalar
    route, bit for bit."""
    from repro_torch.kernels.mailbox.kernel import sum_route

    frames = _sum_frames(cuda, 1000, 12, pw, shift=1)
    assert frames.data_ptr() % 16 == 4 and sum_route(frames, 12, pw) == "scalar"
    sums = mailbox.server_sum_cuda(frames, 12, pw)
    torch.cuda.synchronize()
    assert torch.equal(sums, mailbox.server_sum_ref(frames, 12, pw))


@pytest.mark.gpu
def test_mailbox_wrappers_reject_what_the_kernels_do_not_take(cuda):
    spec = FrameSpec(got_slots=4, state_words=0, payload_words=16)
    frames = _mailbox_frames(np.random.default_rng(0), cuda, 8, spec)
    table = torch.zeros((16, 2), dtype=torch.int32, device=cuda)
    heap = torch.zeros((16, 15), dtype=torch.int32, device=cuda)
    got = torch.zeros(4, dtype=torch.int32, device=cuda)
    put = mailbox.indirect_put_cuda
    with pytest.raises(ValueError, match="int32"):
        mailbox.server_sum_cuda(frames.float(), 12, 16)
    with pytest.raises(ValueError, match="contiguous"):
        mailbox.server_sum_cuda(frames[:, ::2], 12, 8)
    with pytest.raises(ValueError, match="do not fit"):
        mailbox.server_sum_cuda(frames, 20, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        put(frames, table, heap, got.cpu(), 12, 16)
    with pytest.raises(ValueError, match="do not fit"):
        put(frames, table, heap[:, :14].contiguous(), got, 12, 16)
    with pytest.raises(ValueError, match="key word"):
        put(frames, table, heap[:, :0].contiguous(), got, 12, 0)
    before = (mailbox.SUM_LAUNCHES.count, mailbox.PUT_LAUNCHES.count)
    assert mailbox.server_sum_cuda(frames[:0], 12, 16).shape == (0,)
    put(frames[:0], table, heap, got, 12, 16)
    assert (mailbox.SUM_LAUNCHES.count, mailbox.PUT_LAUNCHES.count) == before


@pytest.mark.gpu
def test_kv_fabric_on_the_card_matches_the_cpu(cuda):
    from repro_torch.kernels.mailbox import bench

    rng = np.random.default_rng(1)
    usr = bench.put_payloads(rng, 3000)
    rows = {}
    for dev in ("cpu", cuda):
        fabric = bench.kv_fabric(dev, slots=1024)
        frames = torch.cat([fabric.pack("indirect_put", torch.from_numpy(usr[:2000]).to(dev)),
                            fabric.pack("server_side_sum", torch.from_numpy(usr[2000:]).to(dev))])
        frames[5, bench.SPEC.offsets()["usr"]] ^= 1
        rows[str(dev)] = fabric.dispatcher(bench.SPEC, 2)(frames).cpu()
    assert torch.equal(rows["cpu"], rows[str(cuda)])
    assert (rows["cpu"][5] == 0).all()


# ---------------------------------------------------------------------------
# the ring put (ranks as the CTAs of a cluster)
# ---------------------------------------------------------------------------

RING_SPEC = FrameSpec(got_slots=4, state_words=0, payload_words=16)
RING_CHUNK = 384                                  # 128-B frames in one 48 KiB buffer


def _ring_blocks(dev, n, frames, spec=RING_SPEC, seed=0):
    from repro_torch.kernels.mailbox import bench

    return bench.ring_blocks(dev, np.random.default_rng(seed), n, frames, spec)


def _ring_geom(spec):
    o = spec.offsets()
    return dict(sig_off=o["sig"], usr_off=o["usr"], payload_words=spec.payload_words)


def _check_ring(got, want):
    """Arrivals and sums bit for bit; spins 0 and MAX_SPINS exactly, and
    in [1, MAX_SPINS) where the plain version's poll found the SIG (1)."""
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert (got[2] is None) == (want[2] is None)
    if want[2] is not None:
        assert torch.equal(got[2], want[2])
    found = want[1] == 1
    ok = torch.where(found, (got[1] >= 1) & (got[1] < mailbox.MAX_SPINS), got[1] == want[1])
    assert bool(ok.all()), (got[1].view(-1).tolist(), want[1].view(-1).tolist())


@pytest.mark.gpu
@pytest.mark.parametrize("frames", [1, 3, RING_CHUNK + 1, 3 * RING_CHUNK + 5, 20000])
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_ring_put_kernel_matches_plain_version(cuda, n, frames):
    blocks = _ring_blocks(cuda, n, frames)
    geom = _ring_geom(RING_SPEC)
    for shift in sorted({1, 2, n - 1, n + 1}):
        for wait, stash, handler in [("wfe", True, None), ("wfe", True, "sum"),
                                     ("poll", True, None), ("poll", True, "sum"),
                                     ("wfe", False, None), ("poll", False, None)]:
            kw = dict(shift=shift, wait=wait, stash=stash, handler=handler, **geom)
            before = mailbox.RING_LAUNCHES.count
            got = mailbox.mailbox_put_cuda(blocks, **kw)
            assert mailbox.RING_LAUNCHES.count == before + 1
            _check_ring(got, mailbox.mailbox_put_ref(blocks, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("frames", [1, 3, 3 * RING_CHUNK + 5, 20000])
@pytest.mark.parametrize("n", [2, 8])
def test_ring_put_poll_without_sig_counts_the_cap(cuda, n, frames):
    """The last frame's SIG word zeroed: every rank's poll runs to the cap
    (exactly 2^20) and the arrivals are still right."""
    blocks = _ring_blocks(cuda, n, frames)
    blocks[:, -1, RING_SPEC.offsets()["sig"]] = 0
    geom = _ring_geom(RING_SPEC)
    got = mailbox.mailbox_put_cuda(blocks, wait="poll", handler="sum", **geom)
    want = mailbox.mailbox_put_ref(blocks, wait="poll", handler="sum", **geom)
    assert (want[1] == mailbox.MAX_SPINS).all()
    _check_ring(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("pw", [1, 64, 65, 1024, 8192])
def test_ring_put_fused_sum_over_payload_widths(cuda, pw):
    spec = FrameSpec(got_slots=3, state_words=0, payload_words=pw)   # USR off 16 B alignment
    blocks = _ring_blocks(cuda, 4, 5, spec, seed=pw)
    for wait in ("wfe", "poll"):
        got = mailbox.ring_am_put(blocks, spec=spec, wait=wait, handler="sum", shift=3)
        _check_ring(got, mailbox.ring_am_put(blocks, spec=spec, wait=wait, handler="sum",
                                             shift=3, kernel="ref"))


@pytest.mark.gpu
def test_ring_put_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    blocks = _ring_blocks(cuda, 2, 4)
    geom = _ring_geom(RING_SPEC)
    put = mailbox.mailbox_put_cuda
    with pytest.raises(ValueError, match="A14"):
        put(_ring_blocks(cuda, 9, 1), **geom)
    with pytest.raises(ValueError, match="int32"):
        put(blocks.float(), **geom)
    with pytest.raises(ValueError, match="contiguous"):
        put(blocks[:, ::2], **geom)
    with pytest.raises(ValueError, match="16-byte"):
        put(torch.zeros((2, 3, 30), dtype=torch.int32, device=cuda), **geom)
    with pytest.raises(ValueError, match="16-byte"):
        put(blocks.view(-1)[1:1 + 2 * 3 * 32].view(2, 3, 32), **geom)
    with pytest.raises(ValueError, match="N >= 1"):
        put(blocks[:, :0], **geom)
    with pytest.raises(ValueError, match="do not fit"):
        put(blocks, sig_off=32, usr_off=12, payload_words=16)
    with pytest.raises(ValueError, match="frames of 1 to"):
        put(torch.zeros((2, 1, 12800), dtype=torch.int32, device=cuda), sig_off=0, usr_off=0,
            payload_words=1)
    with pytest.raises(ValueError, match="stash=True"):
        put(blocks, stash=False, handler="sum", **geom)
    with pytest.raises(ValueError, match="shift"):
        put(blocks, shift=-1, **geom)
    with pytest.raises(ValueError, match="wait"):
        put(blocks, wait="spin", **geom)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _flash_case(dev, rng, *, B, Hkv, G, S, T, D, strided):
    """q, k, v bf16 from numpy: (B, H, S, D) views of (B, S, H, D) tensors
    when ``strided`` (the model's layout), else contiguous."""
    def bf16(h, n):
        x = torch.from_numpy(rng.standard_normal((B, n, h, D), dtype=np.float32))
        x = x.to(dev, torch.bfloat16)
        return x.permute(0, 2, 1, 3) if strided else x.permute(0, 2, 1, 3).contiguous()
    return bf16(Hkv * G, S), bf16(Hkv, T), bf16(Hkv, T)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 33, 2113])
@pytest.mark.parametrize("G", [1, 2, 8, 48])
@pytest.mark.parametrize("D", [16, 80, 128, 256])
def test_flash_kernel_matches_plain_version(cuda, D, G, S):
    """Every query row sees at least one key in these cases (causal at
    q_offset >= 0; windows never past the row's own position), so the
    kernel's zero for a row that sees none never arises."""
    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(D * 100 + G * 10 + S)
    Hkv = 2 if G < 48 else 1
    cases = [dict(causal=True, window=None, q_offset=0, T=S),
             dict(causal=True, window=17, q_offset=0, T=S),
             dict(causal=True, window=None, q_offset=7, T=S + 7),
             dict(causal=False, window=None, q_offset=0, T=S + 5)]
    for i, c in enumerate(cases):
        q, k, v = _flash_case(cuda, rng, B=2, Hkv=Hkv, G=G, S=S, T=c["T"], D=D,
                              strided=i % 2 == 0)
        kw = dict(causal=c["causal"], window=c["window"], q_offset=c["q_offset"])
        before = fa.LAUNCHES.count
        got = fa.flash_attention(q, k, v, **kw)
        want = fa.mha_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        assert fa.LAUNCHES.count == before + 1
        assert got.shape == q.shape and got.dtype == torch.bfloat16
        err, worst, bad = fa.compare(got, want, tol=BF16_TOL)
        assert bad == 0, (c, err, worst)


@pytest.mark.gpu
@pytest.mark.parametrize("strided", [True, False])
@pytest.mark.parametrize("S", [127, 129, 4096])
def test_flash_v2_ragged_and_long_at_gemma_heads(cuda, S, strided):
    """D 256, G 2: a last CTA of 127 or 129 rows' worth of positions, and
    a 4,096-token prefill, causal with a window of 1,024 from position 7
    (keys past T as zeros, a window edge crossing the tiles) and plain
    causal."""
    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(S + strided)
    for c in (dict(causal=True, window=1024, q_offset=7, T=S + 7),
              dict(causal=True, window=None, q_offset=0, T=S)):
        q, k, v = _flash_case(cuda, rng, B=1, Hkv=2, G=2, S=S, T=c["T"], D=256,
                              strided=strided)
        kw = dict(causal=c["causal"], window=c["window"], q_offset=c["q_offset"])
        got = fa.flash_attention(q, k, v, **kw)
        want = fa.mha_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err, worst, bad = fa.compare(got, want, tol=BF16_TOL)
        assert bad == 0, (c, err, worst)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [16, 64, 80, 128, 256])
def test_flash_each_design_at_its_head_dims(cuda, D):
    """v2 (TMA + wgmma) serves every head dim, 16 and 80 included; each
    matches the plain version at llama3.2-1b's grouping (G 4), 500
    positions from q_offset 3, with and without a window of 100."""
    from repro_torch.kernels import flash_attention as fa

    assert fa.design(D) == "tma-wgmma v2"
    rng = np.random.default_rng(D)
    for window in (None, 100):
        q, k, v = _flash_case(cuda, rng, B=2, Hkv=2, G=4, S=500, T=503, D=D, strided=True)
        got = fa.flash_attention(q, k, v, causal=True, window=window, q_offset=3)
        want = fa.mha_ref(q, k, v, causal=True, window=window, q_offset=3)
        torch.cuda.synchronize()
        err, worst, bad = fa.compare(got, want, tol=BF16_TOL)
        assert bad == 0, (window, err, worst)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [2113, 4096])
@pytest.mark.parametrize("window", [None, 1024])
def test_flash_hymba_heads(cuda, window, S):
    """hymba-1.5b's prefill: 25 query heads over 5 kv heads (G 5, not a
    power of two) of 64, causal, with its window of 1,024 on the local
    layers and none on the global ones, in the model's strided layout."""
    from repro_torch.kernels import flash_attention as fa

    assert fa.design(64) == "tma-wgmma v2"
    rng = np.random.default_rng(S + (window or 0))
    q, k, v = _flash_case(cuda, rng, B=1, Hkv=5, G=5, S=S, T=S, D=64, strided=True)
    before = fa.LAUNCHES.count
    got = fa.flash_attention(q, k, v, causal=True, window=window)
    want = fa.mha_ref(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES.count == before + 1
    err, worst, bad = fa.compare(got, want, tol=BF16_TOL)
    assert bad == 0, (err, worst)


@pytest.mark.gpu
def test_flash_tile_counts(cuda):
    """The kernel's own count of the kv tiles it visits and masks. v2,
    causal over 1,024 positions at G 2 and D 128: 16 CTAs of 64 positions
    visit 1, 1, 2, 2, ..., 8, 8 tiles of 128 keys (72), each walked by both
    warpgroups of 32 positions (144), and each warpgroup masks only the
    tile on its diagonal (32). At D 80, causal over 300 positions at G 2:
    5 CTAs of 64 positions visit 1, 1, 2, 2, 3 tiles of 128 keys (9), each
    walked by both warpgroups (18), and each warpgroup masks one tile (10):
    the one on its diagonal, which in the last CTA is also the tail (keys
    256-383 against T 300)."""
    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(5)
    q, k, v = _flash_case(cuda, rng, B=1, Hkv=1, G=2, S=1024, T=1024, D=128, strided=True)
    got = fa.tile_counts(q, k, v, causal=True)
    assert got == dict(design="tma-wgmma v2", visited=144, masked=32)
    q, k, v = _flash_case(cuda, rng, B=1, Hkv=1, G=2, S=300, T=300, D=80, strided=True)
    got = fa.tile_counts(q, k, v, causal=True)
    assert got == dict(design="tma-wgmma v2", visited=18, masked=10)
    assert fa.design(32) is None


@pytest.mark.gpu
def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _flash_case(cuda, np.random.default_rng(0), B=1, Hkv=2, G=2, S=8, T=8, D=16,
                          strided=True)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention_cuda(q.float(), k, v)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention_cuda(q, k.cpu(), v)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        fa.flash_attention_cuda(q[:, :3], k, v)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_cuda(q[..., :8], k[..., :8], v[..., :8])
    with pytest.raises(ValueError, match="unit stride"):
        fa.flash_attention_cuda(q.transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention_cuda(q, k, v, window=0)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fa.flash_attention(q.cpu(), k.cpu(), v.cpu(), kernel="cuda")


@pytest.mark.gpu
def test_slots_smoke_engine_through_flash_kernel(cuda, monkeypatch):
    """The gemma smoke on the slots engine, prompts over a lowered
    threshold so every prefill takes the flash path: the kernel and the
    plain version give the same schedule; one launch per layer per prefill
    through the kernel, none through the plain version."""
    from repro_torch.models import attention

    monkeypatch.setattr(attention, "CHUNK_THRESHOLD", 64)
    cfg = get_smoke("gemma3-4b")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (9, 30, 5, 17)]
    runs = {}
    for kernel in ("cuda", "ref"):
        e = Engine(cfg, device=cuda, cache="slots", kernel=kernel, slots=2, max_len=64)
        e.load_params(seed=0)
        for rid, p in enumerate(prompts):
            e.submit(Request(rid, p, max_new_tokens=6))
        e.run_until_drained()
        runs[kernel] = (e.admission_log, e.ticks, e.metrics())
    assert runs["cuda"][:2] == runs["ref"][:2]
    long_prompts = sum(len(p) ** 2 > 64 for p in prompts)
    assert runs["cuda"][2]["kernel_launches"] == {"flash_attention": cfg.num_layers * long_prompts}
    assert runs["ref"][2]["kernel_launches"] == {"flash_attention": 0}
    assert runs["cuda"][2]["nonfinite_logits"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba-130m", "hymba-1.5b"])
def test_state_stack_smoke_on_slots_through_kernels(cuda, monkeypatch, arch):
    """mamba's and hymba's smokes on the slots engine (``cache="slots"``;
    hymba's default): the kernels and the plain versions give the same
    schedule; the scan launches once a state layer a prefill and a decode
    tick, flash (hymba, threshold lowered) once a layer a long prefill;
    nothing through the plain versions."""
    from repro_torch.models import attention

    monkeypatch.setattr(attention, "CHUNK_THRESHOLD", 64)
    cfg = get_smoke(arch)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (9, 30, 5, 17)]
    runs = {}
    for kernel in ("cuda", "ref"):
        e = Engine(cfg, device=cuda, cache="slots", kernel=kernel, slots=2, max_len=64)
        e.load_params(seed=0)
        for rid, p in enumerate(prompts):
            e.submit(Request(rid, p, max_new_tokens=6))
        e.run_until_drained()
        runs[kernel] = (e.admission_log, e.ticks, e.metrics())
    assert runs["cuda"][:2] == runs["ref"][:2]
    steps = len(prompts) + runs["cuda"][1]
    want = {"ssm_scan": cfg.num_layers * steps}
    if arch == "hymba-1.5b":
        want["flash_attention"] = cfg.num_layers * sum(len(p) ** 2 > 64 for p in prompts)
    assert runs["cuda"][2]["kernel_launches"] == want
    assert runs["ref"][2]["kernel_launches"] == {k: 0 for k in want}
    assert runs["cuda"][2]["nonfinite_logits"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hkv,G,D,causal", [(1, 8, 8, 128, True), (2, 16, 1, 80, False)])
def test_flash_qwen2_vl_and_hubert_heads(cuda, B, Hkv, G, D, causal):
    """qwen2-vl-72b's prefill (64 query heads over 8 kv heads of 128, G 8,
    causal) and hubert-xlarge's encoder (16 heads of 80, MHA, no causal
    mask, batch 2; every tile of every row visited, none masked) across
    4,096 keys, in the model's strided layout."""
    from repro_torch.kernels import flash_attention as fa

    assert fa.design(D) == "tma-wgmma v2"
    rng = np.random.default_rng(D + G)
    q, k, v = _flash_case(cuda, rng, B=B, Hkv=Hkv, G=G, S=4096, T=4096, D=D, strided=True)
    before = fa.LAUNCHES.count
    got = fa.flash_attention(q, k, v, causal=causal)
    want = fa.mha_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES.count == before + 1
    err, worst, bad = fa.compare(got, want, tol=BF16_TOL)
    assert bad == 0, (err, worst)
    walk = fa.tile_counts(q, k, v, causal=causal)
    if not causal:                 # 64-row warpgroups, each over all 32 tiles of 128 keys
        assert walk["visited"] == B * Hkv * (4096 * G // 64) * 32 and walk["masked"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("S,strided", [(129, True), (129, False), (4096, False)])
def test_flash_hubert_heads(cuda, S, strided):
    """hubert-xlarge's encoder heads: 2 clips x 16 heads of 80 (MHA), no
    causal mask, S = T frames: 129 (a last tile of one key) and 4,096
    (whole tiles of 128 keys, so no tile takes the mask), strided (the
    model's layout) and dense; 4,096 strided is
    ``test_flash_qwen2_vl_and_hubert_heads``'s hubert case."""
    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(S + strided)
    q, k, v = _flash_case(cuda, rng, B=2, Hkv=16, G=1, S=S, T=S, D=80, strided=strided)
    before = fa.LAUNCHES.count
    got = fa.flash_attention(q, k, v, causal=False)
    want = fa.mha_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert fa.LAUNCHES.count == before + 1
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    err, worst, bad = fa.compare(got, want, tol=BF16_TOL)
    assert bad == 0, (err, worst)
    walk = fa.tile_counts(q, k, v, causal=False)
    assert walk["design"] == "tma-wgmma v2"
    if S == 4096:
        assert walk == dict(design="tma-wgmma v2", visited=2 * 16 * 64 * 32, masked=0)


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [-0.3, 0.0])
@pytest.mark.parametrize("D", [80, 128])
def test_flash_nonpositive_scale(cuda, D, scale):
    """A scale <= 0 (the max over raw scores is then not the max over
    scaled ones) sends every tile through the general softmax, which
    scales before its max: 2 x 8/4 heads, 256 frames, no causal mask
    (whole tiles, none of which a positive scale would mask)."""
    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(D)
    q, k, v = _flash_case(cuda, rng, B=2, Hkv=4, G=2, S=256, T=256, D=D, strided=True)
    before = fa.LAUNCHES.count
    got = fa.flash_attention(q, k, v, causal=False, scale=scale)
    want = fa.mha_ref(q, k, v, causal=False, scale=scale)
    torch.cuda.synchronize()
    assert fa.LAUNCHES.count == before + 1
    err, worst, bad = fa.compare(got, want, tol=BF16_TOL)
    assert bad == 0, (err, worst)
    walk = fa.tile_counts(q, k, v, causal=False, scale=scale)
    assert walk["visited"] > 0 and walk["masked"] == walk["visited"]
    assert fa.tile_counts(q, k, v, causal=False)["masked"] == 0


@pytest.mark.gpu
def test_qwen2_vl_smoke_on_slots_through_flash_kernel(cuda, monkeypatch):
    """qwen2-vl's smoke on ``Engine(cache="auto")`` (slots), prompts over a
    lowered threshold: the kernel and the plain version give the same
    schedule; one flash launch a layer a long prefill through the kernel,
    none through the plain version; and a vision prefill (patches spliced,
    3-D positions) through the prefill step on both paths agrees."""
    from repro_torch.models import attention
    from repro_torch.runtime.steps import make_prefill_step

    monkeypatch.setattr(attention, "CHUNK_THRESHOLD", 64)
    cfg = get_smoke("qwen2-vl-72b")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (9, 30, 5, 17)]
    runs = {}
    for kernel in ("cuda", "ref"):
        e = Engine(cfg, device=cuda, cache="auto", kernel=kernel, slots=2, max_len=64)
        assert e.cache_kind == "slots"
        e.load_params(seed=0)
        for rid, p in enumerate(prompts):
            e.submit(Request(rid, p, max_new_tokens=6))
        e.run_until_drained()
        runs[kernel] = (e.admission_log, e.ticks, e.metrics())
        params = e.params
    assert runs["cuda"][:2] == runs["ref"][:2]
    long_prompts = sum(len(p) ** 2 > 64 for p in prompts)
    assert runs["cuda"][2]["kernel_launches"] == {"flash_attention": cfg.num_layers * long_prompts}
    assert runs["ref"][2]["kernel_launches"] == {"flash_attention": 0}
    assert runs["cuda"][2]["nonfinite_logits"] == 0
    P, S = cfg.frontend.num_patch_tokens, 30
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, S)).astype(np.int32)).to(cuda)
    feats = torch.from_numpy(rng.standard_normal((1, P, cfg.d_model)).astype(np.float32)).to(cuda)
    pos = torch.arange(S, device=cuda, dtype=torch.int32).expand(3, 1, S).clone()
    pos[1, 0, :P], pos[2, 0, :P] = torch.arange(P, device=cuda) // 4, torch.arange(P, device=cuda) % 4
    pos[0, 0, :P] = 0
    last = {}
    for kernel in ("cuda", "ref"):
        step = make_prefill_step(cfg, max_len=S, kernel=kernel, device=cuda)
        last[kernel] = step.fn(params, tok, feats, pos)[0].float()
    assert torch.isfinite(last["cuda"]).all()
    assert (last["cuda"] - last["ref"]).abs().max() <= 0.05 * last["ref"].abs().max()


@pytest.mark.gpu
def test_hubert_smoke_encoder_through_flash_kernel(cuda, monkeypatch):
    """hubert's smoke through the prefill step, frames over a lowered
    threshold: one flash launch a layer (``causal=False``) through the
    kernel, none through the plain version; every frame's logits agree."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention
    from repro_torch.models.model import init_params
    from repro_torch.runtime.steps import make_prefill_step

    monkeypatch.setattr(attention, "CHUNK_THRESHOLD", 64)
    cfg = get_smoke("hubert-xlarge")
    params = init_params(cfg, device=cuda, dtype=torch.bfloat16)
    rng = np.random.default_rng(7)
    feats = torch.from_numpy(rng.standard_normal((2, 40, cfg.frontend.feature_dim))
                             .astype(np.float32)).to(cuda)
    tok = torch.zeros((2, 40), dtype=torch.int32, device=cuda)
    out = {}
    for kernel in ("cuda", "ref"):
        step = make_prefill_step(cfg, max_len=40, kernel=kernel, device=cuda)
        before = fa.LAUNCHES.count
        logits, cache = step.fn(params, tok, feats)
        torch.cuda.synchronize()
        assert cache is None and logits.shape == (2, 40, cfg.vocab_size)
        assert fa.LAUNCHES.count - before == (cfg.num_layers if kernel == "cuda" else 0)
        out[kernel] = logits
    assert torch.isfinite(out["cuda"]).all()
    assert (out["cuda"] - out["ref"]).abs().max() <= 0.05 * out["ref"].abs().max()


# ---------------------------------------------------------------------------
# MLA: flash at separate widths, moe_jam at deepseek's buckets
# ---------------------------------------------------------------------------

def _mla_case(dev, rng, *, B, Hkv, G, S, T, strided, D=192, Dv=128):
    def bf16(h, n, d):
        x = torch.from_numpy(rng.standard_normal((B, n, h, d), dtype=np.float32))
        x = x.to(dev, torch.bfloat16)
        return x.permute(0, 2, 1, 3) if strided else x.permute(0, 2, 1, 3).contiguous()
    return bf16(Hkv * G, S, D), bf16(Hkv, T, D), bf16(Hkv, T, Dv)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 65, 2113, 4096])
@pytest.mark.parametrize("G", [1, 2])
def test_flash_mla_widths_match_plain_version(cuda, G, S):
    """q and k of 192, v of 128 (the (192, 128) instance of v2): causal,
    causal from q_offset 7 and bidirectional, strided and contiguous, the
    scale MLA passes (1/sqrt(192)); the output is (B, Hq, S, 128)."""
    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(S * 10 + G)
    Hkv = 16 // G if S == 4096 else 2
    for i, c in enumerate((dict(causal=True, q_offset=0, T=S),
                           dict(causal=True, q_offset=7, T=S + 7),
                           dict(causal=False, q_offset=0, T=S + 5))):
        q, k, v = _mla_case(cuda, rng, B=1, Hkv=Hkv, G=G, S=S, T=c["T"], strided=i % 2 == 0)
        kw = dict(causal=c["causal"], q_offset=c["q_offset"], scale=192 ** -0.5)
        before = fa.LAUNCHES.count
        got = fa.flash_attention(q, k, v, **kw)
        want = fa.mha_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        assert fa.LAUNCHES.count == before + 1
        assert got.shape == (1, Hkv * G, S, 128) and got.dtype == torch.bfloat16
        err, worst, bad = fa.compare(got, want, tol=BF16_TOL)
        assert bad == 0, (c, err, worst)


@pytest.mark.gpu
def test_flash_refuses_width_pairs_without_an_instance(cuda):
    from repro_torch.kernels import flash_attention as fa

    assert fa.design(192, 128) == "tma-wgmma v2" and fa.key_tile(192, 128) == 128
    assert fa.key_tile(256) == 64 and fa.key_tile(80) == 128 and fa.key_tile(16) == 128
    rng = np.random.default_rng(1)
    for d, dv in ((192, 192), (128, 192), (192, 64), (256, 128), (128, 64)):
        assert fa.design(d, dv) is None and fa.key_tile(d, dv) == 0
        q, k, v = _mla_case(cuda, rng, B=1, Hkv=2, G=1, S=70, T=70, strided=True, D=d, Dv=dv)
        before = fa.LAUNCHES.count
        with pytest.raises(ValueError, match="has no instance"):
            fa.flash_attention(q, k, v)
        assert fa.LAUNCHES.count == before
    q, k, v = _mla_case(cuda, rng, B=1, Hkv=2, G=1, S=70, T=70, strided=True)
    with pytest.raises(ValueError, match="do not fit"):
        fa.flash_attention_cuda(q, k, v[:, :, :60])


@pytest.mark.gpu
@pytest.mark.parametrize("fill", ["decode", "prefill"])
def test_moe_jam_kernel_at_deepseek_buckets(cuda, fill):
    """64 experts of 2048 x 1408 (F not a multiple of the 256-column item),
    top-6 routed uniformly: a decode tick of 8 slots (capacity 8) and a
    4,096-token prefill (capacity 480: 8 row tiles an expert)."""
    from repro_torch.kernels.moe_jam import bench

    ds = bench.DEEPSEEK
    n, c = bench.DEEPSEEK_FILLS[fill]
    counts = bench.deepseek_counts(n, c)
    x, wg, wu, wd, cnt = bench.check_inputs(cuda, counts,
                                            (ds["experts"], c, ds["d_model"], ds["d_ff"]))
    got = moe_jam.moe_jam_ffn(x, wg, wu, wd, counts=cnt)
    want = moe_jam.moe_jam_ffn_ref(x, wg, wu, wd, counts=cnt)
    torch.cuda.synchronize()
    err, worst, bad = moe_jam.compare(got, want, tol=MOE_TOL)
    assert bad == 0, (err, worst)
    empty = ~(torch.arange(c, device=cuda)[None, :] < cnt[:, None].long())
    assert (got[empty] == 0).all()


@pytest.mark.gpu
def test_mla_smoke_engine_through_kernels(cuda, monkeypatch):
    """The deepseek smoke at MLA's real head widths (2 heads, q and k of
    128 + 64, v of 128, kv_lora_rank 64) on the slots engine, prompts over
    a lowered threshold so every prefill takes flash: the kernels and the
    plain versions give the same schedule; flash launches once per layer
    per prefill, moe_jam once per MoE layer per prefill and decode tick,
    and none through the plain versions."""
    import dataclasses

    from repro_torch.models import attention

    monkeypatch.setattr(attention, "CHUNK_THRESHOLD", 64)
    smoke = get_smoke("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(smoke, attention=dataclasses.replace(
        smoke.attention, num_heads=2, num_kv_heads=2, head_dim=192, kv_lora_rank=64,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128))
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (9, 30, 17, 12)]
    runs = {}
    for kernel in ("cuda", "ref"):
        e = Engine(cfg, device=cuda, cache="auto", kernel=kernel, slots=2, max_len=64)
        e.load_params(seed=0)
        for rid, p in enumerate(prompts):
            e.submit(Request(rid, p, max_new_tokens=6))
        e.run_until_drained()
        runs[kernel] = (e.admission_log, e.ticks, e.metrics())
    assert runs["cuda"][:2] == runs["ref"][:2]
    ticks = runs["cuda"][1]
    assert runs["cuda"][2]["kernel_launches"] == {
        "flash_attention": cfg.num_layers * len(prompts),
        "moe_jam": (cfg.num_layers - 1) * (len(prompts) + ticks)}
    assert runs["ref"][2]["kernel_launches"] == {"flash_attention": 0, "moe_jam": 0}
    assert runs["cuda"][2]["nonfinite_logits"] == 0


# ---------------------------------------------------------------------------
# flash attention's gradient (training) and the grad guards
# ---------------------------------------------------------------------------

# the kernel's root-mean-square error against the float32 gradient may be
# at most this many times the plain bf16 path's (autograd through mha_ref
# on bf16 inputs). The rms, not the max: at these small shapes the largest
# error is one element's rounding, and the kernel rounds dS to bf16 for
# dq and dk where the plain path keeps it in float32 (one such case: dq
# max 0.0155 against 0.0101, max |g| 3.1)
BWD_VS_PLAIN = 1.5
# ... and its largest error within this share of the largest |float32
# gradient|
BWD_TOL = 2e-2


def _grads(fn, q, k, v, w, **kw):
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = fn(q, k, v, **kw)
    (out.float() * w).sum().backward()
    return out.detach(), q.grad, k.grad, v.grad


def _bwd_errors(q, k, v, w, kw):
    """For dq, dk, dv: (max |kernel - f32|, rms of it, rms of the plain
    bf16 path's error, max |f32|)."""
    from repro_torch.kernels import flash_attention as fa

    kern = _grads(fa.flash_attention, q, k, v, w, **kw)[1:]
    plain = _grads(fa.mha_ref, q, k, v, w, **kw)[1:]
    f32 = _grads(fa.mha_ref, q.float(), k.float(), v.float(), w, **kw)[1:]
    out = []
    for a, b, c in zip(kern, plain, f32):
        assert a.dtype == torch.bfloat16 and a.shape == c.shape
        ek, ep = a.float() - c, b.float() - c
        out.append((ek.abs().max().item(), ek.pow(2).mean().sqrt().item(),
                    ep.pow(2).mean().sqrt().item(), c.abs().max().item()))
    return out


# (D, G, S): every width and grouping at S off any tile (77, 1,111),
# exactly one 128-position tile (128) and one past it by a position (129);
# granite-20b's grouping (G 48) at D 128
BWD_CASES = ([(D, G, S) for D in (64, 128) for G in (1, 4, 8) for S in (77, 128, 129, 1111)]
             + [(128, 48, S) for S in (77, 129, 1111)])


@pytest.mark.gpu
@pytest.mark.parametrize("D,G,S", BWD_CASES)
def test_flash_bwd_matches_plain_version(cuda, D, G, S):
    """dq, dk, dv from bf16 inputs against autograd through the plain
    version in float32: within ``BWD_VS_PLAIN`` x the plain bf16 path's
    error and ``BWD_TOL`` of max |grad|; causal, windowed (17, and 100,
    whose edge ends inside a tile, from q_offset 3) from q_offset 0 and 7,
    bidirectional; strided (the model's layout) and contiguous."""
    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(D + G * 10 + S)
    cases = [dict(causal=True, window=None, q_offset=0, T=S),
             dict(causal=True, window=17, q_offset=0, T=S),
             dict(causal=True, window=None, q_offset=7, T=S + 7),
             dict(causal=False, window=None, q_offset=0, T=S + 5),
             dict(causal=True, window=100, q_offset=3, T=S + 3)]
    bad = []
    for i, c in enumerate(cases):
        q, k, v = _flash_case(cuda, rng, B=2, Hkv=2, G=G, S=S, T=c["T"], D=D,
                              strided=i % 2 == 0)
        w = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32)).to(cuda)
        kw = dict(causal=c["causal"], window=c["window"], q_offset=c["q_offset"])
        before = (fa.LAUNCHES.count, fa.BWD_LAUNCHES.count)
        errs = _bwd_errors(q, k, v, w, kw)
        assert (fa.LAUNCHES.count, fa.BWD_LAUNCHES.count) == (before[0] + 1, before[1] + 1)
        for name, (e_max, e_k, e_p, top) in zip(("dq", "dk", "dv"), errs):
            if not (e_k <= BWD_VS_PLAIN * e_p and e_max <= BWD_TOL * top):
                bad.append((c, name, e_max, e_k, e_p, top))
    assert not bad, bad


@pytest.mark.gpu
def test_flash_bwd_is_deterministic(cuda):
    """Two backward launches on the same inputs give the same bits (no
    atomics), at llama3.2-1b's heads (32/8 of 64) over 1,000 positions."""
    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(5)
    q, k, v = _flash_case(cuda, rng, B=1, Hkv=8, G=4, S=1000, T=1000, D=64, strided=True)
    out, lse = fa.flash_attention_lse_cuda(q, k, v)
    dout = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32)).to(cuda,
                                                                               torch.bfloat16)
    one = fa.flash_attention_bwd_cuda(q, k, v, out, dout, lse)
    two = fa.flash_attention_bwd_cuda(q, k, v, out, dout, lse)
    for a, b in zip(one, two):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("D,Dv", [(16, 16), (64, 64), (80, 80), (128, 128), (256, 256),
                                  (192, 128)])
def test_flash_lse_matches_logsumexp(cuda, D, Dv):
    """The forward's log-sum-exp (every instance) against ``logsumexp`` of
    the plain version's float32 scaled, masked scores; the output with
    ``lse`` on is the serving output, bit for bit."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import visible_mask

    rng = np.random.default_rng(D)
    for c in (dict(causal=True, window=None, q_offset=0),
              dict(causal=True, window=33, q_offset=5)):
        S, T = 300, 300 + c["q_offset"]
        q, k, _ = _flash_case(cuda, rng, B=2, Hkv=2, G=2, S=S, T=T, D=D, strided=True)
        v = _flash_case(cuda, rng, B=2, Hkv=2, G=1, S=1, T=T, D=Dv, strided=True)[1]
        out, lse = fa.flash_attention_lse_cuda(q, k, v, **c)
        serving = fa.flash_attention_cuda(q, k, v, **c)
        assert torch.equal(out.view(torch.int16), serving.view(torch.int16))
        kx = k.float().repeat_interleave(2, dim=1)
        s = torch.einsum("bhsd,bhtd->bhst", q.float(), kx) * D ** -0.5
        mask = visible_mask(S, T, causal=True, window=c["window"], q_offset=c["q_offset"],
                            device=cuda)
        want = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
        assert lse.shape == (2, 4, S) and lse.dtype == torch.float32
        assert (lse - want).abs().max().item() <= 1e-3 * (1 + want.abs().max().item())


@pytest.mark.gpu
def test_flash_bwd_refuses_widths_without_instance(cuda):
    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(0)
    q, k, v = _flash_case(cuda, rng, B=1, Hkv=1, G=1, S=40, T=40, D=80, strided=False)
    with pytest.raises(ValueError, match="later halves"):
        fa.flash_attention(q.requires_grad_(True), k, v)


@pytest.mark.gpu
def test_kernel_wrappers_refuse_grad(cuda):
    """Under grad no floating-point kernel returns an output autograd does
    not see: flash attention differentiates through FlashAttentionFn, the
    wrappers with no backward raise (and run under no_grad)."""
    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(1)
    q, k, v = _flash_case(cuda, rng, B=1, Hkv=2, G=2, S=64, T=64, D=64, strided=False)
    q.requires_grad_(True)
    assert fa.flash_attention(q, k, v).grad_fn is not None
    with pytest.raises(NotImplementedError, match="FlashAttentionFn"):
        fa.flash_attention_cuda(q, k, v)
    with torch.no_grad():
        fa.flash_attention_cuda(q, k, v)

    c = _case(rng, bs=16, B=2, C=4, K=2, G=2, D=64, M=4)
    pq, pk, pv, tables, starts, n_valid = _on(cuda, c[:6])
    pq = pq.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="serves only"):
        paged_attention_cuda(pq, pk, pv, tables, starts, n_valid, block_size=16)

    x = torch.randn(4, 8, 64, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    w = [torch.randn(4, 64, 64, device=cuda, dtype=torch.bfloat16) for _ in range(2)]
    wd = torch.randn(4, 64, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="MoeJamFn"):
        moe_jam.moe_jam_ffn_cuda(x, w[0], w[1], wd)
    assert moe_jam.moe_jam_ffn(x, w[0], w[1], wd).grad_fn is not None

    dt, b_, c_, xs, a = _scan_case(rng, cuda, 2, 8, 64, 16)[:5]
    with pytest.raises(NotImplementedError, match="SsmScanFn"):
        ssm_scan.ssm_scan_cuda(dt, b_, c_, xs.requires_grad_(True), a)
    assert ssm_scan.ssm_scan(dt, b_, c_, xs, a)[0].grad_fn is not None


@pytest.mark.gpu
@pytest.mark.parametrize("arch,seq_len", [pytest.param("xlstm-1.3b", 64, id="xlstm-1.3b"),
                                          pytest.param("gemma3-4b", 4096, id="gemma3-4b")])
def test_make_train_step_refuses_on_the_card(cuda, arch, seq_len):
    """xLSTM blocks, and flash attention past the chunking threshold at a
    width with no backward instance (the gemma3 smoke's D 16 at 4,096
    tokens), are refused before a step is built."""
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.runtime.steps import make_train_step

    cfg = get_smoke(arch)
    with pytest.raises(NotImplementedError, match="A13"):
        make_train_step(cfg, RunConfig(model=cfg, shape=ShapeConfig("t", seq_len, 2, "train")),
                        device=cuda)


@pytest.mark.gpu
def test_two_train_steps_on_the_card_match_the_cpu(cuda, monkeypatch):
    """A 2-layer GQA config at head dim 64 (llama's smoke widened), 2 x 256
    tokens through flash (the chunking threshold lowered): two steps on
    the card in bf16 (flash forward and backward kernels) against the same
    steps on the CPU in float32 (the plain version): each step's loss
    within 1e-2 and its grad norm within 5e-2 (relative), and the two
    steps' parameter change within 0.25 of the CPU's in L2 norm (the
    first step's lr is 0; bf16 moves the Adam direction of small
    gradients)."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
    from repro_torch.data import synthetic_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as tattn
    from repro_torch.models import model as tmodel
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.steps import make_train_step

    monkeypatch.setattr(tattn, "CHUNK_THRESHOLD", 1024)
    base = get_smoke("llama3.2-1b")
    cfg = dataclasses.replace(base, num_layers=2, remat="full",
                              attention=dataclasses.replace(base.attention, head_dim=64))
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 256, 2, "train"),
                    optimizer=OptimizerConfig(total_steps=10, warmup_steps=1, lr=1e-3))
    p0 = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    out = {}
    for dev, dtype in ((cuda, torch.bfloat16), (torch.device("cpu"), torch.float32)):
        params = tree.map_(lambda t: t.clone().to(dev), p0)
        opt = adamw_init(params)
        bundle = make_train_step(cfg, run, device=dev, compute_dtype=dtype)
        before = (fa.LAUNCHES.count, fa.BWD_LAUNCHES.count)
        metrics = []
        for s in range(2):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in synthetic_batch(cfg, run.shape, s).items()}
            params, opt, m = bundle.fn(params, opt, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        launches = (fa.LAUNCHES.count - before[0], fa.BWD_LAUNCHES.count - before[1])
        out[dev.type] = (metrics, tree.map_(lambda t: t.cpu(), params), launches)
    (mc, pc, lc), (mf, pf, lf) = out["cuda"], out["cpu"]
    assert lc == (2 * 2 * 2, 2 * 2) and lf == (0, 0)     # remat: two forwards a layer
    for a, b in zip(mc, mf):
        assert abs(a["loss"] - b["loss"]) <= 1e-2 * b["loss"], (a, b)
        assert abs(a["grad_norm"] - b["grad_norm"]) <= 5e-2 * b["grad_norm"], (a, b)
    du = torch.cat([(a - p).flatten() for a, p in zip(tree.leaves(pc), tree.leaves(p0))])
    dw = torch.cat([(a - p).flatten() for a, p in zip(tree.leaves(pf), tree.leaves(p0))])
    assert (du - dw).norm() <= 0.25 * dw.norm()


# ---------------------------------------------------------------------------
# the moe_jam backward kernel (MoE training)
# ---------------------------------------------------------------------------

# the backward kernel against its plain version on the same bf16 inputs,
# per element within tol * (rms of the element's row + |plain|)
# (``moe_jam.compare``): both sum the same products in float32 in other
# orders and round h, dG and dU to bf16 before their products, so such a
# rounding may land on the neighbouring bf16 value (2^-7 of it), and each
# output is bf16 (the neighbouring value at most, 2^-7 of |plain|). dx
# sums F terms, where one term's step is a small share: 1e-2, as the
# forward. A weight gradient sums an expert's kept rows alone (1 to C):
# where a few large terms cancel, one term's step is a larger share of
# the sum and of its row's rms (1.6e-2 of it seen at olmoe's buckets, C 40,
# with the kernel's L2 error against float32 equal to the plain path's to
# 4 digits): 3e-2
MOE_BWD_TOL, MOE_DW_TOL = 1e-2, 3e-2
MOE_BWD_SHAPES = [(8, 8, 64, 32), (3, 65, 64, 96), (4, 130, 96, 160), (2, 300, 128, 1408),
                  (64, 40, 2048, 1024), (1, 24, 64, 96)]


def _moe_bwd_case(cuda, e, c, d, f, seed):
    rng = np.random.default_rng(seed)
    x, ws, counts = _moe_case(rng, e, c, d, f, "mixed")
    bf = lambda a: torch.from_numpy(a).to(cuda, torch.bfloat16)      # noqa: E731
    dy = rng.normal(size=(e, c, d)).astype(np.float32)
    return (bf(x), *map(bf, ws), bf(dy),
            torch.from_numpy(counts.astype(np.int32)).to(cuda))


def _bwd_disagreements(got, x, wg, wu, wd, dy, cnt, act="silu"):
    """The gradients that miss the plain version on the same bf16 inputs
    (``MOE_BWD_TOL``, ``MOE_DW_TOL``), or float32 by more than
    ``BWD_VS_PLAIN`` x the plain path's L2 error, or hold a non-finite
    value."""
    plain = moe_jam.moe_jam_ffn_bwd_ref(x, wg, wu, wd, dy, act, counts=cnt)
    f32 = moe_jam.moe_jam_ffn_bwd_ref(*(t.float() for t in (x, wg, wu, wd, dy)), act,
                                      counts=cnt)
    bad = []
    for name, a, b, ref in zip(("dx", "dw_gate", "dw_up", "dw_down"), got, plain, f32):
        err, worst, n_bad = moe_jam.compare(a, b, tol=MOE_DW_TOL if name[1] == "w"
                                            else MOE_BWD_TOL)
        e_k = (a.float() - ref).norm() / ref.norm()
        e_p = (b.float() - ref).norm() / ref.norm()
        if n_bad or not e_k <= BWD_VS_PLAIN * e_p or not torch.isfinite(a).all():
            bad.append((name, err, worst, n_bad, float(e_k), float(e_p)))
    return bad


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("e,c,d,f", MOE_BWD_SHAPES)
def test_moe_jam_bwd_matches_plain_version(cuda, e, c, d, f, act):
    x, wg, wu, wd, dy, cnt = _moe_bwd_case(cuda, e, c, d, f, e * c + f)
    before = moe_jam.BWD_LAUNCHES.count
    got = moe_jam.moe_jam_ffn_bwd_cuda(x, wg, wu, wd, dy, act, counts=cnt)
    torch.cuda.synchronize()
    assert moe_jam.BWD_LAUNCHES.count == before + 1
    for a, like in zip(got, (x, wg, wu, wd)):
        assert a.dtype == torch.bfloat16 and a.shape == like.shape
    bad = _bwd_disagreements(got, x, wg, wu, wd, dy, cnt, act)
    assert not bad, bad
    empty = ~(torch.arange(c, device=cuda)[None, :] < cnt[:, None].long())
    assert (got[0][empty] == 0).all()
    idle = cnt == 0
    assert all((w[idle] == 0).all() for w in got[1:])


@pytest.mark.gpu
def test_moe_jam_bwd_is_deterministic(cuda):
    """Two launches on the same inputs give the same bits (no atomics), at
    olmoe's widths over 130 rows an expert."""
    args = _moe_bwd_case(cuda, 8, 130, 2048, 1024, 3)
    one = moe_jam.moe_jam_ffn_bwd_cuda(*args[:5], counts=args[5])
    two = moe_jam.moe_jam_ffn_bwd_cuda(*args[:5], counts=args[5])
    for a, b in zip(one, two):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("e,c,d,f", [(5, 130, 96, 160), (4, 70, 2048, 1408)])
def test_moe_jam_bwd_ignores_rows_past_counts(cuda, e, c, d, f):
    """x and dy rows past counts hold NaN: the gradients equal those of the
    bucket with those rows zeroed, every one finite; dx past counts and an
    empty expert's weight gradients are exact zeros."""
    x, wg, wu, wd, dy, cnt = _moe_bwd_case(cuda, e, c, d, f, e + c)
    empty = ~(torch.arange(c, device=cuda)[None, :] < cnt[:, None].long())
    nan = lambda t: t.masked_fill(empty[:, :, None], float("nan"))   # noqa: E731
    got = moe_jam.moe_jam_ffn_bwd_cuda(nan(x), wg, wu, wd, nan(dy), counts=cnt)
    want = moe_jam.moe_jam_ffn_bwd_cuda(x, wg, wu, wd, dy.masked_fill(empty[:, :, None], 0),
                                        counts=cnt)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.isfinite(a).all() and torch.equal(a.view(torch.int16),
                                                       b.view(torch.int16))
    assert (got[0][empty] == 0).all()
    assert all((w[cnt == 0] == 0).all() for w in got[1:])


@pytest.mark.gpu
@pytest.mark.parametrize("d,f", [(128, 96), (96, 160)])
def test_moe_jam_bwd_at_row_tile_edges(cuda, d, f):
    """Kept rows at each edge of the 128-row items and the 64-row stages of
    the weight gradients' reduction (0, 1, 63, 64, 65, 127, 128, 129 and C
    of C 300), with NaN in x and dy past counts: the gradients hold the
    plain version, dx past counts and the empty expert's weight gradients
    are exact zeros."""
    counts = np.array([0, 1, 63, 64, 65, 127, 128, 129, 300])
    e, c = len(counts), 300
    rng = np.random.default_rng(d + f)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda, torch.bfloat16)  # noqa: E731
    empty = ~(np.arange(c)[None, :] < counts[:, None])[:, :, None]
    x, dy = (np.where(empty, np.nan, rng.normal(size=(e, c, d))) for _ in range(2))
    wg, wu = (rng.normal(size=(e, d, f)) / np.sqrt(d) for _ in range(2))
    wd = rng.normal(size=(e, f, d)) / np.sqrt(f)
    ins = (bf(x), bf(wg), bf(wu), bf(wd), bf(dy))
    cnt = torch.from_numpy(counts.astype(np.int32)).to(cuda)
    got = moe_jam.moe_jam_ffn_bwd_cuda(*ins, counts=cnt)
    torch.cuda.synchronize()
    assert not _bwd_disagreements(got, *ins, cnt)
    assert (got[0][torch.from_numpy(empty[..., 0]).to(cuda)] == 0).all()
    assert all((w[0] == 0).all() for w in got[1:])


@pytest.mark.gpu
def test_moe_jam_bwd_with_every_expert_empty(cuda):
    """Counts all 0 and NaN in every row of x and dy: every gradient is
    exact zeros (dx, and the weight gradients the kernel writes over the
    wrapper's uninitialised outputs)."""
    x, wg, wu, wd, dy, _ = _moe_bwd_case(cuda, 5, 130, 96, 160, 21)
    nan = torch.full_like(x, float("nan"))
    got = moe_jam.moe_jam_ffn_bwd_cuda(nan, wg, wu, wd, nan, "gelu",
                                       counts=torch.zeros(5, dtype=torch.int32, device=cuda))
    torch.cuda.synchronize()
    for a in got:
        assert torch.equal(a, torch.zeros_like(a))


@pytest.mark.gpu
def test_moe_jam_bwd_is_deterministic_at_olmoe_train_buckets(cuda):
    """Two launches give the same bits at olmoe-1b-7b's training buckets
    (``bench.TRAIN``: 64 x 1,280 x 2,048, F 1,024, a micro-batch routed
    uniformly top-8)."""
    from repro_torch.kernels.moe_jam import bench as mbench

    e, d, f, k, tokens, c = mbench.TRAIN["olmoe-1b-7b train"]
    counts = mbench.train_counts(tokens, e, k, c)
    x, wg, wu, wd, dy, cnt = mbench.bwd_inputs(cuda, counts, (e, c, d, f))
    one = moe_jam.moe_jam_ffn_bwd_cuda(x, wg, wu, wd, dy, counts=cnt)
    two = moe_jam.moe_jam_ffn_bwd_cuda(x, wg, wu, wd, dy, counts=cnt)
    for a, b in zip(one, two):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.gpu
def test_moe_jam_ffn_under_grad_runs_moe_jam_fn(cuda):
    """Under grad the wrapper runs MoeJamFn: one forward and one backward
    launch, the output the serving kernel's bit for bit and the inputs'
    gradients the backward kernel's."""
    x, wg, wu, wd, dy, cnt = _moe_bwd_case(cuda, 6, 70, 128, 96, 11)
    ins = [t.detach().requires_grad_(True) for t in (x, wg, wu, wd)]
    before = (moe_jam.LAUNCHES.count, moe_jam.BWD_LAUNCHES.count)
    out = moe_jam.moe_jam_ffn(*ins, "gelu", counts=cnt)
    grads = torch.autograd.grad(out, ins, dy)
    assert (moe_jam.LAUNCHES.count, moe_jam.BWD_LAUNCHES.count) == (before[0] + 1,
                                                                    before[1] + 1)
    with torch.no_grad():
        serving = moe_jam.moe_jam_ffn_cuda(x, wg, wu, wd, "gelu", counts=cnt)
    want = moe_jam.moe_jam_ffn_bwd_cuda(x, wg, wu, wd, dy, "gelu", counts=cnt)
    assert torch.equal(out.detach().view(torch.int16), serving.view(torch.int16))
    for a, b in zip(grads, want):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.gpu
def test_two_moe_train_steps_on_the_card_match_the_cpu(cuda):
    """The olmoe smoke (2 MoE layers, 8 experts top-2, D 64, F 32), 4 x 64
    tokens, two steps on the card in bf16 (both moe_jam kernels; plain
    ``_sdpa`` below the chunking threshold) against the same steps on the
    CPU in float32: each step's loss within 2e-2 (relative; bf16 moves a
    few router choices) and finite grad norms; moe_jam's forward and
    backward each launch once a layer a step, and the bundle names them."""
    from repro_torch import tree
    from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
    from repro_torch.data import synthetic_batch
    from repro_torch.models import model as tmodel
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.steps import make_train_step

    cfg = get_smoke("olmoe-1b-7b")
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 64, 4, "train"),
                    optimizer=OptimizerConfig(total_steps=10, warmup_steps=1, lr=1e-3))
    p0 = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    out = {}
    for dev, dtype in ((cuda, torch.bfloat16), (torch.device("cpu"), torch.float32)):
        params = tree.map_(lambda t: t.clone().to(dev), p0)
        opt = adamw_init(params)
        bundle = make_train_step(cfg, run, device=dev, compute_dtype=dtype)
        assert {"moe_jam", "moe_jam_bwd"} <= set(bundle.meta["kernels"])
        before = (moe_jam.LAUNCHES.count, moe_jam.BWD_LAUNCHES.count)
        metrics = []
        for s in range(2):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in synthetic_batch(cfg, run.shape, s).items()}
            params, opt, m = bundle.fn(params, opt, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        out[dev.type] = (metrics, (moe_jam.LAUNCHES.count - before[0],
                                   moe_jam.BWD_LAUNCHES.count - before[1]))
    (mc, lc), (mf, lf) = out["cuda"], out["cpu"]
    assert lc == (2 * cfg.num_layers, 2 * cfg.num_layers) and lf == (0, 0)
    for a, b in zip(mc, mf):
        assert np.isfinite(a["grad_norm"]) and a["grad_norm"] > 0, a
        assert abs(a["loss"] - b["loss"]) <= 2e-2 * b["loss"], (a, b)


# ---------------------------------------------------------------------------
# the selective scan's backward kernel (SSM and hybrid training)
# ---------------------------------------------------------------------------

def _scan_bwd_case(cuda, b, s, i, n, seed, *, off=False):
    """``_scan_case``'s inputs with n_valid 0, 1, s - 3 (at least 1), s
    and the rest full, x copied 2 bytes off a 16-byte boundary where
    ``off``, and the cotangents dy (bf16) and dh_last (f32)."""
    rng = np.random.default_rng(seed)
    dt, bb, cc, x, a, h0 = _scan_case(rng, cuda, b, s, i, n)
    if off:
        x = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)[1:].view(x.shape).copy_(x)
    nv = ([0, 1, max(s - 3, 1), s] + [s] * b)[:b]
    n_valid = torch.tensor(nv, dtype=torch.int32, device=cuda)
    dy = torch.from_numpy(rng.standard_normal((b, s, i)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    dh = torch.from_numpy(rng.standard_normal((b, i, n)).astype(np.float32)).to(cuda)
    return dt, bb, cc, x, a, h0, n_valid, dy, dh


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 7, 8, 9, 33, 4096])
@pytest.mark.parametrize("i,n,off", [(130, 16, False), (200, 8, False), (1536, 16, False),
                                     (1536, 8, True), (96, 4, False)])
def test_ssm_scan_bwd_matches_plain_version(cuda, i, n, off, s):
    """Stage and chunk edges (S 1, 7, 8, 9, 33, 4,096), channels past the
    last 64-channel tile, N 4, 8 and 16, rows with 0, 1, partial and full
    valid prefixes, the training forward on the route the shape takes
    (TMA at N 8 and 16 with I a multiple of 8; direct at N 4, I 130 and x
    off 16 bytes): its y and h_last bit for bit the serving forward's; the
    backward within ``compare_bwd``'s rule of the plain version and
    float32, gated columns exact zeros, one launch counted."""
    from repro_torch.kernels.ssm_scan.kernel import n_chunks, scan_route

    dt, bb, cc, x, a, h0, n_valid, dy, dh = _scan_bwd_case(cuda, 4, s, i, n, i + n + s, off=off)
    assert scan_route(dt, bb, cc, x) == ("tma" if n > 4 and i % 8 == 0 and not off
                                         else "direct")
    y, h, states = ssm_scan.ssm_scan_train_cuda(dt, bb, cc, x, a, h0, n_valid)
    ys, hs = ssm_scan.ssm_scan_cuda(dt, bb, cc, x, a, h0, n_valid)
    assert states.shape == (4, n_chunks(s), i, n)
    assert torch.equal(y.view(torch.int16), ys.view(torch.int16)) and torch.equal(h, hs)
    before = ssm_scan.BWD_LAUNCHES.count
    got = ssm_scan.ssm_scan_bwd_cuda(dt, bb, cc, x, a, states, dy, n_valid, dh)
    torch.cuda.synchronize()
    assert ssm_scan.BWD_LAUNCHES.count == before + 1
    for g, like in zip(got, (dt, bb, cc, x)):
        assert g.dtype == torch.bfloat16 and g.shape == like.shape
    assert got[4].shape == (i, n) and got[5].shape == (4, i, n)
    plain = ssm_scan.ssm_scan_bwd_ref(dt, bb, cc, x, a, dy, h0, n_valid, dh)
    f32 = ssm_scan.ssm_scan_bwd_ref(dt.float(), bb.float(), cc.float(), x.float(), a,
                                    dy.float(), h0, n_valid, dh)
    stats, bad = ssm_scan.compare_bwd(got, plain, f32, n_valid)
    assert not bad, {k: stats[k] for k in bad}
    assert torch.equal(got[5][0], dh[0])             # an empty row passes dh_last through


@pytest.mark.gpu
def test_ssm_scan_bwd_is_deterministic(cuda):
    """Two launches give the same bits (no atomics) at mamba-130m's
    training micro-batch (2 x 4,096 x 1,536, N 16, no gate, no dh_last)."""
    dt, bb, cc, x, a, _, _, dy, _ = _scan_bwd_case(cuda, 2, 4096, 1536, 16, 5)
    states = ssm_scan.ssm_scan_train_cuda(dt, bb, cc, x, a)[2]
    one = ssm_scan.ssm_scan_bwd_cuda(dt, bb, cc, x, a, states, dy)
    two = ssm_scan.ssm_scan_bwd_cuda(dt, bb, cc, x, a, states, dy)
    for p, q in zip(one, two):
        bits = torch.int16 if p.dtype == torch.bfloat16 else torch.int32
        assert torch.equal(p.view(bits), q.view(bits))


@pytest.mark.gpu
@pytest.mark.parametrize("gated", [True, False])
def test_ssm_scan_under_grad_runs_ssm_scan_fn(cuda, gated):
    """Under grad the wrapper runs SsmScanFn: one forward and one backward
    launch, y and h_last the serving kernel's bit for bit and the inputs'
    gradients the backward kernel's; with n_valid and h0 None (as training
    runs it) h0 gets none."""
    dt, bb, cc, x, a, h0, n_valid, dy, dh = _scan_bwd_case(cuda, 4, 70, 200, 16, 9)
    if not gated:
        h0, n_valid, dh = None, None, None
    ins = [t.detach().requires_grad_(True) for t in (dt, bb, cc, x, a)]
    ins += [] if h0 is None else [h0.detach().requires_grad_(True)]
    before = (ssm_scan.LAUNCHES.count, ssm_scan.BWD_LAUNCHES.count)
    y, h = ssm_scan.ssm_scan(*ins[:5], ins[5] if h0 is not None else None, n_valid)
    grads = torch.autograd.grad((y, h), ins, (dy, torch.zeros_like(h) if dh is None else dh))
    assert (ssm_scan.LAUNCHES.count, ssm_scan.BWD_LAUNCHES.count) == (before[0] + 1,
                                                                      before[1] + 1)
    with torch.no_grad():
        ys, hs, states = ssm_scan.ssm_scan_train_cuda(dt, bb, cc, x, a, h0, n_valid)
    want = ssm_scan.ssm_scan_bwd_cuda(dt, bb, cc, x, a, states, dy, n_valid,
                                      torch.zeros_like(hs) if dh is None else dh)
    assert torch.equal(y.detach().view(torch.int16), ys.view(torch.int16))
    assert torch.equal(h.detach(), hs)
    for g, w in zip(grads, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba-130m", "hymba-1.5b"])
def test_two_ssm_train_steps_on_the_card_match_the_cpu(cuda, arch):
    """The mamba and hymba smokes with N widened to 16 (inner 128: the
    forward's TMA route) and remat full (the forward recomputed on
    autograd's thread), 4 x 64 tokens, two steps on the card in bf16 (both
    scan kernels; hymba's attention on plain ``_sdpa`` below the chunking
    threshold) against the same steps on the CPU in float32: each step's
    loss within 1e-2 and its grad norm within 5e-2 (relative); the scan's
    forward launches twice a layer a step (remat) and its backward once,
    and the bundle names both."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
    from repro_torch.data import synthetic_batch
    from repro_torch.models import model as tmodel
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.steps import make_train_step

    base = get_smoke(arch)
    cfg = dataclasses.replace(base, remat="full",
                              ssm=dataclasses.replace(base.ssm, state_dim=16))
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 64, 4, "train"),
                    optimizer=OptimizerConfig(total_steps=10, warmup_steps=1, lr=1e-3))
    p0 = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    out = {}
    for dev, dtype in ((cuda, torch.bfloat16), (torch.device("cpu"), torch.float32)):
        params = tree.map_(lambda t: t.clone().to(dev), p0)
        opt = adamw_init(params)
        bundle = make_train_step(cfg, run, device=dev, compute_dtype=dtype)
        assert {"ssm_scan", "ssm_scan_bwd"} <= set(bundle.meta["kernels"])
        before = (ssm_scan.LAUNCHES.count, ssm_scan.BWD_LAUNCHES.count)
        metrics = []
        for step in range(2):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in synthetic_batch(cfg, run.shape, step).items()}
            params, opt, m = bundle.fn(params, opt, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        out[dev.type] = (metrics, (ssm_scan.LAUNCHES.count - before[0],
                                   ssm_scan.BWD_LAUNCHES.count - before[1]))
    (mc, lc), (mf, lf) = out["cuda"], out["cpu"]
    assert lc == (2 * 2 * cfg.num_layers, 2 * cfg.num_layers) and lf == (0, 0)
    for a, b in zip(mc, mf):
        assert abs(a["loss"] - b["loss"]) <= 1e-2 * b["loss"], (a, b)
        assert abs(a["grad_norm"] - b["grad_norm"]) <= 5e-2 * b["grad_norm"], (a, b)
