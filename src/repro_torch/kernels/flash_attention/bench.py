"""Prefill-shaped inputs and the work count of flash attention.

``chip_smoke.py`` takes its flash-attention checks from here. Run as a
module on a machine with a CUDA card, it times the kernel, its plain
version and ``scaled_dot_product_attention`` (the L2 cache flushed before
every launch) against the bound at each check shape, with the SFUs' floor
for the softmax's exponentials beside it (``sfu_ms``), and prints the
share of the key tiles the kernel visits that take the per-element mask,
as the kernel counts them on the device (``kernel.tile_counts``):

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.bench

The shapes: gemma3-4b's prefill of 4,096 tokens (8 query heads over 4 kv
heads of 256), causal, on a global layer (no window) and on a local one
(window 1,024); granite-20b's heads (48 over 1 of 128) at 2,304 tokens;
an odd one, 32 heads of 80 (MHA) at 2,113 tokens, batch 2, queries
starting at position 7 of 2,113 keys; deepseek-v2-lite-16b's MLA
prefill of 4,096 tokens, 16 heads (MHA) with q and k of 192 and v of 128,
causal; hymba-1.5b's prefill of 4,096 tokens (25 query heads over 5
kv heads of 64), causal, on a global layer and on a local one (window
1,024); qwen2-vl-72b's prefill of 4,096 tokens (64 query heads over 8 kv
heads of 128), causal; hubert-xlarge's encoder over two clips of
4,096 frames (16 heads of 80, MHA), without the causal mask; and
llama3.2-1b's prefill of 4,096 tokens (32 query heads over 8 kv heads of
64), causal, as the cluster phase's slots replicas run it. ``BWD_SHAPES``
are the backward's, which ``chip_smoke.py`` checks and times.
"""
from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.timing import bound_ms, card_name, l2_flush_buffer, sfu_ms, timed_ms

# name -> (B, Hq, Hkv, S, T, D, causal, window, q_offset, Dv): q and k of
# width D, v and the output of width Dv
SHAPES = {
    "gemma3-4b global": (1, 8, 4, 4096, 4096, 256, True, None, 0, 256),
    "gemma3-4b local": (1, 8, 4, 4096, 4096, 256, True, 1024, 0, 256),
    "granite-20b": (1, 48, 1, 2304, 2304, 128, True, None, 0, 128),
    "odd": (2, 32, 32, 2113, 2113, 80, True, None, 7, 80),
    "deepseek-v2-lite mla": (1, 16, 16, 4096, 4096, 192, True, None, 0, 128),
    "hymba-1.5b global": (1, 25, 5, 4096, 4096, 64, True, None, 0, 64),
    "hymba-1.5b local": (1, 25, 5, 4096, 4096, 64, True, 1024, 0, 64),
    "qwen2-vl-72b": (1, 64, 8, 4096, 4096, 128, True, None, 0, 128),
    "hubert-xlarge": (2, 16, 16, 4096, 4096, 80, False, None, 0, 80),
    "llama3.2-1b": (1, 32, 8, 4096, 4096, 64, True, None, 0, 64),
}


# the backward's check shapes (the same fields): llama3.2-1b's training
# micro-batch (2 x 4,096 tokens, 32 query heads over 8 kv heads of 64,
# causal), a windowed D 128 case and olmoe-1b-7b's training micro-batch
# (2 x 4,096 tokens, 16 heads of 128, MHA: G 1, causal)
BWD_SHAPES = {
    "llama3.2-1b train": (2, 32, 8, 4096, 4096, 64, True, None, 0, 64),
    "windowed D 128": (1, 32, 8, 4096, 4096, 128, True, 1024, 0, 128),
    "olmoe-1b-7b train": (2, 16, 16, 4096, 4096, 128, True, None, 0, 128),
}


def check_inputs(device, shape, seed: int = 0):
    """(q, k, v) bf16 on ``device`` from numpy seed ``seed``: standard
    normals, so the scaled scores of a row spread over ~1 (head dim's
    square root divides them). q is a (B, Hq, S, D) view of a (B, S, Hq, D)
    tensor, as the model passes its projections; k and v (of width Dv)
    likewise."""
    B, Hq, Hkv, S, T, D = shape[:6]
    Dv = shape[9]
    rng = np.random.default_rng(seed)

    def bf16(*dims):
        x = rng.standard_normal(dims, dtype=np.float32)
        return torch.from_numpy(x).to(device=device, dtype=torch.bfloat16).permute(0, 2, 1, 3)

    return bf16(B, S, Hq, D), bf16(B, T, Hkv, D), bf16(B, T, Hkv, Dv)


def visible_pairs(s: int, t: int, *, causal: bool, window: Optional[int],
                  q_offset: int = 0) -> int:
    """(query, key) pairs of one head with the key visible to the query."""
    q_pos = np.arange(s, dtype=np.int64) + q_offset
    hi = np.minimum(q_pos, t - 1) if causal else np.full(s, t - 1, np.int64)
    lo = np.maximum(q_pos - window + 1, 0) if window is not None else np.zeros(s, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def needed_work(shape) -> dict:
    """The bytes and operations one call needs, for its bound: q, k, v read
    once and the output written once (bf16; q and k of width D, v and the
    output of width Dv); 2 (D + Dv) flops per visible pair and query head
    (2 D for q . k, 2 Dv for p . v), on the tensor cores; and one
    exponential per visible pair and query head (``exps``, on the SFUs:
    ``timing.sfu_ms``)."""
    B, Hq, Hkv, S, T, D, causal, window, q_offset, Dv = shape
    pairs = B * Hq * visible_pairs(S, T, causal=causal, window=window, q_offset=q_offset)
    nbytes = 2 * (B * Hq * S * (D + Dv) + B * Hkv * T * (D + Dv))
    return dict(bytes=nbytes, flops=2 * (D + Dv) * pairs, pairs=pairs, exps=pairs)


def needed_bwd_work(shape) -> dict:
    """The bytes and operations the backward needs, for its bound: q, k, v,
    out, dout (bf16) and lse (float32) read once, dq, dk, dv (bf16)
    written once; 2.5x the forward's flops (dV, dP, dK and dQ products, and
    the score product once)."""
    B, Hq, Hkv, S, T, D, causal, window, q_offset, Dv = shape
    fwd = needed_work(shape)
    nbytes = 2 * (B * Hq * S * (2 * D + 2 * Dv) + 2 * B * Hkv * T * (D + Dv)) + 4 * B * Hq * S
    return dict(bytes=nbytes, flops=int(2.5 * fwd["flops"]), pairs=fwd["pairs"])


def bwd_yardstick(q, k, v, shape, dout):
    """(forward, forward + backward) of one ``scaled_dot_product_attention``
    call on leaf copies of the same tensors: its backward's time is the
    second's less the first's."""
    qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    fwd = yardstick(qs, ks, vs, shape)

    def both():
        return torch.autograd.grad(fwd(), (qs, ks, vs), dout)

    return fwd, both


def _sdpa_mask(shape, device):
    """``(attn_mask, is_causal)`` for ``yardstick``: no mask where every key
    is visible, ``is_causal`` where the mask is the plain causal one, else
    the boolean (S, T) mask."""
    from repro_torch.kernels.flash_attention.ref import visible_mask

    B, Hq, Hkv, S, T, D, causal, window, q_offset, Dv = shape
    if window is None and (not causal or (q_offset == 0 and S == T)):
        return None, causal
    return visible_mask(S, T, causal=causal, window=window, q_offset=q_offset,
                        device=device), False


def yardstick(q, k, v, shape):
    """One ``scaled_dot_product_attention`` call on the same tensors, with
    the mask ``_sdpa_mask`` gives."""
    mask, is_causal = _sdpa_mask(shape, q.device)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(q, k, v, attn_mask=mask, is_causal=is_causal,
                        enable_gqa=shape[1] != shape[2])


def yardstick_backend(q, k, v, shape) -> str:
    """The backend PyTorch's dispatch picks for ``yardstick``'s call on
    these tensors (``FLASH_ATTENTION``, ``EFFICIENT_ATTENTION``,
    ``CUDNN_ATTENTION`` or ``MATH``)."""
    from torch.nn.attention import SDPBackend

    mask, is_causal = _sdpa_mask(shape, q.device)
    choice = torch._fused_sdp_choice(q, k, v, attn_mask=mask, is_causal=is_causal,
                                     enable_gqa=shape[1] != shape[2])
    return {b.value: name for name, b in SDPBackend.__members__.items()}[choice]


def main() -> int:
    from repro_torch.kernels.flash_attention.ops import (compare, flash_attention_cuda,
                                                         mha_ref, tile_counts)

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card: this times the CUDA kernel")
    dev = torch.device("cuda")
    flush = l2_flush_buffer(dev)
    rows = []
    for name, shape in SHAPES.items():
        q, k, v = check_inputs(dev, shape)
        kw = dict(causal=shape[6], window=shape[7], q_offset=shape[8])
        err, _, bad = compare(flash_attention_cuda(q, k, v, **kw), mha_ref(q, k, v, **kw))
        work = needed_work(shape)
        bound, by = bound_ms(work)
        walk = tile_counts(q, k, v, **kw)
        walk["masked_share"] = walk["masked"] / max(walk["visited"], 1)
        rows.append(dict(
            shape=name, **walk, pairs=work["pairs"], flops=work["flops"], bytes=work["bytes"],
            bound_ms=bound, bound_by=by, sfu_ms=sfu_ms(work), max_abs_err=err,
            over_tolerance=bad,
            ms=timed_ms(lambda: flash_attention_cuda(q, k, v, **kw), 50, flush),
            plain_ms=timed_ms(lambda: mha_ref(q, k, v, **kw), 5, flush),
            library_ms=timed_ms(yardstick(q, k, v, shape), 50, flush),
            library_backend=yardstick_backend(q, k, v, shape)))
        r = rows[-1]
        print(f"[bench] flash_attention {name}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms "
              f"({r['library_backend']}), bound {bound:.4f} ms "
              f"({by}; {work['pairs']} visible pairs), SFU floor {r['sfu_ms']:.4f} ms; "
              f"max |kernel - plain| {err:.3e}; "
              f"{walk['design']}: the mask on {walk['masked']} of {walk['visited']} visited "
              f"tiles ({walk['masked_share']:.3f})", flush=True)
        del q, k, v
    print(json.dumps({"card": card_name(), "flash_attention": rows}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
