"""Deterministic synthetic LM data: the JAX package's batches, bit for bit.

Batches are a pure function of (seed, step), so a restarted job resumes
the exact token stream (a checkpoint stores only the step counter). The
token stream is an order-2 Markov-ish mix, so the LM loss falls in a few
steps (uniform tokens would pin it at log V). Host-side numpy, as in
``repro/data/synthetic.py``: the same generator, draws and order.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


def batch_shapes(cfg: ModelConfig, shape: ShapeConfig,
                 batch_override: Optional[int] = None) -> Dict[str, Any]:
    """Shapes/dtypes of one global batch."""
    b = batch_override or shape.global_batch
    s = shape.seq_len
    out = {"tokens": ((b, s), np.int32), "labels": ((b, s), np.int32)}
    if cfg.frontend.kind == "audio_frames":
        out["features"] = ((b, s, cfg.frontend.feature_dim), np.float32)
    elif cfg.frontend.kind == "vision_patches":
        out["features"] = ((b, cfg.frontend.num_patch_tokens, cfg.d_model), np.float32)
    if cfg.attention is not None and cfg.attention.mrope:
        out["mrope_positions"] = ((3, b, s), np.int32)
    return out


def synthetic_batch(cfg: ModelConfig, shape: ShapeConfig, step: int, seed: int = 0,
                    batch_override: Optional[int] = None) -> Dict[str, np.ndarray]:
    """One global batch for ``step``: numpy, host-side, deterministic."""
    b = batch_override or shape.global_batch
    s = shape.seq_len
    rng = np.random.default_rng(np.uint64(seed) * np.uint64(1_000_003) + np.uint64(step))
    v = cfg.vocab_size
    # structured stream: tok[t+1] = (a*tok[t] + 7) mod V, with 10% noise
    a = 31 if v > 31 else 3
    base = rng.integers(0, v, size=(b, 1), dtype=np.int64)
    noise = (rng.random((b, s)) < 0.1) * rng.integers(0, v, size=(b, s))
    toks = np.empty((b, s), np.int64)
    toks[:, 0] = base[:, 0]
    for t in range(1, s):
        toks[:, t] = (a * toks[:, t - 1] + 7) % v
    toks = np.where(noise > 0, noise, toks).astype(np.int32) % v
    out: Dict[str, np.ndarray] = {"tokens": toks, "labels": toks.copy()}
    if cfg.frontend.kind == "audio_frames":
        out["features"] = rng.standard_normal(
            (b, s, cfg.frontend.feature_dim)).astype(np.float32)
        # encoder-only masked prediction: labels are codebook ids
        out["labels"] = rng.integers(0, v, size=(b, s)).astype(np.int32)
    elif cfg.frontend.kind == "vision_patches":
        out["features"] = rng.standard_normal(
            (b, cfg.frontend.num_patch_tokens, cfg.d_model)).astype(np.float32)
    if cfg.attention is not None and cfg.attention.mrope:
        pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
        out["mrope_positions"] = np.stack([pos, pos, pos], 0)
    return out
