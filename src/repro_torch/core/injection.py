"""Injected-function helpers: function state (expert weights) into frame
STATE words and back, and activations into USR words.

The port of ``repro/core/injection.py``; the words are the JAX package's,
bit for bit (paper Fig. 2: the function's state travels in the message).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.message import FrameSpec, bf16_to_words, words_to_bf16


def expert_state_words(w_gate: torch.Tensor, w_up: torch.Tensor,
                       w_down: torch.Tensor) -> torch.Tensor:
    """One expert's (d, f), (d, f), (f, d) bf16 weights as int32 words."""
    return torch.cat([bf16_to_words(w_gate), bf16_to_words(w_up),
                      bf16_to_words(w_down)])


def expert_state_size_words(d_model: int, d_ff: int) -> int:
    return 3 * ((d_model * d_ff + 1) // 2)


def unpack_expert_state(words: torch.Tensor, d_model: int, d_ff: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    per = d_model * d_ff
    w = (per + 1) // 2
    return (words_to_bf16(words[:w], per, (d_model, d_ff)),
            words_to_bf16(words[w:2 * w], per, (d_model, d_ff)),
            words_to_bf16(words[2 * w:3 * w], per, (d_ff, d_model)))


def injected_frame_spec(d_model: int, d_ff: int, payload_tokens: int,
                        got_slots: int = 4) -> FrameSpec:
    """FrameSpec of a weights-in-message expert jam: STATE carries the
    expert, USR ``payload_tokens`` activation vectors (bf16)."""
    return FrameSpec(got_slots=got_slots,
                     state_words=expert_state_size_words(d_model, d_ff),
                     payload_words=(payload_tokens * d_model + 1) // 2)


def tokens_to_words(x: torch.Tensor) -> torch.Tensor:
    return bf16_to_words(x)


def words_to_tokens(words: torch.Tensor, n: int, d: int) -> torch.Tensor:
    return words_to_bf16(words, n * d, (n, d))
