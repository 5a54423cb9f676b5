"""Architecture registry for the archs the port serves.

The JAX package registers eleven archs; the port serves the ones whose
whole path is ported. Asking for any other raises and names the ROADMAP
item that brings it.
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.configs import (deepseek_v2_lite_16b, gemma3_4b, granite_20b, llama32_1b,
                                 mamba_130m, olmoe_1b_7b, stablelm_3b)
from repro_torch.configs.base import ModelConfig

_MODULES = (llama32_1b, olmoe_1b_7b, mamba_130m, gemma3_4b, stablelm_3b, granite_20b,
            deepseek_v2_lite_16b)

ARCHS: Dict[str, Callable[[], ModelConfig]] = {m.ARCH_ID: m.config for m in _MODULES}
SMOKES: Dict[str, Callable[[], ModelConfig]] = {m.ARCH_ID: m.smoke for m in _MODULES}

# archs the JAX package has and the port does not serve yet -> the ROADMAP
# queue-A item that ports them
_LATER = {
    "xlstm-1.3b": "A9", "hymba-1.5b": "A10",
    "qwen2-vl-72b": "A10", "hubert-xlarge": "A10",
}


def _check(arch: str) -> None:
    if arch in ARCHS:
        return
    if arch in _LATER:
        raise KeyError(f"arch {arch!r} is not ported yet (ROADMAP item "
                       f"{_LATER[arch]}); the port serves {sorted(ARCHS)}")
    raise KeyError(f"unknown arch {arch!r}; the port serves {sorted(ARCHS)}")


def default_cache_backend(cfg: ModelConfig) -> str:
    """The serving Engine's sequence-state backend per model family, as the
    JAX package's ``default_cache_backend`` picks it.

    Plain-GQA archs, MoE ones included, take the paged pool (the slots
    backend serves them too, by ``cache="slots"``); pure-SSM stacks the
    recurrent backend (constant-size state per slot); MLA stacks, whose
    compressed latents the paged pool cannot hold, the slots backend. Of
    the other archs the JAX package sends to slots, hybrid attention+SSM
    stacks and mrope archs are not ported (ROADMAP item A10); nor are
    xLSTM stacks (the rest of A9).
    """
    if cfg.xlstm is not None:
        raise NotImplementedError("xLSTM blocks (mLSTM/sLSTM) are ROADMAP item A9")
    if cfg.ssm is not None and cfg.attention is None:
        return "recurrent"
    if cfg.parallel_ssm_attn:
        raise NotImplementedError("hybrid attention+SSM stacks are ROADMAP item A10")
    a = cfg.attention
    if a is not None and a.mrope:
        raise NotImplementedError("mrope archs are ROADMAP item A10")
    if a is not None and a.kind == "mla":
        return "slots"
    return "paged"


def get_config(arch: str) -> ModelConfig:
    _check(arch)
    return ARCHS[arch]()


def get_smoke(arch: str) -> ModelConfig:
    _check(arch)
    return SMOKES[arch]()
