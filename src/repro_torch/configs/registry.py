"""Architecture registry for the archs the port serves.

The JAX package registers eleven archs; the port serves the ones whose
whole path is ported. Asking for any other raises and names the ROADMAP
item that brings it.
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.configs import llama32_1b, mamba_130m, olmoe_1b_7b
from repro_torch.configs.base import ModelConfig

_MODULES = (llama32_1b, olmoe_1b_7b, mamba_130m)

ARCHS: Dict[str, Callable[[], ModelConfig]] = {m.ARCH_ID: m.config for m in _MODULES}
SMOKES: Dict[str, Callable[[], ModelConfig]] = {m.ARCH_ID: m.smoke for m in _MODULES}

# archs the JAX package has and the port does not serve yet -> the ROADMAP
# queue-A item that ports them
_LATER = {
    "gemma3-4b": "A7", "granite-20b": "A7", "stablelm-3b": "A7",
    "deepseek-v2-lite-16b": "A7",
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
    """The serving Engine's sequence-state backend per model family.

    Plain-GQA archs, MoE ones included, take the paged pool; pure-SSM
    stacks the recurrent backend (constant-size state per slot). xLSTM
    stacks (the rest of ROADMAP item A9), hybrid attention+SSM stacks
    (A10) and MLA or mrope archs (the slots backend, A7) are not ported.
    """
    if cfg.xlstm is not None:
        raise NotImplementedError("xLSTM blocks (mLSTM/sLSTM) are ROADMAP item A9")
    if cfg.ssm is not None and cfg.attention is None:
        return "recurrent"
    if cfg.parallel_ssm_attn:
        raise NotImplementedError("hybrid attention+SSM stacks are ROADMAP item A10")
    a = cfg.attention
    if a is not None and (a.kind == "mla" or a.mrope):
        raise NotImplementedError("the slots backend is ROADMAP item A7")
    return "paged"


def get_config(arch: str) -> ModelConfig:
    _check(arch)
    return ARCHS[arch]()


def get_smoke(arch: str) -> ModelConfig:
    _check(arch)
    return SMOKES[arch]()
