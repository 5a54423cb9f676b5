"""Architecture registry: the JAX package's eleven archs, every one served
by the port."""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.configs import (deepseek_v2_lite_16b, gemma3_4b, granite_20b, hubert_xlarge,
                                 hymba_1p5b, llama32_1b, mamba_130m, olmoe_1b_7b,
                                 qwen2_vl_72b, stablelm_3b, xlstm_1p3b)
from repro_torch.configs.base import ModelConfig

_MODULES = (llama32_1b, olmoe_1b_7b, mamba_130m, gemma3_4b, stablelm_3b, granite_20b,
            deepseek_v2_lite_16b, xlstm_1p3b, hymba_1p5b, qwen2_vl_72b, hubert_xlarge)

ARCHS: Dict[str, Callable[[], ModelConfig]] = {m.ARCH_ID: m.config for m in _MODULES}
SMOKES: Dict[str, Callable[[], ModelConfig]] = {m.ARCH_ID: m.smoke for m in _MODULES}

# archs the JAX package has and the port does not serve yet -> the ROADMAP
# queue-A item that ports them (none left)
_LATER: Dict[str, str] = {}


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

    Recurrent stacks (xLSTM, pure SSM) take the recurrent backend
    (constant-size state per slot; the slots backend serves them too, by
    ``cache="slots"``); archs the paged pool cannot hold, MLA latents and
    hybrid attention + SSM stacks and mrope ones (three position streams),
    the slots backend; plain-GQA archs, MoE ones included, the paged pool
    (the slots backend serves them too). An encoder-only arch gets
    "paged" as in the JAX package, and every Engine refuses it.
    """
    if cfg.xlstm is not None or (cfg.ssm is not None and cfg.attention is None):
        return "recurrent"
    a = cfg.attention
    if cfg.parallel_ssm_attn or (a is not None and (a.kind == "mla" or a.mrope)):
        return "slots"
    return "paged"


def get_config(arch: str) -> ModelConfig:
    _check(arch)
    return ARCHS[arch]()


def get_smoke(arch: str) -> ModelConfig:
    _check(arch)
    return SMOKES[arch]()
