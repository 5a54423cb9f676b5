"""Optimizer substrate: AdamW, the LR schedule, gradient transforms and
compression (a copy of ``repro/optim``; the data-parallel
``compressed_psum`` waits for the port's mesh, ROADMAP A14)."""
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.grad import (  # noqa: F401
    clip_by_global_norm, compress_int8, decompress_int8, global_norm, init_error_feedback)
from repro_torch.optim.schedule import warmup_cosine  # noqa: F401
