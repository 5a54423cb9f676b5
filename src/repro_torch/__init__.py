"""repro_torch — the PyTorch/CUDA port of the ``repro`` serving stack.

The package mirrors ``src/repro/``'s module names so each counterpart is
easy to find, but imports only ``torch``, ``numpy`` and the standard
library. It ports greedy paged serving of GQA decoders, dense and MoE:

    configs -> models (common, rope, mlp, moe, kvcache, attention, blocks,
    model) -> kernels.paged_attention, kernels.moe_jam (hand-written CUDA
    kernels, each beside its plain version; kernels.loader builds them)
    -> runtime.steps.make_paged_serve_step -> engine.Engine -> launch.serve

Entry points (``Engine``, ``models.model.init_params``, the serve CLI) run
on ``cuda`` unless the caller passes ``device="cpu"``; with no card they
raise instead of quietly falling back.
"""
