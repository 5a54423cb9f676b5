"""repro_torch — the PyTorch/CUDA port of the ``repro`` serving stack.

The package mirrors ``src/repro/``'s module names so each counterpart is
easy to find, but imports only ``torch``, ``numpy`` and the standard
library. This slice ports greedy paged serving of plain-GQA decoders:

    configs -> models (common, rope, mlp, kvcache, attention, blocks, model)
    -> kernels.paged_attention (hand-written CUDA kernel + plain version)
    -> runtime.steps.make_paged_serve_step -> engine.Engine -> launch.serve

Entry points (``Engine``, ``models.model.init_params``, the serve CLI) run
on ``cuda`` unless the caller passes ``device="cpu"``; with no card they
raise instead of quietly falling back.
"""
