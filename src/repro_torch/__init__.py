"""repro_torch — the PyTorch/CUDA port of the ``repro`` package.

The package mirrors ``src/repro/``'s module names so each counterpart is
easy to find, but imports only ``torch``, ``numpy`` and the standard
library. It ports:

* greedy serving on one device: paged serving of GQA decoders, dense and
  MoE; slots serving of GQA and MLA decoders, dense and MoE, of M-RoPE
  vision-language backbones, of SSM and xLSTM stacks and of hybrid
  attention + SSM stacks (one contiguous cache row per slot, prompts past
  the JAX package's chunking threshold prefilled through flash attention;
  MLA decode absorbed into the compressed cache); recurrent serving of SSM
  and xLSTM stacks (constant-size state per slot, preemption by snapshot
  and resume); and audio encoders through the prefill step (no causal
  mask, no cache), all eleven of the JAX package's archs::

      configs -> models (common, rope, mlp, moe, ssm, xlstm, kvcache,
      attention, blocks, model) -> kernels.paged_attention, kernels.moe_jam,
      kernels.ssm_scan, kernels.flash_attention -> runtime.steps ->
      engine.Engine -> launch.serve

* the Two-Chains frame path at local placement: active-message frames
  (``core.message``, bit for bit the JAX package's words), the GOT and
  jam/ried packages (``core.got``, ``core.registry``), function state in
  frames (``core.injection``), mailboxes (``core.mailbox``), leases and the
  ``Fabric`` invocation surface (``fabric``), and the paper's two handlers,
  Server-Side Sum and Indirect Put (``kernels.mailbox``). The Engine's
  serve step runs through its bundle's ``Fabric`` at ``placement="local"``,
  ``"injected"`` or ``"auto"``;

* the cluster: a ``Router`` over engine replicas (``cluster``) with live
  request migration (a request's state in the ``RST1`` format, shipped as
  a train of 4 KiB active-message frames and checked frame by frame),
  rebalance, drain, failover from snapshots or by recompute, the seeded
  fault injector (``faults``) and ``launch.serve_cluster``;

* served graphs (``fabric.graph``): validated DAGs of fabric functions
  (``GraphSpec``, ``GraphRun``, ``GraphHandle``), their edges as fabric
  leases or, across replicas, as 4 KiB frame trains, ``DecodeSession`` on
  the paged Engine's block pool and draft -> verify speculative decoding
  (``SpeculativeDecoder``: an ngram or model draft, engine or router mode,
  every emitted token the target's greedy token), through
  ``Engine.submit_graph``, ``Router.place_node``/``ship_edge``/
  ``submit_graph`` and ``launch.serve_graph``.

* training (A13): ``loss_fn`` with ``remat="full"``, AdamW with the
  warmup-cosine schedule and the global-norm clip (``optim``),
  ``make_train_step`` with gradient accumulation, the synthetic data
  pipeline (``data``), checkpoints (``checkpoint``), the fault-tolerant
  ``runtime.trainer.Trainer`` and ``launch.train``; flash attention, the
  MoE expert FFN and the selective scan differentiate through their
  backward kernels (``FlashAttentionFn``, ``MoeJamFn``, ``SsmScanFn``), so
  dense, MoE, SSM and hybrid stacks train on the card. xLSTM stacks, and
  flash widths with no backward instance, are refused there.

Every kernel is hand-written CUDA beside its plain version;
``kernels.loader`` builds them at first use. Entry points (``Engine``,
``models.model.init_params``, the serve CLI) run on ``cuda`` unless the
caller passes ``device="cpu"``; with no card they raise instead of quietly
falling back. Not ported yet (ROADMAP queue A): training of xLSTM stacks
on the card and flash's backward at its other widths (A13's later
halves), the transports between devices (A14) and the tooling (A15).
"""
