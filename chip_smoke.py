#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's training and serving paths on one CUDA card
and check them.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases (any failure exits non-zero; with no card it fails at once; each
phase prints the seconds it took):

1. device: the card's name, count, and ``nvidia-smi`` name/power limit;
2. build: compile every kernel of the paths from ``src/`` (one
   ``nvcc`` per source, all started together) and print ptxas's register /
   shared-memory / spill report;
3a. flash attention's backward (training): the kernel's dq, dk, dv at
   llama3.2-1b's training micro-batch (2 x 32/8 heads of 64, 4,096
   tokens, causal), at a windowed D 128 case (32/8 heads, window 1,024)
   and at olmoe-1b-7b's micro-batch (2 x 16/16 heads of 128, causal)
   against autograd through the plain version in float32 (no worse than
   1.5x the plain bf16 path's error, within 2e-2 of max |grad|), two
   launches bit for bit equal; timed against its bound (2.5x the causal
   forward's flops), the plain backward and SDPA's backward; then the
   moe_jam backward (B3b: dx and the three weight gradients) at olmoe's
   training buckets (64 experts x 1,280 rows x 2048, F 1024, routed
   uniformly top-8 from 8,192 tokens), deepseek-v2-lite-16b's (capacity
   480, F 1,408, top-6 from 4,096) and the engine's ragged check input
   (empty experts) against its plain version on the same bf16 inputs and
   against float32, dx past counts and empty experts' weight gradients
   exact zeros, two launches bit for bit equal; timed with the forward at
   C 1,280, the plain backward and three ``bmm``'s autograd backward; then
   the selective scan's backward (B4b: ddt, db, dc, dx, da, dh0 from the
   training forward's chunk states) at mamba-130m's training micro-batch
   (2 x 4,096 x 1,536, N 16), hymba-1.5b's (2 x 4,096 x 3,200) and an
   engine-like ragged batch (32 rows of 96 columns, 0, 1, chunk edges and
   full valid; N 16, N 8 with x off 16 bytes, N 4) against its plain
   version on the same bf16 inputs and against float32
   (``ssm_scan.compare_bwd``), gated columns exact zeros, two launches bit
   for bit equal, the training forward's y and h_last bit for bit the
   serving forward's and its chunk states against the plain version's;
   timed beside its bound, its SFU floor, its chain's floor, the plain
   backward and both forwards (no PyTorch call computes a selective scan);
3b. train: llama3.2-1b at full width and depth through the ``Trainer``
   (float32 masters from seed 0, train_4k at 4,096 tokens, a global batch
   of 8 in 4 micro-batches, remat full, lr 3e-4, 6 steps, a checkpoint
   every 3 under ``build/train_ckpt``, a fault injected before step 4):
   finite, falling loss; one restart, resumed at step 3 with the restored
   state bit for bit the saved one and the replayed step's loss equal;
   flash forward launches 16 x 2 x 4 and backward 16 x 4 a step run,
   nothing else; step p50/p90, tokens/s, the model-FLOPs share of the
   dense bf16 peak, one step profiled, peak memory, checkpoint bytes and
   save/restore seconds; then a float32 control on the stack cut to 2
   layers (each leaf's gradient through the kernels within 1.5x the plain
   bf16 path's error);
3c. train MoE: olmoe-1b-7b at full width, its stack cut to the layers
   one card holds (7 of 16 by the memory estimate), through the
   ``Trainer`` (train_4k's 4,096 tokens, a global batch of 8 in 4
   micro-batches, remat full, 4 steps, no checkpoint): finite, falling
   loss; moe_jam's forward 2 x layers x 4 and backward layers x 4 a step
   run, flash likewise, nothing else; one micro-batch's gradients taken
   twice bit for bit equal; step p50/p90, tokens/s, the model-FLOPs share
   from the active params, one step profiled (moe_jam's, flash's and the
   dispatch's shares), peak memory; the dispatch (a stable sort) timed
   against the one-hot cumsum it replaced at the micro-batch and at
   deepseek's 3,800-token prefill; a float32 control at 2 layers with the
   routing fixed to the float32 path's;
3d. train SSM: mamba-130m (24 layers) and then hymba-1.5b (32) at full
   width and depth through the ``Trainer`` (train_4k's 4,096 tokens, a
   global batch of 8 in 4 micro-batches, remat full, 4 steps, no
   checkpoint): finite, falling loss; ssm_scan's forward (the training
   instance) 2 x layers x 4 and its backward layers x 4 a step run, for
   hymba flash's forward and backward likewise, nothing else; one
   micro-batch's gradients taken twice bit for bit equal; step p50/p90,
   tokens/s, the model-FLOPs share of the dense bf16 peak, one step
   profiled (B4's and B4b's shares, flash's for hymba), peak memory; a
   float32 control at 2 layers;
3. kernel vs plain: call each kernel's wrapper at its path's shapes on the
   card and hold it against its plain PyTorch version (stated tolerance):
   paged attention (split-K v5) at llama3.2-1b's heads (32/8 of 64) and
   at olmoe-1b-7b's (16/16 of 128), valid columns only, the tables holding
   entries that name no pool block inside live ranges; the moe_jam expert
   FFN (v2: a persistent TMA weight stream into wgmma) at olmoe's buckets
   (64 experts x 40 rows x 2048, F 1024) with empty, partial and full
   experts; the ssm_scan selective scan (v2: lanes across the state, two
   channels a lane, longest rows first, TMA-fed stages) at mamba-130m's
   engine shape (32 rows x 32 columns x 1536 channels, N 16) with 0, 1,
   partial and full valid columns per row; flash attention at gemma3-4b's
   prefill (8/4 heads of 256, 4,096 tokens, causal, window None and
   1,024), granite-20b's heads (48/1 of 128, 2,304 tokens), deepseek-v2-
   lite-16b's MLA prefill (16 heads, q and k of 192, v of 128, 4,096
   tokens) and an odd shape (2 x 32 heads of 80, 2,113 tokens from
   position 7), every one TMA + wgmma v2, with the share of visited key
   tiles that take the mask, the key tile, the backend that took the
   library call and the SFUs' floor for the exponentials beside the
   bound; the forward with lse at D 80 (the odd and hubert shapes) and
   D 16 (``LSE_D16_SHAPE``) against ``logsumexp``; moe_jam again at
   deepseek's buckets (64 experts of 2048 x 1408, top-6 routed uniformly)
   at a decode tick of 8 slots (capacity 8)
   and a 4,096-token prefill (capacity 480); flash attention at
   hymba-1.5b's prefill (25/5 heads of 64, 4,096 tokens, causal, window
   None and 1,024), qwen2-vl-72b's (64/8 heads of 128, 4,096 tokens,
   causal), llama3.2-1b's (32/8 heads of 64, 4,096 tokens, causal: the
   cluster phase's slots replicas) and hubert-xlarge's encoder (2 clips x 16/16 heads of 80, 4,096
   frames, no causal mask: no tile takes the mask); the selective scan as the slots backend
   runs it, with no valid gate: one row of 3,800 columns and a decode
   tick of 8 rows, at mamba-130m's 1,536 channels and hymba-1.5b's 3,200,
   N 16 (one check function for every scan shape, ``SCAN_SHAPES``). Each
   is timed
   (kernel, plain version, and one PyTorch library
   yardstick the port never calls, where there is one) with the L2 cache
   flushed before every launch, as the serving loop finds it (written,
   then read, so no dirty line is left for the timed launch to write
   back), and bounded by the bytes and operations this input needs; the
   timer's floor, a one-element ``fill_`` timed the same way, is printed
   first;
4. end to end, ``llama3.2-1b``: a full-width paged ``Engine`` (16 layers,
   random bf16 weights from a seed) serves 12 requests with preemption;
   launch counts are read around exactly that run; the same step inputs
   are then replayed through ``kernel="ref"`` for greedy agreement, and
   one step's logits are compared on identical inputs; that mixed
   prefill + decode step is profiled (``torch.profiler``): device busy and
   idle time, and paged attention's device ms in it;
5. end to end, ``olmoe-1b-7b``: the same for a full-width MoE engine (16
   layers, 64 experts, top-8, 6.9 B random bf16 parameters) on the same
   12 requests; every layer runs both kernels, so each kernel's launches
   must be 16 x steps;
6. end to end, ``mamba-130m``: a full-width recurrent ``Engine`` (24 SSM
   layers, 168 M random bf16 parameters) serves 48 requests on 32 slots,
   with two forced preemptions (a request mid-prefill after tick 3, one
   in decode after tick 12) that must snapshot and resume; ssm_scan's
   launches must be 24 x steps; every request's tokens must be identical
   to a second run without the forced preemptions, served at
   ``placement="injected"`` (the backend's exactness contract, and
   placement changes no token; its params lease must show one miss and a
   hit every later step); then the replay and the logits check as above,
   and one mixed step profiled: device busy and idle time, and
   ssm_scan's device ms over its 24 launches in it.
   Every engine's step goes through its fabric (``metrics()["fabric"]``);
7. end to end, ``gemma3-4b`` on the slots backend: a full-width
   ``Engine(cache="slots", slots=8, max_len=4224)`` (34 layers, 29 of them
   sliding-window, 3.88 B random bf16 parameters) serves 16 FIFO requests
   alternating long prompts (2,112-4,096 tokens: past the JAX package's
   chunking threshold, so each prefill runs the flash-attention kernel on
   every layer) and short ones (64-1,024 tokens: plain ``_sdpa``), 32 new
   tokens each; flash's launches must be 34 x the long prompts, counted
   around exactly that run. The same requests are served again through
   ``kernel="ref"`` (identical schedule; greedy agreement reported), and
   one long prefill's last-position logits through the kernel and through
   the plain version are each held against a float32 plain forward; one
   decode step and one long prefill are profiled (device busy and idle;
   device ms of flash, moe_jam and any kernel named ``scan``);
8. end to end, ``deepseek-v2-lite-16b`` on the slots backend, the same
   geometry and traffic: ``Engine(cache="auto")`` must resolve to slots
   and ``kernel`` to cuda (27 layers: MLA with a 512-wide compressed
   cache and a 64-wide rope key, the first layer dense, 26 MoE layers of
   64 experts top-6 plus 2 shared; 15.7 B random bf16 parameters); flash
   (at q/k 192, v 128) must launch 27 x the long prompts and moe_jam 26 x
   (prefills + decode ticks), nothing else; the replay through
   ``kernel="ref"``, the float32 control and the profiles as in 7;
9. end to end, ``mamba-130m`` on the slots backend (``cache="slots"``),
   the same geometry and traffic, 24 SSM layers at full width: ssm_scan
   (no valid gate) must launch 24 x (prefills + decode ticks), nothing
   else; the replay through ``kernel="ref"``, the float32 control and the
   profiles (with ssm_scan's device ms) as in 7;
10. end to end, ``hymba-1.5b`` on slots, the same again: ``cache="auto"``
   must resolve to slots (32 layers, each GQA attention (25/5 heads of 64;
   30 with a 1,024-token window) beside an SSM of 3,200 channels,
   mean-fused, then an MLP of 5,504; 1.66 B random bf16 parameters); flash
   must launch 32 x the long prompts and ssm_scan 32 x (prefills + decode
   ticks);
11. end to end, ``xlstm-1.3b`` on the recurrent backend (``cache="auto"``
   must resolve to it) at full width and depth (42 mLSTM layers with a
   4 x 1024 x 1024 float32 matrix memory a slot, 6 sLSTM layers; 2.02 B
   random bf16 parameters): 8 requests of 32-128 prompt tokens on 4 slots,
   chunk 16, 16 new each, forced preemptions after ticks 3 (mid-prefill)
   and 8 (decode); no kernel may launch; every request's tokens identical
   to a second run without the preemptions at ``placement="injected"``;
   one mixed step profiled, and its bf16 logits held against the same step
   in float32 (finite; greedy tokens equal in ``LOGITS``'s share; the
   stack cut to its first layer within ``XL_FIRST_LAYER_TOL``);
12. end to end, ``xlstm-1.3b`` on slots (``cache="slots"``): the first 8
   requests of 7's traffic; each prefill's length, mLSTM chunk length (the
   JAX package's rule, which degenerates to 1, 5 and 10 on some of these
   lengths) and ms; no kernel may launch; the 3,800-token prefill's logits
   in bf16 against float32, and through the stack cut to its first layer
   within ``XL_FIRST_LAYER_TOL``;
13. end to end, ``qwen2-vl-72b`` on slots at full width, its stack cut to
   24 of 80 layers (80 are ~145 GB in bf16 and do not fit one card; 24
   are 23.56 B random bf16 parameters, 47.1 GB): the slots traffic,
   ``cache="auto"`` must resolve to slots (M-RoPE's three position
   streams; every slot decodes at the shared length in all three); flash
   (64/8 heads of 128) must launch 24 x the long prompts, nothing else;
   the replay through ``kernel="ref"``, the float32 control and the
   profiles as in 7; then one vision prefill through the prefill step
   (256 patch embeddings from numpy seed 0 over the first positions of
   the 3,800-token prompt, at 3-D positions over a 16 x 16 grid, text
   positions after them), its kernel and plain paths held against
   float32 by the same rule;
14. ``hubert-xlarge``, an encoder, at full width and depth (48 layers, 16
   heads of 80, 1.26 B random bf16 parameters) through the prefill step,
   its entry point: 16 clips of 1,600 frames (plain ``_sdpa``) and 2 of
   4,096 (flash without the causal mask on every layer), features from
   numpy seed 0; flash must launch 48 times on the long batch and never
   on the short one; frames/s, device busy and idle, flash's device ms;
   every frame's logits through the kernel and the plain version held
   against float32 (``SLOTS_VS_F32``);
15. the cluster (request migration and failover; replicas side by side
   on the card, one weight tree, every output held token for token
   against a solo run of the same requests on one engine of the same
   geometry): two full-width ``llama3.2-1b`` paged replicas behind the
   ``Router`` serve phase 4's requests with one request migrated
   mid-chunked-prefill (after router tick 2) and one mid-decode (after
   12); two ``mamba-130m`` recurrent replicas serve phase 6's with one
   migrated mid-decode; each pair replays its requests twice with the first
   replica killed at tick 10: under the JAX package's frame fault rate of
   0.3 with failover by recompute, then from snapshots (every 4 ticks)
   under one fault per train of the clean run's largest handoff, with every
   detected fault retransmitted, one failover and no request lost; two
   ``llama3.2-1b`` slots replicas move a 4,096-token request (prefilled
   through flash) after 3 ticks and a 300-token one after 1. Each
   migration's state bytes, frames, export, encode + decode (frames/s,
   GB/s), import and restore ms; each replica's launches (one a layer a
   step);
16. the frame path (Two-Chains proper): a ``Fabric`` on the card holds a
   key-value shard of 2^26 rows (table 512 MiB, heap 3.75 GiB, heap base
   12,345 in its GOT) and two jams, Server-Side Sum and Indirect Put; 8
   deliveries of 2^20 frames of 128 B (a full 64-bank x 16,384-slot
   mailbox block each, packed on the card from numpy seed 0) are drained
   through the fabric's dispatcher and handed to the handler kernels:
   4 Indirect Put deliveries (keys 90% uniform over int32, 10% from 1,024
   hot keys: ~10^5 rows written twice or more per delivery) and 4
   Server-Side Sum deliveries (words uniform over int32, so sums wrap;
   0.1% of frames corrupted after packing). Exact checks: the sum kernel
   against its plain version, the frames' SIG checksums (unequal on
   exactly the corrupted frames) and the dispatcher's rows; the put
   kernel's whole table and heap against its plain version on a clone of
   the shard, the rows it wrote against a numpy replay of sequential
   puts, the dispatcher's [key, row] against them. Then a one-bank
   mailbox drops the frames posted past its credits, and one olmoe-1b-7b
   expert (12.6 MB of STATE words) called through the fabric ``local``
   (weights in the GOT) and ``injected`` (weights in the frame, leased)
   gives identical words. Both kernels are timed (kernel, plain version,
   library yardstick; the L2 cache flushed before every launch) and
   bounded by the bytes this input needs, and by the 32-byte sectors they
   must move: the Server-Side Sum (v3: a CTA a frame for few or wide
   frames, v2's lane groups for many) with the route it took, the
   Indirect Put (v3: a claim table in L2) with each of its three passes'
   device time (``torch.profiler``);
17. the ring put (kernel B7; ranks as the CTAs of a thread-block cluster,
   the mailbox in the receiver's shared memory): the kernel against its
   plain version, bit for bit, over 1, 2, 4 and 8 ranks, shifts 1, 2,
   n - 1 and n + 1, 1, 3, 385 (one more than a 48 KiB chunk) and 131,072
   frames of 128 B, WFE and poll, stashed (with and without the fused
   sum) and not: spins 0 under WFE and without stash, in [1, 2^20) under
   poll, and exactly 2^20 on every rank when the last frame's SIG word is
   zeroed. Then the Two-Chains ring at a key-value shard's size: 8 ranks,
   each packing 131,072 Server-Side Sum frames (16 MiB) through the
   fabric, put stashed with the sum fused (WFE), stashed under poll, and
   not stashed and then drained by the Server-Side Sum kernel on each
   rank: all three sums equal the fabric dispatcher's. The paper's two
   comparisons are timed on the card: stashing (the fused put against the
   non-stash put and its drain) and WFE against poll (with the poll's
   spins), at 1 frame, 16 frames of 64, 1,024 and 8,192 USR words (there
   the drain's Server-Side Sum, on its wide route, is also held against
   its plain version on every rank, bit for bit), and the 16 MiB-a-rank
   ring;
18. the graph tier (draft -> verify speculative decoding through
   ``repro_torch.fabric.graph``), ``llama3.2-1b`` at full width and depth
   on phase 4's paged geometry: the first 4 of its requests, 32 new
   tokens each, one at a time, served target-only (the baseline), then as
   speculation graphs on the paged Engine (``Engine.submit_graph``): an
   ngram draft at k 2 and 4, a model draft at k 4 sharing the target's
   weights (acceptance near 1) and one with weights from another seed
   (near 0); then through the Router (two target replicas and a draft
   replica, every draft -> verify edge a frame train) with the replica
   holding the verify node killed at router tick 4, and with every edge
   train under the frame fault rate 0.3; and a float32 control (ngram, k
   4, the plain path) on the first request. Every speculated output must
   equal its target-only baseline token for token; each bf16 target
   engine's paged-attention launches must be 16 x (its steps + its verify
   steps), ``engine.paged_verify`` must be on its fabric and no emitted
   row non-finite; the router's edge bytes must be its frames x 4 KiB, the
   kill must rebuild the verify session on the other replica, and the
   chaos run must retransmit. Per run: target steps per emitted token,
   acceptance, rounds and wall tokens/s (host clock; every step reads its
   tokens back) against the baseline's; the verify step's p50 against a
   decode step's;
19. the last line: ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import sys
import time
from pathlib import Path

import numpy as np

# the engine's geometry (and the kernel checks' shapes). With this traffic a
# 160-block pool peaks at 159 blocks and never preempts; 128 blocks preempt
# twice (the schedule depends on lengths only, not on the weights)
SLOTS, CHUNK, BLOCK, MAX_LEN, NUM_BLOCKS = 8, 32, 16, 1024, 128
N_REQUESTS, PROMPT_LO, PROMPT_HI, MAX_NEW, SEED = 12, 64, 384, 32, 0
# the recurrent engine (mamba-130m): 32 slots, the same chunk and request
# generator, 48 requests; after these ticks, preempt the first running
# request that is mid-prefill, then one that is in decode
REC_SLOTS, REC_REQUESTS = 32, 48
REC_PREEMPT_AFTER = {3: "prefill", 12: "decode"}
# the frame path: 8 deliveries, Indirect Put and Server-Side Sum in turn;
# one olmoe-1b-7b expert (d_model 2048, expert_ff 1024) and 8 tokens for
# local against injected
FRAME_DELIVERIES = ("indirect_put", "server_side_sum") * 4
EXPERT_D, EXPERT_FF, EXPERT_TOKENS = 2048, 1024, 8
# the ring put: ranks of the kernel-vs-plain grid (the ring itself is
# ``mailbox.bench.RING_RANKS`` x ``RING_FRAMES``)
RING_GRID_RANKS = (1, 2, 4, 8)
ARCHS = ("llama3.2-1b", "olmoe-1b-7b", "mamba-130m")
# the slots engines (gemma3-4b, then deepseek-v2-lite-16b on the same
# geometry and traffic): 16 FIFO requests, even rids long (past the
# 2,048-token chunking threshold), odd rids short
SLOTS_ARCH, SLOTS_SLOTS, SLOTS_MAX_LEN, SLOTS_REQUESTS = "gemma3-4b", 8, 4224, 16
LONG_PROMPT, SHORT_PROMPT = (2112, 4096), (64, 1024)
MLA_ARCH, MLA_FLASH_SHAPE = "deepseek-v2-lite-16b", "deepseek-v2-lite mla"
# the state and hybrid stacks on the same slots geometry and traffic:
# mamba-130m (``cache="slots"``; its default is recurrent) and hymba-1.5b
# (its default)
MAMBA_ARCH, HYMBA_ARCH = "mamba-130m", "hymba-1.5b"
# qwen2-vl-72b on the same slots geometry and traffic, at full width with
# its stack cut to 24 of 80 layers: 80 layers are ~145 GB in bf16 and do
# not fit one 80 GB card; 24 are 23.56 B params (47.1 GB), leaving room
# for the KV rows (3.3 GB), the plain path's float32 scores and the
# float32 control (one layer cast at a time). Then one vision prefill:
# ``num_patch_tokens`` patch embeddings spliced over the first positions
# of the long prompt, at 3-D positions (t 0, h and w over a 16 x 16 grid),
# text positions after them
QWEN_ARCH, QWEN_LAYERS, QWEN_GRID = "qwen2-vl-72b", 24, (16, 16)
# hubert-xlarge at full width and depth through the prefill step (an
# encoder: no Engine, no decode), (clips, frames) batches of 512 features
# from numpy seed 0: 16 clips of 1,600 frames (32 s at HuBERT's 20 ms
# stride, about LibriSpeech's longest utterances; plain ``_sdpa``, 1,600^2
# is under the threshold) and 2 clips of 4,096 (82 s of long-form audio;
# flash without the causal mask on every layer)
HUBERT_ARCH, HUBERT_BATCHES = "hubert-xlarge", ((16, 1600), (2, 4096))
# the flash-attention check shapes (``flash_attention.bench.SHAPES``) of
# each slots (or encoder) path; the first is the one its JSON entry is
# timed on
FLASH_PATHS = {SLOTS_ARCH: ("gemma3-4b global", "gemma3-4b local", "granite-20b", "odd"),
               MLA_ARCH: (MLA_FLASH_SHAPE,),
               HYMBA_ARCH: ("hymba-1.5b global", "hymba-1.5b local"),
               QWEN_ARCH: ("qwen2-vl-72b",),
               HUBERT_ARCH: ("hubert-xlarge",),
               ARCHS[0]: ("llama3.2-1b",)}
# the selective scan's checks, (path, arch, rows, columns, valid gate):
# the recurrent engine's chunk step with its valid gate (``ssm_scan.bench``'s
# mixed fill, rows with no valid column among them), then, with no valid
# gate as the slots backend runs it, a long prefill of one row and a decode
# tick at mamba's 1,536 channels and hymba's 3,200; a path's JSON entry is
# timed on its first shape
SCAN_SHAPES = (("mamba-130m", MAMBA_ARCH, REC_SLOTS, CHUNK, True),
               (f"{MAMBA_ARCH} slots", MAMBA_ARCH, 1, 3800, False),
               (f"{MAMBA_ARCH} slots", MAMBA_ARCH, 8, 1, False),
               (f"{HYMBA_ARCH} slots", HYMBA_ARCH, 1, 3800, False),
               (f"{HYMBA_ARCH} slots", HYMBA_ARCH, 8, 1, False))
# xlstm-1.3b on the recurrent backend (its default), at full width and
# depth but with fewer requests and shorter prompts than mamba's traffic:
# an mLSTM layer's matrix memory is 4 heads x 1024 x 1024 float32 (16.8 MB
# a slot) and its scan, plain PyTorch, reads and writes it several times a
# column. 4 slots, chunk 16, 8 requests of 32-128 prompt tokens (the paged
# generator's draws), 16 new each; preempted after these ticks
XL_ARCH = "xlstm-1.3b"
XL_SLOTS, XL_CHUNK, XL_REQUESTS, XL_PROMPT, XL_NEW = 4, 16, 8, (32, 128), 16
XL_PREEMPT_AFTER = {3: "prefill", 8: "decode"}
# xlstm-1.3b on slots: the first 8 of the slots traffic's requests
XL_SLOTS_REQUESTS = 8
# the cluster phase: replicas side by side on the one card. Paged (llama3.2-1b
# at the paged geometry and traffic) and recurrent (mamba-130m at its
# geometry and traffic): after these router ticks, migrate the first running
# request in that phase to the other replica. Then the requests replayed
# under two seeded fault plans, each killing the first replica at router
# tick CLUSTER_KILL_TICK: the JAX package's frame fault rate (0.3) with
# failover by recompute (every recovery ticket one frame), and failover from
# snapshots taken every CLUSTER_SNAPSHOT_EVERY ticks with a rate of one
# fault per train of the clean run's largest handoff: a train of N frames
# arrives whole with probability (1 - rate)^N, so at 0.3 no state-carrying
# train of this width (hundreds to thousands of 4 KiB frames) would ever
# arrive, as in the JAX package, which retransmits whole trains. Slots
# (llama3.2-1b, 2 slots of SLOTS_MAX_LEN): (prompt tokens, ticks before the
# migration), each request alone (an aligned admission); the long one
# prefills through flash
CLUSTER_FORCED = {"paged": {2: "prefill", 12: "decode"}, "recurrent": {12: "decode"}}
CLUSTER_KILL_TICK, CLUSTER_SNAPSHOT_EVERY, CHAOS_RATE, CHAOS_RETRIES = 10, 4, 0.3, 20
CLUSTER_SLOTS_REQUESTS = ((LONG_PROMPT[1], 3), (300, 1))
# the graph phase: draft -> verify speculation on llama3.2-1b at full width
# and depth on the paged geometry; the first GRAPH_REQUESTS of the paged
# traffic, MAX_NEW new tokens each, served one at a time. Engine mode: an
# ngram draft at each of GRAPH_NGRAM_K, a model draft at GRAPH_MODEL_K
# sharing the target's weights and one drawn from GRAPH_OTHER_SEED. Router
# tier (k GRAPH_MODEL_K): two target replicas and a draft replica on one
# weight tree, the replica holding the verify node killed at router tick
# GRAPH_KILL_TICK, then every edge train under the JAX package's frame fault
# rate (CHAOS_RATE). A float32 control (ngram, k GRAPH_MODEL_K, the plain
# path: B1 takes bf16 alone) on the first request
GRAPH_REQUESTS, GRAPH_NGRAM_K, GRAPH_MODEL_K, GRAPH_OTHER_SEED = 4, (2, 4), 4, SEED + 1
GRAPH_KILL_TICK = 4
# flash attention vs plain, per element: |kernel - plain| <= 2e-2 * (rms of
# the element's (batch, head, position) row + |plain|) (``flash_attention.
# compare``): bf16 outputs, and the kernel rounds the unnormalized p to bf16
# before P.V where the plain version rounds the normalized probabilities
FLASH_TOL = 2e-2
# the forward's lse is held at the train shapes (D 64, 128) and at the
# other widths the forward serves: D 80 (the odd and hubert-xlarge check
# shapes) and D 16, the smokes' heads (4 over 2), causal from position 5
# with a window of 9 over 2,113 tokens (the same fields as
# ``flash_attention.bench.SHAPES``)
LSE_D16_SHAPE = (2, 4, 2, 2113, 2118, 16, True, 9, 5, 16)
# flash attention's backward: dq, dk and dv from bf16 inputs against
# autograd through the plain version in float32 (``mha_ref``). The
# kernel's max error may be at most BWD_VS_PLAIN x the plain bf16 path's
# (autograd through ``mha_ref`` on bf16 inputs) and at most BWD_TOL of max
# |grad|: both round p (and the kernel dS) to bf16 for their products
BWD_VS_PLAIN, BWD_TOL = 1.5, 2e-2
# the backward's three launches, by the names of their kernels
BWD_PASSES = ("bwd_delta", "bwd_dkdv", "bwd_dq")
# the train phase: llama3.2-1b at full width and depth, the JAX package's
# train_4k sequence length, a global batch of 8 in 4 micro-batches of 2,
# remat="full", lr 3e-4 (warmup 1 step, as the launcher sets it for 6),
# 6 steps with a checkpoint every 3 and a fault injected before step 4,
# so the trainer restarts once, from the checkpoint of step 3
TRAIN_ARCH, TRAIN_BATCH, TRAIN_ACCUM, TRAIN_LR = "llama3.2-1b", 8, 4, 3e-4
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_STEP = 6, 3, 4
# the float32 control: the stack cut to its first TRAIN_CONTROL_LAYERS at
# full width, one 1 x 4,096 micro-batch; each leaf's relative L2 gradient
# error (||g - g_f32|| / ||g_f32||) through the kernels in bf16 within
# TRAIN_VS_PLAIN x the plain bf16 path's (only attention's rounding differs)
TRAIN_CONTROL_LAYERS, TRAIN_VS_PLAIN = 2, 1.5
# the moe_jam backward (B3b) against its plain version on the same bf16
# inputs, per element within tol * (rms of the element's row + |plain|)
# (``moe_jam.compare``): both sum the same products in float32 in other
# orders and round h, dG and dU to bf16 before their products, so such a
# rounding may land on the neighbouring bf16 value (2^-7 of it), and each
# output is bf16 (the neighbouring value at most). dx sums F terms, where
# one term's step is a small share: 1e-2, as the forward (MOE_TOL). A
# weight gradient sums an expert's kept rows alone (1 to C): where a few
# large terms cancel, one term's step is a larger share of the sum and of
# its row's rms (1.6e-2 of it seen at olmoe's engine buckets, C 40, with
# the kernel's L2 error against float32 equal to the plain path's to 4
# digits): 3e-2. Against float32 (the plain version on the same inputs
# cast to float32): each gradient's relative L2 error within BWD_VS_PLAIN x
# the plain bf16 path's
MOE_BWD_TOL, MOE_DW_TOL = 1e-2, 3e-2
# the backward's check inputs: the bench's training shapes
# (``moe_jam.bench.TRAIN``) and the engine's check input (a quarter of the
# experts empty, a quarter full, the rest ragged); the first is the one its
# JSON entry is timed on
MOE_BWD_CASES = ("olmoe-1b-7b train", "deepseek-v2-lite-16b train", "engine check")
# the MoE train phase: olmoe-1b-7b at full width through the Trainer, at
# train_4k's 4,096 tokens, a global batch of TRAIN_BATCH in TRAIN_ACCUM
# micro-batches (capacity 1,280 an expert), remat full, lr TRAIN_LR, warmup
# 1 step, MOE_TRAIN_STEPS steps, no checkpoint (the llama drill covers
# them). Its 16 layers are 6.92 B params: at MOE_BYTES_PER_PARAM (float32
# masters, AdamW's m and v, the float32 gradient sums, the bf16 casts) that
# is ~131 GB, so the stack is cut to the most layers whose estimate, with
# MOE_ACT_RESERVE for a layer's recomputed activations and the logits,
# stays within MOE_PEAK_BUDGET of the card's 80 GB. The rate is measured:
# 6 layers (2.72 B params) peaked at 56.20 GB on an H100 80GB HBM3, under
# 19 bytes a param beside 5 GB of activations (22 bytes a param, the
# estimate that chose 6 layers, left 7 unrun)
MOE_TRAIN_ARCH, MOE_TRAIN_STEPS = "olmoe-1b-7b", 4
MOE_BYTES_PER_PARAM, MOE_ACT_RESERVE, MOE_PEAK_BUDGET = 19, 8e9, 70e9
# the dispatch timed as the train phase and deepseek-v2-lite-16b's
# 3,800-token prefill run it: (tokens, top_k) over 64 experts, uniform
# picks from numpy seed 0
DISPATCH_CASES = {"olmoe-1b-7b train micro-batch": (8192, 8),
                  "deepseek-v2-lite-16b 3,800-token prefill": (3800, 6)}
# the selective scan's backward (B4b) is held to ``ssm_scan.compare_bwd``'s
# rule, whose tolerances (``ssm_scan.ops.BWD_TOL``, ``BWD_VS_PLAIN``,
# ``BWD_F32_REL``) the card tests share
# the SSM train phase: mamba-130m and hymba-1.5b at full width and depth
# through the Trainer, as the MoE phase (TRAIN_BATCH in TRAIN_ACCUM
# micro-batches, remat full, TRAIN_LR, no checkpoint). hymba's 1.66 B
# params are ~32 GB at MOE_BYTES_PER_PARAM, within MOE_PEAK_BUDGET with
# MOE_ACT_RESERVE
SSM_TRAIN_ARCHS, SSM_TRAIN_STEPS = (MAMBA_ARCH, HYMBA_ARCH), 4
# paged attention vs plain, per element: |kernel - plain| <= 2e-2 * (min(1,
# rms of the element's (request, column, head) row) + |plain|). bf16
# output, and p rounded to bf16 before P.V at different points
KERNEL_TOL = 2e-2
# moe_jam vs plain, per element: |kernel - plain| <= 1e-2 * (rms of the
# element's (expert, row) output row + |plain|) (``moe_jam.compare``): an
# output may land on the neighbouring bf16 value, at most 2^-7 of |plain|;
# empty rows must be exact zeros
MOE_TOL = 1e-2
# ssm_scan vs plain (``ssm_scan.compare``): y on valid columns, per element
# within 1e-2 * (rms of its (row, column) + |plain|) (the same float32 sum,
# with and without fused multiply-adds, rounded to bf16: the neighbouring
# bf16 value at most); h_last (float32) within 1e-4 * (1 + |plain|); a row
# with no valid column returns h0 bit for bit, y past n_valid is zero
SCAN_Y_TOL, SCAN_H_TOL = 1e-2, 1e-4
# the replayed mixed step, on identical inputs. llama: every valid row's
# max over the vocab of |logit cuda - logit ref| within 2e-2 (logits ~0.13
# std at this init, tied head; bf16 x 16 layers). olmoe: its router turns
# bf16 noise into discrete changes (a token at a near-tie of its 8th and
# 9th expert takes the other one in some layer, and its request's later
# tokens see it through attention), so both bf16 paths are held against
# the plain path in float32 instead: the kernel path's median and mean row
# error (max |logit - logit_f32| over the vocab) within 1.5x the plain
# bf16 path's. mamba: the same float32 control (logits ~1 std at this
# init, untied head, 24 layers of bf16 activations: a flipped bf16 rounding
# in the scan's output carries through the recurrence and the later layers,
# so no absolute bound is known in advance). xlstm-1.3b runs no kernel, so
# its mixed step is held in bf16 against float32 alone: finite, and the
# greedy tokens equal in at least 5% of the valid rows. Its 48 layers at
# random weights amplify bf16 rounding (tests/test_torch_xlstm.py holds the
# port's departure to the JAX package's own); the first full-width run
# agreed in 5 of 49 rows, mean row error 3.72 at logits up to 5.3. So the
# same step is also held with the stack cut to its first layer, before
# depth amplifies the rounding (``XL_FIRST_LAYER_TOL``)
LOGITS = {"llama3.2-1b": dict(atol=2e-2), "olmoe-1b-7b": dict(vs_f32=1.5),
          "mamba-130m": dict(vs_f32=1.5), "xlstm-1.3b": dict(argmax_share=0.05)}
# xlstm-1.3b's bf16 path against float32 on the same bf16 weights, inputs
# and state, the stack cut to its first layer (an mLSTM block of 4 heads of
# 1,024, then the final norm and the head): the mean over rows of the
# row's largest |logit_bf16 - logit_f32|, over the float32 logits' rms, at
# most twice the JAX package's own departure at this width and vocabulary
# (tests/test_torch_xlstm.py, CPU: 0.0410 on a recurrent step, 0.0468 on a
# 512-token chunked prefill; the port's 0.0436 and 0.0495). A wrong
# recurrence departs by the order of the logits themselves
XL_FIRST_LAYER_TOL = 2 * 0.0468
# gemma3-4b: one long prefill's last-position logits (262,144 of them,
# soft-capped at 30) through the kernel's bf16 path and the plain bf16 path,
# each against the plain path in float32 on the same bf16 weights: the
# kernel path's mean and rms |logit - logit_f32| within 1.5x the plain
# path's (both paths round the same activations to bf16; only attention's
# rounding differs). deepseek-v2-lite-16b: its router turns bf16 noise
# into discrete changes (at random weights ~28% of (token, layer) pairs of
# a 3,800-token prefill pick another top-6 set than float32 does, on
# either bf16 path, and a token whose set changed early changes again in
# later layers), so one row's error is a draw of how many of its 26
# layers flipped: the rule is olmoe's, over every position of the same
# prefill, the kernel path's mean and median row error (max |logit -
# logit_f32| over the vocab) within 1.5x the plain path's
SLOTS_VS_F32 = 1.5


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


class Phase:
    """Prints the seconds a phase took."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        log(f"[phase] {self.name}: {time.perf_counter() - self.t0:.1f}s")


def check_paged(torch, dev, *, arch, heads, kv_heads, head_dim):
    """Phase 3 for paged attention at one path's heads; returns its JSON
    entry (without ``launches``)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import timing
    from repro_torch.kernels.paged_attention import bench

    args = bench.check_inputs(dev, heads=heads, kv_heads=kv_heads, head_dim=head_dim)
    q, kp, vp, tables, starts, n_valid = args
    max_err = 0.0
    for w in (None, 128):
        out = pa.paged_attention(*args, block_size=BLOCK, window=w)
        ref = pa.paged_attention_ref(*args, block_size=BLOCK, window=w)
        torch.cuda.synchronize()
        if not torch.isfinite(out.float()).all():
            raise AssertionError(f"kernel output has NaN/inf (window={w})")
        err, worst, bad = pa.compare_valid(out, ref, n_valid, tol=KERNEL_TOL)
        log(f"[kernel] paged_attention {heads}/{kv_heads}x{head_dim} window={w}: max "
            f"|kernel - plain| on valid columns = {err:.3e}, largest share of the "
            f"allowed error {worst:.3f} ({bad} elements over {KERNEL_TOL} x "
            f"(min(1, row rms) + |plain|))")
        if bad:
            raise AssertionError(f"kernel disagrees with the plain version (window={w})")
        max_err = max(max_err, err)

    B, C, H, D = q.shape
    K = kp.shape[2]
    flush = timing.l2_flush_buffer(dev)
    ms = timing.timed_ms(lambda: pa.paged_attention(*args, block_size=BLOCK), 200, flush)
    plain_ms = timing.timed_ms(lambda: pa.paged_attention_ref(*args, block_size=BLOCK),
                               20, flush)
    # yardstick: SDPA on the pre-gathered dense view with the same mask
    # (the gather is excluded from its time)
    from repro_torch.models.kvcache import PagedKVCache
    seq_end = starts + n_valid
    kd, vd, t = PagedKVCache(kp, vp, BLOCK).gather(tables, seq_lens=seq_end)
    kd = kd[:, :t].permute(0, 2, 1, 3).repeat_interleave(H // K, dim=1).contiguous()
    vd = vd[:, :t].permute(0, 2, 1, 3).repeat_interleave(H // K, dim=1).contiguous()
    qd = q.permute(0, 2, 1, 3).contiguous()
    qpos = starts[:, None] + torch.arange(C, device=dev)[None, :]
    kpos = torch.arange(t, device=dev)
    blk = tables[:, kpos // BLOCK]
    mask = ((kpos[None, None, :] <= qpos[:, :, None])
            & (kpos[None, None, :] < seq_end[:, None, None])
            & ((blk >= 0) & (blk < kp.shape[0]))[:, None, :])[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = timing.timed_ms(lambda: sdpa(qd, kd, vd, attn_mask=mask), 200, flush)
    del flush

    work = bench.needed_work(tables.cpu().numpy(), starts.cpu().numpy(),
                             n_valid.cpu().numpy(), num_blocks=kp.shape[0],
                             block_size=BLOCK, heads=H, kv_heads=K, head_dim=D)
    bound, bound_by = timing.bound_ms(work)
    log(f"[kernel] paged_attention {heads}/{kv_heads}x{head_dim} timing (L2 flushed per "
        f"launch): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA on pre-gathered view "
        f"{library_ms:.4f} ms; needed bytes {work['bytes']} ({work['kv_bytes']} K/V) -> "
        f"{work['bytes'] / timing.HBM_BYTES_PER_S * 1e3:.5f} ms at 3.35 TB/s; "
        f"{work['flops']} flops over {work['keys']} visible keys -> "
        f"{work['flops'] / timing.BF16_FLOPS_PER_S * 1e3:.5f} ms at 989 TFLOP/s")
    return {
        "name": "paged_attention", "route": "cuda", "path": arch, "design": "split-K v5",
        "source": "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:108",
        "launches": None, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": library_ms,
    }


def check_moe_jam(torch, dev, cfg):
    """Phase 3 for the moe_jam expert FFN at olmoe's bucket shape; returns
    its JSON entry (without ``launches``)."""
    from repro_torch.kernels import moe_jam as mj
    from repro_torch.kernels import timing
    from repro_torch.kernels.moe_jam import bench as mbench
    from repro_torch.kernels.moe_jam.kernel import DESIGN
    from repro_torch.models.moe import expert_capacity

    m = cfg.moe
    shape = (m.num_experts, expert_capacity(SLOTS * CHUNK, m), cfg.d_model, m.expert_ff)
    if shape != (mbench.EXPERTS, mbench.CAPACITY, mbench.D_MODEL, mbench.D_FF):
        raise AssertionError(f"the moe_jam check's shape is not the engine's {shape}")
    counts_np = mbench.check_counts()
    x, wg, wu, wd, counts = mbench.check_inputs(dev, counts_np)
    log(f"[kernel] moe_jam input: {tuple(x.shape)} buckets, kept rows per expert "
        f"{counts_np.tolist()}")
    out = mj.moe_jam_ffn(x, wg, wu, wd, "silu", counts=counts)
    ref = mj.moe_jam_ffn_ref(x, wg, wu, wd, "silu", counts=counts)
    torch.cuda.synchronize()
    max_err, worst, bad = mj.compare(out, ref, tol=MOE_TOL)
    empty = ~(torch.arange(x.shape[1], device=dev)[None, :] < counts[:, None])
    nonzero_empty = int((out[empty] != 0).sum())
    log(f"[kernel] moe_jam silu: max |kernel - plain| = {max_err:.3e}, largest share of "
        f"the allowed error {worst:.3f} ({bad} elements over {MOE_TOL} x (row rms + "
        f"|plain|)); {nonzero_empty} non-zero elements in empty rows")
    if bad or nonzero_empty:
        raise AssertionError("moe_jam disagrees with the plain version")

    flush = timing.l2_flush_buffer(dev)
    ms = timing.timed_ms(lambda: mj.moe_jam_ffn_cuda(x, wg, wu, wd, counts=counts), 50, flush)
    plain_ms = timing.timed_ms(lambda: mj.moe_jam_ffn_ref(x, wg, wu, wd, counts=counts),
                               10, flush)
    library_ms = timing.timed_ms(lambda: mbench.yardstick(x, wg, wu, wd), 50, flush)
    del flush, x, wg, wu, wd
    work = mbench.needed_work(counts_np, d_model=cfg.d_model, d_ff=m.expert_ff)
    bound, bound_by = timing.bound_ms(work)
    log(f"[kernel] moe_jam timing (L2 flushed per launch): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, 3 x bmm + act {library_ms:.4f} ms; needed bytes "
        f"{work['bytes']} ({work['weight_bytes']} weights of {work['experts']} experts, "
        f"{work['rows']} kept rows) -> {work['bytes'] / timing.HBM_BYTES_PER_S * 1e3:.5f} "
        f"ms at 3.35 TB/s; {work['flops']} flops -> "
        f"{work['flops'] / timing.BF16_FLOPS_PER_S * 1e3:.5f} ms at 989 TFLOP/s")
    return {
        "name": "moe_jam", "route": "cuda", "path": cfg.name, "design": DESIGN,
        "source": "src/repro_torch/kernels/moe_jam/csrc/moe_jam.cu",
        "replaces": "src/repro/kernels/moe_jam/kernel.py:62",
        "launches": None, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": library_ms,
    }


def check_moe_jam_deepseek(torch, dev, cfg):
    """Phase 3 for the moe_jam expert FFN at deepseek-v2-lite-16b's buckets
    on the slots engine: a decode tick of 8 slots (capacity 8) and a
    4,096-token prefill (capacity 480), routed uniformly; returns its JSON
    entry (without ``launches``), timed at the decode tick, with both
    fills' numbers under ``shapes``."""
    from repro_torch.kernels import moe_jam as mj
    from repro_torch.kernels import timing
    from repro_torch.kernels.moe_jam import bench as mbench
    from repro_torch.kernels.moe_jam.kernel import DESIGN
    from repro_torch.models.moe import expert_capacity

    m, ds = cfg.moe, mbench.DEEPSEEK
    if (m.num_experts, cfg.d_model, m.expert_ff, m.top_k) != (
            ds["experts"], ds["d_model"], ds["d_ff"], ds["top_k"]) or any(
            expert_capacity(n, m) != c for n, c in mbench.DEEPSEEK_FILLS.values()) or (
            mbench.DEEPSEEK_FILLS["decode"][0] != SLOTS_SLOTS
            or mbench.DEEPSEEK_FILLS["prefill"][0] != LONG_PROMPT[1]):
        raise AssertionError("the deepseek moe_jam check's shapes are not the engine's")
    flush = timing.l2_flush_buffer(dev)
    shapes = {}
    for fill, (n, c) in mbench.DEEPSEEK_FILLS.items():
        counts_np = mbench.deepseek_counts(n, c)
        x, wg, wu, wd, counts = mbench.check_inputs(
            dev, counts_np, (m.num_experts, c, cfg.d_model, m.expert_ff))
        out = mj.moe_jam_ffn(x, wg, wu, wd, "silu", counts=counts)
        ref = mj.moe_jam_ffn_ref(x, wg, wu, wd, "silu", counts=counts)
        torch.cuda.synchronize()
        max_err, worst, bad = mj.compare(out, ref, tol=MOE_TOL)
        empty = ~(torch.arange(c, device=dev)[None, :] < counts[:, None])
        nonzero_empty = int((out[empty] != 0).sum())
        del out, ref
        work = mbench.needed_work(counts_np, d_model=cfg.d_model, d_ff=m.expert_ff)
        bound, bound_by = timing.bound_ms(work)
        r = dict(max_abs_err=max_err, bound_ms=bound, bound_by=bound_by,
                 ms=timing.timed_ms(lambda: mj.moe_jam_ffn_cuda(x, wg, wu, wd, counts=counts),
                                    50, flush),
                 plain_ms=timing.timed_ms(lambda: mj.moe_jam_ffn_ref(x, wg, wu, wd,
                                                                     counts=counts), 5, flush),
                 library_ms=timing.timed_ms(lambda: mbench.yardstick(x, wg, wu, wd), 20, flush),
                 kept_rows=work["rows"], experts=work["experts"])
        name = f"{fill} (C {c})"
        shapes[name] = r
        log(f"[kernel] moe_jam {cfg.name} {name}: {tuple(x.shape)} buckets, {work['rows']} kept "
            f"rows in {work['experts']} experts (at most {int(counts_np.max())}); max |kernel - "
            f"plain| = {max_err:.3e}, largest share of the allowed error {worst:.3f} ({bad} "
            f"elements over {MOE_TOL} x (row rms + |plain|)); {nonzero_empty} non-zero "
            f"elements in empty rows; timing (L2 flushed per launch): kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, 3 x bmm + act {r['library_ms']:.4f} ms; needed "
            f"bytes {work['bytes']} -> {work['bytes'] / timing.HBM_BYTES_PER_S * 1e3:.5f} ms at "
            f"3.35 TB/s; {work['flops']} flops -> "
            f"{work['flops'] / timing.BF16_FLOPS_PER_S * 1e3:.5f} ms at 989 TFLOP/s; bound "
            f"{bound:.5f} ms ({bound_by}), kernel at {bound / r['ms']:.3f} of it")
        if bad or nonzero_empty:
            raise AssertionError(f"moe_jam disagrees with the plain version ({name})")
        del x, wg, wu, wd, counts
    del flush
    d = shapes[next(iter(shapes))]
    return {
        "name": "moe_jam", "route": "cuda", "path": cfg.name, "design": DESIGN,
        "source": "src/repro_torch/kernels/moe_jam/csrc/moe_jam.cu",
        "replaces": "src/repro/kernels/moe_jam/kernel.py:62",
        "launches": None, "max_abs_err": max(r["max_abs_err"] for r in shapes.values()),
        "ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
        "bound_by": d["bound_by"], "library_ms": d["library_ms"], "shapes": shapes,
    }


def check_ssm_scan(torch, dev, cfgs):
    """Phase 3 for the ssm_scan selective scan at each shape of
    ``SCAN_SHAPES``; returns one JSON entry per path (without
    ``launches``), timed on its first shape, with every shape's numbers
    under ``shapes``. Where a shape has a valid gate, the columns past it
    must be zero and a row with no valid column must return h0 bit for
    bit. The plain version (a prefix composition of the columns' maps) is
    also held against the same recurrence a column at a time
    (``ssm_scan_loop``), whose time is printed beside it."""
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.kernels import timing
    from repro_torch.kernels.ssm_scan import bench as sbench
    from repro_torch.kernels.ssm_scan.kernel import DESIGN, scan_route
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_loop

    flush = timing.l2_flush_buffer(dev)
    shapes = {}
    for path, arch, rows, cols, gated in SCAN_SHAPES:
        inner, state = cfgs[arch].ssm.expand * cfgs[arch].d_model, cfgs[arch].ssm.state_dim
        if gated:
            if (rows, cols, inner, state) != (sbench.SLOTS, sbench.CHUNK, sbench.INNER,
                                              sbench.STATE):
                raise AssertionError(f"the ssm_scan check's shape is not {path}'s engine's")
            nv_np = sbench.check_n_valid()
        else:
            nv_np = np.full(rows, cols, np.int32)
        args = sbench.check_inputs(dev, nv_np, inner=inner, state=state, steps=cols)
        n_valid = args[-1]
        if not gated:
            args = args[:-1]                    # n_valid None: every column
        name = f"{path} {rows} x {cols} x {inner}"
        design = f"{DESIGN}, route {scan_route(*args[:4])}"
        y, h = ss.ssm_scan(*args)
        y_ref, h_ref = ss.ssm_scan_ref(*args)
        y_loop, h_loop = ssm_scan_loop(*args)
        torch.cuda.synchronize()
        max_y, max_h, worst, bad = ss.compare(y, h, y_ref, h_ref, n_valid, y_tol=SCAN_Y_TOL,
                                              h_tol=SCAN_H_TOL)
        loop_y, loop_h, loop_worst, loop_bad = ss.compare(y_ref, h_ref, y_loop, h_loop,
                                                          n_valid, y_tol=SCAN_Y_TOL,
                                                          h_tol=SCAN_H_TOL)
        del y_loop, h_loop
        gate = "no valid gate"
        if gated:
            valid = torch.arange(cols, device=dev)[None, :] < n_valid[:, None]
            nonzero_garbage = int((y[~valid] != 0).sum())
            idle = n_valid == 0
            idle_exact = bool(torch.equal(h[idle], args[5][idle]))
            gate = (f"valid columns per row {nv_np.tolist()}, {nonzero_garbage} non-zero y "
                    f"past n_valid, rows with no valid column return h0 bit for bit: "
                    f"{idle_exact}")
            bad = bad or nonzero_garbage or not idle_exact
        log(f"[kernel] ssm_scan {name} (N {state}), {gate}: max |kernel - plain| of y on "
            f"valid columns = {max_y:.3e}, of h_last = {max_h:.3e}; largest share of the "
            f"allowed error {worst:.3f} ({SCAN_Y_TOL} x (row rms + |plain|) for y, "
            f"{SCAN_H_TOL} x (1 + |plain|) for h_last); {design}; the plain version against "
            f"the column loop: max |diff| of y {loop_y:.3e}, of h_last {loop_h:.3e}, share "
            f"{loop_worst:.3f} of the same allowance")
        if bad or loop_bad:
            raise AssertionError(f"ssm_scan disagrees with the plain version, or the plain "
                                 f"version with the column loop ({name})")
        del y, h, y_ref, h_ref
        work = sbench.needed_work(nv_np, inner=inner, state=state)
        bound, bound_by = timing.bound_ms(work)
        r = dict(design=design, max_abs_err=max(max_y, max_h), bound_ms=bound,
                 bound_by=bound_by,
                 ms=timing.timed_ms(lambda: ss.ssm_scan_cuda(*args), 100, flush),
                 plain_ms=timing.timed_ms(lambda: ss.ssm_scan_ref(*args), 5, flush),
                 loop_ms=timing.timed_ms(lambda: ssm_scan_loop(*args), 2, flush),
                 loop_max_abs_err=max(loop_y, loop_h))
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ss.ssm_scan_ref(*args)
        r["plain_peak_mb"] = (torch.cuda.max_memory_allocated() - base) / 2**20
        shapes.setdefault(path, {})[name] = r
        log(f"[kernel] ssm_scan {name} timing (L2 flushed per launch): kernel {r['ms']:.4f} "
            f"ms, plain {r['plain_ms']:.4f} ms (peak {r['plain_peak_mb']:.1f} MiB above its "
            f"inputs), column loop {r['loop_ms']:.4f} ms, no single PyTorch call computes a "
            f"selective scan; {work['bytes']} bytes ({work['state_bytes']} state in and out, "
            f"{work['cols']} valid columns) -> "
            f"{work['bytes'] / timing.HBM_BYTES_PER_S * 1e3:.5f} ms at 3.35 TB/s; "
            f"{work['f32_flops']} float32 operations -> "
            f"{work['f32_flops'] / timing.F32_FLOPS_PER_S * 1e3:.5f} ms at 67 TFLOP/s; "
            f"{work['exps']} exponentials -> {timing.sfu_ms(work):.5f} ms on the SFUs; bound "
            f"{bound:.5f} ms ({bound_by}), kernel at {bound / r['ms']:.3f} of it")
        del args
    del flush
    entries = {}
    for path, named in shapes.items():
        first = next(iter(named.values()))
        entries[path] = {
            "name": "ssm_scan", "route": "cuda", "path": path, "design": first["design"],
            "source": "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
            "replaces": "src/repro/kernels/ssm_scan/kernel.py:60",
            "launches": None, "max_abs_err": max(r["max_abs_err"] for r in named.values()),
            "ms": first["ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": None, "shapes": named,
        }
    return entries


def check_flash(torch, dev, cfgs):
    """Phase 3 for flash attention at each slots path's prefill shapes
    (``FLASH_PATHS``: gemma3-4b's global and local layers, granite-20b's
    heads and an odd shape; deepseek-v2-lite-16b's MLA prefill, q and k of
    192, v of 128; hymba-1.5b's global and local layers, 25/5 heads of
    64; qwen2-vl-72b's 64/8 heads of 128) and hubert-xlarge's encoder
    (16/16 heads of 80, without the causal mask); ``cfgs`` maps each path
    to its config. Returns one JSON entry per
    path (without ``launches``), timed on its first shape, with the
    numbers of each of its shapes under ``shapes``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import timing
    from repro_torch.kernels.flash_attention import bench as fbench

    if sorted(n for names in FLASH_PATHS.values() for n in names) != sorted(fbench.SHAPES):
        raise AssertionError("FLASH_PATHS does not cover the bench's shapes")
    for path, names in FLASH_PATHS.items():
        a = cfgs[path].attention
        for name in names:
            sh = fbench.SHAPES[name]
            width = (a.qk_nope_head_dim + a.qk_rope_head_dim, a.v_head_dim) if a.kind == "mla" \
                else (a.head_dim, a.head_dim)
            kv = a.num_heads if a.kind == "mla" else a.num_kv_heads
            if path != SLOTS_ARCH or name.startswith(path):
                if (sh[1], sh[2], sh[5], sh[9]) != (a.num_heads, kv, *width) or (
                        sh[7] not in (None, a.sliding_window)) or sh[3] != LONG_PROMPT[1] or (
                        sh[6] == cfgs[path].is_encoder):
                    raise AssertionError(f"the flash check's shape {name} is not {path}'s")
    flush = timing.l2_flush_buffer(dev)
    shapes = {}
    for name, shape in fbench.SHAPES.items():
        q, k, v = fbench.check_inputs(dev, shape)
        kw = dict(causal=shape[6], window=shape[7], q_offset=shape[8])
        out = fa.flash_attention(q, k, v, **kw)
        ref = fa.mha_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err, worst, bad = fa.compare(out, ref, tol=FLASH_TOL)
        log(f"[kernel] flash_attention {name} {tuple(q.shape)} x {tuple(k.shape)} {kw}: max "
            f"|kernel - plain| = {err:.3e}, largest share of the allowed error {worst:.3f} "
            f"({bad} elements over {FLASH_TOL} x (row rms + |plain|))")
        if bad or not torch.isfinite(out.float()).all():
            raise AssertionError(f"flash attention disagrees with the plain version ({name})")
        del out, ref
        work = fbench.needed_work(shape)
        bound, bound_by = timing.bound_ms(work)
        walk = fa.tile_counts(q, k, v, **kw)
        design = f"{walk['design']}, {fa.key_tile(shape[5], shape[9])}-key tiles"
        r = dict(design=design, max_abs_err=err, bound_ms=bound, bound_by=bound_by,
                 ms=timing.timed_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw), 50, flush),
                 plain_ms=timing.timed_ms(lambda: fa.mha_ref(q, k, v, **kw), 5, flush),
                 library_ms=timing.timed_ms(fbench.yardstick(q, k, v, shape), 50, flush),
                 library_backend=fbench.yardstick_backend(q, k, v, shape))
        shapes[name] = r
        log(f"[kernel] flash_attention {name} timing (L2 flushed per launch): kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms "
            f"({r['library_backend']}); {work['pairs']} visible pairs -> {work['flops']} flops "
            f"-> {work['flops'] / timing.BF16_FLOPS_PER_S * 1e3:.5f} ms at 989 TFLOP/s; "
            f"{work['bytes']} bytes -> {work['bytes'] / timing.HBM_BYTES_PER_S * 1e3:.5f} ms "
            f"at 3.35 TB/s; bound {bound:.5f} ms ({bound_by}), kernel at "
            f"{bound / r['ms']:.3f} of it; SFU floor {timing.sfu_ms(work):.5f} ms ({work['exps']} "
            f"exponentials); {design}, the mask on {walk['masked']} of "
            f"{walk['visited']} visited tiles (counted by the kernel)")
        del q, k, v
    del flush
    entries = {}
    for path, names in FLASH_PATHS.items():
        g = shapes[names[0]]
        entries[path] = {
            "name": "flash_attention", "route": "cuda", "path": path, "design": g["design"],
            "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:98",
            "launches": None, "max_abs_err": max(shapes[n]["max_abs_err"] for n in names),
            "ms": g["ms"], "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
            "bound_by": g["bound_by"], "library_ms": g["library_ms"],
            "shapes": {n: shapes[n] for n in names},
        }
    return entries


def check_flash_bwd(torch, dev):
    """Phase 3 for flash attention's backward kernel at each of
    ``fbench.BWD_SHAPES`` (llama3.2-1b's and olmoe-1b-7b's training
    micro-batches, a windowed D 128 case): dq, dk, dv from bf16 inputs (numpy seed 0; the output's
    gradient from seed ``SEED + 1``, bf16) against autograd through the
    plain version in float32 (``BWD_VS_PLAIN``, ``BWD_TOL``); a second
    launch must give the same bits. The forward the train path launches
    (``flash_attention_lse_cuda``) is held at the same shapes: its output
    against the plain version in float32 (``FLASH_TOL``), its lse against
    ``logsumexp`` of the plain float32 scores. Timed with the L2 flushed:
    the backward kernel (from the forward's out and lse), the plain
    version's backward (autograd through ``mha_ref``'s bf16 graph), and
    SDPA forward + backward by autograd less its forward; the forward with
    lse, ``mha_ref`` in bf16, and SDPA's forward. The backward's three
    launches (the delta pre-pass, the dk/dv pass, the dq pass) are also
    timed one by one by ``torch.profiler`` over one launch after a flush.
    Returns ``{"fwd": entry, "bwd": entry}``, the JSON entries of the
    forward with lse and of the backward (without ``launches``), timed on
    the first shape, the numbers of each shape under ``shapes``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import timing
    from repro_torch.kernels.flash_attention import bench as fbench
    from repro_torch.kernels.flash_attention.kernel import BWD_DESIGN

    from repro_torch.kernels.flash_attention.ref import visible_mask

    flush = timing.l2_flush_buffer(dev)
    shapes, fwd_shapes = {}, {}
    for name, shape in fbench.BWD_SHAPES.items():
        q, k, v = fbench.check_inputs(dev, shape)
        kw = dict(causal=shape[6], window=shape[7], q_offset=shape[8])
        rng = np.random.default_rng(SEED + 1)
        dout = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32)).to(
            dev, torch.bfloat16)

        def grads(fn, *inputs):
            ins = [t.detach().requires_grad_(True) for t in inputs]
            out = fn(*ins, **kw)
            return torch.autograd.grad(out, ins, dout.to(out.dtype))

        errs = {}
        got = grads(fa.flash_attention, q, k, v)
        plain = grads(fa.mha_ref, q, k, v)
        torch.cuda.empty_cache()
        f32 = grads(fa.mha_ref, q.float(), k.float(), v.float())
        for g, a, b, c in zip(("dq", "dk", "dv"), got, plain, f32):
            errs[g] = ((a.float() - c).abs().max().item(), (b.float() - c).abs().max().item(),
                       c.abs().max().item())
        del got, plain, f32
        torch.cuda.empty_cache()
        log(f"[kernel] flash_attention_bwd ({BWD_DESIGN}) {name} {tuple(q.shape)} x "
            f"{tuple(k.shape)} {kw}: "
            + ", ".join(f"{g} max |kernel - f32| {e[0]:.3e} (plain bf16 {e[1]:.3e}, max |g| "
                        f"{e[2]:.3e})" for g, e in errs.items()))
        bad = [g for g, (e_k, e_p, top) in errs.items()
               if not (e_k <= BWD_VS_PLAIN * e_p and e_k <= BWD_TOL * top)]
        if bad:
            raise AssertionError(f"flash backward past {BWD_VS_PLAIN}x the plain bf16 "
                                 f"error or {BWD_TOL} of max |grad| in {bad} ({name})")
        out, lse = fa.flash_attention_lse_cuda(q, k, v, **kw)
        one = fa.flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
        two = fa.flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a.view(torch.int16), b.view(torch.int16))
                   for a, b in zip(one, two)):
            raise AssertionError(f"two backward launches gave different bits ({name})")
        del one, two
        fwd_shapes[name] = _flash_lse_forward(torch, fa, fbench, timing, flush, visible_mask,
                                              name, shape, q, k, v, out, lse, kw)
        work = fbench.needed_bwd_work(shape)
        bound, bound_by = timing.bound_ms(work)
        ms = timing.timed_ms(lambda: fa.flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw),
                             20, flush)
        ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out_p = fa.mha_ref(*ins, **kw)
        plain_ms = timing.timed_ms(
            lambda: torch.autograd.grad(out_p, ins, dout, retain_graph=True), 3, flush)
        del out_p, ins
        torch.cuda.empty_cache()
        fwd, both = fbench.bwd_yardstick(q, k, v, shape, dout)
        library_ms = timing.timed_ms(both, 20, flush) - timing.timed_ms(fwd, 20, flush)
        passes = _busy(torch, lambda: (timing.flush_l2(flush), fa.flash_attention_bwd_cuda(
            q, k, v, out, dout, lse, **kw)), repeats=1, matches=BWD_PASSES)["match_ms"]
        max_err = max(e[0] for e in errs.values())
        shapes[name] = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                            library_ms=library_ms, bound_ms=bound, bound_by=bound_by,
                            errors=errs, deterministic=True, design=BWD_DESIGN,
                            passes_ms=passes,
                            library_backend=fbench.yardstick_backend(q, k, v, shape))
        log(f"[kernel] flash_attention_bwd ({BWD_DESIGN}) {name} timing (L2 flushed per "
            f"launch): kernel {ms:.4f} ms (device ms by launch, profiled: "
            + ", ".join(f"{k_} {v_:.4f}" if v_ is not None else f"{k_} none"
                        for k_, v_ in passes.items())
            + f"), plain (autograd through mha_ref, bf16) {plain_ms:.4f} ms, SDPA "
            f"forward + backward less forward {library_ms:.4f} ms "
            f"({shapes[name]['library_backend']}); {work['pairs']} visible pairs -> "
            f"{work['flops']} flops (2.5x the forward's) -> "
            f"{work['flops'] / timing.BF16_FLOPS_PER_S * 1e3:.5f} ms at 989 TFLOP/s; "
            f"{work['bytes']} bytes -> {work['bytes'] / timing.HBM_BYTES_PER_S * 1e3:.5f} ms "
            f"at 3.35 TB/s; bound {bound:.5f} ms ({bound_by}), kernel at {bound / ms:.3f} of "
            f"it; two launches bit for bit equal")
        del q, k, v, out, lse, dout, fwd, both
        torch.cuda.empty_cache()
    del flush
    first, fwd = shapes[next(iter(shapes))], fwd_shapes[next(iter(fwd_shapes))]
    return {
        "bwd": {"name": "flash_attention_bwd", "route": "cuda", "path": f"{TRAIN_ARCH} train",
                "design": BWD_DESIGN,
                "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu",
                "replaces": "src/repro/models/attention.py:154 (no TPU kernel: the JAX "
                            "package differentiates _sdpa_chunked by recompute)",
                "launches": None,
                "max_abs_err": max(r["max_abs_err"] for r in shapes.values()),
                "ms": first["ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
                "bound_by": first["bound_by"], "library_ms": first["library_ms"],
                "shapes": shapes},
        "fwd": {"name": "flash_attention", "route": "cuda", "path": f"{TRAIN_ARCH} train",
                "design": fwd["design"] + ", with lse",
                "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention/kernel.py:98",
                "launches": None,
                "max_abs_err": max(r["max_abs_err"] for r in fwd_shapes.values()),
                "ms": fwd["ms"], "plain_ms": fwd["plain_ms"], "bound_ms": fwd["bound_ms"],
                "bound_by": fwd["bound_by"], "library_ms": fwd["library_ms"],
                "shapes": fwd_shapes},
    }


def _hold_lse(torch, fa, visible_mask, name, shape, q, k, v, out, lse, kw):
    """The forward with lse at one shape: ``out`` (from
    ``flash_attention_lse_cuda``) against ``mha_ref`` in float32 at
    ``FLASH_TOL``, ``lse`` against ``logsumexp`` of the plain float32
    scores within 1e-3 of (1 + max |lse|). Returns ``(max |out - plain|,
    max |lse - logsumexp|)``."""
    B, Hq, Hkv, S, T, D = shape[:6]
    ref = fa.mha_ref(q.float(), k.float(), v.float(), **kw)
    err, worst, bad = fa.compare(out, ref, tol=FLASH_TOL)
    del ref
    scores = torch.einsum("bhsd,bhtd->bhst", q.float(),
                          k.float().repeat_interleave(Hq // Hkv, dim=1)) * D ** -0.5
    mask = visible_mask(S, T, causal=kw["causal"], window=kw["window"],
                        q_offset=kw["q_offset"], device=q.device)
    want = torch.logsumexp(scores.masked_fill_(~mask, float("-inf")), dim=-1)
    del scores, mask
    lse_err = (lse - want).abs().max().item()
    lse_tol = 1e-3 * (1 + want.abs().max().item())
    del want
    torch.cuda.empty_cache()
    log(f"[kernel] flash_attention (with lse) {name} {tuple(q.shape)} x {tuple(k.shape)} "
        f"{kw}: max |kernel - plain f32| = {err:.3e}, largest share of the allowed error "
        f"{worst:.3f} ({bad} elements over {FLASH_TOL} x (row rms + |plain|)); max |lse - "
        f"logsumexp| = {lse_err:.3e} (allowed {lse_tol:.3e})")
    if bad or not torch.isfinite(out.float()).all() or not lse_err <= lse_tol:
        raise AssertionError(f"flash attention with lse disagrees with the plain version "
                             f"({name})")
    return err, lse_err


def _flash_lse_forward(torch, fa, fbench, timing, flush, visible_mask, name, shape,
                       q, k, v, out, lse, kw):
    """``check_flash_bwd``'s hold (``_hold_lse``) and timing of the forward
    with lse at one shape, timed as ``check_flash`` times the serving
    forward, its bound counting the lse written. Returns the shape's
    numbers."""
    B, Hq, Hkv, S, T, D = shape[:6]
    err, lse_err = _hold_lse(torch, fa, visible_mask, name, shape, q, k, v, out, lse, kw)
    work = fbench.needed_work(shape)
    work["bytes"] += 4 * B * Hq * S                   # the lse written
    bound, bound_by = timing.bound_ms(work)
    walk = fa.tile_counts(q, k, v, **kw)
    r = dict(design=f"{walk['design']}, {fa.key_tile(shape[5], shape[9])}-key tiles",
             max_abs_err=err, lse_err=lse_err, bound_ms=bound, bound_by=bound_by,
             ms=timing.timed_ms(lambda: fa.flash_attention_lse_cuda(q, k, v, **kw), 50, flush),
             plain_ms=timing.timed_ms(lambda: fa.mha_ref(q, k, v, **kw), 5, flush),
             library_ms=timing.timed_ms(fbench.yardstick(q, k, v, shape), 50, flush),
             library_backend=fbench.yardstick_backend(q, k, v, shape))
    torch.cuda.empty_cache()
    log(f"[kernel] flash_attention (with lse) {name} timing (L2 flushed per launch): kernel "
        f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, SDPA forward {r['library_ms']:.4f} "
        f"ms ({r['library_backend']}); {work['pairs']} visible pairs -> {work['flops']} flops "
        f"-> {work['flops'] / timing.BF16_FLOPS_PER_S * 1e3:.5f} ms at 989 TFLOP/s; "
        f"{work['bytes']} bytes (lse included) -> "
        f"{work['bytes'] / timing.HBM_BYTES_PER_S * 1e3:.5f} ms at 3.35 TB/s; bound "
        f"{bound:.5f} ms ({bound_by}), kernel at {bound / r['ms']:.3f} of it; SFU floor "
        f"{timing.sfu_ms(work):.5f} ms ({work['exps']} exponentials)")
    return r


def check_flash_lse_widths(torch, dev):
    """Phase 3 for the forward with lse at the widths the train shapes do
    not cover: D 80 (the odd and hubert-xlarge check shapes) and D 16
    (``LSE_D16_SHAPE``), each held by ``_hold_lse``, its output bit for
    bit the serving forward's."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import bench as fbench
    from repro_torch.kernels.flash_attention.ref import visible_mask

    for name, shape in (("odd", fbench.SHAPES["odd"]),
                        ("hubert-xlarge", fbench.SHAPES["hubert-xlarge"]),
                        ("D 16", LSE_D16_SHAPE)):
        q, k, v = fbench.check_inputs(dev, shape)
        kw = dict(causal=shape[6], window=shape[7], q_offset=shape[8])
        out, lse = fa.flash_attention_lse_cuda(q, k, v, **kw)
        serving = fa.flash_attention_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        if not torch.equal(out.view(torch.int16), serving.view(torch.int16)):
            raise AssertionError(f"the forward with lse changed the output ({name})")
        _hold_lse(torch, fa, visible_mask, name, shape, q, k, v, out, lse, kw)
        del q, k, v, out, lse, serving
        torch.cuda.empty_cache()


def _moe_bwd_case(dev, name):
    """(shape (E, C, D, F), counts, the bench's backward inputs) of one of
    ``MOE_BWD_CASES``."""
    from repro_torch.kernels.moe_jam import bench as mbench

    if name in mbench.TRAIN:
        e, d, f, k, tokens, c = mbench.TRAIN[name]
        counts = mbench.train_counts(tokens, e, k, c)
        shape = (e, c, d, f)
    else:
        counts = mbench.check_counts()
        shape = (mbench.EXPERTS, mbench.CAPACITY, mbench.D_MODEL, mbench.D_FF)
    return shape, counts, mbench.bwd_inputs(dev, counts, shape)


def check_moe_jam_bwd(torch, dev):
    """Phase 3 for the moe_jam backward kernel (B3b) at each of
    ``MOE_BWD_CASES``: dx and the three weight gradients from bf16 inputs
    (``moe_jam.bench.bwd_inputs``) against the plain version on the same
    bf16 inputs (``MOE_BWD_TOL``, ``MOE_DW_TOL``) and against it on the
    inputs cast to float32 (``BWD_VS_PLAIN``); dx rows past counts and an
    empty expert's weight gradients exact zeros; a second launch the same
    bits. Timed with the L2 flushed: the forward kernel, the backward
    kernel (and its passes by ``torch.profiler``), the plain backward
    (autograd through ``moe_jam_ffn_ref`` in bf16) and three ``bmm``'s
    forward + backward by autograd less the forward. Returns ``{"bwd":
    entry, "fwd": entry}`` (without ``launches``), timed on the first case,
    every case's numbers under ``shapes``; the forward's is the training
    micro-batch's (C 1,280)."""
    from repro_torch.kernels import moe_jam as mj
    from repro_torch.kernels import timing
    from repro_torch.kernels.moe_jam import bench as mbench
    from repro_torch.kernels.moe_jam.kernel import BWD_DESIGN, DESIGN

    flush = timing.l2_flush_buffer(dev)
    shapes, fwd_shapes, empties = {}, {}, 0
    for name in MOE_BWD_CASES:
        shape, counts_np, (x, wg, wu, wd, dy, cnt) = _moe_bwd_case(dev, name)
        E, C, D, F = shape
        got = mj.moe_jam_ffn_bwd_cuda(x, wg, wu, wd, dy, counts=cnt)
        again = mj.moe_jam_ffn_bwd_cuda(x, wg, wu, wd, dy, counts=cnt)
        same = all(torch.equal(a.view(torch.int16), b.view(torch.int16))
                   for a, b in zip(got, again))
        del again
        plain = mj.moe_jam_ffn_bwd_ref(x, wg, wu, wd, dy, counts=cnt)
        f32 = mj.moe_jam_ffn_bwd_ref(*(t.float() for t in (x, wg, wu, wd, dy)), counts=cnt)
        errs, bad = {}, []
        for g, k_, p_, f_ in zip(("dx", "dw_gate", "dw_up", "dw_down"), got, plain, f32):
            err, worst, n_bad = mj.compare(k_, p_, tol=MOE_BWD_TOL if g == "dx" else MOE_DW_TOL)
            ref_norm = f_.norm().item()
            e_k = (k_.float() - f_).norm().item() / ref_norm
            e_p = (p_.float() - f_).norm().item() / ref_norm
            errs[g] = dict(max_abs_err=err, share=worst, over=n_bad, l2_kernel=e_k,
                           l2_plain=e_p, finite=bool(torch.isfinite(k_).all()))
            if n_bad or not e_k <= BWD_VS_PLAIN * e_p or not errs[g]["finite"]:
                bad.append(g)
        del plain, f32
        empty_rows = ~(torch.arange(C, device=dev)[None, :] < cnt[:, None].long())
        idle = cnt == 0
        empties += int(idle.sum())
        zeros = (int((got[0][empty_rows] != 0).sum()),
                 sum(int((w[idle] != 0).sum()) for w in got[1:]))
        del got
        torch.cuda.empty_cache()
        log(f"[kernel] moe_jam_bwd ({BWD_DESIGN}) {name} {shape}: {int(counts_np.sum())} kept "
            f"rows, {int(idle.sum())} empty experts; "
            + "; ".join(f"{g} max |kernel - plain| {e['max_abs_err']:.3e} (share "
                        f"{e['share']:.3f}, {e['over']} over), L2 vs f32 {e['l2_kernel']:.4e} "
                        f"(plain bf16 {e['l2_plain']:.4e})" for g, e in errs.items())
            + f"; non-zero: {zeros[0]} in dx past counts, {zeros[1]} in empty experts' "
            f"weight gradients; second launch bit for bit equal: {same}")
        if bad or any(zeros) or not same:
            raise AssertionError(f"moe_jam backward disagrees with its plain version ({name}: "
                                 f"{bad}, zeros {zeros}, deterministic {same})")
        work = mbench.needed_bwd_work(counts_np, capacity=C, d_model=D, d_ff=F)
        bound, bound_by = timing.bound_ms(work)
        lib_fwd, lib_both = mbench.bwd_yardstick(x, wg, wu, wd, dy)
        r = dict(max_abs_err=max(e["max_abs_err"] for e in errs.values()), errors=errs,
                 deterministic=same, bound_ms=bound, bound_by=bound_by, design=BWD_DESIGN,
                 kept_rows=work["rows"],
                 ms=timing.timed_ms(lambda: mj.moe_jam_ffn_bwd_cuda(x, wg, wu, wd, dy,
                                                                    counts=cnt), 10, flush),
                 plain_ms=timing.timed_ms(mbench.plain_bwd(x, wg, wu, wd, dy, cnt), 3, flush),
                 library_ms=(timing.timed_ms(lib_both, 10, flush)
                             - timing.timed_ms(lib_fwd, 10, flush)),
                 passes_ms=timing.kernel_ms(
                     lambda: mj.moe_jam_ffn_bwd_cuda(x, wg, wu, wd, dy, counts=cnt), flush,
                     mbench.BWD_PASSES, iters=3))
        shapes[name] = r
        pass_bounds = {k: timing.bound_ms(w) for k, w in work["passes"].items()}
        log(f"[kernel] moe_jam_bwd {name} timing (L2 flushed per launch): kernel "
            f"{r['ms']:.4f} ms (passes, profiled, each beside its own bound: "
            + ", ".join(f"{k} {v:.4f} (bound {pass_bounds[k][0]:.4f} ms, {pass_bounds[k][1]})"
                        for k, v in r["passes_ms"].items())
            + f"), plain (autograd through moe_jam_ffn_ref, bf16) {r['plain_ms']:.4f} ms, 3 x "
            f"bmm forward + backward by autograd less forward {r['library_ms']:.4f} ms; "
            f"{work['flops']} flops (eight products over {work['rows']} kept rows) -> "
            f"{work['flops'] / timing.BF16_FLOPS_PER_S * 1e3:.5f} ms at 989 TFLOP/s; "
            f"{work['bytes']} bytes -> {work['bytes'] / timing.HBM_BYTES_PER_S * 1e3:.5f} ms "
            f"at 3.35 TB/s; bound {bound:.5f} ms ({bound_by}), kernel at {bound / r['ms']:.3f} "
            f"of it")
        if name in mbench.TRAIN:
            fwork = mbench.needed_work(counts_np, d_model=D, d_ff=F)
            fbound, fby = timing.bound_ms(fwork)
            out = mj.moe_jam_ffn_cuda(x, wg, wu, wd, counts=cnt)
            ferr, fworst, fbad = mj.compare(out, mj.moe_jam_ffn_ref(x, wg, wu, wd, counts=cnt),
                                            tol=MOE_TOL)
            del out
            fr = fwd_shapes[name] = dict(
                max_abs_err=ferr, bound_ms=fbound, bound_by=fby,
                ms=timing.timed_ms(lambda: mj.moe_jam_ffn_cuda(x, wg, wu, wd, counts=cnt), 10,
                                   flush),
                plain_ms=timing.timed_ms(lambda: mj.moe_jam_ffn_ref(x, wg, wu, wd,
                                                                    counts=cnt), 3, flush),
                library_ms=timing.timed_ms(lambda: mbench.yardstick(x, wg, wu, wd), 10, flush))
            log(f"[kernel] moe_jam ({DESIGN}) {name} forward (C {C}): max |kernel - plain| = "
                f"{ferr:.3e}, largest share of the allowed error {fworst:.3f} ({fbad} over "
                f"{MOE_TOL}); kernel {fr['ms']:.4f} ms, plain {fr['plain_ms']:.4f} ms, 3 x bmm "
                f"+ act {fr['library_ms']:.4f} ms, bound {fbound:.5f} ms ({fby}), kernel at "
                f"{fbound / fr['ms']:.3f} of it")
            if fbad:
                raise AssertionError(f"moe_jam disagrees with the plain version ({name})")
        del x, wg, wu, wd, dy, cnt, lib_fwd, lib_both
        torch.cuda.empty_cache()
    del flush
    if not empties:
        raise AssertionError("no backward case held an empty expert")
    first, fwd = next(iter(shapes.values())), next(iter(fwd_shapes.values()))
    return {
        "bwd": {"name": "moe_jam_bwd", "route": "cuda", "path": f"{MOE_TRAIN_ARCH} train",
                "design": BWD_DESIGN,
                "source": "src/repro_torch/kernels/moe_jam/csrc/moe_jam_bwd.cu",
                "replaces": "src/repro/models/moe.py:66 (no TPU kernel: the JAX package "
                            "differentiates expert_ffn)",
                "launches": None,
                "max_abs_err": max(r["max_abs_err"] for r in shapes.values()),
                "ms": first["ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
                "bound_by": first["bound_by"], "library_ms": first["library_ms"],
                "shapes": shapes},
        "fwd": {"name": "moe_jam", "route": "cuda", "path": f"{MOE_TRAIN_ARCH} train",
                "design": DESIGN, "source": "src/repro_torch/kernels/moe_jam/csrc/moe_jam.cu",
                "replaces": "src/repro/kernels/moe_jam/kernel.py:62", "launches": None,
                "max_abs_err": max(r["max_abs_err"] for r in fwd_shapes.values()),
                "ms": fwd["ms"], "plain_ms": fwd["plain_ms"], "bound_ms": fwd["bound_ms"],
                "bound_by": fwd["bound_by"], "library_ms": fwd["library_ms"],
                "shapes": fwd_shapes},
    }


def _bits(torch, t):
    """``t``'s bits as integers, for a bit-for-bit comparison."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def check_ssm_scan_bwd(torch, dev):
    """Phase 3 for the selective scan's backward (B4b) at each of
    ``ssm_scan.bench.BWD_CASES``: the training forward (chunk states) must
    give the serving forward's y and h_last bit for bit and states within
    ``SCAN_H_TOL`` of the plain version's (``ssm_scan_chunk_states``);
    then the backward from those states against the plain version on the
    same bf16 inputs and on them cast to float32 (``compare_bwd``),
    gated columns exact zeros, a second launch the same bits. Timed with
    the L2 flushed: the backward (and each of its four launches by
    ``torch.profiler``), the plain backward, the serving forward and the
    training forward, beside the bound; the SFUs' floor, the chain's floor,
    the gradient pass's resident CTAs an SM (the CUDA runtime's occupancy
    query) and the forward's bound are printed on the timing line. Returns
    ``{"bwd": {path: entry}, "fwd": {path: entry}}`` (without
    ``launches``) for the training cases; each bwd entry's ``shapes``
    holds its own case's measured numbers by name, and the first's also
    the engine cases'."""
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.kernels import timing
    from repro_torch.kernels.ssm_scan import bench as sbench
    from repro_torch.kernels.ssm_scan.kernel import (BWD_DESIGN, DESIGN, bwd_resident_ctas,
                                                     scan_route)

    flush = timing.l2_flush_buffer(dev)
    bwd, fwd, engine = {}, {}, {}
    for name, (rows, cols, inner, state, ragged, _) in sbench.BWD_CASES.items():
        dt, b, c, x, a, h0, n_valid, dy, dh_last = sbench.bwd_inputs(dev, name)
        nv_np = sbench.bwd_n_valid(rows, cols, ragged)
        args = (dt, b, c, x, a, h0, n_valid)
        route = scan_route(dt, b, c, x)
        y, h, states = ss.ssm_scan_train_cuda(*args)
        y_s, h_s = ss.ssm_scan_cuda(*args)
        y_ref, h_ref = ss.ssm_scan_ref(*args)
        st_ref = ss.ssm_scan_chunk_states(*args)
        torch.cuda.synchronize()
        same_fwd = (torch.equal(_bits(torch, y), _bits(torch, y_s))
                    and torch.equal(_bits(torch, h), _bits(torch, h_s)))
        nv_all = n_valid if n_valid is not None else torch.full((rows,), cols, device=dev)
        max_y, max_h, _, fwd_bad = ss.compare(y, h, y_ref, h_ref, nv_all, y_tol=SCAN_Y_TOL,
                                              h_tol=SCAN_H_TOL)
        st_err = float((states - st_ref).abs().max())
        st_bad = int((~((states - st_ref).abs() <= SCAN_H_TOL * (1 + st_ref.abs()))).sum())
        del y, h, y_s, h_s, y_ref, h_ref, st_ref

        def call():
            return ss.ssm_scan_bwd_cuda(dt, b, c, x, a, states, dy, n_valid, dh_last)

        def plain_call():
            return ss.ssm_scan_bwd_ref(dt, b, c, x, a, dy, h0, n_valid, dh_last)

        got, again = call(), call()
        same = all(torch.equal(_bits(torch, p), _bits(torch, q)) for p, q in zip(got, again))
        del again
        plain = plain_call()
        f32 = ss.ssm_scan_bwd_ref(dt.float(), b.float(), c.float(), x.float(), a, dy.float(),
                                  h0, n_valid, dh_last)
        stats, bad = ss.compare_bwd(got, plain, f32, n_valid)
        del got, plain, f32
        torch.cuda.empty_cache()
        log(f"[kernel] ssm_scan_bwd ({BWD_DESIGN}) {name} ({rows} x {cols} x {inner}, N {state}, "
            f"valid columns {int(nv_np.sum())}, forward route {route}): "
            + "; ".join(f"{g} max |kernel - plain| {e['max_abs_err']:.3e} of max "
                        f"{e['max_abs']:.3e}, L2 vs f32 {e['l2_kernel']:.4e} (plain bf16 "
                        f"{e['l2_plain']:.4e}), non-zero past n_valid {e['gated_nonzero']}"
                        for g, e in stats.items())
            + f"; second launch bit for bit equal: {same}; the training forward's y and h_last "
            f"bit for bit the serving forward's: {same_fwd} (against plain: max |diff| of y "
            f"{max_y:.3e}, of h_last {max_h:.3e}, {fwd_bad} over), its chunk states "
            f"{tuple(states.shape)} against plain max |diff| {st_err:.3e} ({st_bad} over "
            f"{SCAN_H_TOL} x (1 + |plain|))")
        if bad or not same or not same_fwd or fwd_bad or st_bad:
            raise AssertionError(f"ssm_scan backward disagrees ({name}: {bad}, deterministic "
                                 f"{same}, forward {same_fwd}, {fwd_bad} over, states over "
                                 f"{st_bad})")
        work = sbench.needed_bwd_work(nv_np, inner=inner, state=state,
                                      dh_last=dh_last is not None)
        bound, bound_by = timing.bound_ms(work)
        fwork = sbench.needed_work(nv_np, inner=inner, state=state)
        fbound, fby = timing.bound_ms(fwork)
        sfu, chain = timing.sfu_ms(work), sbench.chain_ms(work)
        r = dict(max_abs_err=max(e["max_abs_err"] for e in stats.values()), errors=stats,
                 deterministic=same, bound_ms=bound, bound_by=bound_by,
                 ms=timing.timed_ms(call, 10, flush),
                 passes_ms=timing.kernel_ms(call, flush, sbench.BWD_PASSES, iters=3),
                 plain_ms=timing.timed_ms(plain_call, 1, flush),
                 fwd_ms=timing.timed_ms(lambda: ss.ssm_scan_cuda(*args), 10, flush),
                 fwd_train_ms=timing.timed_ms(lambda: ss.ssm_scan_train_cuda(*args), 10, flush))
        log(f"[kernel] ssm_scan_bwd {name} timing (L2 flushed per launch): kernel {r['ms']:.4f} "
            f"ms (profiled: " + ", ".join(f"{label} ({sbench.BWD_PASSES[label]}) {ms:.4f}"
                                          for label, ms in r["passes_ms"].items())
            + f"; gradient pass {bwd_resident_ctas(state)} CTAs resident an SM by the CUDA "
            f"runtime's occupancy query), plain (ssm_scan_bwd_ref) {r['plain_ms']:.4f} ms, no "
            f"single PyTorch call computes a selective scan; {work['bytes']} bytes -> "
            f"{work['bytes'] / timing.HBM_BYTES_PER_S * 1e3:.5f} ms at 3.35 TB/s; "
            f"{work['f32_flops']} float32 operations -> "
            f"{work['f32_flops'] / timing.F32_FLOPS_PER_S * 1e3:.5f} ms at 67 TFLOP/s; bound "
            f"{bound:.5f} ms ({bound_by}), kernel at {bound / r['ms']:.4f} of it; "
            f"{work['exps']} exponentials -> SFU floor {sfu:.5f} ms; "
            f"{work['chain_steps']} dependent steps in sequence (the longest chunk's local "
            f"carry, sweep, recompute and reverse, and the carry over its row's chunks) x "
            f"{sbench.CHAIN_CYCLES} cycles at "
            f"{sbench.CLOCK_HZ / 1e9:.2f} GHz -> chain floor {chain:.5f} ms; forward at this "
            f"shape: serving {r['fwd_ms']:.4f} ms, training (chunk states) "
            f"{r['fwd_train_ms']:.4f} ms (route {route}; bound {fbound:.5f} ms, {fby})")
        if not ragged:
            path = f"{name.split()[0]} train"
            bwd[path] = {
                "name": "ssm_scan_bwd", "route": "cuda", "path": path, "design": BWD_DESIGN,
                "source": "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan_bwd.cu",
                "replaces": "src/repro/models/ssm.py:94 (no TPU kernel: the JAX package "
                            "differentiates the lax.scan of ssm_forward)",
                "launches": None, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": bound, "bound_by": bound_by,
                "library_ms": None, "passes_ms": r["passes_ms"], "fwd_ms": r["fwd_ms"],
                "shapes": {name: r}}
            fwd[path] = {
                "name": "ssm_scan", "route": "cuda", "path": path,
                "design": f"{DESIGN}, route {route}, training instance (chunk states)",
                "source": "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
                "replaces": "src/repro/kernels/ssm_scan/kernel.py:60", "launches": None,
                "max_abs_err": max(max_y, max_h), "ms": r["fwd_train_ms"],
                "plain_ms": timing.timed_ms(lambda: ss.ssm_scan_ref(*args), 2, flush),
                "bound_ms": fbound, "bound_by": fby, "library_ms": None,
                "serving_ms": r["fwd_ms"]}
        else:
            engine[name] = r
        del dt, b, c, x, a, h0, n_valid, dy, dh_last, states, args, call, plain_call
        torch.cuda.empty_cache()
    del flush
    next(iter(bwd.values()))["shapes"].update(engine)
    return {"bwd": bwd, "fwd": fwd}


def _n_params(cfg) -> int:
    from repro_torch import tree
    from repro_torch.models import model as model_lib

    return sum(t.numel() for t in tree.leaves(model_lib.abstract_params(cfg)))


class _FirstBatch:
    """A data pipeline that records its start step and first batch."""

    def __init__(self, pipe, start, into):
        self.pipe, self.start, self.into = pipe, start, into

    def __next__(self):
        batch = next(self.pipe)
        if self.start is not None:
            self.into.append((self.start, batch["tokens"].clone()))
            self.start = None
        return batch

    def close(self):
        self.pipe.close()


def _train_cfg(cfg, ckpt_dir):
    """``cfg`` with its stack cut where the disk under ``ckpt_dir`` cannot
    take two checkpoints at once (the new one is written before retention
    removes the old), and the reason, or ``cfg`` and None."""
    import dataclasses
    import shutil

    free = shutil.disk_usage(ckpt_dir).free
    per_ckpt = lambda c: 12 * _n_params(c)         # noqa: E731  f32 params, m, v
    if 2.2 * per_ckpt(cfg) <= free:
        return cfg, None
    layers = cfg.num_layers
    while layers > 1 and 2.2 * per_ckpt(dataclasses.replace(cfg, num_layers=layers)) > free:
        layers -= 1
    return (dataclasses.replace(cfg, num_layers=layers),
            f"the disk has {free / 1e9:.1f} GB free, under two checkpoints of "
            f"{per_ckpt(cfg) / 1e9:.1f} GB: the drill's stack is cut to {layers} of "
            f"{cfg.num_layers} layers")


def train_path(torch, dev, card):
    """The train phase: ``Trainer`` on ``TRAIN_ARCH`` at full width and
    depth (float32 masters from seed 0, ``train_4k`` at 4,096 tokens, a
    global batch of ``TRAIN_BATCH`` in ``TRAIN_ACCUM`` micro-batches,
    remat="full", AdamW at ``TRAIN_LR``), ``TRAIN_STEPS`` steps with a
    checkpoint every ``TRAIN_CKPT_EVERY`` (under ``build/train_ckpt``, one
    kept) and ``FaultInjector(fail_steps=(TRAIN_FAIL_STEP,))``. Every
    launch count is set to 0 just before ``train()`` and read just after.
    Checks: every loss finite and the last step's below the first's; one
    restart, the pipeline resumed at the checkpoint's step with its batch
    equal to ``synthetic_batch`` of that step; the restored params and
    optimizer state equal, bit for bit, to a copy taken on the card when
    that checkpoint was saved; flash forward launches 2 x 16 x accum a step
    run (remat recomputes each layer's forward) and backward 16 x accum,
    replays included, nothing else; the float32 control
    (``TRAIN_CONTROL_LAYERS``, ``TRAIN_VS_PLAIN``). Prints step p50/p90,
    tokens/s, the model-FLOPs share of the card's dense bf16 peak, one
    step's device busy and idle share and top device ops, flash's forward
    and backward shares of it, peak allocated memory, checkpoint bytes and
    save and restore seconds. Returns ``{"flash_attention": n,
    "flash_attention_bwd": n}``, the launches of the drill."""
    import dataclasses
    import shutil

    from repro_torch import tree
    from repro_torch.configs.base import TRAIN_4K, OptimizerConfig, RunConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data import synthetic_batch
    from repro_torch.kernels import timing
    from repro_torch.runtime.fault import FaultInjector
    from repro_torch.runtime.steps import LAUNCH_COUNTERS
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    ckpt_dir = Path(__file__).resolve().parent / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt_dir.mkdir(parents=True)
    full = dataclasses.replace(get_config(TRAIN_ARCH), remat="full")
    cfg, cut = _train_cfg(full, ckpt_dir)
    if cut:
        log(f"[train] {cut}")
    shape = dataclasses.replace(TRAIN_4K, global_batch=TRAIN_BATCH)
    run = RunConfig(model=cfg, shape=shape, checkpoint_dir=str(ckpt_dir),
                    optimizer=OptimizerConfig(lr=TRAIN_LR, total_steps=TRAIN_STEPS,
                                              warmup_steps=max(1, TRAIN_STEPS // 10),
                                              accum_steps=TRAIN_ACCUM))
    record = dict(starts=[], runs=[], saved=None, restored=None, restore_s=None)

    class Drill(Trainer):
        def _pipeline(self, start_step):
            return _FirstBatch(super()._pipeline(start_step), start_step, record["starts"])

        def init_state(self):
            t = time.perf_counter()
            step, params, opt = super().init_state()
            torch.cuda.synchronize()
            if step:
                record["restore_s"] = time.perf_counter() - t
                saved = record["saved"]
                record["restored"] = step == saved[0] and all(
                    a.dtype == b.dtype and a.shape == b.shape and torch.equal(
                        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
                    for a, b in zip(tree.leaves({"params": params, "opt": opt}),
                                    tree.leaves(saved[1])))
                record["saved"] = saved = None    # the steps after run without the copy
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            return step, params, opt

    log_lines = []
    trainer = Drill(cfg, run, tcfg=TrainerConfig(steps=TRAIN_STEPS, log_every=1,
                                                 checkpoint_every=TRAIN_CKPT_EVERY,
                                                 keep_checkpoints=1),
                    injector=FaultInjector(fail_steps=(TRAIN_FAIL_STEP,)),
                    log_fn=lambda m: (log_lines.append(m), log(m)), device=dev)
    save = trainer.ckpt.save

    def saving(step, state, **kw):
        if step == TRAIN_CKPT_EVERY:               # the checkpoint the restart reads
            record["saved"] = (step, tree.map_(lambda t: t.detach().clone(), state))
        save(step, state, **kw)

    trainer.ckpt.save = saving
    step_fn = trainer.bundle.fn

    def timed_step(params, opt, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step_fn(params, opt, batch)
        loss = float(out[2]["loss"])
        record["runs"].append((time.perf_counter() - t, loss,
                               {k: float(v) for k, v in out[2].items()}))
        return out

    trainer.bundle.fn = timed_step
    torch.cuda.reset_peak_memory_stats()
    for counter in LAUNCH_COUNTERS.values():
        counter.reset()
    stats = trainer.train()
    launches = {name: c.count for name, c in LAUNCH_COUNTERS.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9    # the steps after the restore
    trainer.bundle.fn = step_fn
    npz = ckpt_dir / f"step_{TRAIN_STEPS}" / "arrays.npz"
    ckpt_bytes = npz.stat().st_size if npz.exists() else 0

    runs = record["runs"]
    losses = [r[1] for r in runs]
    n_runs = len(runs)
    want = {"flash_attention": 2 * cfg.num_layers * TRAIN_ACCUM * n_runs,
            "flash_attention_bwd": cfg.num_layers * TRAIN_ACCUM * n_runs}
    first_loss = losses[0]
    last_loss = losses[-1]
    replay = record["starts"][1][0] if len(record["starts"]) > 1 else None
    resumed = (replay is not None and torch.equal(
        record["starts"][1][1].cpu(),
        torch.from_numpy(synthetic_batch(cfg, shape, replay, run.seed)["tokens"])))
    problems = []
    if not all(np.isfinite(losses)) or not last_loss < first_loss:
        problems.append(f"losses {losses}: not all finite, or the last not below the first")
    if stats.restarts != 1 or stats.steps != TRAIN_STEPS:
        problems.append(f"{stats.restarts} restarts, {stats.steps} steps")
    if [s for s, _ in record["starts"]] != [0, TRAIN_CKPT_EVERY] or not resumed:
        problems.append(f"pipelines started at {[s for s, _ in record['starts']]}, first "
                        f"batch after the restart equal to synthetic_batch: {resumed}")
    if not record["restored"]:
        problems.append("the restored params and opt state differ from the saved ones")
    # the step from the checkpoint runs twice, from the same bits on the same
    # batch: a deterministic forward gives the same loss
    first_run, replayed = runs[TRAIN_CKPT_EVERY][2], runs[TRAIN_FAIL_STEP][2]
    if first_run["loss"] != replayed["loss"]:
        problems.append(f"the replayed step's loss {replayed['loss']!r} is not the first "
                        f"run's {first_run['loss']!r}")
    if any(n != want.get(k, 0) for k, n in launches.items()):
        problems.append(f"launches {launches}, want {want} over {n_runs} step runs")
    if n_runs != TRAIN_FAIL_STEP + TRAIN_STEPS - TRAIN_CKPT_EVERY:
        problems.append(f"{n_runs} step runs")
    if problems:
        raise AssertionError("train phase: " + "; ".join(problems))

    tokens = TRAIN_BATCH * shape.seq_len
    times = sorted(r[0] for i, r in enumerate(runs) if i not in (0, TRAIN_FAIL_STEP))
    p50, p90 = float(np.percentile(times, 50)), float(np.percentile(times, 90))
    a = cfg.attention
    n_params = _n_params(cfg)
    # model FLOPs a step: 6 x params x tokens (forward + backward of every
    # matrix product; the tied embedding counted once, as the head) + 3 x the
    # causal attention's forward, 4 x Hq x D x S/2 a token a layer
    attn = 3 * 4 * a.num_heads * a.head_dim * (shape.seq_len / 2) * cfg.num_layers * tokens
    flops = 6 * n_params * tokens + attn
    mfu = flops / p50 / timing.BF16_FLOPS_PER_S
    log(f"[train] {TRAIN_ARCH} at full width, {cfg.num_layers} layers, {n_params / 1e6:.1f} M "
        f"float32 params; {TRAIN_BATCH} x {shape.seq_len} tokens a step in {TRAIN_ACCUM} "
        f"micro-batches, remat full; losses by step run {[round(x, 4) for x in losses]}; "
        f"{stats.restarts} restart, resumed at step {replay} (batch = synthetic_batch, "
        f"restored state bit for bit equal; the replayed step's loss equal, its grad norm "
        f"{'equal' if first_run['grad_norm'] == replayed['grad_norm'] else 'not equal'}); "
        f"{n_runs} step runs, launches {launches}")
    log(f"[train] step p50 {p50 * 1e3:.1f} ms, p90 {p90 * 1e3:.1f} ms ({len(times)} steady "
        f"runs), {tokens / p50:.0f} tokens/s; model FLOPs 6 x {n_params} params x {tokens} "
        f"tokens + 3 x 4 x {a.num_heads} x {a.head_dim} x {shape.seq_len // 2} x "
        f"{cfg.num_layers} x {tokens} (causal attention) = {flops:.4e} a step -> "
        f"{mfu:.3f} of 989 TFLOP/s dense bf16; peak allocated {peak:.2f} GB over the steps "
        f"after the restore (before it chip_smoke keeps a copy of the saved state on the "
        f"card); checkpoint "
        f"{ckpt_bytes} bytes, save {trainer.ckpt.last_save_s:.2f} s (call to commit, async), "
        f"restore {record['restore_s']:.2f} s, on {card}")

    # one step profiled, then the float32 control
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in synthetic_batch(cfg, shape, TRAIN_STEPS, run.seed).items()}
    params, opt = trainer.params, trainer.opt
    prof = _busy(torch, lambda: step_fn(params, opt, batch), repeats=1,
                 matches=("flash_wgmma", "bwd_") + BWD_PASSES)
    busy = prof["busy_ms"] or 0.0
    log(f"[train] one step profiled: wall {prof['wall_ms']:.1f} ms, device busy {busy:.1f} ms "
        f"(idle share {1 - busy / prof['wall_ms']:.3f}), flash forward "
        f"{prof['match_ms']['flash_wgmma']:.1f} ms ({prof['match_ops']['flash_wgmma']} "
        f"launches, {prof['match_ms']['flash_wgmma'] / max(busy, 1e-9):.3f} of busy), "
        f"backward {prof['match_ms']['bwd_']:.1f} ms ({prof['match_ops']['bwd_']} kernels, "
        f"{prof['match_ms']['bwd_'] / max(busy, 1e-9):.3f} of busy; "
        + ", ".join(f"{m} {prof['match_ms'][m]:.1f} ms" for m in BWD_PASSES)
        + f"); top device ops {prof['top']}")
    del batch, params, opt, trainer
    gc.collect()
    torch.cuda.empty_cache()
    _train_control(torch, dev, cfg, shape, card)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    log(f"[train] phase {time.perf_counter() - t_phase:.1f} s")
    return {k: launches[k] for k in want}


def _moe_train_cfg(full):
    """``full`` cut to the most layers whose estimated peak
    (``MOE_BYTES_PER_PARAM`` x params + ``MOE_ACT_RESERVE``) fits
    ``MOE_PEAK_BUDGET``, and the estimate."""
    import dataclasses

    for layers in range(full.num_layers, 0, -1):
        cfg = dataclasses.replace(full, num_layers=layers)
        est = MOE_BYTES_PER_PARAM * _n_params(cfg) + MOE_ACT_RESERVE
        if est <= MOE_PEAK_BUDGET:
            return cfg, est
    raise AssertionError(f"{full.name}: not one layer fits {MOE_PEAK_BUDGET / 1e9:.0f} GB")


def _dispatch_times(torch, dev, card):
    """The MoE dispatch (``models.moe.build_dispatch``, a stable sort) at
    each of ``DISPATCH_CASES``, warm, against the one-hot exclusive
    ``cumsum`` it replaced (the JAX package's form), on the same ids: both
    must give the same slot, keep and rank. Returns ``{case: (ms, cumsum
    ms)}``."""
    import torch.nn.functional as F

    from repro_torch.kernels import timing
    from repro_torch.models.moe import build_dispatch

    def cumsum_dispatch(ids, e, c):
        flat = ids.reshape(-1).long()
        one_hot = F.one_hot(flat, e + 1)[:, :e]
        rank = ((torch.cumsum(one_hot, dim=0) - one_hot) * one_hot).sum(-1).reshape(ids.shape)
        keep = rank < c
        slot = torch.where(keep, ids.long() * c + rank, torch.full_like(rank, e * c))
        return slot.to(torch.int32), keep, rank.to(torch.int32)

    out = {}
    for name, (tokens, k) in DISPATCH_CASES.items():
        e = 64
        c = max(8, -(-int(np.ceil(tokens * k * 1.25 / e)) // 8) * 8)
        rng = np.random.default_rng(0)
        ids = torch.from_numpy(np.argsort(rng.random((tokens, e)), axis=1)[:, :k].astype(
            np.int32)).to(dev)
        new, old = build_dispatch(ids, e, c), cumsum_dispatch(ids, e, c)
        if not all(torch.equal(a, b) for a, b in zip(new, old)):
            raise AssertionError(f"the sorted dispatch differs from the cumsum's ({name})")
        out[name] = (timing.timed_ms(lambda: build_dispatch(ids, e, c), 20, None),
                     timing.timed_ms(lambda: cumsum_dispatch(ids, e, c), 5, None))
        log(f"[train] MoE dispatch {name} ({tokens} x top-{k} over {e} experts, capacity {c}): "
            f"stable sort {out[name][0]:.4f} ms, one-hot cumsum {out[name][1]:.4f} ms (warm; "
            f"slot, keep and rank equal), on {card}")
    return out


def moe_train_path(torch, dev, card):
    """The MoE train phase: ``Trainer`` on ``MOE_TRAIN_ARCH`` at full width,
    its stack cut by ``_moe_train_cfg`` (float32 masters from seed 0,
    ``train_4k`` at 4,096 tokens, a global batch of ``TRAIN_BATCH`` in
    ``TRAIN_ACCUM`` micro-batches, remat="full", AdamW at ``TRAIN_LR``),
    ``MOE_TRAIN_STEPS`` steps, no checkpoint. Every launch count is set to
    0 just before ``train()`` and read just after. Checks: every loss
    finite and the last below the first; launches per step run: moe_jam's
    forward 2 x layers x accum (remat) and its backward layers x accum,
    flash's forward and backward likewise, nothing else; one micro-batch's
    gradients taken twice from the same params bit for bit equal; the
    float32 control (``_train_control``, routing fixed). Prints step
    p50/p90, tokens/s, the model-FLOPs share of the dense bf16 peak from
    the active params, one step's device busy and idle share, its top
    device ops and the shares of moe_jam's forward and backward, flash's
    forward and backward and the dispatch's sort and search, the peak
    allocated memory, and the dispatch's times (``_dispatch_times``).
    Returns the launches of the run."""
    import dataclasses
    import shutil

    from repro_torch import tree
    from repro_torch.configs.base import TRAIN_4K, OptimizerConfig, RunConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data import synthetic_batch
    from repro_torch.kernels import timing
    from repro_torch.models import model as model_lib
    from repro_torch.runtime.steps import LAUNCH_COUNTERS
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    dispatch = _dispatch_times(torch, dev, card)
    full = dataclasses.replace(get_config(MOE_TRAIN_ARCH), remat="full")
    cfg, est = _moe_train_cfg(full)
    n_params = _n_params(cfg)
    log(f"[train] {MOE_TRAIN_ARCH} at full width, its stack cut to {cfg.num_layers} of "
        f"{full.num_layers} layers: {full.num_layers} layers are {_n_params(full) / 1e9:.2f} B "
        f"params, ~{MOE_BYTES_PER_PARAM * _n_params(full) / 1e9:.0f} GB at "
        f"{MOE_BYTES_PER_PARAM} bytes a param (float32 masters, AdamW's m and v, the float32 "
        f"gradient sums, the bf16 casts); {cfg.num_layers} layers are "
        f"{n_params / 1e9:.2f} B params, estimated peak {est / 1e9:.1f} GB with "
        f"{MOE_ACT_RESERVE / 1e9:.0f} GB of activations, within {MOE_PEAK_BUDGET / 1e9:.0f} GB "
        f"of the card's 80")
    ckpt_dir = Path(__file__).resolve().parent / "build" / "moe_train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    shape = dataclasses.replace(TRAIN_4K, global_batch=TRAIN_BATCH)
    run = RunConfig(model=cfg, shape=shape, checkpoint_dir=str(ckpt_dir),
                    optimizer=OptimizerConfig(lr=TRAIN_LR, total_steps=MOE_TRAIN_STEPS,
                                              warmup_steps=1, accum_steps=TRAIN_ACCUM))
    trainer = Trainer(cfg, run, tcfg=TrainerConfig(steps=MOE_TRAIN_STEPS, log_every=1,
                                                   checkpoint_every=MOE_TRAIN_STEPS + 1),
                      log_fn=log, device=dev)
    if not {"moe_jam", "moe_jam_bwd"} <= set(trainer.bundle.meta["kernels"]):
        raise AssertionError(f"the train bundle names {trainer.bundle.meta['kernels']}")
    step_fn = trainer.bundle.fn
    runs = []

    def timed_step(params, opt, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step_fn(params, opt, batch)
        runs.append((time.perf_counter() - t, float(out[2]["loss"])))
        return out

    trainer.bundle.fn = timed_step
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for counter in LAUNCH_COUNTERS.values():
        counter.reset()
    stats = trainer.train()
    launches = {name: c.count for name, c in LAUNCH_COUNTERS.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    trainer.bundle.fn = step_fn
    losses = [r[1] for r in runs]
    n = TRAIN_ACCUM * len(runs) * cfg.num_layers
    want = {"moe_jam": 2 * n, "moe_jam_bwd": n, "flash_attention": 2 * n,
            "flash_attention_bwd": n}
    problems = []
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        problems.append(f"losses {losses}: not all finite, or the last not below the first")
    if stats.steps != MOE_TRAIN_STEPS or len(runs) != MOE_TRAIN_STEPS:
        problems.append(f"{stats.steps} steps, {len(runs)} step runs")
    if any(c != want.get(k, 0) for k, c in launches.items()):
        problems.append(f"launches {launches}, want {want}")
    if problems:
        raise AssertionError("MoE train phase: " + "; ".join(problems))
    tokens = TRAIN_BATCH * shape.seq_len
    times = sorted(r[0] for r in runs[1:])
    p50, p90 = float(np.percentile(times, 50)), float(np.percentile(times, 90))
    a = cfg.attention
    active = cfg.active_param_count()
    attn = 3 * 4 * a.num_heads * a.head_dim * (shape.seq_len / 2) * cfg.num_layers * tokens
    flops = 6 * active * tokens + attn
    log(f"[train] {MOE_TRAIN_ARCH}, {cfg.num_layers} layers at full width: losses by step "
        f"{[round(x, 4) for x in losses]}; launches {launches} over {len(runs)} step runs "
        f"(moe_jam 2 x {cfg.num_layers} layers x {TRAIN_ACCUM} micro-batches a step, remat "
        f"full; its backward once)")
    log(f"[train] {MOE_TRAIN_ARCH} step p50 {p50 * 1e3:.1f} ms, p90 {p90 * 1e3:.1f} ms "
        f"({len(times)} runs after the first), {tokens / p50:.0f} tokens/s; model FLOPs 6 x "
        f"{active} active params x {tokens} tokens + 3 x 4 x {a.num_heads} x {a.head_dim} x "
        f"{shape.seq_len // 2} x {cfg.num_layers} x {tokens} (causal attention) = "
        f"{flops:.4e} a step -> {flops / p50 / timing.BF16_FLOPS_PER_S:.3f} of 989 TFLOP/s "
        f"dense bf16; peak allocated {peak:.2f} GB (estimated {est / 1e9:.1f}), on {card}")

    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in synthetic_batch(cfg, shape, MOE_TRAIN_STEPS, run.seed).items()}
    params, opt = trainer.params, trainer.opt
    flash_bwd = ("bwd_delta", "bwd_dkdv", "bwd_dq")
    matches = ("moe_stream_kernel", "moe_bwd_", "flash_wgmma", "Sort", "searchsorted") + flash_bwd
    prof = _busy(torch, lambda: step_fn(params, opt, batch), repeats=1, matches=matches)
    busy = prof["busy_ms"] or 0.0
    ms = dict(prof["match_ms"], flash_bwd=sum(prof["match_ms"][m] for m in flash_bwd))
    parts = {"moe_jam forward": "moe_stream_kernel", "moe_jam backward": "moe_bwd_",
             "flash forward": "flash_wgmma", "flash backward": "flash_bwd",
             "the dispatch's sort": "Sort", "its search": "searchsorted"}
    log(f"[train] {MOE_TRAIN_ARCH} one step profiled: wall {prof['wall_ms']:.1f} ms, device "
        f"busy {busy:.1f} ms (idle share {1 - busy / prof['wall_ms']:.3f}); of busy: "
        + ", ".join(f"{label} {ms[m]:.1f} ms ({ms[m] / max(busy, 1e-9):.3f})"
                    for label, m in parts.items())
        + f"; top device ops {prof['top']}")

    # determinism: one micro-batch's gradients twice from the same params
    del opt, trainer
    gc.collect()
    torch.cuda.empty_cache()
    mb = {k: v[:TRAIN_BATCH // TRAIN_ACCUM] for k, v in batch.items()}
    leaves = tree.leaves(params)

    def micro_grads():
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss, _ = model_lib.loss_fn(cfg, params, mb, kernel="cuda")
        out = torch.autograd.grad(loss, leaves)
        for leaf in leaves:
            leaf.requires_grad_(False)
        return out

    one = micro_grads()
    two = micro_grads()
    differ = [i for i, (g1, g2) in enumerate(zip(one, two))
              if not torch.equal(g1.view(torch.int32), g2.view(torch.int32))]
    log(f"[train] {MOE_TRAIN_ARCH} one micro-batch's gradients taken twice: "
        f"{len(leaves) - len(differ)} of {len(leaves)} leaves bit for bit equal")
    if differ:
        raise AssertionError(f"MoE gradients differ between two runs in leaves {differ}")
    del one, two, params, leaves, batch, mb
    gc.collect()
    torch.cuda.empty_cache()
    _train_control(torch, dev, cfg, shape, card)
    log(f"[train] MoE phase {time.perf_counter() - t_phase:.1f} s")
    return dict(launches, dispatch=dispatch)


def ssm_train_path(torch, dev, card):
    """Phase 3d: ``_ssm_train`` on each of ``SSM_TRAIN_ARCHS``. Returns
    ``{arch: launches of its run}``."""
    out = {}
    for arch in SSM_TRAIN_ARCHS:
        out[arch] = _ssm_train(torch, dev, card, arch)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _attn_span(seq_len: int, window) -> float:
    """The mean number of keys a causal query sees over ``seq_len``
    positions, with ``window`` (None: all before it)."""
    w = seq_len if window is None else min(window, seq_len)
    return (w * (w + 1) / 2 + (seq_len - w) * w) / seq_len


def _ssm_train(torch, dev, card, arch):
    """``Trainer`` on ``arch`` at full width and depth (float32 masters from
    seed 0, ``train_4k`` at 4,096 tokens, a global batch of ``TRAIN_BATCH``
    in ``TRAIN_ACCUM`` micro-batches, remat="full", AdamW at ``TRAIN_LR``),
    ``SSM_TRAIN_STEPS`` steps, no checkpoint. Every launch count is set to
    0 just before ``train()`` and read just after. Checks: every loss
    finite and the last below the first; launches per step run: ssm_scan's
    forward 2 x layers x accum (remat) and its backward layers x accum,
    flash's forward and backward likewise where the stack attends, nothing
    else; one micro-batch's gradients taken twice from the same params bit
    for bit equal; the float32 control (``_train_control``). Prints step
    p50/p90, tokens/s, the model-FLOPs share of the dense bf16 peak, one
    step's device busy and idle share, its top device ops and the shares
    of B4, B4b and flash's forward and backward, and the peak allocated
    memory. Returns the launches of the run."""
    import dataclasses
    import shutil

    from repro_torch import tree
    from repro_torch.configs.base import TRAIN_4K, OptimizerConfig, RunConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data import synthetic_batch
    from repro_torch.kernels import timing
    from repro_torch.models import model as model_lib
    from repro_torch.runtime.steps import LAUNCH_COUNTERS
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), remat="full")
    n_params = _n_params(cfg)
    est = MOE_BYTES_PER_PARAM * n_params + MOE_ACT_RESERVE
    if est > MOE_PEAK_BUDGET:
        raise AssertionError(f"{arch}: estimated peak {est / 1e9:.1f} GB")
    log(f"[train] {arch} at full width and depth: {cfg.num_layers} layers, "
        f"{n_params / 1e9:.3f} B params, estimated peak {est / 1e9:.1f} GB")
    ckpt_dir = Path(__file__).resolve().parent / "build" / "ssm_train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    shape = dataclasses.replace(TRAIN_4K, global_batch=TRAIN_BATCH)
    run = RunConfig(model=cfg, shape=shape, checkpoint_dir=str(ckpt_dir),
                    optimizer=OptimizerConfig(lr=TRAIN_LR, total_steps=SSM_TRAIN_STEPS,
                                              warmup_steps=1, accum_steps=TRAIN_ACCUM))
    trainer = Trainer(cfg, run, tcfg=TrainerConfig(steps=SSM_TRAIN_STEPS, log_every=1,
                                                   checkpoint_every=SSM_TRAIN_STEPS + 1),
                      log_fn=log, device=dev)
    attends = cfg.attention is not None
    want_kernels = {"ssm_scan", "ssm_scan_bwd"} | (
        {"flash_attention", "flash_attention_bwd"} if attends else set())
    if set(trainer.bundle.meta["kernels"]) != want_kernels:
        raise AssertionError(f"the train bundle names {trainer.bundle.meta['kernels']}")
    step_fn = trainer.bundle.fn
    runs = []

    def timed_step(params, opt, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step_fn(params, opt, batch)
        runs.append((time.perf_counter() - t, float(out[2]["loss"])))
        return out

    trainer.bundle.fn = timed_step
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for counter in LAUNCH_COUNTERS.values():
        counter.reset()
    stats = trainer.train()
    launches = {name: c.count for name, c in LAUNCH_COUNTERS.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    trainer.bundle.fn = step_fn
    losses = [r[1] for r in runs]
    n = TRAIN_ACCUM * len(runs) * cfg.num_layers
    want = {"ssm_scan": 2 * n, "ssm_scan_bwd": n}
    if attends:
        want.update(flash_attention=2 * n, flash_attention_bwd=n)
    problems = []
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        problems.append(f"losses {losses}: not all finite, or the last not below the first")
    if stats.steps != SSM_TRAIN_STEPS or len(runs) != SSM_TRAIN_STEPS:
        problems.append(f"{stats.steps} steps, {len(runs)} step runs")
    if any(c != want.get(k, 0) for k, c in launches.items()):
        problems.append(f"launches {launches}, want {want}")
    if problems:
        raise AssertionError(f"{arch} train phase: " + "; ".join(problems))
    tokens = TRAIN_BATCH * shape.seq_len
    times = sorted(r[0] for r in runs[1:])
    p50, p90 = float(np.percentile(times, 50)), float(np.percentile(times, 90))
    attn, attn_text = 0.0, ""
    if attends:
        a = cfg.attention
        windows = [a.sliding_window if bt.endswith("_local") else None
                   for bt in model_lib.flat_block_types(cfg)]
        span = sum(_attn_span(shape.seq_len, w) for w in windows)
        attn = 3 * 4 * a.num_heads * a.head_dim * span * tokens
        attn_text = (f" + 3 x 4 x {a.num_heads} x {a.head_dim} x {span:.1f} (keys a query "
                     f"sees, summed over the layers: causal, {a.sliding_window}-token windows "
                     f"on {sum(w is not None for w in windows)}) x {tokens}")
    flops = 6 * n_params * tokens + attn
    log(f"[train] {arch}, {cfg.num_layers} layers at full width: losses by step "
        f"{[round(x, 4) for x in losses]}; launches {launches} over {len(runs)} step runs "
        f"(ssm_scan 2 x {cfg.num_layers} layers x {TRAIN_ACCUM} micro-batches a step, remat "
        f"full; its backward once)")
    log(f"[train] {arch} step p50 {p50 * 1e3:.1f} ms, p90 {p90 * 1e3:.1f} ms ({len(times)} runs "
        f"after the first), {tokens / p50:.0f} tokens/s; model FLOPs 6 x {n_params} params x "
        f"{tokens} tokens{attn_text} = {flops:.4e} a step -> "
        f"{flops / p50 / timing.BF16_FLOPS_PER_S:.4f} of 989 TFLOP/s dense bf16; peak allocated "
        f"{peak:.2f} GB (estimated {est / 1e9:.1f}), on {card}")

    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in synthetic_batch(cfg, shape, SSM_TRAIN_STEPS, run.seed).items()}
    params, opt = trainer.params, trainer.opt
    flash_bwd = ("bwd_delta", "bwd_dkdv", "bwd_dq")
    matches = ("ssm_scan_kernel", "ssm_scan_bwd", "flash_wgmma") + flash_bwd
    prof = _busy(torch, lambda: step_fn(params, opt, batch), repeats=1, matches=matches)
    busy = prof["busy_ms"] or 0.0
    ms = dict(prof["match_ms"], flash_bwd=sum(prof["match_ms"][m] or 0.0 for m in flash_bwd))
    parts = {"ssm_scan forward (B4)": "ssm_scan_kernel", "its backward (B4b)": "ssm_scan_bwd"}
    if attends:
        parts.update({"flash forward": "flash_wgmma", "flash backward": "flash_bwd"})
    log(f"[train] {arch} one step profiled: wall {prof['wall_ms']:.1f} ms, device busy "
        f"{busy:.1f} ms (idle share {1 - busy / prof['wall_ms']:.3f}); of busy: "
        + ", ".join(f"{label} {(ms[m] or 0.0):.1f} ms ({(ms[m] or 0.0) / max(busy, 1e-9):.3f})"
                    for label, m in parts.items())
        + f"; top device ops {prof['top']}")

    # determinism: one micro-batch's gradients twice from the same params
    del opt, trainer
    gc.collect()
    torch.cuda.empty_cache()
    mb = {k: v[:TRAIN_BATCH // TRAIN_ACCUM] for k, v in batch.items()}
    leaves = tree.leaves(params)

    def micro_grads():
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss, _ = model_lib.loss_fn(cfg, params, mb, kernel="cuda")
        out = torch.autograd.grad(loss, leaves)
        for leaf in leaves:
            leaf.requires_grad_(False)
        return out

    one = micro_grads()
    two = micro_grads()
    differ = [i for i, (g1, g2) in enumerate(zip(one, two))
              if not torch.equal(g1.view(torch.int32), g2.view(torch.int32))]
    log(f"[train] {arch} one micro-batch's gradients taken twice: "
        f"{len(leaves) - len(differ)} of {len(leaves)} leaves bit for bit equal")
    if differ:
        raise AssertionError(f"{arch} gradients differ between two runs in leaves {differ}")
    del one, two, params, leaves, batch, mb
    gc.collect()
    torch.cuda.empty_cache()
    _train_control(torch, dev, cfg, shape, card)
    log(f"[train] {arch} phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def _train_control(torch, dev, full, shape, card):
    """The float32 control of a train phase: ``full`` cut to its first
    ``TRAIN_CONTROL_LAYERS`` at full width, one 1 x 4,096 micro-batch
    (``synthetic_batch`` step 0): every leaf's gradient of ``loss_fn``
    through the kernels in bf16, through the plain version in bf16 and in
    float32, on the same float32 params from seed 0. A MoE stack runs
    without remat and with its routing fixed (``_fixed_routing``): the
    float32 path's expert choices are replayed on both bf16 paths."""
    import contextlib
    import dataclasses

    from repro_torch import tree
    from repro_torch.data import synthetic_batch
    from repro_torch.models import model as model_lib

    cfg = dataclasses.replace(full, num_layers=TRAIN_CONTROL_LAYERS)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, remat="none")
    routing = _fixed_routing() if cfg.moe is not None else contextlib.nullcontext(None)
    one = dataclasses.replace(shape, global_batch=1)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in synthetic_batch(cfg, one, 0).items()}
    params = model_lib.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    leaves = tree.leaves(params)

    def grads(kernel, dtype):
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss, _ = model_lib.loss_fn(cfg, params, batch, kernel=kernel, compute_dtype=dtype)
        out = torch.autograd.grad(loss, leaves)
        for leaf in leaves:
            leaf.requires_grad_(False)
        return float(loss.detach()), out

    with routing as replay:
        l_f, g_f = grads("ref", torch.float32)           # first: it sets the routing
        if replay:
            replay()
        l_k, g_k = grads("cuda", torch.bfloat16)
        if replay:
            replay()
        l_p, g_p = grads("ref", torch.bfloat16)
    rows, bad = [], []
    for (path, _), a, b, c in zip(tree.flatten_with_paths(params), g_k, g_p, g_f):
        ref = c.norm().item()
        e_k, e_p = (a - c).norm().item() / ref, (b - c).norm().item() / ref
        rows.append((path, e_k, e_p))
        if not (np.isfinite(e_k) and e_k <= TRAIN_VS_PLAIN * e_p):
            bad.append((path, e_k, e_p))
    worst = max(rows, key=lambda r: r[1] / max(r[2], 1e-30))
    log(f"[train] {cfg.name} float32 control ({TRAIN_CONTROL_LAYERS} layers, 1 x "
        f"{shape.seq_len}{', routing fixed to the float32 path' if cfg.moe else ''}): loss "
        f"kernel bf16 {l_k:.5f}, plain bf16 {l_p:.5f}, plain float32 {l_f:.5f}; "
        f"{len(rows)} leaves, relative L2 gradient error kernel / plain: median "
        f"{np.median([r[1] for r in rows]):.3e} / {np.median([r[2] for r in rows]):.3e}, "
        f"largest ratio {worst[1] / max(worst[2], 1e-30):.3f} at {worst[0]} "
        f"({worst[1]:.3e} / {worst[2]:.3e}); limit {TRAIN_VS_PLAIN}x, on {card}")
    if bad:
        raise AssertionError(f"kernel-path gradients past {TRAIN_VS_PLAIN}x the plain bf16 "
                             f"path's error against float32: {bad}")


class _fixed_routing:
    """Fix a MoE stack's routing across the float32 control's three
    gradients: the first path's expert choices (``models.moe.route_topk``'s
    ids, recorded call by call) are replayed on the later paths, each path
    computing its own gates (its router probabilities at those ids,
    normalized over k) and its own load-balance and z losses at them. With
    bf16 noise flipping ~28% of random-weight router choices, the flips
    and not the kernels would decide the comparison; fixed, every
    path dispatches the same tokens to the same expert rows. The context
    yields ``replay``, which starts the next path's replay."""

    def __enter__(self):
        from repro_torch.models import moe as moe_mod

        self.mod, self.real = moe_mod, moe_mod.route_topk
        self.ids, self.at = [], None
        moe_mod.route_topk = self.route
        return self.replay

    def __exit__(self, *exc):
        self.mod.route_topk = self.real

    def replay(self):
        self.at = 0

    def route(self, x, router_w, m):
        import torch

        r = self.real(x, router_w, m)
        if self.at is None:
            self.ids.append(r.expert_ids)
            return r
        ids = self.ids[self.at]
        self.at += 1
        logits = x.float() @ router_w.float()
        probs = torch.softmax(logits, dim=-1)
        gates = probs.gather(1, ids.long())
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        f = torch.nn.functional.one_hot(ids[:, 0].long(), m.num_experts).float().mean(0)
        aux = m.num_experts * torch.sum(f * probs.mean(0)) * m.router_aux_coef
        return r._replace(expert_ids=ids, gates=gates, aux_loss=aux)


def serve(torch, dev, arch, *, forced_preemption=True, placement="local"):
    """Phases 4-6 and 11: the full-width engine at ``placement``; returns
    (engine, step records, backend events, summary). The recurrent engine
    preempts requests by ``REC_PREEMPT_AFTER`` (``XL_PREEMPT_AFTER`` for
    xlstm-1.3b, whose traffic is ``XL_*``'s) unless ``forced_preemption``
    is False. Each kernel of ``per_step`` must launch that many times a
    step; every other kernel not at all."""
    from repro_torch.configs.registry import default_cache_backend, get_config
    from repro_torch.engine import Engine, Request
    from repro_torch.models.model import flat_block_types
    from repro_torch.models.ssm import dt_rank
    from repro_torch.runtime.steps import LAUNCH_COUNTERS

    cfg = get_config(arch)
    recurrent = default_cache_backend(cfg) == "recurrent"
    (prompt_lo, prompt_hi), max_new, preempt_after = (PROMPT_LO, PROMPT_HI), MAX_NEW, {}
    if cfg.xlstm is not None:
        geom = dict(slots=XL_SLOTS, max_len=MAX_LEN, chunk=XL_CHUNK)
        n_requests, (prompt_lo, prompt_hi), max_new = XL_REQUESTS, XL_PROMPT, XL_NEW
        preempt_after = XL_PREEMPT_AFTER
    elif recurrent:
        geom = dict(slots=REC_SLOTS, max_len=MAX_LEN, chunk=CHUNK)
        n_requests, preempt_after = REC_REQUESTS, REC_PREEMPT_AFTER
    else:
        geom = dict(slots=SLOTS, max_len=MAX_LEN, num_blocks=NUM_BLOCKS, block_size=BLOCK,
                    chunk=CHUNK)
        n_requests = N_REQUESTS
    torch.cuda.reset_peak_memory_stats()
    engine = Engine(cfg, device=dev, cache="auto", kernel="auto", placement=placement, **geom)
    t0 = time.perf_counter()
    engine.load_params(seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(engine.params))
    bts = flat_block_types(cfg)
    if cfg.xlstm is not None:
        x = cfg.xlstm
        shape = (f"{bts.count('mlstm')} mLSTM layers of inner "
                 f"{int(cfg.d_model * x.proj_factor_mlstm)} in {x.num_heads} heads, "
                 f"{bts.count('slstm')} sLSTM layers")
    elif recurrent:
        s = cfg.ssm
        shape = (f"inner {s.expand * cfg.d_model}, state {s.state_dim}, conv "
                 f"{s.conv_width}, dt_rank {dt_rank(cfg.d_model, s)}")
    else:
        a = cfg.attention
        shape = f"{a.num_heads}/{a.num_kv_heads} heads of {a.head_dim}"
        if cfg.moe:
            shape += (f", {cfg.moe.num_experts} experts top-{cfg.moe.top_k} of "
                      f"{cfg.moe.expert_ff}")
    log(f"[e2e] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, {shape}, "
        f"vocab {cfg.vocab_size}, {n_params} bf16 params drawn in "
        f"{time.perf_counter() - t0:.1f}s; cache={engine.cache_kind}, "
        f"kernels={engine.kernel}, slots {engine.slots}")
    if engine.kernel != "cuda" or engine.cache_kind != ("recurrent" if recurrent else "paged"):
        raise AssertionError(f"auto resolved to {engine.kernel!r} / "
                             f"{engine.cache_kind!r} on the card")
    # launches each kernel makes per step on this path (an xLSTM stack's
    # recurrences launch none)
    per_step = ({"ssm_scan": sum(bt == "ssm" for bt in bts)} if recurrent else
                {"paged_attention": cfg.num_layers,
                 "moe_jam": sum(bt.endswith("_moe") for bt in bts)})
    per_step = {k: n for k, n in per_step.items() if n}

    rng = np.random.default_rng(SEED)
    for rid in range(n_requests):
        n = int(rng.integers(prompt_lo, prompt_hi + 1))
        engine.submit(Request(rid, rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32),
                              max_new_tokens=max_new))

    records, events = [], []
    inner = engine.bundle.fn

    def recording(params, cache, *args):
        out = inner(params, cache, *args)
        records.append(tuple(a.clone() for a in args) + (out[0].clone(),))
        return out

    # the backend's slot events between steps, for the replay: a fresh
    # request's slot re-templated, a snapshot taken or restored
    state_init, state_evict = engine.state.init, engine.state.evict

    def init(entry, cache, slot):
        events.append((len(records), "init", slot, entry.req.rid, entry.snapshot is not None))
        return state_init(entry, cache, slot)

    def evict(entry, cache, slot):
        events.append((len(records), "evict", slot, entry.req.rid, None))
        return state_evict(entry, cache, slot)

    engine.bundle.fn = recording
    engine.state.init, engine.state.evict = init, evict
    forced = preempt_after if forced_preemption else {}
    step_s = []
    for counter in LAUNCH_COUNTERS.values():
        counter.reset()
    t0 = time.perf_counter()
    while engine.pending():
        steps_before = engine.steps
        t = time.perf_counter()
        engine.tick()
        if engine.steps > steps_before:
            step_s.append(time.perf_counter() - t)
        if engine.ticks in forced:
            _force_preemption(engine, forced[engine.ticks])
        if engine.ticks > 2000:
            raise AssertionError("engine did not drain in 2000 ticks")
    wall = time.perf_counter() - t0
    launches = {name: c.count for name, c in LAUNCH_COUNTERS.items()}
    engine.bundle.fn = inner
    engine.state.init, engine.state.evict = state_init, state_evict
    m = engine.metrics()
    tokens = sum(len(r.out_tokens) for r in engine.completed)
    summary = dict(arch=arch, requests=len(engine.completed), tokens=tokens, wall_s=wall,
                   tokens_per_s=tokens / wall, steps=engine.steps, ticks=engine.ticks,
                   step_p50_ms=float(np.median(step_s)) * 1e3,
                   step_p90_ms=float(np.percentile(step_s, 90)) * 1e3,
                   preemptions=m["preemptions"], launches=launches,
                   engine_launches=m["kernel_launches"],
                   nonfinite_logits=m["nonfinite_logits"],
                   placements=m["fabric"]["placements"], fabric_calls=m["fabric"]["calls"],
                   leases=m["fabric"]["leases"],
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if recurrent:
        summary.update({k: m[k] for k in ("snapshots_taken", "snapshots_restored",
                                          "state_bytes_per_slot")})
    else:
        summary.update(peak_used_blocks=m["peak_used_blocks"],
                       live_token_fraction_mean=m["live_token_fraction_mean"])
    log(f"[e2e] {json.dumps(summary)}")
    if len(engine.completed) != n_requests or any(
            len(r.out_tokens) != max_new for r in engine.completed):
        raise AssertionError("not every request completed with all its tokens")
    for name, n in launches.items():
        want = per_step.get(name, 0) * engine.steps
        if n != want or n != m["kernel_launches"].get(name, 0):
            raise AssertionError(f"{n} {name} launches (engine {m['kernel_launches']}) for "
                                 f"{engine.steps} steps of {per_step.get(name, 0)} layers "
                                 "that run it")
    if m["nonfinite_logits"]:
        raise AssertionError(f"{m['nonfinite_logits']} emitted rows had non-finite logits")
    step = f"engine.{engine.cache_kind}_step"
    if m["fabric"]["placements"] != {step: placement} or m["fabric"]["calls"] != {
            step: engine.steps}:
        raise AssertionError(f"the steps did not go through the fabric at {placement}: "
                             f"{m['fabric']}")
    if not recurrent and m["preemptions"] < 1:
        raise AssertionError("the pool did not force a preemption")
    if recurrent and m["preemptions"] != len(forced):
        raise AssertionError(f"{m['preemptions']} preemptions, {len(forced)} forced")
    if forced and min(m["snapshots_taken"], m["snapshots_restored"]) < len(forced):
        raise AssertionError("the forced preemptions did not snapshot and resume")
    return engine, records, events, summary


def _force_preemption(engine, phase):
    """Preempt the first running request (by slot), not preempted before,
    that is mid-prefill or in decode."""
    for entry in engine.slot_entry:
        if entry is None or entry.preemptions:
            continue
        prefill = entry.pos < len(entry.prompt_tokens)
        if prefill == (phase == "prefill"):
            log(f"[e2e] tick {engine.ticks}: preempting request {entry.req.rid} in "
                f"{phase} at position {entry.pos} of its {len(entry.prompt_tokens)}-token "
                f"prompt")
            engine.preempt(entry.req.rid)
            return
    raise AssertionError(f"no running request in {phase} after tick {engine.ticks}")


def replay(torch, dev, engine, records, events):
    """Replay the recorded step inputs through kernel="ref" on the card:
    greedy agreement per emitted-or-prefill row, and one mixed step's logits
    on identical inputs (``_mixed_step``). On the recurrent backend the
    replay also applies the engine's slot events between steps to its own
    cache: re-templating a fresh request's slot, and taking and restoring
    its own snapshots."""
    from repro_torch.models import model as model_lib
    from repro_torch.models.kvcache import gather_slot_rows, scatter_slot_rows
    from repro_torch.runtime.steps import make_paged_serve_step, make_recurrent_serve_step

    cfg = engine.cfg
    rule = LOGITS[cfg.name]
    recurrent = engine.cache_kind == "recurrent"
    if recurrent:
        ref_step = make_recurrent_serve_step(cfg, slots=engine.slots, chunk=CHUNK,
                                             kernel="ref", device=dev).fn
        cache = model_lib.init_recurrent_cache(cfg, engine.slots, device=dev)
        template = engine.state.template
    else:
        ref_step = make_paged_serve_step(
            cfg, slots=SLOTS, chunk=CHUNK, num_blocks=NUM_BLOCKS, block_size=BLOCK,
            max_blocks_per_seq=engine.max_blocks_per_seq, kernel="ref", device=dev).fn
        cache = model_lib.init_paged_cache(cfg, NUM_BLOCKS, BLOCK, device=dev)
    mixed = _mixed_index(records)
    agree = total = 0
    first = None
    logit = None
    snapshots = {}
    pending = list(events) if recurrent else []
    for i, (*args, want) in enumerate(records):
        while pending and pending[0][0] == i:
            _, kind, slot, rid, restored = pending.pop(0)
            if kind == "evict":
                snapshots[rid] = gather_slot_rows(cache, template, slot, engine.slots)
            else:
                row = snapshots.pop(rid) if restored else template
                cache = scatter_slot_rows(cache, row, slot, engine.slots)
        nv = args[-1]
        if i == mixed:
            logit = _mixed_step(torch, dev, engine, cache, i, args, rule)
        got, cache = ref_step(engine.params, cache, *args)
        rows = (nv > 0).nonzero().squeeze(1).tolist()
        g, w = got.tolist(), want.tolist()
        for r in rows:
            total += 1
            if g[r] == w[r]:
                agree += 1
            elif first is None:
                first = (i, r)
    log(f"[replay] {cfg.name} greedy agreement cuda vs ref on {len(records)} recorded "
        f"steps: {agree}/{total} rows ({agree / max(total, 1):.4f}); first divergence "
        f"(step, slot) = {first}")
    if logit is None or not logit["ok"]:
        raise AssertionError(f"logits disagree: {logit}")
    return dict(agree=agree, rows=total, first_divergence=first, logits=logit)


def _mixed_index(records):
    """The recorded step with prefill and decode rows that has the most
    valid rows (n_valid is each record's last input)."""
    return max(range(len(records)), key=lambda i: (
        int(((records[i][-2] > 1).sum() > 0) and ((records[i][-2] == 1).sum() > 0)),
        int(records[i][-2].sum())))


def _step_profile(torch, engine, records):
    """Device busy and idle time of one mixed prefill + decode step (the
    replay's, on a clone of the engine's final pool or recurrent state),
    and the device ms in it of the kernel that serves the path (paged
    attention, or ssm_scan on the recurrent backend): what the kernel costs
    on the path it serves."""
    i = _mixed_index(records)
    *args, _ = records[i]
    cache = {"layers": [{k: v.clone() for k, v in lc.items()} for lc in engine.cache["layers"]]}
    name, match = (("ssm_scan", "ssm_scan") if engine.cache_kind == "recurrent"
                   else ("paged attention", "paged_"))
    b = _busy(torch, lambda: engine.bundle.fn(engine.params, cache, *args), matches=(match,))
    nv = args[-1]
    idle = (f"idle {b['wall_ms'] - b['busy_ms']:.2f} ms (share "
            f"{1 - b['busy_ms'] / b['wall_ms']:.3f})" if b["busy_ms"] is not None
            else "device time not measured (the trace holds no device event)")
    kernel = (f"{name} {b['match_ms'][match]} ms in {b['match_ops'][match]} device operations "
              f"({engine.cfg.num_layers} layers)" if engine.kernel_launches
              else "no kernel of the port (the recurrences are plain PyTorch)")
    log(f"[e2e] {engine.cfg.name} one mixed step (step {i}, n_valid {nv.tolist()}): host wall "
        f"{b['wall_ms']:.2f} ms (median of 3, no profiler); device busy {b['busy_ms']} ms over "
        f"{b['device_ops']} device operations (torch.profiler); {idle}; {kernel}; most device "
        f"time (ms): {b['top']}")
    del cache
    return b


def _mixed_step(torch, dev, engine, cache, i, args, rule):
    """One step's logits on identical inputs (cloned cache) through the
    kernels and the plain versions in bf16, and for a ``vs_f32`` rule the
    plain versions in float32 (the recurrent cache's conv history cast to
    it); for an ``argmax_share`` rule (a stack with no kernel) the plain
    versions in bf16 and in float32 alone, whose greedy tokens must agree
    in that share of the valid rows, and the stack cut to its first layer
    within ``XL_FIRST_LAYER_TOL``. Returns the numbers and ``ok``."""
    from repro_torch.models import model as model_lib
    from repro_torch.models.kvcache import PagedLayout, RecurrentLayout

    if engine.cache_kind == "recurrent":
        tok, st, nv = args
        layout = dict(recurrent=RecurrentLayout(st, nv))
    else:
        tok, tab, st, nv = args
        layout = dict(paged=PagedLayout(tab, st, nv, BLOCK))
    runs = [("cuda", torch.bfloat16), ("ref", torch.bfloat16)]
    if "vs_f32" in rule:
        runs.append(("ref", torch.float32))
    if "argmax_share" in rule:
        runs = [("ref", torch.bfloat16), ("ref", torch.float32)]
    valid = torch.arange(tok.shape[1], device=dev)[None, :] < nv[:, None]
    outs = []
    for kind, dtype in runs:
        cast = dtype if engine.cache_kind == "recurrent" else None
        c = {"layers": [{k: v.to(cast or v.dtype, copy=True) if k == "conv"
                         else v.clone() for k, v in lc.items()} for lc in cache["layers"]]}
        with torch.no_grad():
            lg, _, _ = model_lib.forward(engine.cfg, engine.params, tok, cache=c,
                                         paged_kernel=kind, compute_dtype=dtype, **layout)
        outs.append(lg[valid])
        del c
    if not all(torch.isfinite(o).all() for o in outs):
        raise AssertionError(f"non-finite logits: {[bool(torch.isfinite(o).all()) for o in outs]}")
    rows = int(valid.sum())
    head = (f"[replay] step {i} (n_valid {nv.tolist()}), {rows} valid rows, max |logit| "
            f"{outs[1].abs().max().item():.3f}")
    if "argmax_share" in rule:
        err = (outs[0] - outs[1]).abs().amax(-1)
        out = dict(step=i, rows=rows, mean_err=err.mean().item(), max_err=err.max().item(),
                   argmax_equal=int((outs[0].argmax(-1) == outs[1].argmax(-1)).sum()),
                   first_layer=_first_layer_departure(torch, engine.cfg, engine.params, tok,
                                                      cache, layout, valid))
        out["ok"] = (out["argmax_equal"] >= rule["argmax_share"] * rows
                     and out["first_layer"] <= XL_FIRST_LAYER_TOL)
        log(f"{head}: row error max |logit_bf16 - logit_f32| mean {out['mean_err']:.4f}, max "
            f"{out['max_err']:.4f}; greedy tokens equal {out['argmax_equal']}/{rows} (at least "
            f"{rule['argmax_share']} of them required); the stack cut to its first layer "
            f"departs by {out['first_layer']:.5f} of the float32 logits' rms (at most "
            f"{XL_FIRST_LAYER_TOL} required)")
        return out
    if "atol" in rule:
        err = (outs[0] - outs[1]).abs().amax(-1)
        out = dict(step=i, rows=rows, max_err=err.max().item(),
                   agree=int((err <= rule["atol"]).sum()))
        out["ok"] = out["agree"] == rows
        log(f"{head}: max |logits cuda - ref| = {out['max_err']:.3e}; rows within atol "
            f"{rule['atol']}: {out['agree']}/{rows}")
        return out
    f32 = outs[2]
    err_c = (outs[0] - f32).abs().amax(-1)
    err_r = (outs[1] - f32).abs().amax(-1)
    out = dict(step=i, rows=rows,
               median_cuda=err_c.median().item(), median_ref=err_r.median().item(),
               mean_cuda=err_c.mean().item(), mean_ref=err_r.mean().item(),
               max_cuda=err_c.max().item(), max_ref=err_r.max().item(),
               max_cuda_vs_ref=(outs[0] - outs[1]).abs().max().item(),
               argmax_cuda=int((outs[0].argmax(-1) == f32.argmax(-1)).sum()),
               argmax_ref=int((outs[1].argmax(-1) == f32.argmax(-1)).sum()))
    k = rule["vs_f32"]
    out["ok"] = (out["median_cuda"] <= k * out["median_ref"]
                 and out["mean_cuda"] <= k * out["mean_ref"])
    log(f"{head}: row error max |logit - logit_f32| of the kernels' bf16 path: median "
        f"{out['median_cuda']:.4f}, mean {out['mean_cuda']:.4f}, max {out['max_cuda']:.4f}; "
        f"of the plain bf16 path: median {out['median_ref']:.4f}, mean "
        f"{out['mean_ref']:.4f}, max {out['max_ref']:.4f} (kernel path within {k}x of it "
        f"required); argmax equal to float32's: {out['argmax_cuda']}/{rows} kernels, "
        f"{out['argmax_ref']}/{rows} plain; max |cuda - ref| {out['max_cuda_vs_ref']:.4f}")
    return out


def _first_layer_departure(torch, cfg, params, tok, cache, layout, valid):
    """``cfg``'s stack cut to its first layer, in bf16 and in float32 on the
    same bf16 weights, inputs and first-layer state (``cache``, or None
    for no cache): the mean over the ``valid`` rows of the row's largest
    |logit_bf16 - logit_f32|, over the float32 logits' rms."""
    import dataclasses

    from repro_torch.models import model as model_lib

    one = dataclasses.replace(cfg, num_layers=1)
    cut = dict(params, layers=params["layers"][:1])
    outs = []
    for dtype in (torch.bfloat16, torch.float32):
        c = None if cache is None else {"layers": [
            {k: v.to(dtype, copy=True) if k == "conv" else v.clone()
             for k, v in cache["layers"][0].items()}]}
        with torch.no_grad():
            lg = model_lib.forward(one, cut, tok, cache=c, paged_kernel="ref",
                                   compute_dtype=dtype, **layout)[0]
        outs.append(lg[valid])
        del c, lg
    if not all(torch.isfinite(o).all() for o in outs):
        raise AssertionError("non-finite logits from the first layer")
    err = (outs[0] - outs[1]).abs().amax(-1).mean()
    return (err / outs[1].pow(2).mean().sqrt()).item()


def _check_exact_without_preemption(torch, dev, arch, engine):
    """The recurrent backend's exactness contract: the same requests served
    again without the forced preemptions (other slots, other steps), and at
    ``placement="injected"``, emit identical tokens; the step's params
    lease is acquired every step, one miss (the injection) and then hits."""
    again, _, _, summary = serve(torch, dev, arch, forced_preemption=False,
                                 placement="injected")
    lease = summary["leases"][f"engine.{again.cache_kind}_step.params"]
    log(f"[e2e] {arch} at placement=injected: params lease {lease['misses']} miss(es), "
        f"{lease['hits']} hits over {again.steps} steps ({again.ticks} ticks)")
    if (lease["misses"], lease["hits"]) != (1, again.steps - 1):
        raise AssertionError(f"the params lease did not count 1 miss and "
                             f"{again.steps - 1} hits: {lease}")
    want = {r.rid: r.out_tokens for r in engine.completed}
    got = {r.rid: r.out_tokens for r in again.completed}
    differ = sorted(rid for rid in want if got.get(rid) != want[rid])
    log(f"[e2e] {arch}: a second run without the forced preemptions, at placement="
        f"injected ({summary['preemptions']} preemptions, {summary['steps']} steps) emits "
        f"identical tokens for {len(want) - len(differ)}/{len(want)} requests"
        + (f"; first differing request {differ[0]}: {want[differ[0]][:8]} vs "
           f"{got[differ[0]][:8]}" if differ else ""))
    if differ:
        raise AssertionError(f"requests {differ} differ without the forced preemptions")
    del again
    gc.collect()


def slots_requests(cfg):
    """16 FIFO requests from numpy seed ``SEED``: even rids long prompts,
    odd rids short ones, ``MAX_NEW`` new tokens each."""
    rng = np.random.default_rng(SEED)
    prompts = []
    for rid in range(SLOTS_REQUESTS):
        lo, hi = LONG_PROMPT if rid % 2 == 0 else SHORT_PROMPT
        n = int(rng.integers(lo, hi + 1))
        prompts.append(rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32))
    return prompts


def serve_slots(torch, dev, engine, prompts):
    """Serve ``prompts`` on the slots ``engine``, timing each prefill and
    decode step (synchronized) around the steps' functions; returns the
    summary (launches read around exactly this run)."""
    from repro_torch.engine import Request
    from repro_torch.runtime.steps import LAUNCH_COUNTERS

    for rid, p in enumerate(prompts):
        engine.submit(Request(rid, p, max_new_tokens=MAX_NEW))
    prefill_ms, decode_ms = {}, []
    prefill, decode = engine.prefill_bundle.fn, engine.bundle.fn

    def timed(fn, into):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            into((time.perf_counter() - t) * 1e3, args)
            return out
        return run

    engine.prefill_bundle.fn = timed(prefill, lambda ms, a: prefill_ms.setdefault(
        a[1].shape[1], []).append(ms))
    engine.bundle.fn = timed(decode, lambda ms, a: decode_ms.append(ms))
    for counter in LAUNCH_COUNTERS.values():
        counter.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c.count for name, c in LAUNCH_COUNTERS.items()}
    engine.prefill_bundle.fn, engine.bundle.fn = prefill, decode
    m = engine.metrics()
    tokens = sum(len(r.out_tokens) for r in engine.completed)
    long_ms = [t for n, ts in prefill_ms.items() for t in ts if n > LONG_PROMPT[0] - 1]
    short_ms = [t for n, ts in prefill_ms.items() for t in ts if n <= SHORT_PROMPT[1]]
    return dict(arch=engine.cfg.name, kernel=engine.kernel, requests=len(engine.completed),
                tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall, ticks=engine.ticks,
                prefills=sum(len(ts) for ts in prefill_ms.values()), prefill_ms=prefill_ms,
                prefill_long_ms_median=float(np.median(long_ms)),
                prefill_short_ms_median=float(np.median(short_ms)),
                prefill_total_ms=float(sum(long_ms) + sum(short_ms)),
                decode_steps=len(decode_ms), decode_p50_ms=float(np.median(decode_ms)),
                decode_p90_ms=float(np.percentile(decode_ms, 90)),
                decode_total_ms=float(sum(decode_ms)), shared_length=engine.cache["length"],
                launches=launches, engine_launches=m["kernel_launches"],
                nonfinite_logits=m["nonfinite_logits"], fabric_calls=m["fabric"]["calls"],
                placements=m["fabric"]["placements"],
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def slots_path(torch, dev, card, arch, cfg=None):
    """Phases 7-10 and 13: ``arch`` (its registered config, or ``cfg``) on
    the slots engine through the kernels, again through the plain
    versions, and one long prefill's logits against float32 (for a vision
    arch also one prefill with an image spliced in); returns each kernel's
    launches on the main path. gemma3-4b and mamba-130m take
    ``cache="slots"`` (their default backends are the paged pool and the
    recurrent one), deepseek-v2-lite-16b, hymba-1.5b and qwen2-vl-72b
    ``cache="auto"``, which must resolve to slots. Flash attention must
    launch once per attention layer per long prompt, the selective scan
    once per SSM (or hybrid) layer per prefill and per decode tick, and for
    a MoE stack moe_jam once per MoE layer per prefill and per decode tick;
    no other kernel."""
    from repro_torch.configs.registry import default_cache_backend, get_config
    from repro_torch.engine import Engine
    from repro_torch.models import attention
    from repro_torch.models.model import flat_block_types

    cfg = cfg or get_config(arch)
    cache = "auto" if default_cache_backend(cfg) == "slots" else "slots"
    prompts = slots_requests(cfg)
    n_long = sum(attention._use_chunked(len(p), len(p)) for p in prompts)
    engine = Engine(cfg, device=dev, cache=cache, kernel="auto", slots=SLOTS_SLOTS,
                    max_len=SLOTS_MAX_LEN)
    t0 = time.perf_counter()
    engine.load_params(seed=SEED)
    torch.cuda.synchronize()
    params = engine.params
    n_params = sum(p.numel() for p in _leaves(params))
    cache_gb = sum(t.numel() * t.element_size() for t in _leaves(engine.cache["layers"])) / 1e9
    a = cfg.attention
    types = flat_block_types(cfg)
    n_local = sum(bt.endswith("_local") for bt in types)
    n_attn = sum(bt.startswith(("attn", "mla", "hybrid")) for bt in types)
    n_ssm = sum(bt == "ssm" or bt.startswith("hybrid") for bt in types)
    n_moe = sum(bt.endswith("_moe") for bt in types)
    if a is None:
        heads = f"SSM inner {cfg.ssm.expand * cfg.d_model}, state {cfg.ssm.state_dim}"
    elif a.kind == "mla":
        heads = (f"MLA: {a.num_heads} heads, q/k {a.qk_nope_head_dim} + {a.qk_rope_head_dim}, "
                 f"v {a.v_head_dim}, kv_lora_rank {a.kv_lora_rank}; {n_moe} MoE layers of "
                 f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} + {cfg.moe.num_shared} "
                 f"shared of {cfg.moe.expert_ff}")
    else:
        heads = f"{a.num_heads}/{a.num_kv_heads} heads of {a.head_dim}"
        if n_local:
            heads = f"{n_local} with window {a.sliding_window}, {heads}"
        if a.mrope:
            heads += f", M-RoPE sections {a.mrope_sections} (theta {a.rope_theta:g})"
        if n_ssm:
            heads += (f", beside an SSM of inner {cfg.ssm.expand * cfg.d_model}, state "
                      f"{cfg.ssm.state_dim} in every layer")
    log(f"[slots] {cfg.name}: {cfg.num_layers} layers ({heads}), d_model {cfg.d_model}, "
        f"vocab {cfg.vocab_size}, {n_params} bf16 params drawn in "
        f"{time.perf_counter() - t0:.1f}s; cache={cache} -> {engine.cache_kind} "
        f"({cache_gb:.3f} GB), kernel={engine.kernel}, {engine.slots} slots of "
        f"{engine.max_len}; prompts {[len(p) for p in prompts]} ({n_long} past the threshold)")
    if engine.kernel != "cuda" or engine.cache_kind != "slots":
        raise AssertionError(f"auto resolved to {engine.kernel!r}, cache "
                             f"{engine.cache_kind!r} on the card")
    summary = serve_slots(torch, dev, engine, prompts)
    log(f"[slots] {json.dumps(summary)}")
    if summary["requests"] != len(prompts) or any(
            len(r.out_tokens) != MAX_NEW for r in engine.completed):
        raise AssertionError("not every request completed with all its tokens")
    want = {}
    if n_attn:
        want["flash_attention"] = n_attn * n_long
    if n_ssm:
        want["ssm_scan"] = n_ssm * (len(prompts) + engine.ticks)
    if n_moe:
        want["moe_jam"] = n_moe * (len(prompts) + engine.ticks)
    if summary["engine_launches"] != want or any(
            n != want.get(k, 0) for k, n in summary["launches"].items()):
        raise AssertionError(f"launches {summary['launches']} (engine "
                             f"{summary['engine_launches']}), want {want}: {n_long} long "
                             f"prompts, {n_attn} attention, {n_ssm} SSM and {n_moe} MoE "
                             f"layers, {len(prompts)} prefills, {engine.ticks} decode ticks")
    if summary["nonfinite_logits"] or summary["fabric_calls"] != {
            "engine.prefill": len(prompts), "engine.decode": engine.ticks}:
        raise AssertionError(f"non-finite logits or fabric calls off: {summary}")
    tokens = {r.rid: r.out_tokens for r in engine.completed}
    schedule = (list(engine.admission_log), engine.ticks, engine.cache["length"])
    step_tokens = torch.zeros((engine.slots, 1), dtype=torch.int32, device=dev)
    long_prompt = torch.from_numpy(prompts[0][None]).to(dev)
    # device operations by name: the flash kernel, the scan kernel, or
    # moe_jam's two passes and the MoE dispatch's cumulative sum (a scan)
    matches = ("flash_wgmma", "moe_stream", "scan") if n_moe else ("flash_wgmma", "ssm_scan")
    for what, fn in (("decode step", lambda: engine.bundle.fn(params, engine.cache, step_tokens)),
                     (f"prefill of {len(prompts[0])} tokens",
                      lambda: engine.prefill_bundle.fn(params, long_prompt))):
        b = _busy(torch, fn, matches=matches)
        idle = (f"idle share {1 - b['busy_ms'] / b['wall_ms']:.3f}" if b["busy_ms"] is not None
                else "device time not measured (the trace holds no device event)")
        log(f"[slots] {cfg.name} one {what}: host wall {b['wall_ms']:.2f} ms (median of 3, no "
            f"profiler); device busy {b['busy_ms']} ms over {b['device_ops']} device "
            f"operations (torch.profiler); {idle}; device ms (operations) of "
            + ", ".join(f"{m!r} {b['match_ms'][m]} ({b['match_ops'][m]})" for m in matches)
            + f"; most device time (ms): {b['top']}")
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    ref = Engine(cfg, device=dev, cache=cache, kernel="ref", slots=SLOTS_SLOTS,
                 max_len=SLOTS_MAX_LEN)
    ref.load_params(params)
    ref_summary = serve_slots(torch, dev, ref, prompts)
    if (list(ref.admission_log), ref.ticks, ref.cache["length"]) != schedule:
        raise AssertionError("the plain path's schedule differs")
    if any(ref_summary["launches"].values()):
        raise AssertionError(f"kernel='ref' launched kernels: {ref_summary['launches']}")
    agree = sum(t == u for r in ref.completed for t, u in zip(r.out_tokens, tokens[r.rid]))
    same = sum(r.out_tokens == tokens[r.rid] for r in ref.completed)
    first = sum(r.out_tokens[0] == tokens[r.rid][0] for r in ref.completed)
    log(f"[slots] replay through kernel='ref' (identical schedule, {ref.ticks} ticks): greedy "
        f"agreement {agree}/{SLOTS_REQUESTS * MAX_NEW} tokens, {same}/{SLOTS_REQUESTS} requests "
        f"identical, first tokens {first}/{SLOTS_REQUESTS}; plain path {ref_summary['tokens_per_s']:.1f} "
        f"tokens/s, long prefill median {ref_summary['prefill_long_ms_median']:.1f} ms, peak "
        f"{ref_summary['peak_mem_gb']:.2f} GB")
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    logits = _slots_logits(torch, dev, cfg, params, prompts[0], n_attn, n_ssm)
    if cfg.frontend.kind == "vision_patches":
        _vision_prefill(torch, dev, cfg, params, prompts[0], n_attn, n_ssm,
                        logits["f32_last"])
    log(f"[slots] {cfg.name} peak allocated over the float32 controls "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[e2e] {cfg.name} (slots): {summary['tokens']} tokens in {summary['wall_s']:.2f}s = "
        f"{summary['tokens_per_s']:.1f} tokens/s; prefill median {summary['prefill_long_ms_median']:.1f}"
        f" ms long, {summary['prefill_short_ms_median']:.1f} ms short ({summary['prefill_total_ms']:.0f}"
        f" ms of prefill, {summary['decode_total_ms']:.0f} ms of decode); decode step p50 "
        f"{summary['decode_p50_ms']:.2f} ms, p90 {summary['decode_p90_ms']:.2f} ms; flash "
        f"{logits['flash_ms']:.1f} and ssm_scan {logits['scan_ms']:.1f} of a "
        f"{logits['prefill_ms']:.1f} ms prefill of {len(prompts[0])} tokens (CUDA events); peak "
        f"{summary['peak_mem_gb']:.2f} GB; greedy agreement {agree}/{SLOTS_REQUESTS * MAX_NEW} "
        f"on {card}")
    return summary["launches"]


def xlstm_slots(torch, dev, card):
    """Phase 12: xlstm-1.3b on the slots backend (``cache="slots"``; its
    default is recurrent) at full width and depth, 8 slots of 4,224, the
    first ``XL_SLOTS_REQUESTS`` of the slots traffic. Each prefill's length,
    mLSTM chunk length (the JAX package's rule; "scan" under 2 x chunk) and
    ms; no kernel may launch; the 3,800-token prefill's last-position
    logits in bf16 against the same prefill in float32 (finite; the numbers
    are reported), and the same prefill through the stack cut to its first
    layer (the chunk-parallel mLSTM) within ``XL_FIRST_LAYER_TOL``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.engine import Engine
    from repro_torch.models.xlstm import mlstm_chunk_len
    from repro_torch.runtime.steps import make_prefill_step

    cfg = get_config(XL_ARCH)
    prompts = slots_requests(cfg)[:XL_SLOTS_REQUESTS]
    engine = Engine(cfg, device=dev, cache="slots", kernel="auto", slots=SLOTS_SLOTS,
                    max_len=SLOTS_MAX_LEN)
    t0 = time.perf_counter()
    engine.load_params(seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(engine.params))
    state_gb = sum(t.numel() * t.element_size() for t in _leaves(engine.cache["layers"])) / 1e9
    log(f"[slots] {cfg.name}: {cfg.num_layers} layers, {n_params} bf16 params drawn in "
        f"{time.perf_counter() - t0:.1f}s; cache=slots, {engine.slots} slots ({state_gb:.3f} GB "
        f"of state), kernels {engine.kernel_launches}; prompts {[len(p) for p in prompts]}")
    if engine.cache_kind != "slots" or engine.kernel_launches:
        raise AssertionError(f"cache {engine.cache_kind!r}, kernels {engine.kernel_launches}")
    summary = serve_slots(torch, dev, engine, prompts)
    chunk = cfg.xlstm.chunk
    for n in sorted({len(p) for p in prompts}, reverse=True):
        how = f"chunks of {mlstm_chunk_len(n, chunk)}" if n >= 2 * chunk else "the scan"
        log(f"[slots] {cfg.name} prefill of {n} tokens ({how}): "
            f"{', '.join(f'{t:.1f}' for t in summary['prefill_ms'][n])} ms")
    log(f"[slots] {json.dumps({k: v for k, v in summary.items() if k != 'prefill_ms'})}")
    if summary["requests"] != len(prompts) or any(
            len(r.out_tokens) != MAX_NEW for r in engine.completed):
        raise AssertionError("not every request completed with all its tokens")
    if any(summary["launches"].values()) or summary["nonfinite_logits"]:
        raise AssertionError(f"launches {summary['launches']} or non-finite logits "
                             f"({summary['nonfinite_logits']})")
    params = engine.params
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    long_prompt = max(prompts, key=len)
    tokens = torch.from_numpy(long_prompt[None]).to(dev)
    last = {}
    for dtype in (torch.bfloat16, torch.float32):
        step = make_prefill_step(cfg, max_len=len(long_prompt), kernel="auto", device=dev,
                                 compute_dtype=dtype)
        last[dtype] = step.fn(params, tokens)[0][0].float()
    err = (last[torch.bfloat16] - last[torch.float32]).abs()
    argmax = [int(last[d].argmax()) for d in last]
    log(f"[slots] {cfg.name} prefill of {len(long_prompt)} tokens, last-position logits bf16 "
        f"against float32 (same bf16 weights): mean |diff| {err.mean().item():.5f}, max "
        f"{err.max().item():.5f}, max |logit| {last[torch.float32].abs().max().item():.3f}; "
        f"argmax bf16/f32 {argmax}")
    if not all(torch.isfinite(t).all() for t in last.values()):
        raise AssertionError("non-finite logits in the long prefill")
    first = _first_layer_departure(torch, cfg, params, tokens, None, {},
                                   torch.ones_like(tokens, dtype=torch.bool))
    log(f"[slots] {cfg.name} prefill of {len(long_prompt)} tokens through the stack cut to "
        f"its first layer (chunks of {mlstm_chunk_len(len(long_prompt), chunk)}): departs by "
        f"{first:.5f} of the float32 logits' rms (at most {XL_FIRST_LAYER_TOL} required)")
    if not first <= XL_FIRST_LAYER_TOL:
        raise AssertionError(f"the first layer's bf16 logits depart by {first:.5f}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[e2e] {cfg.name} (slots): {summary['tokens']} tokens in {summary['wall_s']:.2f}s = "
        f"{summary['tokens_per_s']:.1f} tokens/s; {summary['prefill_total_ms']:.0f} ms of "
        f"prefill, decode step p50 {summary['decode_p50_ms']:.2f} ms, p90 "
        f"{summary['decode_p90_ms']:.2f} ms over {summary['decode_steps']} ticks; peak "
        f"{summary['peak_mem_gb']:.2f} GB on {card}")


def encoder_path(torch, dev, card):
    """Phase 14: hubert-xlarge at full width and depth through the prefill
    step, its entry point (every Engine refuses an encoder, as the JAX one
    does), random bf16 weights from seed ``SEED``. Each batch of
    ``HUBERT_BATCHES`` (frame features (B, T, 512) float32 from numpy seed
    ``SEED``) runs once to warm, then once with every launch count set to
    0 just before and read just after: flash (without the causal mask)
    must launch once a layer on a batch past the chunking threshold and
    never on one under it, and no other kernel may launch; frames/s, one
    more call profiled (device busy and idle, flash's device ms); every
    frame's logits through the kernel and through the plain version, each
    against the plain version in float32 on the same bf16 weights: the
    kernel path's mean and rms |logit - logit_f32| over every frame within
    ``SLOTS_VS_F32`` of the plain path's. Returns flash's launches on the
    batches, by (clips, frames)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import attention
    from repro_torch.models import model as model_lib
    from repro_torch.runtime.steps import LAUNCH_COUNTERS, make_prefill_step

    cfg = get_config(HUBERT_ARCH)
    a = cfg.attention
    t0 = time.perf_counter()
    params = model_lib.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev,
                                   dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"[encoder] {cfg.name}: {cfg.num_layers} layers, {a.num_heads}/{a.num_kv_heads} heads "
        f"of {a.head_dim} (causal {not cfg.is_encoder}), d_model {cfg.d_model}, d_ff "
        f"{cfg.d_ff} ({cfg.act}), features {cfg.frontend.feature_dim}, vocab "
        f"{cfg.vocab_size}; {sum(t.numel() for t in _leaves(params))} bf16 params drawn in "
        f"{time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(SEED)
    launches = {}
    for B, T in HUBERT_BATCHES:
        feats = torch.from_numpy(rng.standard_normal((B, T, cfg.frontend.feature_dim),
                                                     dtype=np.float32)).to(dev)
        tokens = torch.zeros((B, T), dtype=torch.int32, device=dev)
        steps = {name: make_prefill_step(cfg, max_len=T, kernel=kernel, device=dev,
                                         compute_dtype=dtype)
                 for name, kernel, dtype in (("cuda", "auto", torch.bfloat16),
                                             ("ref", "ref", torch.bfloat16),
                                             ("f32", "ref", torch.float32))}
        if steps["cuda"].meta["kernel"] != "cuda":
            raise AssertionError(f"auto resolved to {steps['cuda'].meta['kernel']!r} on the card")
        run = lambda name: steps[name].fn(params, tokens, feats)     # noqa: E731
        run("cuda")                                                # warm
        torch.cuda.synchronize()
        for counter in LAUNCH_COUNTERS.values():
            counter.reset()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        logits, cache = run("cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = {name: c.count for name, c in LAUNCH_COUNTERS.items()}
        peak = torch.cuda.max_memory_allocated() / 1e9
        long = attention._use_chunked(T, T)
        want = {"flash_attention": cfg.num_layers if long else 0}
        if cache is not None or tuple(logits.shape) != (B, T, cfg.vocab_size) or any(
                n != want.get(k, 0) for k, n in got.items()):
            raise AssertionError(f"{B} x {T}: launches {got} (want {want}), cache "
                                 f"{type(cache).__name__}, logits {tuple(logits.shape)}")
        launches[(B, T)] = got["flash_attention"]
        b = _busy(torch, lambda: run("cuda"), matches=("flash",))
        outs = {"cuda": logits.float(), "ref": run("ref")[0].float(), "f32": run("f32")[0]}
        if not all(torch.isfinite(o).all() for o in outs.values()):
            raise AssertionError(f"non-finite logits on the {B} x {T} batch")
        err = {k: (outs[k] - outs["f32"]).abs() for k in ("cuda", "ref")}
        st = {k: dict(mean=e.mean().item(), rms=e.pow(2).mean().sqrt().item(), max=e.max().item())
              for k, e in err.items()}
        ok = all(st["cuda"][m] <= SLOTS_VS_F32 * st["ref"][m] for m in ("mean", "rms"))
        agree = [int((outs[k].argmax(-1) == outs["f32"].argmax(-1)).sum()) for k in ("cuda", "ref")]
        idle = (f"idle share {1 - b['busy_ms'] / b['wall_ms']:.3f}" if b["busy_ms"] is not None
                else "device time not measured (the trace holds no device event)")
        log(f"[encoder] {cfg.name} {B} clips x {T} frames ({'flash' if long else 'plain _sdpa'}"
            f"): {wall * 1e3:.1f} ms = {B * T / wall:.0f} frames/s; launches {got}; peak "
            f"{peak:.2f} GB; host wall {b['wall_ms']:.2f} ms (median of 3), device busy "
            f"{b['busy_ms']} ms over {b['device_ops']} operations, {idle}; flash "
            f"{b['match_ms']['flash']} ms over {b['match_ops']['flash']} launches; most device "
            f"time (ms): {b['top']}")
        log(f"[encoder] {cfg.name} {B} x {T}, every frame's logits (max |logit| "
            f"{outs['f32'].abs().max().item():.3f}) against the float32 plain pass: kernel path "
            f"mean {st['cuda']['mean']:.5f}, rms {st['cuda']['rms']:.5f}, max "
            f"{st['cuda']['max']:.5f}; plain path mean {st['ref']['mean']:.5f}, rms "
            f"{st['ref']['rms']:.5f}, max {st['ref']['max']:.5f} (kernel path within "
            f"{SLOTS_VS_F32}x of it required); argmax equal to float32's in {agree[0]} / "
            f"{agree[1]} of {B * T} frames; on {card}")
        if not ok:
            raise AssertionError(f"the kernel path is further from float32 than the plain "
                                 f"path on the {B} x {T} batch: {st}")
        del feats, tokens, steps, logits, outs, err
        gc.collect()
        torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _busy(torch, fn, repeats: int = 3, matches=()):
    """Host wall ms of one synchronized call of ``fn`` (the median of
    ``repeats``, no profiler) and the card's busy ms in one more call traced
    by ``torch.profiler``: the summed durations of the kernels, copies and
    fills it ran (one stream, so they do not overlap; None when the trace
    holds no device event), the six device operations that took most of
    it, by name, and for each of ``matches`` the ms and count of those whose
    name holds it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in ops) / 1e3 if ops else None
    by_name = {}
    for e in ops:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    hits = {m: [e for e in ops if m in e.name] for m in matches}
    return dict(wall_ms=float(np.median(walls)), busy_ms=busy, device_ops=len(ops),
                top=[(name[:60], round(ms, 3)) for name, ms in top],
                match_ms={m: sum(e.time_range.elapsed_us() for e in h) / 1e3 if ops else None
                          for m, h in hits.items()},
                match_ops={m: len(h) for m, h in hits.items()})


def _vision_prefill(torch, dev, cfg, params, prompt, n_attn, n_ssm, text_f32):
    """Phase 13's vision prefill: ``cfg.frontend.num_patch_tokens`` patch
    embeddings (numpy seed ``SEED``, standard normals at the rms of the
    scaled text embeddings, d_model**0.5 / vocab**0.5) over the first
    positions of ``prompt``, the image at 3-D positions (t 0, h and w over
    ``QWEN_GRID``), the text after it at one position in all three streams
    counting on from the grid's side; held to ``_slots_logits``' rule, and
    its float32 logits must differ from the text-only prefill's
    (``text_f32``)."""
    h, w = QWEN_GRID
    n_img, seq = cfg.frontend.num_patch_tokens, len(prompt)
    if h * w != n_img:
        raise AssertionError(f"the grid {QWEN_GRID} does not hold {n_img} patches")
    rng = np.random.default_rng(SEED)
    feats = rng.standard_normal((1, n_img, cfg.d_model), dtype=np.float32)
    feats *= (cfg.d_model / cfg.vocab_size) ** 0.5
    pos = np.empty((3, 1, seq), np.int32)
    pos[0, 0, :n_img] = 0
    pos[1, 0, :n_img] = np.arange(n_img) // w
    pos[2, 0, :n_img] = np.arange(n_img) % w
    pos[:, 0, n_img:] = max(h, w) + np.arange(seq - n_img)
    extra = (torch.from_numpy(feats).to(dev), torch.from_numpy(pos).to(dev))
    out = _slots_logits(torch, dev, cfg, params, prompt, n_attn, n_ssm, extra=extra,
                        what=f"vision prefill ({n_img} patches over a {h} x {w} grid)")
    shift = (out["f32_last"] - text_f32).abs().max().item()
    log(f"[slots] {cfg.name} vision prefill: the image moves the last-position float32 "
        f"logits by up to {shift:.5f} against the text-only prefill")
    if not shift > 0:
        raise AssertionError("the image did not reach the logits")
    return out


def _slots_logits(torch, dev, cfg, params, prompt, n_attn, n_ssm, extra=(),
                  what="one long prefill"):
    """One long prefill's logits through the kernels (bf16), the plain
    versions (bf16) and the plain versions in float32 (the same bf16
    weights): the kernel path must be as close to float32 as the plain
    path (``SLOTS_VS_F32``), at the last position (the engine's prefill
    step, given ``extra``: a vision arch's patch embeddings and 3-D
    positions), or for a MoE stack over every position (the same forward
    with the head on every position), where it also counts the (token,
    layer) pairs whose top-k experts differ from float32's on each path,
    and its rows with no such change must be as close too. Also times the
    flash and scan launches inside the kernel path's prefill with CUDA
    events: ``n_attn`` and ``n_ssm`` of them."""
    from repro_torch.models import attention, moe, ssm
    from repro_torch.models import model as model_lib
    from repro_torch.runtime.steps import make_prefill_step

    rows_rule = cfg.moe is not None
    tokens = torch.from_numpy(prompt[None]).to(dev)

    def every_position(kernel, dtype):
        @torch.no_grad()
        def fn(p, t):
            cache = model_lib.init_cache(cfg, 1, len(prompt), dtype=dtype, device=dev)
            return model_lib.forward(cfg, p, t, cache=cache, paged_kernel=kernel,
                                     compute_dtype=dtype)[0][0]
        return fn
    inner, flash_events = attention.flash_attention, []
    scan, scan_events = ssm.ssm_scan, []

    def timed(fn, events):
        def run(*args, **kw):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*args, **kw)
            ev[1].record()
            events.append(ev)
            return out
        return run

    route, routes = moe.route_topk, []

    def recorded_route(*args):
        r = route(*args)
        routes.append(torch.sort(r.expert_ids, dim=-1).values)
        return r

    outs, experts = {}, {}
    for name, kernel, dtype in (("cuda", "cuda", torch.bfloat16), ("ref", "ref", torch.bfloat16),
                                ("f32", "ref", torch.float32)):
        if rows_rule:
            run = every_position(kernel, dtype)
        else:
            step = make_prefill_step(cfg, max_len=len(prompt), kernel=kernel, device=dev,
                                     compute_dtype=dtype)
            run = lambda p, t, step=step: step.fn(p, t, *extra)[0]   # (1, V): the last position
        if name == "cuda":
            attention.flash_attention = timed(inner, flash_events)
            ssm.ssm_scan = timed(scan, scan_events)
        try:
            run(params, tokens)                     # warm
            flash_events.clear()
            scan_events.clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            outs[name] = run(params, tokens).float()
            torch.cuda.synchronize()
            if name == "cuda":
                prefill_ms = (time.perf_counter() - t) * 1e3
                flash_ms = sum(s.elapsed_time(e) for s, e in flash_events)
                scan_ms = sum(s.elapsed_time(e) for s, e in scan_events)
                n_flash, n_scan = len(flash_events), len(scan_events)
                attention.flash_attention, ssm.ssm_scan = inner, scan
            if rows_rule:                           # the same forward once more, routes kept
                routes.clear()
                moe.route_topk = recorded_route
                run(params, tokens)
                experts[name] = torch.stack(routes)          # (MoE layers, tokens, k)
        finally:
            attention.flash_attention, ssm.ssm_scan = inner, scan
            moe.route_topk = route
    f32 = outs["f32"][-1]
    err = {k: (outs[k][-1] - f32).abs() for k in ("cuda", "ref")}
    out = dict(prompt=len(prompt), f32_last=f32, prefill_ms=prefill_ms, flash_ms=flash_ms,
               flash_calls=n_flash,
               scan_ms=scan_ms, scan_calls=n_scan,
               **{f"{s}_{k}": v for k in ("cuda", "ref") for s, v in (
                   ("mean", err[k].mean().item()), ("rms", err[k].pow(2).mean().sqrt().item()),
                   ("max", err[k].max().item()))},
               argmax=[int(outs[k][-1].argmax()) for k in ("cuda", "ref", "f32")],
               max_cuda_vs_ref=(outs["cuda"][-1] - outs["ref"][-1]).abs().max().item())
    k = SLOTS_VS_F32
    if rows_rule:
        rows = {n: (outs[n] - outs["f32"]).abs().amax(-1) for n in ("cuda", "ref")}
        out.update({f"rows_{s}_{n}": v for n in ("cuda", "ref") for s, v in (
            ("mean", rows[n].mean().item()), ("median", rows[n].median().item()))})
        out["rows_argmax_equal"] = [int((outs[n].argmax(-1) == outs["f32"].argmax(-1)).sum())
                                    for n in ("cuda", "ref")]
        flips = {n: (experts[n] != experts["f32"]).any(-1) for n in ("cuda", "ref")}
        out["route_flip_share"] = [flips[n].float().mean().item() for n in ("cuda", "ref")]
        out["last_token_flipped_layers"] = [int(flips[n][:, -1].sum()) for n in ("cuda", "ref")]
        steady = {n: ~flips[n].any(0) for n in ("cuda", "ref")}
        out["rows_unflipped"] = [int(steady[n].sum()) for n in ("cuda", "ref")]
        out["rows_unflipped_mean"] = [rows[n][steady[n]].mean().item() for n in ("cuda", "ref")]
        out["ok"] = (out["rows_mean_cuda"] <= k * out["rows_mean_ref"]
                     and out["rows_median_cuda"] <= k * out["rows_median_ref"]
                     and out["rows_unflipped_mean"][0] <= k * out["rows_unflipped_mean"][1])
        rule = (f"; over all {len(prompt)} positions, row error max |logit - logit_f32|: "
                f"kernel path mean {out['rows_mean_cuda']:.5f}, median "
                f"{out['rows_median_cuda']:.5f}; plain path mean {out['rows_mean_ref']:.5f}, "
                f"median {out['rows_median_ref']:.5f} (kernel path within {k}x of it "
                f"required); argmax equal to float32's {out['rows_argmax_equal'][0]} kernels, "
                f"{out['rows_argmax_equal'][1]} plain; (token, layer) pairs whose top-"
                f"{cfg.moe.top_k} experts differ from float32's: {out['route_flip_share'][0]:.4f} "
                f"kernels, {out['route_flip_share'][1]:.4f} plain; of the last token's "
                f"{experts['f32'].shape[0]} MoE layers {out['last_token_flipped_layers'][0]} "
                f"kernels, {out['last_token_flipped_layers'][1]} plain; rows with no such "
                f"change {out['rows_unflipped'][0]} / {out['rows_unflipped'][1]}, their mean row "
                f"error {out['rows_unflipped_mean'][0]:.5f} / {out['rows_unflipped_mean'][1]:.5f} "
                f"(kernel path within {k}x of it required)")
        where = "logits at every position (head on each)"
    else:
        out["ok"] = (out["mean_cuda"] <= k * out["mean_ref"]
                     and out["rms_cuda"] <= k * out["rms_ref"])
        rule, where = f" (kernel path within {k}x of it required)", "last-position logits"
    out["ok"] = out["ok"] and (n_flash, n_scan) == (n_attn, n_ssm)
    log(f"[slots] {what} ({len(prompt)} tokens), {where} (max |logit| "
        f"{f32.abs().max().item():.3f} at the last) against the float32 plain forward: at the "
        f"last position kernel path mean {out['mean_cuda']:.5f}, rms {out['rms_cuda']:.5f}, "
        f"max {out['max_cuda']:.5f}; plain path mean {out['mean_ref']:.5f}, rms "
        f"{out['rms_ref']:.5f}, max {out['max_ref']:.5f}{rule}; last-position argmax "
        f"cuda/ref/f32 {out['argmax']}; max |cuda - ref| {out['max_cuda_vs_ref']:.5f}; "
        f"{n_flash} flash launches took {flash_ms:.2f} and {n_scan} ssm_scan launches "
        f"{scan_ms:.2f} of the kernel path's {prefill_ms:.2f} ms")
    if not out["ok"]:
        raise AssertionError(f"the kernel path is further from float32 than the plain path: {out}")
    return out


def frame_path(torch, dev, card):
    """Phase 16: the Two-Chains frame path at a key-value shard's size;
    returns the JSON entries of its two kernels (launches filled in)."""
    from repro_torch.core import mailbox as mbx
    from repro_torch.kernels import mailbox as mk
    from repro_torch.kernels import timing
    from repro_torch.kernels.mailbox import bench as fb
    from repro_torch.kernels.mailbox.kernel import PUT_DESIGN, SUM_DESIGN, sum_route

    spec, n = fb.SPEC, fb.BANKS * fb.FRAMES_PER_BANK
    o = spec.offsets()
    usr_off, pw, sig = o["usr"], spec.payload_words, o["sig"] + 1
    torch.cuda.reset_peak_memory_stats()
    fabric = fb.kv_fabric(dev)
    table, heap, base = fabric.got.resolve(("kv.table", "kv.heap", "kv.heap_base"))
    got = torch.cat([base.view(1), torch.zeros(spec.got_slots - 1, dtype=torch.int32,
                                               device=dev)])
    plain_table, plain_heap = table.clone(), heap.clone()
    dispatch = fabric.dispatcher(spec, 2)
    cfg = mbx.MailboxConfig(banks=fb.BANKS, frames_per_bank=fb.FRAMES_PER_BANK, spec=spec)
    log(f"[frames] fabric {fabric.name!r}: GOT {fabric.got.symbols} (layout hash "
        f"{fabric.got.layout_hash():#010x}), table {tuple(table.shape)} + heap "
        f"{tuple(heap.shape)} int32 = {(table.nbytes + heap.nbytes) / 2 ** 30:.2f} GiB, heap "
        f"base {int(base)}; functions {fabric.functions}; {len(FRAME_DELIVERIES)} "
        f"deliveries of {n} frames of {spec.total_bytes} B")
    rng = np.random.default_rng(SEED)
    payloads = [fb.put_payloads(rng, n) if kind == "indirect_put" else fb.sum_payloads(rng, n)
                for kind in FRAME_DELIVERIES]
    times = {kind: [] for kind in FRAME_DELIVERIES}      # (pack, drain, kernel) seconds
    last, err = {}, {kind: 0 for kind in FRAME_DELIVERIES}
    mk.SUM_LAUNCHES.reset()
    mk.PUT_LAUNCHES.reset()
    for d, (kind, usr_np) in enumerate(zip(FRAME_DELIVERIES, payloads)):
        usr = torch.from_numpy(usr_np).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = fabric.pack(kind, usr)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bad = fb.corrupt(frames, rng) if kind == "server_side_sum" else None
        # the block as a ring put lands it: every bank full, no credit left
        box = {"frames": frames.view(fb.BANKS, fb.FRAMES_PER_BANK, spec.total_words),
               "credits": torch.zeros(fb.BANKS, dtype=torch.int32, device=dev),
               "head": torch.full((fb.BANKS,), fb.FRAMES_PER_BANK, dtype=torch.int32,
                                  device=dev)}
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        results, _ = mbx.drain_mailbox(box, dispatch, cfg)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        block = box["frames"].view(n, spec.total_words)
        if kind == "indirect_put":
            mk.am_indirect_put(block, table, heap, got, spec)
        else:
            sums = mk.am_server_sum(block, spec)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        times[kind].append((t1 - t0, t3 - t2, t4 - t3))
        results = results.view(n, 2)
        if kind == "indirect_put":
            e = _check_put(torch, dev, fb, d, usr_np, block, results, table, heap, plain_table,
                           plain_heap, base)
        else:
            e = _check_sum(torch, fb, d, block, results, sums, bad, usr_off, pw, sig)
        err[kind] = max(err[kind], e)
        last[kind] = block
        del usr, frames, box, results
    launches = {"server_sum": mk.SUM_LAUNCHES.count, "indirect_put": mk.PUT_LAUNCHES.count}
    want = {"server_sum": FRAME_DELIVERIES.count("server_side_sum"),
            "indirect_put": FRAME_DELIVERIES.count("indirect_put")}
    if launches != want:
        raise AssertionError(f"kernel launches on the frame path {launches}, want {want}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    # the first delivery of each kind also pays one-time costs (loading the
    # kernel library and its modules, growing the allocator's pool): the
    # later ones are the steady state
    for kind, ts in times.items():
        per = ", ".join(f"{p * 1e3:.2f} + {dr * 1e3:.2f} + {k * 1e3:.2f}" for p, dr, k in ts)
        steady = np.sum(ts[1:], axis=0)
        total = steady.sum()
        log(f"[frames] {kind}: pack + drain + kernel per delivery (ms, host clock, "
            f"synchronized): {per}; after the first: {len(ts) - 1} x {n} frames in "
            f"{total * 1e3:.2f} ms ({steady[0] * 1e3:.2f} + {steady[1] * 1e3:.2f} + "
            f"{steady[2] * 1e3:.2f}) = {(len(ts) - 1) * n / total:.4g} frames/s, "
            f"{(len(ts) - 1) * n * spec.total_bytes / total / 1e9:.2f} GB/s of frames on "
            f"{card}")
    log(f"[frames] launches on the frame path {launches}; peak allocated {peak:.2f} GB")
    _check_drop(torch, dev, fabric, spec)
    _check_expert_placements(torch, dev)

    flush = timing.l2_flush_buffer(dev)
    blk = last["server_side_sum"]
    usr_view = blk[:, usr_off:usr_off + pw]
    sum_design = f"{SUM_DESIGN}, route {sum_route(blk, usr_off, pw)}"
    sum_sectors = fb.sum_sector_work(n, usr_off, pw, w=spec.total_words)
    sum_entry = _entry(
        "server_sum", "src/repro/kernels/mailbox/kernel.py:167", launches["server_sum"], n,
        err["server_side_sum"],
        ms=timing.timed_ms(lambda: mk.server_sum_cuda(blk, usr_off, pw), 200, flush),
        plain_ms=timing.timed_ms(lambda: mk.server_sum_ref(blk, usr_off, pw), 50, flush),
        library_ms=timing.timed_ms(lambda: usr_view.sum(1, dtype=torch.int32), 200, flush),
        work=fb.sum_work(n),
        note=(f"; {sum_design}; 32-byte sectors {sum_sectors['sectors']} ("
              f"{sum_sectors['usr_sectors']} of USR words, the rest sums) -> "
              f"{timing.bound_ms(sum_sectors)[0]:.5f} ms"))
    sum_entry["design"] = sum_design
    blk = last["indirect_put"]
    keys = blk[:, usr_off].cpu().numpy()
    rows_np, last_np = fb.last_writers(fb.put_rows(keys))
    rows = torch.from_numpy(rows_np).to(dev)
    win = torch.from_numpy(last_np).to(dev)
    t_vals = torch.stack([blk[win, usr_off], rows.to(torch.int32)], 1)
    h_vals = blk[win, usr_off + 1:usr_off + pw].contiguous()
    # the same frames again leave the same state: every timed call is a
    # whole put
    def put():
        return mk.indirect_put_cuda(blk, table, heap, got, usr_off, pw)

    passes = fb.put_passes_ms(put, flush)
    sectors = fb.put_sector_work(n, rows_np, last_np)
    put_entry = _entry(
        "indirect_put", "src/repro/kernels/mailbox/kernel.py:215", launches["indirect_put"], n,
        err["indirect_put"],
        ms=timing.timed_ms(put, 100, flush),
        plain_ms=timing.timed_ms(lambda: mk.indirect_put_ref(blk, plain_table, plain_heap,
                                                             usr_off, pw, base), 20, flush),
        library_ms=timing.timed_ms(lambda: (table.index_put_((rows,), t_vals),
                                            heap.index_put_((rows,), h_vals)), 100, flush),
        work=fb.put_work(n, len(rows_np)),
        note=(f"; {PUT_DESIGN}: passes (profiler, device ms per call) "
              + ", ".join(f"{k} {v:.4f}" for k, v in passes.items())
              + f"; 32-byte sectors {sectors['sectors']} ({sectors['partial_sectors']} partly "
              f"written) -> {timing.bound_ms(sectors)[0]:.5f} ms, "
              f"{timing.bound_ms(dict(bytes=sectors['rmw_bytes']))[0]:.5f} ms if each partly "
              f"written one is read too"))
    put_entry["design"] = PUT_DESIGN
    if set(passes) != set(fb.PUT_PASSES):
        raise AssertionError(f"the profiler saw the put's passes {sorted(passes)}, want "
                             f"{list(fb.PUT_PASSES)}")
    if not (torch.equal(table, plain_table) and torch.equal(heap, plain_heap)):
        raise AssertionError("the timed puts left the kernel's and the plain version's "
                             "shards unequal")
    return [sum_entry, put_entry]


def _entry(name, replaces, launches, n, max_err, *, ms, plain_ms, library_ms, work,
           path="frame path", source="src/repro_torch/kernels/mailbox/csrc/mailbox.cu",
           note=""):
    """A mailbox kernel's JSON entry; ``note`` ends its log line."""
    from repro_torch.kernels import timing

    bound, bound_by = timing.bound_ms(work)
    log(f"[kernel] {name} timing (L2 flushed per launch, {n} frames): kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library {library_ms:.4f} ms; needed bytes {work['bytes']} "
        f"-> {bound:.5f} ms at 3.35 TB/s ({bound_by}){note}")
    return {"name": name, "route": "cuda", "path": path, "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": library_ms}


def ring_path(torch, dev, card):
    """Phase 17: the one-sided ring put (B7), ranks as the CTAs of a cluster;
    returns its JSON entry (launches from the Two-Chains ring)."""
    from repro_torch.core.message import FrameSpec
    from repro_torch.kernels import mailbox as mk
    from repro_torch.kernels import timing
    from repro_torch.kernels.mailbox import bench as fb
    from repro_torch.kernels.mailbox.kernel import ring_chunk_frames

    spec, n, N = fb.SPEC, fb.RING_RANKS, fb.RING_FRAMES
    sig = spec.offsets()["sig"]
    chunk = ring_chunk_frames(spec.total_words)
    rng = np.random.default_rng(SEED)
    err, cases, capped = 0, 0, 0
    for frames in (1, 3, chunk + 1, N):
        base = fb.ring_blocks(dev, rng, max(RING_GRID_RANKS), frames)
        for ranks in RING_GRID_RANKS:
            blocks = base[:ranks]
            for shift in sorted({1, 2, ranks - 1, ranks + 1}):
                for wait, stash, handler in RING_ROUTES:
                    err = max(err, _check_ring(torch, mk, blocks, spec, shift=shift, wait=wait,
                                               stash=stash, handler=handler))
                    cases += 1
            # the last frame's SIG word missing: the poll runs to its cap
            blocks = blocks.clone()
            blocks[:, -1, sig] = 0
            err = max(err, _check_ring(torch, mk, blocks, spec, wait="poll", handler="sum",
                                       capped=True))
            capped += 1
        del base
    log(f"[ring] kernel == plain, bit for bit: {cases} cases (1/2/4/8 ranks, shifts 1, 2, "
        f"n-1, n+1, 1/3/{chunk + 1}/{N} frames of {spec.total_bytes} B, wfe/poll x stash "
        f"+/- sum and no stash), spins 0 / [1, 2^20) / exact; {capped} cases with the last "
        f"SIG missing: 2^20 spins on every rank, arrivals right; max |diff| {err}")

    # the Two-Chains ring: 8 ranks of a key-value shard's 16 MiB of frames each
    fabric = fb.kv_fabric(dev)
    usr = torch.from_numpy(fb.sum_payloads(rng, n * N)).to(dev).view(n, N, spec.payload_words)
    blocks = torch.stack([fabric.pack("server_side_sum", usr[r], src_rank=r) for r in range(n)])
    del usr
    want = torch.roll(fabric.dispatcher(spec, 2)(blocks)[..., 0], 1, 0)   # what each rank gets
    landed = torch.roll(blocks, 1, 0)
    torch.cuda.synchronize()
    mk.RING_LAUNCHES.reset()
    t0 = time.perf_counter()
    fused = mk.ring_am_put(blocks, spec=spec, handler="sum")
    polled = mk.ring_am_put(blocks, spec=spec, wait="poll", handler="sum")
    to_hbm = mk.ring_am_put(blocks, spec=spec, stash=False)
    drained = torch.stack([mk.am_server_sum(a, spec) for a in to_hbm[0]])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = mk.RING_LAUNCHES.count
    sums_ok = [torch.equal(fused[2][..., 0], want), torch.equal(polled[2][..., 0], want),
               torch.equal(drained, want)]
    landed_ok = all(torch.equal(r[0], landed) for r in (fused, polled, to_hbm))
    spins = polled[1].view(-1).tolist()
    log(f"[ring] the Two-Chains ring: {n} ranks x {N} frames ({N * spec.total_bytes / 2 ** 20:.0f} "
        f"MiB a rank, packed by fabric {fabric.name!r}); stash+sum (wfe), stash+sum (poll), "
        f"no stash + am_server_sum on each rank: sums == the dispatcher's {sums_ok}, arrivals "
        f"== roll {landed_ok}; spins wfe {fused[1].view(-1).tolist()}, poll {spins}, no stash "
        f"{to_hbm[1].view(-1).tolist()}; {launches} ring launches, {wall * 1e3:.2f} ms for "
        f"the three (host clock, first calls)")
    if not (all(sums_ok) and landed_ok and launches == 3 and (fused[1] == 0).all()
            and (to_hbm[1] == 0).all() and all(1 <= s < mk.MAX_SPINS for s in spins)):
        raise AssertionError("the Two-Chains ring disagrees")
    del fused, polled, to_hbm, drained, want, landed

    # the paper's two comparisons: stashing (Fig. 9/10), WFE vs poll (Fig. 13/14)
    flush = timing.l2_flush_buffer(dev)
    sizes = [("1 frame", spec, 1, 200)]
    sizes += [(f"16 frames of {pw} USR words", FrameSpec(4, 0, pw), 16, 200)
              for pw in fb.PAYLOADS]
    sizes += [(f"{N} frames ({N * spec.total_bytes / 2 ** 20:.0f} MiB) a rank", spec, N, 30)]
    times = {}
    for label, sp, frames, iters in sizes:
        blk = blocks if frames == N and sp == spec else fb.ring_blocks(dev, rng, n, frames, sp)
        err = max(err, _check_ring(torch, mk, blk, sp, handler="sum"))
        if frames < N:
            _check_drain(torch, mk, blk, sp, label)
        t = times[label] = fb.ring_times(blk, flush, iters, sp)
        rate = {k: n * frames / (t[k]["ms"] * 1e-3) for k in ("stash+sum", "non-stash+drain")}
        log(f"[ring] {n} ranks x {label}, {sp.total_bytes} B frames, on {card}: STASHING: "
            f"stash+sum {t['stash+sum']['ms']:.4f} ms (warm {t['stash+sum']['warm_ms']:.4f}) "
            f"vs non-stash put + drain {t['non-stash+drain']['ms']:.4f} ms (warm "
            f"{t['non-stash+drain']['warm_ms']:.4f}; the put alone "
            f"{t['non-stash']['ms']:.4f}): "
            f"{t['non-stash+drain']['ms'] / t['stash+sum']['ms']:.2f}x, "
            f"{rate['stash+sum']:.4g} vs {rate['non-stash+drain']:.4g} frames/s; WFE vs POLL: "
            f"wfe {t['wfe']['ms']:.4f} ms (warm {t['wfe']['warm_ms']:.4f}) vs poll "
            f"{t['poll']['ms']:.4f} ms (warm {t['poll']['warm_ms']:.4f}), poll spins "
            f"{t['poll_spins']}, wfe spins 0; torch.roll {t['roll_ms']:.4f} ms, roll + sum "
            f"{t['roll+sum_ms']:.4f} ms (L2 flushed per launch unless warm)")
    big = times[sizes[-1][0]]
    plain_ms = timing.timed_ms(lambda: mk.ring_am_put(blocks, spec=spec, handler="sum",
                                                      kernel="ref"), 10, flush)
    log(f"[ring] timings {json.dumps(times)}")
    return _entry("mailbox_put", "src/repro/kernels/mailbox/kernel.py:96", launches, n * N, err,
                  ms=big["stash+sum"]["ms"], plain_ms=plain_ms, library_ms=big["roll+sum_ms"],
                  work=fb.ring_work(n, N, spec.total_words, summed=True), path="ring put",
                  source="src/repro_torch/kernels/mailbox/csrc/ring_put.cu")


def _check_drain(torch, mk, blocks, spec, label):
    """The drain of the non-stash ring put at the latency frames: the
    Server-Side Sum of each rank's arrivals (a call of few frames: the
    sum's wide route) against its plain version, bit for bit."""
    from repro_torch.kernels.mailbox.kernel import sum_route

    usr_off, pw = spec.offsets()["usr"], spec.payload_words
    arrivals = mk.ring_am_put(blocks, spec=spec, stash=False)[0]
    routes = sorted({sum_route(a, usr_off, pw) for a in arrivals})
    same = all(torch.equal(mk.am_server_sum(a, spec), mk.server_sum_ref(a, usr_off, pw))
               for a in arrivals)
    log(f"[ring] {label}: the drain's Server-Side Sum (route {routes}) == plain on every "
        f"rank: {same}")
    if not same:
        raise AssertionError(f"the drain's Server-Side Sum disagrees at {label}")


# the grid's routes: (wait, stash, handler); a fused sum needs the stash
RING_ROUTES = [("wfe", True, None), ("wfe", True, "sum"), ("poll", True, None),
               ("poll", True, "sum"), ("wfe", False, None), ("poll", False, None)]


def _check_ring(torch, mk, blocks, spec, capped=False, **kw):
    """One ring put through the kernel against its plain version: arrivals
    and sums bit for bit; spins where the plain version says 0 or 2^20
    exactly, in [1, 2^20) where its poll finds the SIG word; with
    ``capped``, 2^20 on every rank. Returns the largest |kernel - plain|."""
    got = mk.ring_am_put(blocks, spec=spec, **kw)
    want = mk.ring_am_put(blocks, spec=spec, kernel="ref", **kw)
    found = want[1] == 1
    spins_ok = bool(torch.where(found, (got[1] >= 1) & (got[1] < mk.MAX_SPINS),
                                got[1] == want[1]).all())
    if capped:
        spins_ok = spins_ok and bool((got[1] == mk.MAX_SPINS).all())
    same = (torch.equal(got[0], want[0]) and (got[2] is None) == (want[2] is None)
            and (want[2] is None or torch.equal(got[2], want[2])))
    if not (same and spins_ok):
        raise AssertionError(f"ring put {tuple(blocks.shape)} {kw} capped={capped}: kernel != "
                             f"plain (arrivals/sums equal {same}, spins "
                             f"{got[1].view(-1).tolist()} vs {want[1].view(-1).tolist()})")
    return max(_max_diff(torch, got[0], want[0]),
               0 if want[2] is None else _max_diff(torch, got[2], want[2]))


def _check_put(torch, dev, fb, d, usr_np, block, results, table, heap, plain_table,
               plain_heap, base):
    """An Indirect Put delivery: the kernel's whole shard against the plain
    version's on its clone, the rows written against a numpy replay of
    sequential puts, and the dispatcher's [key, row] rows. Returns the
    largest |kernel - plain| over the shard."""
    from repro_torch.kernels import mailbox as mk

    spec = fb.SPEC
    mk.indirect_put_ref(block, plain_table, plain_heap, spec.offsets()["usr"],
                        spec.payload_words, base)
    same_table, same_heap = torch.equal(table, plain_table), torch.equal(heap, plain_heap)
    keys = usr_np[:, 0]
    rows_np = fb.put_rows(keys)
    uniq, last = fb.last_writers(rows_np)
    rows = torch.from_numpy(uniq).to(dev)
    want_table = torch.from_numpy(np.stack([keys[last], uniq.astype(np.int32)], 1)).to(dev)
    replay = (torch.equal(table[rows], want_table)
              and torch.equal(heap[rows], torch.from_numpy(usr_np[last, 1:]).to(dev)))
    want_rows = torch.from_numpy(np.stack([keys, rows_np.astype(np.int32)], 1)).to(dev)
    dispatched = (torch.equal(results, want_rows)
                  and torch.equal(results[torch.from_numpy(last).to(dev)], table[rows]))
    neg = int((keys < 0).sum())
    log(f"[frames] delivery {d} indirect_put: {len(uniq)} rows written, {len(keys) - len(uniq)} "
        f"frames overwritten by a later one ({neg} negative keys, extremes "
        f"{int(keys.min())}/{int(keys.max())}); kernel shard == plain shard: table "
        f"{same_table}, heap {same_heap}; written rows == numpy replay: {replay}; "
        f"dispatcher rows == [key, row]: {dispatched}")
    if not (same_table and same_heap and replay and dispatched):
        raise AssertionError(f"Indirect Put delivery {d} disagrees")
    return max(_max_diff(torch, table, plain_table), _max_diff(torch, heap, plain_heap))


def _max_diff(torch, a, b):
    differ = a != b
    return int((a[differ].long() - b[differ].long()).abs().max()) if differ.any() else 0


def _check_sum(torch, fb, d, block, results, sums, bad, usr_off, pw, sig):
    """A Server-Side Sum delivery: the kernel against its plain version,
    against each valid frame's SIG checksum (unequal on exactly the
    corrupted frames), and against the dispatcher's rows. Returns the
    largest |kernel - plain|."""
    from repro_torch.kernels import mailbox as mk

    plain = mk.server_sum_ref(block, usr_off, pw)
    same = torch.equal(sums, plain)
    valid = sums == block[:, sig]
    invalid = (~valid).nonzero().squeeze(1).cpu().numpy()
    want = torch.stack([torch.where(valid, sums, 0), torch.zeros_like(sums)], 1)
    dispatched = torch.equal(results, want)
    wide = block[:, usr_off:usr_off + pw].to(torch.int64).sum(1)
    wrapped = int((wide != sums.to(torch.int64)).sum())
    log(f"[frames] delivery {d} server_side_sum: kernel == plain: {same}; sums == SIG "
        f"checksum on {int(valid.sum())} frames, unequal on {len(invalid)} (corrupted "
        f"{len(bad)}, the same frames: {np.array_equal(invalid, bad)}); {wrapped} sums "
        f"wrapped; dispatcher rows == [sum, 0] on valid frames, zero rows on the rest: "
        f"{dispatched}")
    if not (same and np.array_equal(invalid, bad) and dispatched):
        raise AssertionError(f"Server-Side Sum delivery {d} disagrees")
    return _max_diff(torch, sums, plain)


def _check_drop(torch, dev, fabric, spec):
    """post_local into a one-bank mailbox past its credits: the frames
    without a credit are dropped, the bank's slots keep the first ones."""
    from repro_torch.core import mailbox as mbx

    cfg = mbx.MailboxConfig(banks=1, frames_per_bank=4, spec=spec)
    box = mbx.init_mailbox(cfg, device=dev)
    usr = torch.arange(6 * spec.payload_words, dtype=torch.int32,
                       device=dev).view(6, spec.payload_words)
    frames = fabric.pack("server_side_sum", usr)
    for f in frames:
        mbx.post_local(box, 0, f)
    kept = torch.equal(box["frames"][0], frames[:4])
    log(f"[frames] post_local of 6 frames into a 1 x 4 mailbox: credits "
        f"{box['credits'].tolist()}, head {box['head'].tolist()}, slots hold the first 4: "
        f"{kept}")
    if box["credits"].tolist() != [0] or box["head"].tolist() != [4] or not kept:
        raise AssertionError("post_local did not drop the frames past its credits")
    results, cleared = mbx.drain_mailbox(box, fabric.dispatcher(spec, 2), cfg)
    if cleared["credits"].tolist() != [4] or results.shape != (1, 4, 2):
        raise AssertionError("drain_mailbox did not clear the bank")


def _check_expert_placements(torch, dev):
    """One olmoe-1b-7b expert through ``fabric.call``: ``local`` with its
    weights bound in the GOT, ``injected`` with them in the frame's STATE
    (12.6 MB of words, leased): identical result words; the lease counts
    one miss, then hits."""
    from repro_torch.core import injection as inj
    from repro_torch.core.message import FrameSpec
    from repro_torch.fabric import Fabric

    d, f, tokens = EXPERT_D, EXPERT_FF, EXPERT_TOKENS
    rng = np.random.default_rng(SEED)
    ws = [torch.from_numpy((rng.standard_normal(shape) * 0.02).astype(np.float32))
          .to(device=dev, dtype=torch.bfloat16) for shape in ((d, f), (d, f), (f, d))]
    x = torch.from_numpy(rng.standard_normal((tokens, d)).astype(np.float32)).to(
        device=dev, dtype=torch.bfloat16)
    spec_local = FrameSpec(got_slots=4, state_words=0, payload_words=tokens * d // 2)
    spec_inj = inj.injected_frame_spec(d, f, tokens)
    fabric = Fabric(name="expert")
    fabric.install({"expert.w_gate": ws[0], "expert.w_up": ws[1], "expert.w_down": ws[2]})

    def ffn(usr, wg, wu, wd):
        h = inj.words_to_tokens(usr[0], tokens, d)
        return inj.tokens_to_words((torch.nn.functional.silu(h @ wg) * (h @ wu)) @ wd)[None]

    @fabric.function("expert.local", spec=spec_local, result_words=tokens * d // 2,
                     got_symbols=("expert.w_gate", "expert.w_up", "expert.w_down"))
    def local(got, state, usr):
        return ffn(usr, *got)

    @fabric.function("expert.injected", spec=spec_inj, result_words=tokens * d // 2)
    def injected(got, state, usr):
        return ffn(usr, *inj.unpack_expert_state(state[0], d, f))

    payload = inj.tokens_to_words(x)
    want = fabric.call("expert.local", payload, placement="local")
    same = []
    for _ in range(3):
        state = fabric.lease("expert.state", ws, materialize=lambda: inj.expert_state_words(*ws))
        same.append(torch.equal(fabric.call("expert.injected", payload, state=state,
                                            placement="injected"), want))
    lease = fabric.metrics()["leases"]["expert.state"]
    log(f"[frames] one olmoe-1b-7b expert (d {d}, ff {f}, {tokens} tokens): injected frame "
        f"{spec_inj.total_bytes} B ({spec_inj.state_words} STATE words), local frame "
        f"{spec_local.total_bytes} B; injected == local, word for word: {same}; lease "
        f"{lease['misses']} miss, {lease['hits']} hits")
    if not all(same) or (lease["misses"], lease["hits"]) != (1, 2):
        raise AssertionError("local and injected expert calls differ")


def cluster_path(torch, dev, card):
    """Phase 15: the cluster half of the port (``repro_torch.cluster``):
    replicas side by side on the one card, sharing one weight tree. Paged:
    two full-width llama3.2-1b replicas at ``serve``'s geometry serve its
    requests; recurrent: two mamba-130m replicas at its recurrent geometry;
    each time one solo run of the same requests on one engine, a clean
    cluster run with forced live migrations (paged: one mid-chunked-prefill
    and one mid-decode; recurrent: one mid-decode), then the requests
    replayed under two fault plans with one replica killed; slots: two
    llama3.2-1b replicas, one long (flash) and one short request each
    migrated at an aligned admission. Every output must equal the solo
    run's, token for token; each replica's step launches its kernel once a
    layer a step. Returns each kernel's launches over the phase."""
    from repro_torch.configs.registry import get_config
    from repro_torch.engine import Engine, Request
    from repro_torch.runtime.steps import LAUNCH_COUNTERS

    for counter in LAUNCH_COUNTERS.values():
        counter.reset()
    paged_geom = dict(cache="paged", slots=SLOTS, max_len=MAX_LEN, num_blocks=NUM_BLOCKS,
                      block_size=BLOCK, chunk=CHUNK)
    rec_geom = dict(cache="recurrent", slots=REC_SLOTS, max_len=MAX_LEN, chunk=CHUNK)
    for arch, geom, n_requests, forced in (
            (ARCHS[0], paged_geom, N_REQUESTS, CLUSTER_FORCED["paged"]),
            (MAMBA_ARCH, rec_geom, REC_REQUESTS, CLUSTER_FORCED["recurrent"])):
        cfg = get_config(arch)
        engines = _replicas(torch, dev, cfg, geom, 3)
        rng = np.random.default_rng(SEED)
        prompts = [rng.integers(0, cfg.vocab_size, size=(int(rng.integers(PROMPT_LO,
                                                                           PROMPT_HI + 1)),))
                   .astype(np.int32) for _ in range(n_requests)]
        solo, pair = engines[0], engines[1:]
        for rid, p in enumerate(prompts):
            solo.submit(Request(rid, p, max_new_tokens=MAX_NEW))
        solo.run_until_drained()
        want = {r.rid: list(r.out_tokens) for r in solo.completed}
        log(f"[cluster] {arch} solo run: {len(want)} requests on one engine, "
            f"{solo.steps} steps, {solo.preempt_count} preemptions")
        before = [dict(e.kernel_launches) for e in pair]
        steps_before = [e.steps for e in pair]
        router, out, restores = _cluster_run(torch, pair, prompts, forced=forced)
        _same_as_solo(f"{arch} clean", out, want)
        per_layer = cfg.num_layers
        kname = "paged_attention" if geom["cache"] == "paged" else "ssm_scan"
        for e, b, s in zip(pair, before, steps_before):
            n = e.kernel_launches[kname] - b[kname]
            log(f"[cluster] {arch} replica {e.engine_id}: {n} {kname} launches over "
                f"{e.steps - s} steps ({e.metrics()['migrations']})")
            if n == 0 or n != per_layer * (e.steps - s):
                raise AssertionError(f"replica {e.engine_id}: {n} {kname} launches for "
                                     f"{e.steps - s} steps of {per_layer} layers")
        _log_migrations(arch, router, restores, card)
        decode_frames = max(m["frames"] for m in router.migrations)
        # the JAX package's chaos rate, with failover by recompute: every
        # recovery ticket is one frame (prompt + delivered tokens); the
        # state-carrying trains would not survive it (below)
        _chaos_run(torch, pair, prompts, want, arch=arch, rate=CHAOS_RATE, snapshot_every=0)
        # failover from snapshots: a per-frame rate of one fault per train
        # of the size the clean run's largest migration shipped
        _chaos_run(torch, pair, prompts, want, arch=arch, rate=1.0 / decode_frames,
                   snapshot_every=CLUSTER_SNAPSHOT_EVERY)
        del engines, solo, pair, router
        gc.collect()
        torch.cuda.empty_cache()
    _slots_cluster(torch, dev, card)
    return {name: c.count for name, c in LAUNCH_COUNTERS.items()}


def _replicas(torch, dev, cfg, geom, n, max_len=None):
    """``n`` engines of one geometry on the card, sharing one weight tree
    drawn from ``SEED`` (the first draws it, the others take it through
    ``inject_params``, as the cluster launcher does)."""
    from repro_torch.engine import Engine

    engines = []
    for i in range(n):
        e = Engine(cfg, device=dev, kernel="auto", engine_id=f"{cfg.name}:{geom['cache']}#{i}",
                   **geom)
        e.inject_params(engines[0].params if engines else None, seed=SEED)
        if e.kernel != "cuda":
            raise AssertionError(f"auto resolved to {e.kernel!r} on the card")
        engines.append(e)
    torch.cuda.synchronize()
    return engines


def _cluster_run(torch, pair, prompts, *, forced=(), faults=None, snapshot_every=0,
                 max_retries=6):
    """Serve ``prompts`` through a Router over ``pair`` (restarted); after
    the router ticks in ``forced`` ({tick: "prefill" | "decode"}) migrate
    the first running request in that phase to the other replica. Returns
    the router and each request's tokens."""
    from repro_torch.cluster import Replica, Router
    from repro_torch.engine import Request

    for e in pair:
        e.restart()
    restores = _time_restores(torch, pair)
    router = Router([Replica(e) for e in pair], snapshot_every=snapshot_every,
                    max_retries=max_retries, retry_backoff_s=0.0)
    if faults is not None:
        faults.install(router)
    handles = [router.submit(Request(rid, p, max_new_tokens=MAX_NEW))
               for rid, p in enumerate(prompts)]
    while router.pending():
        router.tick()
        phase = dict(forced).get(router.tick_no)
        if phase is not None:
            _force_migration(router, phase)
        if router.tick_no > 4000:
            raise AssertionError("the cluster did not drain in 4000 ticks")
    for e in pair:
        del e._restore_inbound
    return router, {h.rid: list(h.req.out_tokens) for h in handles}, restores


def _time_restores(torch, engines):
    """Time each engine's restores of migrated-in state (device synced),
    appending (engine_id, rid, ms); ``del e._restore_inbound`` undoes it."""
    restores = []
    for e in engines:
        def timed(entry, slot, inner=e._restore_inbound, e=e):
            torch.cuda.synchronize()
            t = time.perf_counter()
            inner(entry, slot)
            torch.cuda.synchronize()
            restores.append((e.engine_id, entry.req.rid, (time.perf_counter() - t) * 1e3))
        e._restore_inbound = timed
    return restores


def _force_migration(router, phase):
    """Migrate the first running request (by replica, then slot) that is
    mid-prefill or in decode to the other replica."""
    for rep in router.replicas:
        for entry in rep.engine.slot_entry:
            if entry is None or entry.req.done:
                continue
            prefill = 0 < entry.pos < len(entry.prompt_tokens)
            if prefill == (phase == "prefill") and (prefill or entry.req.out_tokens):
                dst = next(r for r in router.replicas if r is not rep)
                router.migrate(entry.req.rid, dst.engine_id, reason=f"forced ({phase})")
                return
    raise AssertionError(f"no running request in {phase} after tick {router.tick_no}")


def _same_as_solo(label, out, want):
    bad = {rid: next(i for i, (x, y) in enumerate(zip(out[rid], want[rid])) if x != y)
           for rid in want if out.get(rid) != want[rid] and len(out.get(rid, [])) ==
           len(want[rid])}
    missing = [rid for rid in want if len(out.get(rid, [])) != len(want[rid])]
    if bad or missing:
        raise AssertionError(f"{label}: outputs differ from the solo run (rid: first "
                             f"differing position) {bad}; incomplete {missing}")
    log(f"[cluster] {label}: {len(want)}/{len(want)} requests identical to the solo run, "
        f"token for token")


def _log_migrations(arch, router, restores, card):
    restore = {rid: ms for _, rid, ms in restores}
    for m in router.migrations:
        wire_s = (m["encode_ms"] + m["decode_ms"]) / 1e3
        nbytes = m["frames"] * 4096
        log(f"[cluster] {arch} migration of rid {m['rid']} ({m['reason']}) {m['src']} -> "
            f"{m['dst']} at position {m['pos']}: {m['state_bytes']} state bytes in "
            f"{m['frames']} frames; export {m['export_ms']:.2f} ms, encode {m['encode_ms']:.2f}"
            f" + decode {m['decode_ms']:.2f} ms ({m['frames'] / wire_s:.0f} frames/s, "
            f"{nbytes / wire_s / 1e9:.3f} GB/s), import {m['import_ms']:.2f} ms, restore "
            f"{restore.get(m['rid'], float('nan')):.2f} ms (host clocks, device synced) on "
            f"{card}")


def _chaos_run(torch, pair, prompts, want, *, arch, rate, snapshot_every):
    """Replay ``prompts`` under a seeded plan (frame faults at ``rate``, the
    first replica killed at ``CLUSTER_KILL_TICK``): outputs identical to
    the solo run, every detected fault retransmitted, one failover, no
    request failed."""
    from repro_torch.faults import FaultInjector, FaultPlan

    plan = FaultPlan(seed=SEED, frame_fault_rate=rate,
                     kill_at={pair[0].engine_id: CLUSTER_KILL_TICK})
    router, out, _ = _cluster_run(torch, pair, prompts, faults=FaultInjector(plan),
                                  snapshot_every=snapshot_every, max_retries=CHAOS_RETRIES)
    f = router.metrics()["faults"]
    label = f"{arch} chaos (frame fault rate {rate:.3g}, snapshot every {snapshot_every})"
    _same_as_solo(label, out, want)
    restored = [m for m in router.migrations if m["reason"].startswith("failover")]
    log(f"[cluster] {label}: injected {f['injected']}, detected {f['detected']}, "
        f"retransmits {f['retransmits']}, failovers {f['failovers']}, recovered "
        f"{f['requests_recovered']} ({sum(m['pos'] > 0 for m in restored)} from a snapshot, "
        f"{sum(m['frames'] for m in restored)} frames), snapshots {f['snapshots_taken']}")
    if (f["detected"] != f["retransmits"] or f["failovers"] != 1 or f["requests_failed"]
            or not f["requests_recovered"]):
        raise AssertionError(f"{label}: {f}")
    if snapshot_every and not any(m["pos"] > 0 for m in restored):
        raise AssertionError(f"{label}: no request was restored from a snapshot")


def _slots_cluster(torch, dev, card):
    """Two llama3.2-1b slots replicas: a long prompt (past the flash
    threshold) migrated after 3 ticks and a short one after 1, each alone,
    so the target's shared length is the request's (an aligned admission);
    each held against its solo run. The replica that prefills the long
    prompt launches flash once a layer."""
    from repro_torch.cluster import Replica, Router
    from repro_torch.configs.registry import get_config
    from repro_torch.engine import Request
    from repro_torch.models import attention

    cfg = get_config(ARCHS[0])
    geom = dict(cache="slots", slots=2, max_len=SLOTS_MAX_LEN)
    solo, a, b = _replicas(torch, dev, cfg, geom, 3)
    rng = np.random.default_rng(SEED)
    for rid, (n, ticks) in enumerate(CLUSTER_SLOTS_REQUESTS):
        prompt = rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
        for e in (solo, a, b):
            e.restart()
        h = solo.submit(Request(rid, prompt, max_new_tokens=MAX_NEW))
        solo.run_until_drained()
        want = {rid: list(h.req.out_tokens)}
        flash_before = a.kernel_launches["flash_attention"]
        restores = _time_restores(torch, (b,))
        router = Router([Replica(a), Replica(b)])
        h = router.submit(Request(rid, prompt, max_new_tokens=MAX_NEW))
        for _ in range(ticks):
            router.tick()
        t = time.perf_counter()
        router.migrate(rid, b.engine_id, reason=f"forced after tick {ticks}")
        router.run_until_drained()
        torch.cuda.synchronize()
        del b._restore_inbound
        _same_as_solo(f"{cfg.name} slots, {n}-token prompt migrated after tick {ticks}",
                      {rid: list(h.req.out_tokens)}, want)
        _log_migrations(f"{cfg.name} slots", router, restores, card)
        flash = a.kernel_launches["flash_attention"] - flash_before
        long = attention._use_chunked(n, n)
        log(f"[cluster] {cfg.name} slots replica {a.engine_id}: {flash} flash_attention "
            f"launches ({'past' if long else 'under'} the threshold); {b.engine_id} decodes "
            f"only (no kernel on the decode step); {time.perf_counter() - t:.2f}s after the "
            f"migration")
        if flash != (cfg.num_layers if long else 0):
            raise AssertionError(f"{flash} flash launches for a {n}-token prefill of "
                                 f"{cfg.num_layers} layers")


def graph_path(torch, dev, card):
    """Phase 18: draft -> verify speculation (``repro_torch.fabric.graph``)
    on full-width llama3.2-1b paged engines (the constants at
    ``GRAPH_REQUESTS``): every speculated output equal to its target-only
    baseline; each bf16 target's paged-attention launches one a layer per
    step and per verify step. Returns each kernel's launches over the
    phase."""
    from repro_torch.configs.registry import get_config
    from repro_torch.engine import Engine, Request
    from repro_torch.runtime.steps import LAUNCH_COUNTERS

    for counter in LAUNCH_COUNTERS.values():
        counter.reset()
    cfg = get_config(ARCHS[0])
    geom = dict(cache="paged", slots=SLOTS, max_len=MAX_LEN, num_blocks=NUM_BLOCKS,
                block_size=BLOCK, chunk=CHUNK)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=(int(rng.integers(PROMPT_LO,
                                                                       PROMPT_HI + 1)),))
               .astype(np.int32) for _ in range(GRAPH_REQUESTS)]

    def engine(eid, params=None, seed=SEED, dtype=torch.bfloat16):
        e = Engine(cfg, device=dev, kernel="auto" if dtype == torch.bfloat16 else "ref",
                   engine_id=f"graph-{eid}", compute_dtype=dtype, **geom)
        e.load_params(params, seed=seed)
        return e

    base = engine("base")
    weights = base.params
    t0, t1, d_same = (engine(eid, weights) for eid in ("t0", "t1", "d-same"))
    d_other = engine("d-other", seed=GRAPH_OTHER_SEED)
    if {e.kernel for e in (base, t0, t1, d_same, d_other)} != {"cuda"}:
        raise AssertionError("auto did not resolve to cuda on the card")
    torch.cuda.synchronize()
    want, base_run = _graph_baseline(torch, base, prompts)
    log(f"[graph] {cfg.name} target-only baseline: {base_run['tokens']} tokens of "
        f"{len(prompts)} requests ({[len(p) for p in prompts]} prompt tokens) in "
        f"{base_run['wall_s']:.3f}s = {base_run['tokens_per_s']:.1f} tokens/s, 1 target step "
        f"a token, decode step p50 {base_run['decode_p50_ms']:.2f} ms on {card}")
    verify_ms = []
    for e in (t0, t1):
        e._verify_call = _timed(torch, e._verify_call, verify_ms)
    runs = [_graph_engine_run(torch, cfg, f"ngram k {k}", t0, None, k, prompts, want,
                              base_run, card) for k in GRAPH_NGRAM_K]
    for label, draft in (("model draft sharing the target's weights", d_same),
                         (f"model draft from seed {GRAPH_OTHER_SEED}", d_other)):
        runs.append(_graph_engine_run(torch, cfg, f"{label} k {GRAPH_MODEL_K}", t0, draft,
                                      GRAPH_MODEL_K, prompts, want, base_run, card))
    if runs[2]["acceptance_rate"] <= runs[3]["acceptance_rate"]:
        raise AssertionError("the draft sharing the target's weights was accepted no more "
                             "often than the one from another seed")
    _graph_router_run(torch, cfg, "router, verify replica killed", (t0, t1, d_same), prompts,
                      want, base_run, card, kill=True)
    _graph_router_run(torch, cfg, f"router, edge frame fault rate {CHAOS_RATE}",
                      (t0, t1, d_same), prompts, want, base_run, card, rate=CHAOS_RATE)
    log(f"[graph] verify step (emit all, {CHUNK} columns a row) p50 "
        f"{float(np.median(verify_ms)) * 1e3:.2f} ms over {len(verify_ms)} steps against a "
        f"decode step's {base_run['decode_p50_ms']:.2f} ms (host clock, tokens read back) on "
        f"{card}")
    del base, t0, t1, d_same, d_other, weights
    gc.collect()
    torch.cuda.empty_cache()
    launches = {name: c.count for name, c in LAUNCH_COUNTERS.items()}
    _graph_float32_control(torch, dev, cfg, geom, prompts[0], card)
    return launches


def _timed(torch, fn, into):
    """``fn`` timed on the host clock with the device synced at both ends
    (seconds appended to ``into``)."""
    def timed(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        into.append(time.perf_counter() - t)
        return out
    return timed


def _graph_baseline(torch, engine, prompts):
    """Target-only greedy decode of ``prompts``, one at a time on ``engine``
    (device synced every tick): each request's tokens, and the run's wall
    time and decode-tick p50."""
    from repro_torch.engine import Request

    out, decode_s = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for rid, prompt in enumerate(prompts):
        h = engine.submit(Request(rid, prompt, max_new_tokens=MAX_NEW))
        while engine.pending():
            entry = engine.slot_entry[0]
            decode = entry is not None and entry.pos >= len(entry.prompt_tokens)
            t = time.perf_counter()
            engine.tick()
            torch.cuda.synchronize()
            if decode:
                decode_s.append(time.perf_counter() - t)
        out.append(list(h.req.out_tokens))
    wall = time.perf_counter() - t0
    tokens = sum(len(o) for o in out)
    return out, dict(tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
                     decode_p50_ms=float(np.median(decode_s)) * 1e3)


def _graph_stats(dec):
    """The decoder's requests' ``SpecStats`` summed, with the rates."""
    keys = ("rounds", "emitted", "proposed", "accepted", "target_verify_steps",
            "target_prefill_steps", "draft_steps", "verify_rebuilds", "failovers")
    reqs = dec.metrics()["requests"]
    tot = {k: sum(r[k] for r in reqs) for k in keys}
    tot["acceptance_rate"] = tot["accepted"] / max(1, tot["proposed"])
    tot["target_steps_per_token"] = tot["target_verify_steps"] / max(1, tot["emitted"])
    return tot


def _graph_check(label, outs, want):
    bad = {i: next((j for j, (x, y) in enumerate(zip(o, w)) if x != y), min(len(o), len(w)))
           for i, (o, w) in enumerate(zip(outs, want)) if o != w}
    if bad or len(outs) != len(want):
        raise AssertionError(f"{label}: speculated outputs differ from the target-only "
                             f"baseline (request: first differing position) {bad}")


def _graph_launches(cfg, label, engine, before):
    """The engine's paged-attention launches since ``before`` (launches,
    steps, verify steps) must be one a layer per step and per verify step,
    its verify step on its fabric and no emitted row non-finite."""
    m = engine.metrics()
    n = m["kernel_launches"]["paged_attention"] - before[0]
    steps, verify = m["steps"] - before[1], m["verify_steps"] - before[2]
    if n != cfg.num_layers * (steps + verify) or (verify and n == 0):
        raise AssertionError(f"{label}: {engine.engine_id} launched paged attention {n} "
                             f"times for {steps} steps + {verify} verify steps of "
                             f"{cfg.num_layers} layers")
    if verify and "engine.paged_verify" not in m["fabric"]["functions"]:
        raise AssertionError(f"{label}: engine.paged_verify is not on the engine's fabric: "
                             f"{m['fabric']['functions']}")
    if m["nonfinite_logits"]:
        raise AssertionError(f"{label}: {m['nonfinite_logits']} non-finite emitted rows")
    return f"{engine.engine_id} {n} launches = {cfg.num_layers} x ({steps} + {verify})"


def _counts(engine):
    m = engine.metrics()
    return m["kernel_launches"]["paged_attention"], m["steps"], m["verify_steps"]


def _graph_log(label, stats, outs, wall, base_run, card, extra=""):
    tokens = sum(len(o) for o in outs)
    log(f"[graph] {label}: {len(outs)}/{len(outs)} requests identical to the baseline; "
        f"target steps a token {stats['target_steps_per_token']:.3f} (prefill excluded), "
        f"acceptance {stats['acceptance_rate']:.3f}, {stats['rounds']} rounds, "
        f"{stats['draft_steps']} draft steps; {tokens / wall:.1f} tokens/s against "
        f"{base_run['tokens_per_s']:.1f} target-only ({wall:.3f}s){extra} on {card}")


def _graph_engine_run(torch, cfg, label, target, draft, k, prompts, want, base_run, card):
    """Engine mode: ``prompts`` one at a time through a SpeculativeDecoder
    on ``target`` (ngram when ``draft`` is None)."""
    from repro_torch.fabric.graph import SpeculativeDecoder

    engines = (target,) if draft is None else (target, draft)
    for e in engines:
        e.restart()
    before = [_counts(e) for e in engines]
    dec = SpeculativeDecoder(target=target, draft=draft, k=k)
    torch.cuda.synchronize()
    t = time.perf_counter()
    outs = [list(dec.submit(p, MAX_NEW).tokens()) for p in prompts]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    _graph_check(label, outs, want)
    stats = _graph_stats(dec)
    counts = "; ".join(_graph_launches(cfg, label, e, b) for e, b in zip(engines, before))
    _graph_log(label, stats, outs, wall, base_run, card, f"; {counts}")
    return stats


def _graph_router_run(torch, cfg, label, engines, prompts, want, base_run, card, *,
                      kill=False, rate=0.0):
    """Router mode: two target replicas and a draft replica (model tags
    ``target`` and ``draft``), so every draft -> verify edge is a frame
    train; ``kill`` fails the replica holding the verify node at router
    tick ``GRAPH_KILL_TICK``, ``rate`` damages edge frames."""
    from repro_torch.cluster import FaultInjector, FaultPlan, Replica, Router
    from repro_torch.fabric.graph import EDGE_SPEC, SpeculativeDecoder

    t0, t1, draft = engines
    for e in engines:
        e.restart()
    before = [_counts(e) for e in engines]
    router = Router([Replica(t0, model="target"), Replica(t1, model="target"),
                     Replica(draft, model="draft")], max_retries=CHAOS_RETRIES,
                    retry_backoff_s=0.0)
    # the first verify placement breaks the tie between empty replicas by
    # engine id: t0 holds the verify node when the plan kills it
    plan = FaultPlan(seed=SEED, frame_fault_rate=rate,
                     kill_at={t0.engine_id: GRAPH_KILL_TICK} if kill else {})
    injector = FaultInjector(plan).install(router)
    dec = SpeculativeDecoder(router=router, target_model="target", draft_model="draft",
                             k=GRAPH_MODEL_K)
    torch.cuda.synchronize()
    t = time.perf_counter()
    outs = [list(dec.submit(p, MAX_NEW).tokens()) for p in prompts]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    _graph_check(label, outs, want)
    stats = _graph_stats(dec)
    m = router.metrics()
    r, f = m["router"], m["faults"]
    verify_at = [p["engine_id"] for p in r["node_placements"] if p["node"] == "verify"]
    if r["edge_frames"] == 0 or r["edge_bytes"] != r["edge_frames"] * EDGE_SPEC.total_bytes:
        raise AssertionError(f"{label}: edge frames {r['edge_frames']}, bytes "
                             f"{r['edge_bytes']}")
    if kill and (verify_at[0] != t0.engine_id or set(verify_at) != {t0.engine_id,
                                                                     t1.engine_id}
                 or not stats["verify_rebuilds"] or injector.counters["kills"] != 1):
        raise AssertionError(f"{label}: verify placed on {verify_at}, stats {stats}, "
                             f"faults {f}")
    if rate and (not r["edge_retransmits"] or f["detected"] != r["edge_retransmits"]):
        raise AssertionError(f"{label}: no retransmitted edge: {r} {f}")
    counts = "; ".join(_graph_launches(cfg, label, e, b) for e, b in zip(engines, before))
    _graph_log(label, stats, outs, wall, base_run, card,
               f"; edge frames {r['edge_frames']} ({r['edge_bytes']} bytes), retransmits "
               f"{r['edge_retransmits']}, warm edge hits {r['edge_local_hits']}; failovers "
               f"{stats['failovers']} (router {f['failovers']}), session rebuilds "
               f"{stats['verify_rebuilds']}; verify placements {verify_at.count(t0.engine_id)} "
               f"on {t0.engine_id}, {verify_at.count(t1.engine_id)} on {t1.engine_id}; "
               f"injected {injector.counters}; {counts}")
    for e in engines:
        e.restart()


def _graph_float32_control(torch, dev, cfg, geom, prompt, card):
    """One request, target-only and at ngram k ``GRAPH_MODEL_K``, on two
    float32 engines (the plain path) sharing one weight tree."""
    from repro_torch.engine import Engine
    from repro_torch.fabric.graph import SpeculativeDecoder

    base, target = (Engine(cfg, device=dev, kernel="ref", engine_id=f"graph-f32-{eid}",
                           compute_dtype=torch.float32, **geom) for eid in ("base", "t"))
    base.load_params(seed=SEED)
    target.load_params(base.params)
    want, base_run = _graph_baseline(torch, base, [prompt])
    dec = SpeculativeDecoder(target=target, k=GRAPH_MODEL_K)
    t = time.perf_counter()
    outs = [list(dec.submit(prompt, MAX_NEW).tokens())]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    label = f"float32 control, ngram k {GRAPH_MODEL_K}, plain path"
    _graph_check(label, outs, want)
    if target.metrics()["nonfinite_logits"]:
        raise AssertionError(f"{label}: non-finite emitted rows")
    _graph_log(label, _graph_stats(dec), outs, wall, base_run, card)
    del base, target
    gc.collect()
    torch.cuda.empty_cache()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch


    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        return fail(f"{src / 'repro_torch'} not found: run from a checkout of the repo")
    sys.path.insert(0, str(src))
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.device import strict_fp32
    from repro_torch.kernels import loader, timing
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.mailbox import kernel as mb_kernel
    from repro_torch.kernels.moe_jam import kernel as mj_kernel
    from repro_torch.kernels.paged_attention import bench
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    from repro_torch.kernels.ssm_scan import kernel as ss_kernel

    t_start = time.perf_counter()
    strict_fp32()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = timing.card_name()
    log(f"[device] {name} x{count}; torch {torch.__version__} cuda {torch.version.cuda}; {card}")

    with Phase("build"):
        libs = loader.build_all([pa_kernel.SOURCE, mj_kernel.SOURCE, ss_kernel.SOURCE,
                                 mb_kernel.SOURCE, mb_kernel.RING_SOURCE, fa_kernel.SOURCE,
                                 fa_kernel.BWD_SOURCE, mj_kernel.BWD_SOURCE,
                                 ss_kernel.BWD_SOURCE])
        for lib in libs.values():
            log(f"[build] {lib.name}")
            report = lib.with_suffix(".log")
            for line in (report.read_text().splitlines() if report.exists() else []):
                if line.strip():
                    log(f"[build] {line.strip()}")

    if (bench.SLOTS, bench.CHUNK, bench.BLOCK, bench.NUM_BLOCKS,
            bench.MAX_BLOCKS * bench.BLOCK) != (SLOTS, CHUNK, BLOCK, NUM_BLOCKS, MAX_LEN):
        raise AssertionError("the kernel check's shapes are not the engine's")
    entries = {}
    with Phase("kernel vs plain"):
        flush = timing.l2_flush_buffer(dev)
        log(f"[kernel] timer floor: a one-element fill_ timed as every kernel below is: "
            f"{timing.floor_ms(flush):.4f} ms (L2 flushed clean), "
            f"{timing.floor_ms(None):.4f} ms (warm)")
        del flush
        train_entries = check_flash_bwd(torch, dev)
        entries[("flash_attention_bwd", "train")] = train_entries["bwd"]
        entries[("flash_attention", "train")] = train_entries["fwd"]
        torch.cuda.empty_cache()
        moe_entries = check_moe_jam_bwd(torch, dev)
        entries[("moe_jam_bwd", "train")] = moe_entries["bwd"]
        entries[("moe_jam", "train")] = moe_entries["fwd"]
        torch.cuda.empty_cache()
        scan_entries = check_ssm_scan_bwd(torch, dev)
        for key in ("bwd", "fwd"):
            for path, entry in scan_entries[key].items():
                entries[(entry["name"], path)] = entry
        torch.cuda.empty_cache()
    with Phase("train"):
        launches = train_path(torch, dev, card)
        entries[("flash_attention_bwd", "train")]["launches"] = launches["flash_attention_bwd"]
        entries[("flash_attention", "train")]["launches"] = launches["flash_attention"]
        gc.collect()
        torch.cuda.empty_cache()
    with Phase(f"train {MOE_TRAIN_ARCH}"):
        launches = moe_train_path(torch, dev, card)
        for kname in ("moe_jam_bwd", "moe_jam"):
            entries[(kname, "train")]["launches"] = launches[kname]
        entries[("moe_jam_bwd", "train")]["dispatch_ms"] = launches["dispatch"]
        for kname, key in (("flash_attention", "fwd"), ("flash_attention_bwd", "bwd")):
            entries[(kname, f"{MOE_TRAIN_ARCH} train")] = dict(
                train_entries[key], **train_entries[key]["shapes"][f"{MOE_TRAIN_ARCH} train"],
                path=f"{MOE_TRAIN_ARCH} train", launches=launches[kname], shapes=None)
        gc.collect()
        torch.cuda.empty_cache()
    with Phase(f"train SSM ({', '.join(SSM_TRAIN_ARCHS)})"):
        for arch, launches in ssm_train_path(torch, dev, card).items():
            for kname in ("ssm_scan", "ssm_scan_bwd"):
                entries[(kname, f"{arch} train")]["launches"] = launches[kname]
            if launches["flash_attention"]:
                entries[("flash_attention_bwd", "train")][f"{arch} train launches"] = launches[
                    "flash_attention_bwd"]
                entries[("flash_attention", "train")][f"{arch} train launches"] = launches[
                    "flash_attention"]
        gc.collect()
        torch.cuda.empty_cache()
    with Phase("kernel vs plain (serving)"):
        for arch in ARCHS:
            a = get_config(arch).attention
            if a is not None:
                entries[("paged_attention", arch)] = check_paged(
                    torch, dev, arch=arch, heads=a.num_heads, kv_heads=a.num_kv_heads,
                    head_dim=a.head_dim)
        entries[("moe_jam", "olmoe-1b-7b")] = check_moe_jam(torch, dev,
                                                            get_config("olmoe-1b-7b"))
        cfgs = {p: get_config(p) for p in FLASH_PATHS}
        for path, entry in check_flash(torch, dev, cfgs).items():
            where = "encoder" if cfgs[path].is_encoder else "slots"
            entries[("flash_attention", f"{path} {where}")] = entry
        torch.cuda.empty_cache()
        check_flash_lse_widths(torch, dev)
        for path, entry in check_ssm_scan(
                torch, dev, {p: get_config(p) for p in (MAMBA_ARCH, HYMBA_ARCH)}).items():
            entries[("ssm_scan", path)] = entry
        torch.cuda.empty_cache()
        entries[("moe_jam", f"{MLA_ARCH} slots")] = check_moe_jam_deepseek(
            torch, dev, get_config(MLA_ARCH))
        torch.cuda.empty_cache()

    for arch in ARCHS:
        with Phase(f"end to end {arch}"):
            engine, records, events, summary = serve(torch, dev, arch)
            if engine.cache_kind == "recurrent":
                _check_exact_without_preemption(torch, dev, arch, engine)
            rep = replay(torch, dev, engine, records, events)
            _step_profile(torch, engine, records)
            for (kname, path), entry in entries.items():
                if path == arch:
                    entry["launches"] = summary["launches"][kname]
            log(f"[e2e] {arch}: {summary['tokens']} tokens in {summary['wall_s']:.2f}s = "
                f"{summary['tokens_per_s']:.1f} tokens/s, step p50 "
                f"{summary['step_p50_ms']:.2f} ms, {summary['steps']} steps, "
                f"{summary['preemptions']} preemptions, peak "
                f"{summary['peak_mem_gb']:.2f} GB, greedy agreement "
                f"{rep['agree']}/{rep['rows']} on {name} ({card})")
            del engine, records, events
            gc.collect()              # request handles and the engine form cycles
            torch.cuda.empty_cache()
    for arch in (SLOTS_ARCH, MLA_ARCH, MAMBA_ARCH, HYMBA_ARCH):
        with Phase(f"end to end {arch} (slots)"):
            launches = slots_path(torch, dev, card, arch)
            for (kname, path), entry in entries.items():
                if path == f"{arch} slots":
                    entry["launches"] = launches[kname]
            gc.collect()
            torch.cuda.empty_cache()
    with Phase(f"end to end {XL_ARCH} (recurrent)"):
        engine, records, events, summary = serve(torch, dev, XL_ARCH)
        _check_exact_without_preemption(torch, dev, XL_ARCH, engine)
        _step_profile(torch, engine, records)
        i = _mixed_index(records)
        logit = _mixed_step(torch, dev, engine, engine.cache, i, records[i][:-1],
                            LOGITS[XL_ARCH])
        if not logit["ok"]:
            raise AssertionError(f"bf16 departs from float32 past the stated rule: {logit}")
        log(f"[e2e] {XL_ARCH}: {summary['tokens']} tokens in {summary['wall_s']:.2f}s = "
            f"{summary['tokens_per_s']:.1f} tokens/s, step p50 {summary['step_p50_ms']:.2f} ms, "
            f"{summary['steps']} steps, {summary['preemptions']} preemptions, snapshots "
            f"{summary['snapshots_taken']} taken / {summary['snapshots_restored']} restored, "
            f"{summary['state_bytes_per_slot']} state bytes a slot, peak "
            f"{summary['peak_mem_gb']:.2f} GB, no kernel launched, on {name} ({card})")
        del engine, records, events
        gc.collect()
        torch.cuda.empty_cache()
    with Phase(f"end to end {XL_ARCH} (slots)"):
        xlstm_slots(torch, dev, card)
        gc.collect()
        torch.cuda.empty_cache()
    full = get_config(QWEN_ARCH)
    with Phase(f"end to end {QWEN_ARCH} (slots, {QWEN_LAYERS} of {full.num_layers} layers)"):
        log(f"[slots] {QWEN_ARCH} at full width, its stack cut to {QWEN_LAYERS} of "
            f"{full.num_layers} layers: the whole stack does not fit one card")
        launches = slots_path(torch, dev, card, QWEN_ARCH,
                              dataclasses.replace(full, num_layers=QWEN_LAYERS))
        entries[("flash_attention", f"{QWEN_ARCH} slots")]["launches"] = launches[
            "flash_attention"]
        gc.collect()
        torch.cuda.empty_cache()
    with Phase(f"end to end {HUBERT_ARCH} (encoder)"):
        launches = encoder_path(torch, dev, card)
        entries[("flash_attention", f"{HUBERT_ARCH} encoder")]["launches"] = launches[
            max(HUBERT_BATCHES, key=lambda bt: bt[1])]
        gc.collect()
        torch.cuda.empty_cache()
    with Phase("cluster (replicas side by side)"):
        launches = cluster_path(torch, dev, card)
        log(f"[cluster] launches over the phase (every count set to 0 just before it): "
            f"{launches} on {card}")
        for kname, src in (("paged_attention", ARCHS[0]), ("ssm_scan", MAMBA_ARCH)):
            entries[(kname, "cluster")] = dict(entries[(kname, src)], path=f"{src} cluster",
                                               launches=launches[kname])
        entries[("flash_attention", f"{ARCHS[0]} slots")]["path"] = f"{ARCHS[0]} cluster"
        entries[("flash_attention", f"{ARCHS[0]} slots")]["launches"] = launches[
            "flash_attention"]
        gc.collect()
        torch.cuda.empty_cache()
    with Phase("graph (draft -> verify speculation)"):
        launches = graph_path(torch, dev, card)
        log(f"[graph] launches over the phase (every count set to 0 just before it): "
            f"{launches} on {card}")
        if set(k for k, n in launches.items() if n) != {"paged_attention"}:
            raise AssertionError(f"the graph phase launched {launches}: paged attention "
                                 "alone expected")
        entries[("paged_attention", "graph")] = dict(
            entries[("paged_attention", ARCHS[0])], path=f"{ARCHS[0]} graph",
            launches=launches["paged_attention"])
        gc.collect()
        torch.cuda.empty_cache()
    unlaunched = [k for k, e in entries.items() if not e["launches"]]
    if unlaunched:
        raise AssertionError(f"kernels checked but never launched on their path: {unlaunched}")
    with Phase("frame path"):
        frame_entries = frame_path(torch, dev, card)
        gc.collect()
        torch.cuda.empty_cache()
    with Phase("ring put"):
        frame_entries.append(ring_path(torch, dev, card))
        torch.cuda.empty_cache()
    log(f"[phase] total: {time.perf_counter() - t_start:.1f}s")

    print(card, flush=True)
    print(json.dumps({"kernels": list(entries.values()) + frame_entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:                       # report, then exit non-zero
        import traceback
        traceback.print_exc()
        sys.exit(fail(f"{type(exc).__name__}: {exc}"))
