"""Fault-tolerant training loop (the port of ``repro/runtime/trainer.py``).

Wires together the train step (``runtime.steps.make_train_step``), the data
pipeline (``data.DataPipeline``), the checkpoint manager
(``checkpoint.CheckpointManager``) and the fault machinery
(``runtime.fault``). The loop:

  1. restore-or-init the float32 params and the optimizer state on the
     device (init from a ``torch.Generator`` seeded with ``run.seed``),
  2. per step: inject faults (tests), fetch the prefetched batch, run the
     step, observe the step time, periodically checkpoint asynchronously,
  3. on a failure, an ``InjectedFault`` or an error of the CUDA runtime
     (``torch.AcceleratorError``), restore from the latest committed
     checkpoint and continue (bounded by ``RestartPolicy``); any other
     error is a bug, not a fault, and is raised, not replayed.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.data.pipeline import DataPipeline
from repro_torch.device import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.optim.adamw import AdamWState, adamw_init
from repro_torch.runtime.fault import (FaultInjector, InjectedFault, RestartPolicy,
                                       StepStats, StragglerMonitor)
from repro_torch.runtime.steps import StepBundle, make_train_step

# failures the loop restarts from; torch.AcceleratorError is the CUDA
# runtime's own error where the installed torch has it
RETRYABLE = (InjectedFault,) + ((torch.AcceleratorError,)
                                if hasattr(torch, "AcceleratorError") else ())


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    keep_checkpoints: int = 3
    restore: bool = True


class Trainer:
    """``train()`` runs ``tcfg.steps`` steps of ``run`` on ``device``
    (default ``cuda``; raises without a card) in bf16 through the train
    step's kernels (the plain versions on the CPU), checkpointing into
    ``run.checkpoint_dir`` (required) as ``tcfg`` says. The batch is
    ``run.shape.global_batch``. After ``train()``, ``params`` and ``opt``
    hold the final state."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, *,
                 tcfg: Optional[TrainerConfig] = None,
                 injector: Optional[FaultInjector] = None,
                 log_fn: Callable[[str], None] = print, device=None):
        self.cfg, self.run = cfg, run
        if not run.checkpoint_dir:
            raise ValueError("RunConfig.checkpoint_dir is required for training: the "
                             "Trainer writes its checkpoints there and restores from it")
        self.device = resolve_device(device)
        self.tcfg = tcfg or TrainerConfig()
        self.injector = injector
        self.log = log_fn
        self.bundle: StepBundle = make_train_step(cfg, run, device=self.device)
        self.ckpt = CheckpointManager(run.checkpoint_dir, keep=self.tcfg.keep_checkpoints)
        self.monitor = StragglerMonitor()
        self.policy = RestartPolicy()

    # -- state ----------------------------------------------------------------
    def init_state(self):
        """(step, params, opt) on the device: the latest checkpoint when
        there is one (and ``tcfg.restore``), else fresh float32 params from
        ``run.seed`` and a zero optimizer state."""
        if self.tcfg.restore:
            shapes = model_lib.abstract_params(self.cfg)
            template = {"params": shapes, "opt": AdamWState(
                step=torch.empty((), dtype=torch.int32, device="meta"), m=shapes, v=shapes)}
            step, state = self.ckpt.restore_latest(template, self.device)
            if step is not None:
                self.log(f"[trainer] restored checkpoint step {step}")
                return step, state["params"], state["opt"]
        gen = torch.Generator(device=self.device).manual_seed(self.run.seed)
        params = model_lib.init_params(self.cfg, gen, self.device)
        return 0, params, adamw_init(params)

    def _pipeline(self, start_step: int) -> DataPipeline:
        return DataPipeline(self.cfg, self.run.shape, device=self.device, seed=self.run.seed,
                            start_step=start_step)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- loop -----------------------------------------------------------------
    def train(self) -> StepStats:
        stats = StepStats()
        step, params, opt = self.init_state()
        pipe = self._pipeline(step)
        metrics: Dict[str, torch.Tensor] = {}
        steps_since_start = 0          # the first step after a (re)start warms up
        try:
            while step < self.tcfg.steps:
                try:
                    batch = next(pipe)
                    t0 = time.perf_counter()
                    # jitter counts as step time; a failure raises out of
                    # the timed region into the restart path
                    if self.injector is not None:
                        self.injector.before_step(step)
                    params, opt, metrics = self.bundle.fn(params, opt, batch)
                    self._sync()
                    dt = time.perf_counter() - t0
                    steps_since_start += 1
                    if steps_since_start > 1 and self.monitor.observe(step, dt):
                        stats.stragglers += 1
                        self.log(f"[trainer] straggler step {step}: {dt*1e3:.1f}ms vs ewma "
                                 f"{self.monitor.ewma*1e3:.1f}ms")
                    step += 1
                    if step % self.tcfg.log_every == 0:
                        self.log(f"[trainer] step {step}: loss={float(metrics['loss']):.4f} "
                                 f"gnorm={float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms")
                    if step % self.tcfg.checkpoint_every == 0:
                        self.ckpt.save(step, {"params": params, "opt": opt},
                                       meta={"config": self.cfg.to_json()})
                except RETRYABLE as e:
                    self.log(f"[trainer] step {step} failed: {e}")
                    if not self.policy.on_failure(e):
                        raise
                    stats.restarts += 1
                    pipe.close()
                    self.ckpt.wait()
                    params = opt = batch = None            # free the device first
                    gc.collect()
                    if self.device.type == "cuda":
                        torch.cuda.empty_cache()
                    step, params, opt = self.init_state()
                    pipe = self._pipeline(step)
                    steps_since_start = 0
                    self.log(f"[trainer] restarted from step {step} "
                             f"(restart {self.policy.restarts})")
        finally:
            pipe.close()
            self.ckpt.wait()

        self.params, self.opt = params, opt
        stats.steps = step
        stats.p50_s = self.monitor.percentile(50.0)
        stats.p999_s = self.monitor.percentile(99.9)
        stats.tail_spread = self.monitor.tail_spread()
        stats.final_metrics = {k: float(v) for k, v in metrics.items()}
        return stats
