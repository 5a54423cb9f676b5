"""Host loader with background prefetch.

A worker thread makes future batches (host numpy) while the device step
runs, as in ``repro/data/pipeline.py``. Where the JAX pipeline places each
batch onto a mesh, the port copies it onto one ``device`` (pinned host
memory and a non-blocking copy on a card); the mesh is ROADMAP A14.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.synthetic import synthetic_batch
from repro_torch.device import resolve_device


class DataPipeline:
    """Prefetching batch iterator from ``start_step``: each ``next`` gives
    the batch of the next step as tensors on ``device`` (default ``cuda``;
    raises without a card). ``step`` is the step of the next batch."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, *, device=None,
                 seed: int = 0, start_step: int = 0, prefetch: int = 2):
        self.cfg, self.shape = cfg, shape
        self.device = resolve_device(device)
        self.seed = seed
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        self.step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # -- worker ---------------------------------------------------------------
    def _worker(self) -> None:
        step = self.step
        while not self._stop.is_set():
            batch = synthetic_batch(self.cfg, self.shape, step, self.seed)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    # -- consumer -------------------------------------------------------------
    def _place(self, host_batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        cuda = self.device.type == "cuda"
        out = {}
        for k, v in host_batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = t.pin_memory().to(self.device, non_blocking=True) if cuda else t
        return out

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        step, batch = self._q.get()
        self.step = step + 1
        return self._place(batch)

    def close(self) -> None:
        """Stop the worker; safe to call more than once."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
